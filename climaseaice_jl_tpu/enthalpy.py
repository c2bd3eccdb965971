"""Enthalpy-method vertical column sea-ice model.

JAX equivalent of `src/EnthalpyMethodSeaIceModel.jl`: a standalone
1-D(z) model with prognostic enthalpy H, diagnostic temperature T = H/c,
phase mask ϕ, phase-dependent molecular diffusivity
κ = κ_ice (1 − ϕ) + κ_water ϕ, and tendency ∂t H = ∂z(κ ∂z T), stepped with
forward Euler.

Behavioral parity notes (mirrored deliberately from the reference):

* ``compute_porosity!`` sets ϕ = 1 where T < Tₘ (`EnthalpyMethodSeaIceModel.jl:120-130`);
* ``compute_temperature!`` uses T = H/c without the ℒϕ term (`:132-144`).

Temperature boundary conditions are Dirichlet values at the top/bottom faces
(possibly time-dependent callables ``T(t)``), imposed through ghost cells,
matching the `ValueBoundaryCondition` usage of
`examples/diffusive_ice_column_model.jl`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .utils import pytree_dataclass, static_field
from .state import Clock

REFERENCE_DENSITY = 999.8  # kg m⁻³ (`EnthalpyMethodSeaIceModel.jl:38`)


@pytree_dataclass
class ZGrid:
    """Uniform 1-D vertical grid with one halo cell per side.  Cell centers at
    z0 + (k+1/2)Δz, k = 0..Nz-1 (k=0 is the bottom)."""
    Nz: int = static_field()
    dtype: str = static_field(default="float64")
    z0: object = -1.0
    z1: object = 0.0

    @property
    def dz(self):
        return (self.z1 - self.z0) / self.Nz

    @property
    def shape(self):
        return (self.Nz + 2,)

    def interior(self, q):
        return q[..., 1:self.Nz + 1]

    def zc(self):
        import numpy as np
        k = np.arange(self.Nz)
        return self.z0 + (k + 0.5) * self.dz


@pytree_dataclass
class MolecularDiffusivity:
    kappa_ice: object = 1e-5
    kappa_water: object = 1e-6


@pytree_dataclass
class ValueBoundaryCondition:
    """Dirichlet temperature at a z-face; ``value`` is a number or ``f(t)``."""
    value: object = static_field(default=0.0)

    def at(self, t):
        if callable(self.value):
            return self.value(t)
        return self.value


@pytree_dataclass
class FluxBoundaryCondition:
    """Prescribed diffusive flux through a z-face (number or ``f(t)``)."""
    value: object = static_field(default=0.0)

    def at(self, t):
        if callable(self.value):
            return self.value(t)
        return self.value


@pytree_dataclass
class EnthalpyMethodSeaIceModel:
    grid: ZGrid = None
    closure: MolecularDiffusivity = None
    ice_heat_capacity: object = 2090.0 / REFERENCE_DENSITY
    water_heat_capacity: object = 3991.0 / REFERENCE_DENSITY
    fusion_enthalpy: object = 3.3e5 / REFERENCE_DENSITY
    top_T_bc: object = static_field(default=None)     # Value/Flux BC at z = z1
    bottom_T_bc: object = static_field(default=None)  # Value/Flux BC at z = z0

    def __post_init__(self):
        if self.closure is None:
            object.__setattr__(self, "closure", MolecularDiffusivity())


@pytree_dataclass
class EnthalpyState:
    H: object = None     # enthalpy (padded, Nz+2)
    T: object = None     # temperature diagnostic
    phi: object = None   # phase mask
    kappa: object = None
    clock: Clock = None


def initial_state(model: EnthalpyMethodSeaIceModel, T=None, H=None, time=0.0,
                  columns=()):
    """``set!(model; T=...)`` or ``set!(model; H=...)`` analog
    (`EnthalpyMethodSeaIceModel.jl:80-98`).  ``columns``: optional leading
    (x, y) batch shape — a 3-D :xyz field of independent columns."""
    grid = model.grid
    dt_ = jnp.dtype(grid.dtype)
    z = jnp.zeros(tuple(columns) + grid.shape, dt_)
    if T is not None and H is not None:
        raise ValueError("cannot set both temperature and enthalpy")
    state = EnthalpyState(H=z, T=z, phi=z, kappa=z,
                          clock=Clock(time=jnp.asarray(time, dt_),
                                      iteration=jnp.asarray(0, "int32")))
    if T is not None:
        # set!(T=...): H = cT + ℒϕ, T kept as set (`:80-98` update_enthalpy!);
        # the first step recomputes T = H/c (reference behavior, consistent
        # for initial T ≥ 0 where ϕ = 0).
        Tv = _set_interior(grid, z, T)
        Tv = _apply_T_bcs(model, Tv, state.clock.time)
        phi = _porosity(Tv)
        kappa = (model.closure.kappa_ice * (1 - phi)
                 + model.closure.kappa_water * phi)
        H = model.ice_heat_capacity * Tv + model.fusion_enthalpy * phi
        return state.evolve(T=Tv, H=H, phi=phi, kappa=kappa)
    if H is not None:
        state = state.evolve(H=_set_interior(grid, z, H))
    return update_state(model, state)


def _set_interior(grid, q, values):
    if callable(values):
        values = values(grid.zc())
    return q.at[..., 1:grid.Nz + 1].set(jnp.asarray(values, q.dtype))


def _porosity(T):
    # ϕ = 1 where T < Tₘ (= 0 °C), reference behavior (`:120-130`)
    return jnp.where(T < 0, 1.0, 0.0)


def _apply_T_bcs(model, T, t):
    """Ghost cells imposing Dirichlet face values (or zero-gradient default)."""
    grid = model.grid
    Nz = grid.Nz
    bot, top = model.bottom_T_bc, model.top_T_bc
    if isinstance(bot, ValueBoundaryCondition):
        T = T.at[..., 0].set(2 * bot.at(t) - T[..., 1])
    else:
        T = T.at[..., 0].set(T[..., 1])
    if isinstance(top, ValueBoundaryCondition):
        T = T.at[..., Nz + 1].set(2 * top.at(t) - T[..., Nz])
    else:
        T = T.at[..., Nz + 1].set(T[..., Nz])
    return T


def update_state(model, state):
    """T = H/c, ϕ(T), κ(ϕ), BC ghost cells (`:161-166`)."""
    c = model.ice_heat_capacity
    T = state.H / c
    T = _apply_T_bcs(model, T, state.clock.time)
    phi = _porosity(T)
    kappa = model.closure.kappa_ice * (1 - phi) + model.closure.kappa_water * phi
    return state.evolve(T=T, phi=phi, kappa=kappa)


def _step(model, state, dt):
    """∂t H = ∂z(κ ∂z T), forward Euler (`:168-201`)."""
    grid = model.grid
    Nz, dz = grid.Nz, grid.dz
    T, kappa = state.T, state.kappa

    # diffusive flux at z-faces k-1/2 for k = 1..Nz+1: κ̄ (T[k] − T[k−1]) / Δz
    # (last-axis ops: the column model batches over arbitrary leading (x, y)
    # dims, the :xyz launch analog of `EnthalpyMethodSeaIceModel.jl`)
    kappa_face = 0.5 * (kappa + jnp.roll(kappa, 1, axis=-1))
    grad = (T - jnp.roll(T, 1, axis=-1)) / dz
    flux = kappa_face * grad  # flux[k] at the face below cell k

    G = (jnp.roll(flux, -1, axis=-1) - flux) / dz

    # Prescribed-flux BCs override the face flux at the boundaries
    t = state.clock.time
    if isinstance(model.bottom_T_bc, FluxBoundaryCondition):
        G = G.at[..., 1].set((flux[..., 2] - model.bottom_T_bc.at(t)) / dz)
    if isinstance(model.top_T_bc, FluxBoundaryCondition):
        G = G.at[..., Nz].set((model.top_T_bc.at(t) - flux[..., Nz]) / dz)

    H = state.H.at[..., 1:Nz + 1].add(dt * G[..., 1:Nz + 1])
    state = state.evolve(H=H,
                         clock=Clock(time=state.clock.time + dt,
                                     iteration=state.clock.iteration + 1))
    return update_state(model, state)


step = jax.jit(_step)
