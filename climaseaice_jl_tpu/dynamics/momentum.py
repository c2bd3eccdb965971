"""Momentum equations: tendencies, explicit solver, split-explicit αEVP solver.

Vectorized JAX equivalents of:

* `src/SeaIceDynamics/sea_ice_momentum_equations.jl` — config;
* `src/SeaIceDynamics/momentum_tendencies_kernel_functions.jl` — tendencies;
* `src/SeaIceDynamics/explicit_momentum_equations.jl` — explicit solver;
* `src/SeaIceDynamics/split_explicit_momentum_equations.jl` — split-explicit
  substepping.

The reference's ~2·substeps kernel launches per outer step (called out as
the bottleneck at `split_explicit_momentum_equations.jl:150-156`) become one
``lax.fori_loop`` inside a single XLA executable; each substep's halo
re-pads are pure slice updates (single-device) or ``ppermute`` collectives
(distributed) injected via the ``halo_u``/``halo_v`` callables.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax.numpy as jnp
from jax import lax

from ..utils import pytree_dataclass, static_field
from ..ops import ixf, iyf
from ..fields import fill_halos_fc, fill_halos_cf, fill_halos_cc, fill_halos_ff
from ..state import ModelFields
from .coriolis import x_f_cross_U, y_f_cross_U
from .stresses import (explicit_tau_x, explicit_tau_y,
                       implicit_tau_x_coefficient, implicit_tau_y_coefficient)
from .free_drift import free_drift_u, free_drift_v
from .rheologies import (ElastoViscoPlasticRheology, ice_strength,
                         compute_evp_viscosities, compute_evp_stresses,
                         stress_divergence, strain_rates,
                         rheology_forcing_u, rheology_forcing_v)


@dataclasses.dataclass(frozen=True)
class ExplicitSolver:
    """One semi-implicit velocity update per step (`explicit_momentum_equations.jl`)."""


@dataclasses.dataclass(frozen=True)
class SplitExplicitSolver:
    """N pseudo-time substeps per step (`split_explicit_momentum_equations.jl:18-34`)."""
    substeps: int = 120
    # halo_exchange (distributed runs only):
    #   'per_substep' — exchange u/v halos via ppermute after every update;
    #   'wide'        — communication-avoiding: exchange once per outer step
    #                   with halos ≥ 2·substeps+3 wide, local-only fills in
    #                   the loop (`split_explicit_momentum_equations.jl:51-64`)
    halo_exchange: str = "per_substep"


@pytree_dataclass
class ImmersedDrag:
    """Linear drag flux −C·u through faces adjacent to immersed cells —
    vectorized analog of the reference coastline example's immersed
    FluxBoundaryConditions (`examples/ice_advected_on_coastline.jl:91-98`,
    `ice_stress_divergence.jl:65-123`)."""
    coefficient: object = 3e-3


@pytree_dataclass
class ImmersedStressBC:
    """General immersed flux boundary conditions on the stress divergence
    (`ice_stress_divergence.jl:57-123` with FluxBoundaryCondition in discrete
    form): ``u_flux``/``v_flux`` are callables
    ``f(grid, clock, fields[, parameters])`` returning the boundary flux
    sampled at every node.  The immersed stress divergence gates them to the
    faces whose (f,f) node is immersed (`immersed_peripheral_node`), weights
    by the face length, and evaluates each flux at the face's own index —
    exactly the reference's `getbc(bc, i, jˢ/jᴺ, k, grid, clock, fields)`.
    :class:`ImmersedDrag` is the special case ``flux = −C·u``.
    """
    u_flux: object = static_field(default=None)
    v_flux: object = static_field(default=None)
    parameters: object = None


def _immersed_flux_values(imm, grid, clock, fields):
    """(Fu, Fv): boundary flux arrays for the immersed stress divergence."""
    if isinstance(imm, ImmersedDrag):
        return -imm.coefficient * fields.u, -imm.coefficient * fields.v
    zeros = jnp.zeros(grid.shape, grid.np_dtype)

    def ev(f):
        if f is None:
            return zeros
        if imm.parameters is None:
            return f(grid, clock, fields)
        return f(grid, clock, fields, imm.parameters)

    return ev(imm.u_flux), ev(imm.v_flux)


@pytree_dataclass
class SeaIceMomentumEquation:
    """Dynamics container (`sea_ice_momentum_equations.jl:3-12,67-94`)."""
    rheology: object = None
    coriolis: object = None
    solver: object = static_field(default_factory=lambda: SplitExplicitSolver(150))
    top_momentum_stress: object = None
    bottom_momentum_stress: object = None
    free_drift: object = None
    immersed_drag: object = None     # ImmersedDrag | None
    minimum_concentration: object = 1e-3
    minimum_mass: object = 1.0   # kg m⁻²

    def __post_init__(self):
        if self.rheology is None:
            object.__setattr__(self, "rheology", ElastoViscoPlasticRheology())


def _inv(x, ok):
    return jnp.where(ok, 1.0 / jnp.where(ok, x, 1.0), 0.0)


def _user_forcing(model, comp, grid, clock, fields):
    f = model.forcing_dict().get(comp)
    if f is None:
        return jnp.zeros(grid.shape, grid.np_dtype)
    return f(grid, clock, fields)


def velocity_tendencies(model, dyn, grid, dt, fields, clock, div=None):
    """(Gu, Gv) (`momentum_tendencies_kernel_functions.jl:11-74`).

    ``dt`` may be a scalar or a per-point array (the EVP substep Δτ).
    ``div``: optional precomputed ``(div_x, div_y)`` — for EVP the stress
    divergence depends only on the σ fields, which are constant across the
    u- and v-half-updates of one substep, so the substep loop hoists it."""
    masks = model.masks
    m_cc = fields.h * fields.a * fields.rho
    a_fc = ixf(fields.a)
    m_fc = ixf(m_cc)
    a_cf = iyf(fields.a)
    m_cf = iyf(m_cc)

    div_x, div_y = div if div is not None else stress_divergence(
        dyn.rheology, grid, fields,
        masks=(masks.solid_cc, masks.per_ff), clock=clock)

    inv_m_fc = _inv(m_fc, m_fc > 0)
    inv_m_cf = _inv(m_cf, m_cf > 0)

    Fu = _user_forcing(model, "u", grid, clock, fields)
    Fv = _user_forcing(model, "v", grid, clock, fields)
    if isinstance(dyn.rheology, ElastoViscoPlasticRheology):
        Fu = Fu + rheology_forcing_u(dyn.rheology, grid, dt, fields)
        Fv = Fv + rheology_forcing_v(dyn.rheology, grid, dt, fields)

    top, bottom = dyn.top_momentum_stress, dyn.bottom_momentum_stress

    Gu = (-x_f_cross_U(dyn.coriolis, grid, fields.u, fields.v)
          - explicit_tau_x(grid, top, clock, fields) * inv_m_fc * a_fc
          + explicit_tau_x(grid, bottom, clock, fields) * inv_m_fc * a_fc
          + div_x * inv_m_fc
          + Fu)
    Gv = (-y_f_cross_U(dyn.coriolis, grid, fields.u, fields.v)
          - explicit_tau_y(grid, top, clock, fields) * inv_m_cf * a_cf
          + explicit_tau_y(grid, bottom, clock, fields) * inv_m_cf * a_cf
          + div_y * inv_m_cf
          + Fv)

    if dyn.immersed_drag is not None and masks.imm_ff is not None:
        # immersed_∂ⱼσᵢⱼ with flux BCs on faces whose ff node is *immersed*
        # peripheral (not a domain wall): for the u point the south/north
        # (f,f) faces, (qᴺ − qˢ)/Az with q = flux·Δx_ff sampled at each face's
        # own index; east/west analog for v
        # (`ice_stress_divergence.jl:65-101,116-123`).
        from ..ops import shift_m
        Fu, Fv = _immersed_flux_values(dyn.immersed_drag, grid, clock, fields)
        wx = jnp.where(masks.imm_ff, jnp.broadcast_to(grid.dx_ff, grid.shape), 0.0)
        wy = jnp.where(masks.imm_ff, jnp.broadcast_to(grid.dy_ff, grid.shape), 0.0)
        imm_x = (shift_m(Fu * wx, 1) + Fu * wx) / grid.az_fc
        imm_y = (shift_m(Fv * wy, 0) + Fv * wy) / grid.az_cf
        Gu = Gu + imm_x * inv_m_fc
        Gv = Gv + imm_y * inv_m_cf

    Gu = jnp.where(m_fc <= 0, 0.0, Gu)
    Gv = jnp.where(m_cf <= 0, 0.0, Gv)
    return Gu, Gv


def _masked_velocity(grid, uD, uF, m, a, minimum_mass, minimum_concentration, active):
    """3-state select: dynamic / free-drift / zero, then peripheral masking
    (`split_explicit_momentum_equations.jl:224-228`)."""
    eps_ = jnp.finfo(grid.np_dtype).eps
    marginal = (m > eps_) & (a > eps_)
    active_ice = (m >= minimum_mass) & (a >= minimum_concentration)
    u_new = jnp.where(active_ice, uD, jnp.where(marginal, uF, 0.0))
    if active is not None:
        u_new = jnp.where(active, u_new, 0.0)
    return u_new


# --- explicit solver (`explicit_momentum_equations.jl:8-113`) -----------------

def explicit_momentum_step(model, state, fields, dt, u_prev, v_prev):
    """Returns (u, v) after one explicit semi-implicit update."""
    dyn = model.dynamics
    grid = model.grid
    clock = state.clock

    Gu, Gv = velocity_tendencies(model, dyn, grid, dt, fields, clock)

    m_cc = fields.h * fields.a * fields.rho
    a_fc, m_fc = ixf(fields.a), ixf(m_cc)
    a_cf, m_cf = iyf(fields.a), iyf(m_cc)

    top, bottom = dyn.top_momentum_stress, dyn.bottom_momentum_stress
    tau_ui = (implicit_tau_x_coefficient(grid, bottom, clock, fields)
              - implicit_tau_x_coefficient(grid, top, clock, fields)) * _inv(m_fc, m_fc > 0) * a_fc
    tau_vi = (implicit_tau_y_coefficient(grid, bottom, clock, fields)
              - implicit_tau_y_coefficient(grid, top, clock, fields)) * _inv(m_cf, m_cf > 0) * a_cf
    tau_ui = jnp.where(m_fc <= 0, 0.0, tau_ui)
    tau_vi = jnp.where(m_cf <= 0, 0.0, tau_vi)

    uD = (u_prev + dt * Gu) / (1 + dt * tau_ui)
    vD = (v_prev + dt * Gv) / (1 + dt * tau_vi)
    uF = free_drift_u(grid, dyn.free_drift, clock, fields)
    vF = free_drift_v(grid, dyn.free_drift, clock, fields)

    # NOTE: the reference's explicit kernels apply no peripheral mask
    # (`explicit_momentum_equations.jl:40-82`); we match that.
    u = _masked_velocity(grid, uD, uF, m_fc, a_fc,
                         dyn.minimum_mass, dyn.minimum_concentration, None)
    v = _masked_velocity(grid, vD, vF, m_cf, a_cf,
                         dyn.minimum_mass, dyn.minimum_concentration, None)
    u = fill_halos_fc(u, grid)
    v = fill_halos_cf(v, grid)
    return u, v


# --- split-explicit αEVP solver ----------------------------------------------

def _make_evp_substep(model, state, dt, clock, P, un, vn, halo_u, halo_v):
    """One αEVP substep as a reusable closure: ``one(u, v, s11, s22, s12,
    alpha, substep) -> (u, v, s11, s22, s12, alpha, Delta, zcc, zff)``.

    Factored out of :func:`split_explicit_momentum_step` so the overlapped
    -exchange mode can instantiate the *same* substep on narrow boundary-band
    submodels (sliced grid/masks/stresses) as well as on the full shard."""
    dyn = model.dynamics
    rheo = dyn.rheology
    grid = model.grid
    masks = model.masks
    substeps = dyn.solver.substeps
    h, a = state.h, state.a
    rho = jnp.broadcast_to(jnp.asarray(model.sea_ice_density, grid.np_dtype),
                           grid.shape)
    is_evp = isinstance(rheo, ElastoViscoPlasticRheology)

    m_cc = h * a * rho
    a_fc, m_fc = ixf(a), ixf(m_cc)
    a_cf, m_cf = iyf(a), iyf(m_cc)
    active_u = None if masks.per_fc is None else ~masks.per_fc
    active_v = None if masks.per_cf is None else ~masks.per_cf
    top, bottom = dyn.top_momentum_stress, dyn.bottom_momentum_stress

    def fields_of(u, v, s11, s22, s12, alpha):
        return ModelFields(h=h, a=a, S=state.S, hs=state.hs, u=u, v=v,
                           Tu=state.Tu, Tus=state.Tus, rho=rho,
                           sig11=s11, sig22=s22, sig12=s12,
                           un=un, vn=vn, P=P, alpha=alpha,
                           tracers=state.tracers)

    def u_step(u, v, s11, s22, s12, alpha, div=None):
        f = fields_of(u, v, s11, s22, s12, alpha)
        dtau = dt / ixf(alpha) if is_evp else dt / substeps
        Gu, _ = velocity_tendencies(model, dyn, grid, dtau, f, clock, div=div)
        tau_ui = (implicit_tau_x_coefficient(grid, bottom, clock, f)
                  - implicit_tau_x_coefficient(grid, top, clock, f)
                  ) * _inv(m_fc, m_fc > 0) * a_fc
        tau_ui = jnp.where(m_fc <= 0, 0.0, tau_ui)
        uD = (u + dtau * Gu) / (1 + dtau * tau_ui)
        uF = free_drift_u(grid, dyn.free_drift, clock, f)
        u_new = _masked_velocity(grid, uD, uF, m_fc, a_fc, dyn.minimum_mass,
                                 dyn.minimum_concentration, active_u)
        return halo_u(u_new)

    def v_step(u, v, s11, s22, s12, alpha, div=None):
        f = fields_of(u, v, s11, s22, s12, alpha)
        dtau = dt / iyf(alpha) if is_evp else dt / substeps
        _, Gv = velocity_tendencies(model, dyn, grid, dtau, f, clock, div=div)
        tau_vi = (implicit_tau_y_coefficient(grid, bottom, clock, f)
                  - implicit_tau_y_coefficient(grid, top, clock, f)
                  ) * _inv(m_cf, m_cf > 0) * a_cf
        tau_vi = jnp.where(m_cf <= 0, 0.0, tau_vi)
        vD = (v + dtau * Gv) / (1 + dtau * tau_vi)
        vF = free_drift_v(grid, dyn.free_drift, clock, f)
        v_new = _masked_velocity(grid, vD, vF, m_cf, a_cf, dyn.minimum_mass,
                                 dyn.minimum_concentration, active_v)
        return halo_v(v_new)

    def one(u, v, s11, s22, s12, alpha, Delta, zcc, zff, substep):
        div = None
        if is_evp:
            strains = strain_rates(grid, u, v)
            Delta, zcc, zff = compute_evp_viscosities(rheo, grid, u, v, P,
                                                      strains=strains)
            s11, s22, s12, alpha = compute_evp_stresses(
                rheo, grid, u, v, h, a, rho, dt, s11, s22, s12,
                Delta, zcc, zff, P, strains=strains)
            div = stress_divergence(
                rheo, grid, fields_of(u, v, s11, s22, s12, alpha),
                masks=(masks.solid_cc, masks.per_ff), clock=clock)

        def even_order(args):
            u, v = args
            u2 = u_step(u, v, s11, s22, s12, alpha, div)
            v2 = v_step(u2, v, s11, s22, s12, alpha, div)
            return u2, v2

        def odd_order(args):
            u, v = args
            v2 = v_step(u, v, s11, s22, s12, alpha, div)
            u2 = u_step(u, v2, s11, s22, s12, alpha, div)
            return u2, v2

        u, v = lax.cond(substep % 2 == 0, even_order, odd_order, (u, v))
        return (u, v, s11, s22, s12, alpha, Delta, zcc, zff)

    return one


# --- overlapped halo exchange: boundary-band recompute --------------------------

_BAND_W = 8   # interior cells per boundary band: the merge takes the 4-cell
              # substep stencil depth, whose own stencil reads 4 more.


def _band_slicer(grid, dim, side):
    """(cut, paste) for a (2H+_BAND_W)-cell band at one edge of dimension
    ``dim``; ``paste`` overwrites the H+4-cell merge region (halo + the
    4 interior cells the pre-exchange interior pass got wrong)."""
    H = grid.Hx if dim == 0 else grid.Hy
    n = grid.nxp if dim == 0 else grid.nyp
    ext = 2 * H + _BAND_W
    mw = H + 4
    lo = side == 0

    def cut(q):
        if q is None or np.ndim(q) == 0:
            return q
        if dim == 0:
            return q[:ext] if lo else q[n - ext:]
        return q[:, :ext] if lo else q[:, n - ext:]

    def paste(full, band):
        if dim == 0:
            return (full.at[:mw].set(band[:mw]) if lo
                    else full.at[n - mw:].set(band[ext - mw:]))
        return (full.at[:, :mw].set(band[:, :mw]) if lo
                else full.at[:, n - mw:].set(band[:, ext - mw:]))

    return cut, paste


def _band_submodel(model, dim, side):
    """Model restricted to one boundary band: sliced grid metrics/coords,
    masks, and external stress arrays (StressFunctions re-evaluate on the
    band grid's own coordinates).  A south/west band's fake far edge gets
    wall/fold treatment from the in-loop local fills, but only at band cells
    ≥ H+_BAND_W deep — outside every read of the merge region."""
    from ..grids import _METRIC_LOCS
    grid = model.grid
    cut, paste = _band_slicer(grid, dim, side)

    def cut_m(m):
        if m is None or np.ndim(m) == 0:
            return m
        m = jnp.asarray(m)
        if m.ndim == 2 and m.shape == grid.shape:
            return cut(m)
        if m.ndim == 2 and m.shape[0] == 1:   # (1, nyp) latitude row
            return cut(m) if dim == 1 else m
        raise NotImplementedError(f"band slice of metric shape {m.shape}")

    H = grid.Hx if dim == 0 else grid.Hy
    n = grid.nxp if dim == 0 else grid.nyp
    ext = 2 * H + _BAND_W
    cut1 = (lambda c: c[:ext]) if side == 0 else (lambda c: c[n - ext:])

    mets = {f: cut_m(getattr(grid, f)) for f in _METRIC_LOCS}
    kw = dict(solid_cc=cut_m(grid.solid_cc),
              lon_cc=cut_m(grid.lon_cc), lat_cc=cut_m(grid.lat_cc), **mets)
    if dim == 0:
        g = grid.evolve(Nx=_BAND_W, xc=cut1(grid.xc), xf=cut1(grid.xf), **kw)
    else:
        g = grid.evolve(Ny=_BAND_W, yc=cut1(grid.yc), yf=cut1(grid.yf),
                        # a south band's fake north edge is not the fold
                        north_fold=grid.north_fold and side == 1, **kw)

    m = model.masks
    from ..model import Masks
    bmasks = Masks(solid_cc=cut_m(m.solid_cc), per_fc=cut_m(m.per_fc),
                   per_cf=cut_m(m.per_cf), per_ff=cut_m(m.per_ff),
                   imm_ff=cut_m(m.imm_ff))

    dyn = model.dynamics
    from .stresses import StressFunction, SemiImplicitStress

    def cut_s(x):
        if x is None or isinstance(x, StressFunction) or np.ndim(x) == 0:
            return x
        return cut(jnp.asarray(x))

    top = dyn.top_momentum_stress
    if isinstance(top, dict):
        top = {k: cut_s(v) for k, v in top.items()}
    else:
        top = cut_s(top)
    bottom = dyn.bottom_momentum_stress
    if isinstance(bottom, SemiImplicitStress):
        bottom = dataclasses.replace(bottom, ue=cut_s(bottom.ue),
                                     ve=cut_s(bottom.ve))
    bdyn = dataclasses.replace(dyn, top_momentum_stress=top,
                               bottom_momentum_stress=bottom)
    return model.evolve(grid=g, masks=bmasks, dynamics=bdyn), cut, paste


def _make_bands(model, state, dt, clock, P, un, vn):
    """One `_make_evp_substep` instance per meshed edge, on band submodels."""
    from ..fields import (_meshed as _dim_meshed,
                          fill_halos_fc_local, fill_halos_cf_local)
    grid = model.grid
    bands = []
    for dim in (0, 1):
        if not _dim_meshed(grid, dim):
            continue
        for side in (0, 1):
            bmodel, cut, paste = _band_submodel(model, dim, side)
            g = bmodel.grid
            bstate = state.evolve(
                h=cut(state.h), a=cut(state.a), hs=cut(state.hs),
                S=cut(state.S), Tu=cut(state.Tu), Tus=cut(state.Tus),
                tracers={k: cut(q) for k, q in (state.tracers or {}).items()})
            one_b = _make_evp_substep(
                bmodel, bstate, dt, clock, cut(P), cut(un), cut(vn),
                lambda q, g=g: fill_halos_fc_local(q, g),
                lambda q, g=g: fill_halos_cf_local(q, g))
            bands.append((one_b, cut, paste))
    return bands


def split_explicit_momentum_step(model, state, dt, u_start, v_start,
                                 halo_u=None, halo_v=None):
    """The hot loop: N substeps of {αEVP stresses → alternating-leapfrog u/v}
    (`split_explicit_momentum_equations.jl:103-264`).

    ``u_start``/``v_start`` implement `reset_velocities!` (Ψ⁻ under RK3).
    ``halo_u``/``halo_v`` default to the local (single-device) halo fills and
    are swapped for ppermute exchanges in the distributed path.

    Returns a dict of updated state components.
    """
    dyn = model.dynamics
    rheo = dyn.rheology
    grid = model.grid
    clock = state.clock
    substeps = dyn.solver.substeps
    masks = model.masks

    # Deferred joint exchange (meshed per-substep mode): the two half-updates
    # use *local* fills (halo validity shrinks ≤ 4 cells within one substep —
    # strain ±1, ϵ̇-interp ±1, ∂σ ±1, u-interp ±1) and one batched u+v
    # exchange round at substep end restores exact halos.  Interior results
    # are identical to per-half-update exchanges (overlap cells recompute the
    # neighbor's values from the same inputs), but the exchange count per
    # substep halves and the two messages fuse into one payload — the
    # analog of the reference's grouped async halo sends
    # (`split_explicit_momentum_equations.jl:170-187`).
    from ..fields import _meshed as _dim_meshed
    meshed = _dim_meshed(grid, 0) or _dim_meshed(grid, 1)
    policy = getattr(dyn.solver, "halo_exchange", "per_substep")

    def _loop_local_ok(h_min):
        return (halo_u is None and halo_v is None and meshed
                and isinstance(dyn.rheology, ElastoViscoPlasticRheology)
                and dyn.free_drift is None  # stencil budget counted for EVP
                and (not _dim_meshed(grid, 0) or grid.Hx >= h_min)
                and (not _dim_meshed(grid, 1) or grid.Hy >= h_min)
                # mid-substep local fills cannot refresh a fold split across x
                and not (grid.north_fold and _dim_meshed(grid, 0)))

    deferred = policy == "per_substep" and _loop_local_ok(4)
    # overlapped exchange additionally needs H ≥ 5 (the carried σ halos are
    # exact only to depth H−1, and the band passes read them to depth 4) and
    # local tiles wide enough to host a band
    overlap = (policy == "overlap" and _loop_local_ok(5)
               and (not _dim_meshed(grid, 0) or grid.Nx >= _BAND_W)
               and (not _dim_meshed(grid, 1) or grid.Ny >= _BAND_W))
    if deferred or overlap:
        from ..fields import (fill_halos_fc_local, fill_halos_cf_local,
                              fill_halos_uv)
        halo_u = lambda q: fill_halos_fc_local(q, grid)
        halo_v = lambda q: fill_halos_cf_local(q, grid)
        exchange_uv = lambda u, v: fill_halos_uv(u, v, grid)
    elif halo_u is None or halo_v is None:
        if getattr(dyn.solver, "halo_exchange", "per_substep") == "wide":
            from ..fields import fill_halos_fc_local, fill_halos_cf_local
            halo_u = lambda q: fill_halos_fc_local(q, grid)
            halo_v = lambda q: fill_halos_cf_local(q, grid)
        else:
            halo_u = lambda q: fill_halos_fc(q, grid)
            halo_v = lambda q: fill_halos_cf(q, grid)
        exchange_uv = None
    else:
        exchange_uv = None

    h, a = state.h, state.a
    is_evp = isinstance(rheo, ElastoViscoPlasticRheology)

    # initialize_rheology!: P over the full array incl. halos; snapshot uⁿ, vⁿ
    # (`elasto_visco_plastic_rheology.jl:192-216`); no-op for other rheologies
    # (`Rheologies.jl:44-49`)
    P = ice_strength(rheo, h, a) if is_evp else None
    un, vn = u_start, v_start

    one = _make_evp_substep(model, state, dt, clock, P, un, vn,
                            halo_u, halo_v)

    if overlap:
        bands = _make_bands(model, state, dt, clock, P, un, vn)

        def body(i, carry):
            # Overlapped exchange (`elasto_visco_plastic_rheology.jl:276-279`
            # + `:204-206` — post async at substep end, complete at next use):
            # the ppermute consumes only the previous substep's edge strips
            # and is consumed only by the narrow boundary-band recompute, so
            # XLA's scheduler runs it concurrently with the full-shard
            # (interior) substep, which reads the *pre-exchange* arrays —
            # exact at ≥4 cells from a meshed edge (the substep stencil
            # depth).  The band passes rerun the same substep on
            # (2H+8)-cell edge strips with the fresh halos and overwrite
            # the (H+4)-cell merge region.
            u, v, s11, s22, s12, alpha, Delta, zcc, zff = carry
            substep = i + 1
            u_ex, v_ex = exchange_uv(u, v)
            out = one(u, v, s11, s22, s12, alpha, Delta, zcc, zff, substep)
            for one_b, cut, paste in bands:
                b = one_b(cut(u_ex), cut(v_ex), cut(s11), cut(s22),
                          cut(s12), cut(alpha), cut(Delta), cut(zcc),
                          cut(zff), substep)
                out = tuple(paste(o, q) for o, q in zip(out, b))
            return out
    elif exchange_uv is not None:

        def body(i, carry):
            u, v, s11, s22, s12, alpha, Delta, zcc, zff = carry
            out = one(u, v, s11, s22, s12, alpha, Delta, zcc, zff, i + 1)
            u2, v2 = exchange_uv(out[0], out[1])
            return (u2, v2) + out[2:]
    else:

        def body(i, carry):
            u, v, s11, s22, s12, alpha, Delta, zcc, zff = carry
            return one(u, v, s11, s22, s12, alpha, Delta, zcc, zff, i + 1)

    if exchange_uv is not None and not overlap:
        u0, v0 = exchange_uv(u_start, v_start)
    else:
        u0 = halo_u(u_start)
        v0 = halo_v(v_start)
    zeros = jnp.zeros(grid.shape, grid.np_dtype)

    def _or_zeros(q):
        return q if q is not None else zeros

    init = (u0, v0, _or_zeros(state.sig11), _or_zeros(state.sig22),
            _or_zeros(state.sig12), _or_zeros(state.alpha),
            _or_zeros(state.Delta), _or_zeros(state.zeta_cc), _or_zeros(state.zeta_ff))

    u, v, s11, s22, s12, alpha, Delta, zcc, zff = lax.fori_loop(0, substeps, body, init)

    if overlap:
        # the loop carries stale meshed halos (exact interiors); one final
        # exchange restores them for the advection/thermo consumers
        u, v = exchange_uv(u, v)

    if not is_evp:
        return dict(u=u, v=v)

    # finalize_rheology!: σ halo refresh (`elasto_visco_plastic_rheology.jl:275-280`)
    from ..fields import fill_halos_many
    s11, s22, s12 = fill_halos_many((s11, s22, s12), ("cc", "cc", "ff"), grid)

    return dict(u=u, v=v, sig11=s11, sig22=s22, sig12=s12, alpha=alpha,
                P=P, un=un, vn=vn, Delta=Delta, zeta_cc=zcc, zeta_ff=zff)
