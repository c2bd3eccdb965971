"""SeaIceModel: configuration pytree, state factory, and the pure step
functions (Forward Euler and low-storage split RK3).

A functional re-design of `src/sea_ice_model.jl`, `src/sea_ice_fe_step.jl`,
`src/sea_ice_rk_substep.jl` and `src/tracer_tendency_kernel_functions.jl`:
the model is an immutable config pytree, the state is a separate pytree, and
``step(model, state, dt) -> state`` is a single jitted pure function that XLA
fuses end-to-end (advection + EVP substep loop + column thermodynamics in one
executable).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .utils import pytree_dataclass, static_field
from .grids import Grid, solid_crop_rows, south_crop_grid
from .state import SeaIceState, Clock, ModelFields
from .fields import (fill_halos_cc, fill_halos_fc, fill_halos_cf, fill_halos_ff,
                     peripheral_masks, solid_cc_mask)
from .advection import horizontal_div_Uc, required_halo
from .thermodynamics.heat_bcs import PrescribedTemperature
from .thermodynamics.slab import (sea_ice_slab_thermodynamics,
                                  bare_ice_thermodynamic_step, layered_thermodynamic_step)
from .dynamics.momentum import (SeaIceMomentumEquation, ExplicitSolver,
                                SplitExplicitSolver, explicit_momentum_step,
                                split_explicit_momentum_step)
from .dynamics.free_drift import StressBalanceFreeDrift, free_drift_u, free_drift_v
from .dynamics.rheologies import ElastoViscoPlasticRheology


@pytree_dataclass
class Masks:
    solid_cc: object = None
    per_fc: object = None
    per_cf: object = None
    per_ff: object = None
    # immersed-only peripheral ff nodes (immersed_peripheral_node analog):
    # gates immersed stress-divergence fluxes; None on non-immersed grids
    imm_ff: object = None


@pytree_dataclass
class SeaIceModel:
    """Model configuration (immutable pytree).  Mirrors the keyword surface of
    the reference constructor (`src/sea_ice_model.jl:140-297`); state lives in
    a separate :class:`~climaseaice_jl_tpu.state.SeaIceState` pytree created
    by :func:`initial_state`.
    """
    grid: Grid = None
    masks: Masks = None
    ice_thermodynamics: object = None
    snow_thermodynamics: object = None
    phase_transitions: object = None
    sea_ice_density: object = 900.0            # kg m⁻³ (bulk)
    snow_density: object = 330.0               # kg m⁻³ (bulk)
    ice_consolidation_thickness: object = 0.05  # m
    ice_salinity: object = 0.0                 # psu
    top_heat_flux: object = None
    bottom_heat_flux: object = 0.0
    snowfall: object = 0.0
    dynamics: object = None
    advection: object = static_field(default=None)
    timestepper: str = static_field(default="SplitRungeKutta3")
    forcing: object = static_field(default=None)  # dict-like tuple of (name, fn)

    def forcing_dict(self):
        return dict(self.forcing) if self.forcing else {}


def sea_ice_model(grid: Grid,
                  ice_thermodynamics="default",
                  snow_thermodynamics=None,
                  phase_transitions=None,
                  sea_ice_density=900.0,
                  snow_density=330.0,
                  ice_consolidation_thickness=0.05,
                  ice_salinity=0.0,
                  top_heat_flux=None,
                  bottom_heat_flux=0.0,
                  snowfall=0.0,
                  dynamics=None,
                  advection=None,
                  timestepper="SplitRungeKutta3",
                  forcing=None):
    """Build a :class:`SeaIceModel` with the reference's defaults
    (`src/sea_ice_model.jl:140-158`)."""
    from .thermodynamics.phase_transitions import PhaseTransitions

    if ice_thermodynamics == "default":
        ice_thermodynamics = sea_ice_slab_thermodynamics()
    if phase_transitions is None:
        phase_transitions = PhaseTransitions()

    # Default top flux: equilibrium with the internal flux when the top
    # temperature is prescribed and there is no snow (`sea_ice_model.jl:243-257`)
    if ice_thermodynamics is not None and top_heat_flux is None:
        if (snow_thermodynamics is None
                and isinstance(ice_thermodynamics.top_heat_bc, PrescribedTemperature)):
            top_heat_flux = _equilibrium_top_flux(ice_thermodynamics, phase_transitions)
        else:
            top_heat_flux = 0.0

    from .fields import immersed_only_ff
    per_fc, per_cf, per_ff = peripheral_masks(grid)
    solid_cc = solid_cc_mask(grid)
    masks = Masks(solid_cc=solid_cc, per_fc=per_fc,
                  per_cf=per_cf, per_ff=per_ff, imm_ff=immersed_only_ff(grid))

    if forcing is not None and not isinstance(forcing, tuple):
        unknown = set(forcing) - {"u", "v", "h", "a", "hs", "S"}
        if unknown:
            # could be custom tracer names (registered at initial_state time),
            # but more often a typo — warn rather than silently ignore
            import warnings
            warnings.warn(f"forcing keys {sorted(unknown)} match no standard "
                          "prognostic (u, v, h, a, hs, S); they only apply if "
                          "a tracer of that name exists", stacklevel=2)
        forcing = tuple(sorted(forcing.items()))

    if advection is not None:
        need = required_halo(advection)
        if min(h for h in (grid.Hx, grid.Hy) if h > 0) < need:
            raise ValueError(
                f"advection scheme needs halo ≥ {need}; grid has ({grid.Hx}, {grid.Hy})")

    return SeaIceModel(grid=grid, masks=masks,
                       ice_thermodynamics=ice_thermodynamics,
                       snow_thermodynamics=snow_thermodynamics,
                       phase_transitions=phase_transitions,
                       sea_ice_density=sea_ice_density,
                       snow_density=snow_density,
                       ice_consolidation_thickness=ice_consolidation_thickness,
                       ice_salinity=ice_salinity,
                       top_heat_flux=top_heat_flux,
                       bottom_heat_flux=bottom_heat_flux,
                       snowfall=snowfall,
                       dynamics=dynamics,
                       advection=advection,
                       timestepper=timestepper,
                       forcing=forcing)


def _equilibrium_top_flux(thermo, pt):
    """FluxFunction equal to the slab's internal conductive flux — keeps a
    prescribed-temperature slab in flux equilibrium (`sea_ice_model.jl:247-251`)."""
    from .thermodynamics.heat_bcs import FluxFunction, bottom_temperature
    from .thermodynamics.slab import eval_internal_flux

    def equilibrium_flux(grid, Tu, clock, fields):
        Tb = bottom_temperature(thermo.bottom_heat_bc, grid, pt.liquidus, fields)
        return eval_internal_flux(thermo.internal_heat_flux, grid, Tu, Tb, clock, fields)

    return FluxFunction(func=equilibrium_flux, top_temperature_dependent=True)


# --- state construction -------------------------------------------------------

def initial_state(model: SeaIceModel, h=0.0, a=0.0, hs=0.0, u=0.0, v=0.0,
                  tracers=None, time=0.0):
    """Allocate and initialize the full state pytree (the functional analog of
    the reference's field allocation + ``set!``)."""
    grid = model.grid
    dt_ = grid.np_dtype

    def cc(val):
        return grid.field_from(val)

    state = SeaIceState(
        h=cc(h), a=cc(a),
        u=cc(u), v=cc(v),
        hs=cc(hs) if model.snow_thermodynamics is not None else None,
        S=cc(model.ice_salinity),
        tracers={k: cc(v0) for k, v0 in (tracers or {}).items()},
        Tu=_initial_surface_temperature(model.ice_thermodynamics, grid),
        Tus=_initial_surface_temperature(model.snow_thermodynamics, grid),
        mf_ice=grid.new_field(), mf_snow=grid.new_field(),
        mf_snowfall=grid.new_field(),
        Qtop=grid.new_field(), Qbot=grid.new_field(),
        clock=Clock(time=jnp.asarray(time, dt_), iteration=jnp.asarray(0, "int32")),
    )

    dyn = model.dynamics
    if dyn is not None and isinstance(getattr(dyn, "rheology", None), ElastoViscoPlasticRheology):
        alpha0 = jnp.full(grid.shape, dyn.rheology.max_relaxation_parameter, dt_)
        state = state.evolve(
            sig11=grid.new_field(), sig22=grid.new_field(), sig12=grid.new_field(),
            alpha=alpha0, P=grid.new_field(),
            un=grid.new_field(), vn=grid.new_field(),
            Delta=grid.new_field(), zeta_cc=grid.new_field(), zeta_ff=grid.new_field())

    return update_state(model, state)


def _initial_surface_temperature(thermo, grid):
    if thermo is None:
        return None
    if isinstance(thermo.top_heat_bc, PrescribedTemperature):
        return grid.new_field() + jnp.asarray(thermo.top_heat_bc.temperature, grid.np_dtype)
    return grid.new_field()


def set_fields(model, state, **kw):
    """Functional ``set!``: overwrite interiors of prognostic fields, then
    refresh halos (`src/sea_ice_model.jl:301-315`)."""
    updates = {name: model.grid.field_from(val) for name, val in kw.items()}
    state = state.evolve(**updates)
    return update_state(model, state)


def make_fields(model, state) -> ModelFields:
    grid = model.grid
    rho = jnp.broadcast_to(jnp.asarray(model.sea_ice_density, grid.np_dtype), grid.shape)
    return ModelFields(h=state.h, a=state.a, S=state.S, hs=state.hs,
                       u=state.u, v=state.v, Tu=state.Tu, Tus=state.Tus,
                       rho=rho, sig11=state.sig11, sig22=state.sig22,
                       sig12=state.sig12, un=state.un, vn=state.vn,
                       P=state.P, alpha=state.alpha, tracers=state.tracers)


# --- update_state: immersed masking + halo fills ------------------------------

def update_state(model, state):
    """`src/sea_ice_model.jl:379-394`: mask immersed cells and refresh halos of
    every prognostic field — all fields' meshed-direction exchanges batched
    into one ppermute payload per direction (fields.fill_halos_many)."""
    from .fields import fill_halos_many
    grid = model.grid
    masks = model.masks

    def mask_cc(q):
        if q is None or masks.solid_cc is None:
            return q
        return jnp.where(masks.solid_cc, 0.0, q)

    names, qs, locs = [], [], []
    for name in ("h", "a", "hs", "S", "Tu", "Tus",
                 "mf_ice", "mf_snow", "mf_snowfall"):
        q = getattr(state, name)
        if q is not None:
            names.append(name)
            qs.append(mask_cc(q))
            locs.append("cc")
    tr = list(state.tracers) if state.tracers else []
    for k in tr:
        names.append(None)
        qs.append(mask_cc(state.tracers[k]))
        locs.append("cc")
    if state.u is not None:
        u = state.u
        if masks.per_fc is not None:
            u = jnp.where(masks.per_fc, 0.0, u)
        names.append("u")
        qs.append(u)
        locs.append("fc")
    if state.v is not None:
        v = state.v
        if masks.per_cf is not None:
            v = jnp.where(masks.per_cf, 0.0, v)
        names.append("v")
        qs.append(v)
        locs.append("cf")

    filled = fill_halos_many(qs, locs, grid)
    upd = {}
    tr_out = {}
    ti = iter(tr)
    for name, q in zip(names, filled):
        if name is None:
            tr_out[next(ti)] = q
        else:
            upd[name] = q
    if tr_out:
        upd["tracers"] = tr_out
    return state.evolve(**upd)


# --- tendencies and tracer update ---------------------------------------------

def tracer_tendencies(model, state):
    """G = −∇·(U c) + user forcing for h, ℵ, hs and extra tracers
    (`src/tracer_tendency_kernel_functions.jl:27-52`; forcing surface mirrors
    Oceananigans `model_forcing`, `src/sea_ice_model.jl:260`)."""
    grid = model.grid
    adv = model.advection
    u, v = state.u, state.v
    adv_masks = (model.masks.per_fc, model.masks.per_cf)
    forcing = model.forcing_dict()
    fields = make_fields(model, state) if forcing else None

    def F(name):
        fn = forcing.get(name)
        if fn is None:
            return 0.0
        return fn(grid, state.clock, fields)

    # Solid-row crop: on the ≥ cs fully-solid southern rows every face is
    # peripheral, so fluxes are killed and the divergence is EXACTLY zero —
    # compute on a row-sliced grid view and concatenate zeros (the view's
    # first Hy output rows, whose stencils roll-wrap, are discarded into that
    # zero band; all kept rows' stencils stay ≥ Hy − required_halo inside the
    # view).  Serial-only, off with forcing (user closures carry full-shape
    # arrays).
    cs_adv = solid_crop_rows(grid) if adv is not None and not forcing else 0
    if cs_adv >= 32:
        gc = south_crop_grid(grid, cs_adv)
        uc, vc = u[:, cs_adv:], v[:, cs_adv:]
        mc = (adv_masks[0][:, cs_adv:], adv_masks[1][:, cs_adv:])
        zband = jnp.zeros((grid.nxp, cs_adv + grid.Hy), grid.np_dtype)

        def div(c):
            d = horizontal_div_Uc(gc, adv, uc, vc, c[:, cs_adv:], masks=mc)
            return jnp.concatenate([zband, d[:, grid.Hy:]], 1)
    else:
        div = lambda c: horizontal_div_Uc(grid, adv, u, v, c, masks=adv_masks)
    Gh = -div(state.h) + F("h")
    Ga = -div(state.a) + F("a")
    Ghs = (-div(state.hs) + F("hs")) if state.hs is not None else None
    Gtr = {k: -div(c) + F(k) for k, c in (state.tracers or {}).items()}
    return Gh, Ga, Ghs, Gtr


def dynamic_step_tracers(model, state, G, dt, base=None):
    """Euler tracer update + clipping + ridging (`src/sea_ice_fe_step.jl:56-94`).

    ``base``: the state to update *from* (Ψ⁻ under RK3,
    `src/sea_ice_rk_substep.jl:134-152`); defaults to ``state``.
    """
    Gh, Ga, Ghs, Gtr = G
    b = base if base is not None else state

    h_plus = b.h + dt * Gh
    a_plus = b.a + dt * Ga
    a_plus = jnp.maximum(0.0, a_plus)
    h_plus = jnp.maximum(0.0, h_plus)
    a_plus = jnp.where(h_plus == 0, 0.0, a_plus)
    h_plus = jnp.where(a_plus == 0, 0.0, h_plus)

    V_plus = h_plus * a_plus
    a_new = jnp.where(a_plus > 1, 1.0, a_plus)
    h_new = jnp.where(a_plus > 1, V_plus, h_plus)

    upd = dict(h=h_new, a=a_new)

    if state.hs is not None and Ghs is not None:
        hs_plus = b.hs + dt * Ghs
        hs_plus = jnp.maximum(0.0, hs_plus)
        hs_plus = jnp.where(a_new <= 0, 0.0, hs_plus)
        upd["hs"] = hs_plus

    if Gtr:
        upd["tracers"] = {k: (b.tracers[k] + dt * Gtr[k]) for k in Gtr}

    return state.evolve(**upd)


# --- momentum dispatch --------------------------------------------------------

def momentum_step(model, state, dt, u_prev=None, v_prev=None):
    """`time_step_momentum!` dispatch on the dynamics/solver type."""
    dyn = model.dynamics
    if dyn is None:
        return state
    if isinstance(dyn, StressBalanceFreeDrift):
        # Free-drift-only dynamics (`stress_balance_free_drift.jl:132-151`)
        f = make_fields(model, state)
        grid = model.grid
        u = free_drift_u(grid, dyn, state.clock, f)
        v = free_drift_v(grid, dyn, state.clock, f)
        return state.evolve(u=fill_halos_fc(u, grid), v=fill_halos_cf(v, grid))

    u_start = u_prev if u_prev is not None else state.u
    v_start = v_prev if v_prev is not None else state.v

    if isinstance(dyn.solver, ExplicitSolver):
        f = make_fields(model, state)
        u, v = explicit_momentum_step(model, state, f, dt, u_start, v_start)
        return state.evolve(u=u, v=v)
    if isinstance(dyn.solver, SplitExplicitSolver):
        upd = split_explicit_momentum_step(model, state, dt, u_start, v_start)
        return state.evolve(**upd)
    raise TypeError(f"unsupported solver {dyn.solver!r}")


# --- thermodynamic dispatch ---------------------------------------------------

def thermodynamic_step(model, state, dt):
    """`thermodynamic_time_step!` dispatch (`thermodynamic_time_step.jl:7-60`)."""
    ice_t = model.ice_thermodynamics
    snow_t = model.snow_thermodynamics
    if ice_t is None:
        return state
    fields = make_fields(model, state)
    if snow_t is None:
        h1, a1, Tu, diags = bare_ice_thermodynamic_step(model, state, fields, dt)
        return state.evolve(h=h1, a=a1, Tu=Tu,
                            mf_ice=diags["mf_ice"], mf_snow=diags["mf_snow"],
                            mf_snowfall=diags["mf_snowfall"],
                            Qtop=diags["Qtop"], Qbot=diags["Qbot"])
    h1, a1, hs1, Tu, Tus, diags = layered_thermodynamic_step(model, state, fields, dt)
    return state.evolve(h=h1, a=a1, hs=hs1, Tu=Tu, Tus=Tus,
                        mf_ice=diags["mf_ice"], mf_snow=diags["mf_snow"],
                        mf_snowfall=diags["mf_snowfall"],
                        Qtop=diags["Qtop"], Qbot=diags["Qbot"])


# --- full step ----------------------------------------------------------------

def _tick(state, dt):
    c = state.clock
    return state.evolve(clock=Clock(time=c.time + dt, iteration=c.iteration + 1))


def forward_euler_step(model, state, dt):
    """`src/sea_ice_fe_step.jl:13-34`."""
    G = tracer_tendencies(model, state)
    state = momentum_step(model, state, dt)
    state = dynamic_step_tracers(model, state, G, dt)
    state = thermodynamic_step(model, state, dt)
    state = _tick(state, dt)
    state = update_state(model, state)
    return state


RK3_FRACTIONS = (1.0 / 3.0, 1.0 / 2.0, 1.0)


def rk3_step(model, state, dt):
    """Low-storage split RK3 (`src/sea_ice_rk_substep.jl`): cache Ψ⁻, then three
    substeps each re-based on Ψ⁻ with Δτ = Δt/3, Δt/2, Δt.

    The three stages are identical up to the fraction, so on large grids they
    run as one ``lax.scan`` over the fractions: XLA compiles the stage *once*
    instead of inlining three copies, which keeps the one-time compile short.
    Small grids (< 256²) unroll: three inlined copies compile instantly
    there, and the eager-mode (unjitted) scan compile hangs XLA CPU on
    degenerate 0-D/1-D shapes."""
    psi = state  # cached Ψ⁻ (cache_current_fields!)

    def stage(s, frac):
        dtau = dt * frac
        G = tracer_tendencies(model, s)
        s = momentum_step(model, s, dtau, u_prev=psi.u, v_prev=psi.v)
        s = dynamic_step_tracers(model, s, G, dtau, base=psi)
        s = thermodynamic_step(model, s, dtau)
        s = update_state(model, s)
        return s, None

    if model.grid.Nx * model.grid.Ny < 65536:
        for frac in RK3_FRACTIONS:
            state, _ = stage(state, jnp.asarray(frac, model.grid.np_dtype))
    else:
        fracs = jnp.asarray(RK3_FRACTIONS, dtype=model.grid.np_dtype)
        state, _ = jax.lax.scan(stage, state, fracs)
    state = _tick(state, dt)
    return state


def _step(model, state, dt):
    if model.timestepper == "ForwardEuler":
        return forward_euler_step(model, state, dt)
    if model.timestepper == "SplitRungeKutta3":
        return rk3_step(model, state, dt)
    raise ValueError(f"unknown timestepper {model.timestepper!r}")


step = jax.jit(_step)
# Donating the state buffers lets XLA update them in place; only for drivers
# that discard the previous state (Simulation, bench).
step_donated = jax.jit(_step, donate_argnums=(1,))
step_unjitted = _step


# --- small shared physics helpers ---------------------------------------------

def ice_mass_cc(h, a, rho):
    """m = ρ h ℵ (`src/ClimaSeaIce.jl:42`)."""
    return h * a * rho


def cell_advection_timescale(model, state):
    """min(Δx/|u|, Δy/|v|) over the interior (`src/ClimaSeaIce.jl:66-69`)."""
    grid = model.grid
    u = jnp.abs(grid.interior(state.u))
    v = jnp.abs(grid.interior(state.v))
    dx = jnp.broadcast_to(grid.dx_fc, grid.shape)
    dy = jnp.broadcast_to(grid.dy_cf, grid.shape)
    tx = jnp.min(grid.interior(dx) / jnp.maximum(u, 1e-30))
    ty = jnp.min(grid.interior(dy) / jnp.maximum(v, 1e-30))
    return jnp.minimum(tx, ty)
