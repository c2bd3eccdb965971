"""Slab (Semtner-style) thermodynamics: fluxes, tendencies and step kernels.

Vectorized JAX implementation of the reference's column physics:

* `src/SeaIceThermodynamics/slab_heat_and_tracer_fluxes.jl` (conductive flux,
  combined snow+ice resistors-in-series, interface temperature),
* `src/SeaIceThermodynamics/slab_sea_ice_thermodynamics.jl` (config),
* `src/SeaIceThermodynamics/slab_thermodynamics_tendencies.jl` (Stefan
  tendencies),
* `src/SeaIceThermodynamics/thermodynamic_time_step.jl` (the two fused column
  kernels: bare ice `:75-118` and layered snow+ice `:131-298`, plus the
  shared helpers `ice_volume_update`, `concentration_thermodynamic_step`,
  `snow_accumulation`, `snow_ice_formation` `:304-370`).

Everything is whole-grid ``jnp.where`` arithmetic — the reference's
``ifelse``-everywhere, branch-free style maps 1:1.  One subtlety: Julia's
``Bool`` is a *strong zero* (``false * NaN == 0``); every such product is
rewritten here as an explicit ``jnp.where`` with a safe denominator so no
NaNs are materialized.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..utils import pytree_dataclass, static_field
from .phase_transitions import melting_temperature, latent_heat
from .heat_bcs import (PrescribedTemperature, FluxFunction, getflux,
                       bottom_temperature, solve_surface_temperature,
                       MeltingConstrainedFluxBalance, IceWaterThermalEquilibrium)


# --- internal flux models ----------------------------------------------------

@pytree_dataclass
class ConductiveFlux:
    """Single-layer Fourier conduction F = −k (Tu − Tb) / h
    (`slab_heat_and_tracer_fluxes.jl:8-19`)."""
    conductivity: object = 2.0  # W/(m K)


@pytree_dataclass
class IceSnowConductiveFlux:
    """Resistors-in-series snow+ice conduction F = (Tb − Tu)/(hs/ks + hi/ki)
    (`slab_heat_and_tracer_fluxes.jl:37-66`)."""
    snow_conductivity: object = 0.31
    ice_conductivity: object = 2.0


def _safe_div(num, den, predicate):
    """num/den where predicate else 0, without materializing inf/NaN."""
    den_safe = jnp.where(predicate, den, 1.0)
    return jnp.where(predicate, num / den_safe, jnp.zeros((), num.dtype if hasattr(num, "dtype") else None))


def conductive_flux_value(flux: ConductiveFlux, Tu, Tb, h):
    k = flux.conductivity
    return _safe_div(-k * (Tu - Tb), h, h > 0)


def ice_snow_conductive_flux_value(flux: IceSnowConductiveFlux, Tu, Tb, hi, hs):
    R = hs / flux.snow_conductivity + hi / flux.ice_conductivity
    return _safe_div(Tb - Tu, R, R > 0)


def interface_temperature(flux: IceSnowConductiveFlux, Tu, Tb, hi, hs):
    """Tsi = Tb + (Tu − Tb)·Ri/(Rs + Ri) (`slab_heat_and_tracer_fluxes.jl:70-85`)."""
    Ri = hi / flux.ice_conductivity
    Rs = hs / flux.snow_conductivity
    R = Rs + Ri
    return jnp.where(R > 0, Tb + (Tu - Tb) * _safe_div(Ri, R, R > 0), Tb)


def eval_internal_flux(flux, grid, Tu, Tb, clock, fields):
    """Evaluate the slab-internal heat flux at surface temperature ``Tu``.

    Supports the built-in conductive models, a user FluxFunction, or a bare
    callable (`slab_sea_ice_thermodynamics.jl:217-219` flux_kernel dispatch).
    """
    if isinstance(flux, ConductiveFlux):
        return conductive_flux_value(flux, Tu, Tb, fields.h)
    if isinstance(flux, IceSnowConductiveFlux):
        return ice_snow_conductive_flux_value(flux, Tu, Tb, fields.h, fields.hs)
    if isinstance(flux, (FluxFunction,)) or callable(flux):
        return getflux(flux, grid, Tu, clock, fields)
    raise TypeError(f"unsupported internal heat flux {flux!r}")


# --- thermodynamics config ---------------------------------------------------

class ProportionalEvolution:
    """Hibler (1979) lateral-vs-vertical growth partition (marker)."""
    def __repr__(self):
        return "ProportionalEvolution()"


@pytree_dataclass
class SlabThermodynamics:
    """Single slab layer (ice or snow) thermodynamics configuration.

    The prognostic top-surface temperature lives in the model *state*
    (``state.Tu`` for ice, ``state.Tus`` for snow), not here — unlike the
    reference (`slab_sea_ice_thermodynamics.jl:18-23`) which stores a Field.
    """
    top_heat_bc: object = None
    bottom_heat_bc: object = None
    internal_heat_flux: object = None
    concentration_evolution: object = static_field(default_factory=ProportionalEvolution)

    def __post_init__(self):
        if self.top_heat_bc is None:
            object.__setattr__(self, "top_heat_bc", MeltingConstrainedFluxBalance())
        if self.bottom_heat_bc is None:
            object.__setattr__(self, "bottom_heat_bc", IceWaterThermalEquilibrium())
        if self.internal_heat_flux is None:
            object.__setattr__(self, "internal_heat_flux", ConductiveFlux(2.0))


def sea_ice_slab_thermodynamics(conductivity=2.0, **kw):
    return SlabThermodynamics(internal_heat_flux=ConductiveFlux(conductivity), **kw)


def snow_slab_thermodynamics(conductivity=0.31, **kw):
    return SlabThermodynamics(internal_heat_flux=ConductiveFlux(conductivity), **kw)


# --- shared helpers (thermodynamic_time_step.jl:304-370) ----------------------

def concentration_thermodynamic_step(conc_evolution, dVdt, an, hn, hc, dt):
    if not isinstance(conc_evolution, ProportionalEvolution):
        raise TypeError(f"unsupported concentration evolution {conc_evolution!r}")
    freezing = dVdt >= 0
    da_f = jnp.where(freezing & (hc > 0),
                     (1 - an) * _safe_div(dVdt, hc, hc > 0), 0.0)
    da_m = jnp.where(~freezing & (hn > 0),
                     an * _safe_div(dVdt, 2 * hn, hn > 0), 0.0)
    a_plus = an + dt * (da_f + da_m)
    return jnp.maximum(0.0, a_plus)


def ice_volume_update(conc_evolution, dVdt, hn, an, hc, dt):
    """`thermodynamic_time_step.jl:304-324` — volume update, clipping,
    pathological resets and thermodynamic ridging."""
    V1 = jnp.maximum(0.0, hn * an + dt * dVdt)
    dVdt_eff = (V1 - hn * an) / dt
    a_plus = concentration_thermodynamic_step(conc_evolution, dVdt_eff, an, hn, hc, dt)
    h_plus = _safe_div(V1, a_plus, a_plus > 0)

    h_plus = jnp.where(a_plus <= 0, 0.0, h_plus)
    a_plus = jnp.where(dVdt_eff == 0, an, a_plus)
    h_plus = jnp.where(dVdt_eff == 0, hn, h_plus)
    a_plus = jnp.where(h_plus == 0, 0.0, a_plus)
    h_plus = jnp.where(a_plus == 0, 0.0, h_plus)

    h_new = jnp.where(a_plus > 1, h_plus * a_plus, h_plus)
    a_new = jnp.where(a_plus > 1, 1.0, a_plus)
    return h_new, a_new


def snow_accumulation(snowfall_rate, rho_s, a, ):
    """Gs⁺ = Ps/ρs where ice is present (`thermodynamic_time_step.jl:331-334`)."""
    return jnp.where(a > 0, snowfall_rate / rho_s, 0.0)


def snow_ice_formation(hi, hs, rho_i, rho_s, rho_w):
    """Negative-freeboard flooding (`thermodynamic_time_step.jl:336-354`)."""
    hf = hi * (1 - rho_i / rho_w) - hs * rho_s / rho_w
    flooding = hf < 0
    dhs = jnp.where(flooding, -hf * rho_i / rho_s, 0.0)
    hs_new = jnp.maximum(0.0, hs - dhs)
    dhs = hs - hs_new
    hi_new = hi + dhs * rho_s / rho_i
    return hi_new, hs_new


# --- bare-ice kernel (`thermodynamic_time_step.jl:75-118`) --------------------

def bare_ice_thermodynamic_step(model, state, fields, dt):
    """One thermodynamic step for slab ice without snow.

    Returns updated ``(h, a, Tu, diagnostics)`` where diagnostics is a dict
    with mass fluxes and the applied external fluxes (used by the energy /
    mass closure tests in place of the reference's recording FluxFunctions).
    """
    grid = model.grid
    thermo = model.ice_thermodynamics
    pt = model.phase_transitions
    liquidus = pt.liquidus
    clock = state.clock

    hn, an = state.h, state.a
    hc = model.ice_consolidation_thickness
    rho_i = model.sea_ice_density
    Qx = model.top_heat_flux
    Qb_ext = model.bottom_heat_flux

    consolidated = hn >= hc
    Tb = bottom_temperature(thermo.bottom_heat_bc, grid, liquidus, fields)

    internal = thermo.internal_heat_flux
    top_bc = thermo.top_heat_bc

    if isinstance(top_bc, PrescribedTemperature):
        Tu = state.Tu
    else:
        def balance(T):
            return (getflux(Qx, grid, T, clock, fields)
                    - eval_internal_flux(internal, grid, T, Tb, clock, fields))
        Ts = solve_surface_temperature(balance, state.Tu, top_bc.iterations)
        Tm = melting_temperature(liquidus, fields.S)
        Tu = jnp.where(consolidated, jnp.minimum(Ts, Tm), Tb)
        Tu = jnp.broadcast_to(Tu, grid.shape)

    Qui = getflux(Qx, grid, Tu, clock, fields)
    Qbi = getflux(Qb_ext, grid, Tu, clock, fields)
    Qii = jnp.where(consolidated,
                    eval_internal_flux(internal, grid, Tu, Tb, clock, fields), 0.0)

    Eu = rho_i * latent_heat(pt, Tu)
    Eb = rho_i * latent_heat(pt, Tb)
    dVdt = (Qui - Qii) / Eu + (Qii - Qbi) / Eb

    h1, a1 = ice_volume_update(thermo.concentration_evolution, dVdt, hn, an, hc, dt)

    mf_ice = rho_i * (h1 * a1 - hn * an) / dt
    zeros = jnp.zeros(grid.shape, grid.np_dtype)
    diags = dict(
        mf_ice=jnp.broadcast_to(mf_ice, grid.shape),
        mf_snow=zeros,
        mf_snowfall=zeros,
        Qtop=jnp.broadcast_to(Qui, grid.shape) + zeros,
        Qbot=jnp.broadcast_to(Qbi, grid.shape) + zeros,
    )
    return h1, a1, Tu, diags


# --- layered snow+ice kernel (`thermodynamic_time_step.jl:131-298`) -----------

def layered_thermodynamic_step(model, state, fields, dt):
    """One thermodynamic step for the layered snow + ice column.

    Returns ``(h, a, hs, Tu_ice, Tus_snow, diagnostics)``.
    """
    grid = model.grid
    ice_thermo = model.ice_thermodynamics
    snow_thermo = model.snow_thermodynamics
    pt = model.phase_transitions
    liquidus = pt.liquidus
    clock = state.clock

    hin, an, hsn = state.h, state.a, state.hs
    hc = model.ice_consolidation_thickness
    rho_i = model.sea_ice_density
    rho_s = model.snow_density
    Qx = model.top_heat_flux
    Qb_ext = model.bottom_heat_flux

    Vin = hin * an
    Vsn = hsn * an
    consolidated = hin >= hc

    bottom_bc = ice_thermo.bottom_heat_bc
    Tb = bottom_temperature(bottom_bc, grid, liquidus, fields)
    Tm = melting_temperature(liquidus, fields.S)

    ks = snow_thermo.internal_heat_flux.conductivity
    ki = ice_thermo.internal_heat_flux.conductivity
    combined = IceSnowConductiveFlux(snow_conductivity=ks, ice_conductivity=ki)

    # Effective melting temperature: snow melts at 0 °C when present
    Tm_eff = jnp.where(hsn > 0, jnp.zeros((), grid.np_dtype), Tm)

    snow_top_bc = snow_thermo.top_heat_bc
    if isinstance(snow_top_bc, PrescribedTemperature):
        Tus = state.Tus
    else:
        def balance(T):
            return (getflux(Qx, grid, T, clock, fields)
                    - ice_snow_conductive_flux_value(combined, T, Tb, hin, hsn))
        Ts = solve_surface_temperature(balance, state.Tus, snow_top_bc.iterations)
        Tus = jnp.where(consolidated, jnp.minimum(Ts, Tm_eff), Tb)
        Tus = jnp.broadcast_to(Tus, grid.shape)

    # Analytic snow-ice interface temperature; stored as the ice's Tu
    Tsi = interface_temperature(combined, Tus, Tb, hin, hsn)

    # Snow-surface energy balance: per-cell external flux vs per-ice conduction
    Qis = jnp.where(consolidated,
                    ice_snow_conductive_flux_value(combined, Tus, Tb, hin, hsn), 0.0)
    Qui = getflux(Qx, grid, Tus, clock, fields)
    Qui = jnp.broadcast_to(Qui, grid.shape)
    Qui_per_ice = _safe_div(Qui, an, an > 0)

    dQ = Qui_per_ice - Qis                    # dQ < 0 ⇒ energy available for melt
    melt_energy = jnp.maximum(0.0, -dQ)       # per-ice

    Ls = pt.reference_latent_heat
    snow_energy_capacity = rho_s * Ls * hsn / dt
    Qs = jnp.minimum(melt_energy, snow_energy_capacity)
    Gs_minus = Qs / (rho_s * Ls)

    # Closed-form self-consistent solve for ℵⁿ⁺¹ (`:226-255`)
    rhoiL = rho_i * Ls
    Qbi = getflux(Qb_ext, grid, Tus, clock, fields)
    alpha = (Qui - Qbi) / rhoiL
    beta = Qs / rhoiL

    Cm = jnp.where(hin > 0, an * _safe_div(jnp.ones((), grid.np_dtype), 2 * hin, hin > 0), 0.0)
    Cf = jnp.where(hc > 0, (1 - an) * _safe_div(jnp.ones((), grid.np_dtype), hc, hc > 0), 0.0)
    Km = dt * Cm
    Kf = dt * Cf

    eps_ = jnp.finfo(grid.np_dtype).eps
    Dm = 1 - Km * beta
    Df = 1 - Kf * beta
    am = jnp.where(jnp.abs(Dm) > eps_,
                   (an + Km * alpha) / jnp.where(jnp.abs(Dm) > eps_, Dm, 1.0),
                   an + Km * alpha)
    af = jnp.where(jnp.abs(Df) > eps_,
                   (an + Kf * alpha) / jnp.where(jnp.abs(Df) > eps_, Df, 1.0),
                   an + Kf * alpha)

    dtVm = alpha + beta * am
    melting = dtVm < 0
    a_tmp = jnp.where(melting, am, af)

    # Final tendency via ice_melt_freeze_tendency with effective top flux
    Qui_eff = Qui + Qs * a_tmp
    Qii = jnp.where(consolidated,
                    conductive_flux_value(ice_thermo.internal_heat_flux, Tsi, Tb, hin),
                    0.0)
    Eu = rho_i * latent_heat(pt, Tsi)
    Eb = rho_i * latent_heat(pt, Tb)
    dVdt = (Qui_eff - Qii) / Eu + (Qii - Qbi) / Eb

    hi1, a1 = ice_volume_update(ice_thermo.concentration_evolution, dVdt, hin, an, hc, dt)

    # Conserve snow volume under the concentration change
    hs_rebased = jnp.where(a1 > 0, hsn * an * _safe_div(jnp.ones((), grid.np_dtype), a1, a1 > 0), 0.0)

    Ps = _snowfall_rate(model, clock)        # kg m⁻² s⁻¹
    Gs_plus = snow_accumulation(Ps, rho_s, a1)
    hs_p = jnp.maximum(0.0, hs_rebased + dt * (Gs_plus - Gs_minus))

    hi1, hs_p = snow_ice_formation(hi1, hs_p, rho_i, rho_s, pt.liquid_density)
    hs_p = jnp.where(a1 <= 0, 0.0, hs_p)

    Ps_abs = rho_s * Gs_plus * a1

    mf_ice = rho_i * (hi1 * a1 - Vin) / dt
    mf_snow = rho_s * (hs_p * a1 - Vsn) / dt - Ps_abs
    zeros = jnp.zeros(grid.shape, grid.np_dtype)
    diags = dict(
        mf_ice=jnp.broadcast_to(mf_ice, grid.shape) + zeros,
        mf_snow=jnp.broadcast_to(mf_snow, grid.shape) + zeros,
        mf_snowfall=jnp.broadcast_to(Ps_abs, grid.shape) + zeros,
        Qtop=jnp.broadcast_to(Qui, grid.shape) + zeros,
        Qbot=jnp.broadcast_to(Qbi, grid.shape) + zeros,
    )
    return hi1, a1, hs_p, jnp.broadcast_to(Tsi, grid.shape), Tus, diags


def _snowfall_rate(model, clock):
    """Snowfall forcing (kg m⁻² s⁻¹): constant/array or time series
    (`thermodynamic_time_step.jl:326-334`)."""
    sf = model.snowfall
    if sf is None:
        return jnp.zeros((), model.grid.np_dtype)
    if hasattr(sf, "at_time"):  # FieldTimeSeries-like
        return sf.at_time(clock.time)
    return jnp.asarray(sf, model.grid.np_dtype)
