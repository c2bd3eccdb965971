"""Dynamical single-layer (shallow-water) ocean for ice-ocean coupling.

The reference's coupling prototype drives the ice with a full Oceananigans
``HydrostaticFreeSurfaceModel`` (`validation/ice_ocean_model/
melting_baroclinicity.jl:60-76`).  This module provides the JAX
analog at the fidelity the coupling physics actually exercises: a
free-surface single-layer ocean on the same staggered C-grid as the ice,
with prognostic currents (u, v), surface elevation η, and mixed-layer
temperature / salinity tracers.  Unlike :class:`~.coupled.SlabOcean` (whose
currents are prescribed), this ocean *responds* to wind and ice-ocean
stress, so melt-driven buoyancy patterns advect and the ice feels evolving
currents through its `SemiImplicitStress` bottom drag.

Discretization — designed for XLA, everything inside one jitted step:

* **Momentum + continuity**: forward-backward scheme (η first with old
  velocities, then u with the new η, then v with the new u), the standard
  stable explicit pairing for gravity waves; substepped inside a
  ``lax.fori_loop`` at the gravity-wave CFL while tracers ride the outer
  coupled step.
* **Metric-aware flux-form continuity** on the shared grid operators
  (`ops.py`), so volume ∑ η·Az is conserved to roundoff.
* **Tracers**: WENO flux-form advection (`advection.py`) in advective form
  (flux divergence minus c·∇·U), plus lateral diffusion and the coupling
  fluxes applied by `coupled.py`.
* Bounded walls / immersed land reuse `peripheral_masks` — velocities are
  zeroed on peripheral faces every substep, exactly like the ice momentum
  solvers.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from .utils import pytree_dataclass, static_field
from .ops import dxc, dyc, dxf, dyf, ixf, iyf, ixc, iyc
from .fields import (fill_halos_cc, fill_halos_fc, fill_halos_cf,
                     peripheral_masks, mask_immersed_cc)
from .advection import horizontal_div_Uc, WENO
from .dynamics.coriolis import x_f_cross_U, y_f_cross_U


@pytree_dataclass
class ShallowWaterOcean:
    """Config for the dynamical mixed-layer ocean.

    Fluxes follow the slab-ocean sign conventions of `coupled.py`
    (positive upward / cooling); radiation constants mirror
    `ice_ocean_model.jl:61-66`."""
    depth: object = 50.0                  # resting layer thickness H [m]
    gravity: object = 9.81                # (use ~0.02-0.1 for reduced gravity)
    coriolis: object = None               # FPlane / BetaPlane / None
    bottom_drag: object = 1e-3            # quadratic Cd at the layer base
    lateral_viscosity: object = None      # Ah [m² s⁻¹] (None = off: static)
    tracer_diffusivity: object = None     # κh [m² s⁻¹] (None = off: static)
    wind_stress_x: object = 0.0           # open-water τₓ [N m⁻²] (fc)
    wind_stress_y: object = 0.0           # (cf)
    ice_ocean_drag: object = 5.5e-3       # C_io for the ice→ocean stress
    density: object = 1024.0              # `ice_ocean_model.jl:61`
    heat_capacity: object = 3991.0
    emissivity: object = 1.0
    stefan_boltzmann_constant: object = 5.67e-8
    reference_temperature: object = 273.15
    solar_insolation: object = 0.0        # W m⁻² (negative = heating)
    temperature_restoring_rate: object = 0.0
    temperature_restoring_target: object = 0.0
    substeps: int = static_field(default=16)          # SW substeps / coupled dt
    advection: object = static_field(default_factory=lambda: WENO(order=5))

    @property
    def mixed_layer_depth(self):
        """Heat/salt capacity thickness — lets `coupled.py` treat slab and
        shallow-water oceans uniformly in the flux conversions."""
        return self.depth


def _laplacian_fc(grid, q):
    """∇²q at (f,c) with the grid metrics (both terms at matching stagger)."""
    qxx = dxf(dxc(q) / grid.dx_cc) / grid.dx_fc
    qyy = dyc(dyf(q) / grid.dy_ff) / grid.dy_fc
    return qxx + qyy


def _laplacian_cf(grid, q):
    qxx = dxc(dxf(q) / grid.dx_ff) / grid.dx_cf
    qyy = dyf(dyc(q) / grid.dy_cc) / grid.dy_cf
    return qxx + qyy


def _laplacian_cc(grid, q):
    qxx = dxc(dxf(q) / grid.dx_fc) / grid.dx_cc
    qyy = dyc(dyf(q) / grid.dy_cf) / grid.dy_cc
    return qxx + qyy


def shallow_water_substeps(grid, ocean: ShallowWaterOcean, u, v, eta,
                           tau_u, tau_v, dt):
    """``ocean.substeps`` forward-backward shallow-water substeps.

    ``tau_u/tau_v`` are the total surface stresses [N m⁻²] at (f,c)/(c,f)
    (wind over open water + ice-ocean stress), held fixed across the
    substeps of one coupled step.  Returns (u, v, η)."""
    H = ocean.depth
    g = ocean.gravity
    rho = ocean.density
    n = ocean.substeps
    dtau = dt / n
    per_fc, per_cf, _ = peripheral_masks(grid)

    def sub(_, carry):
        u, v, eta = carry
        # continuity: flux-form, layer thickness at faces
        h_fc = H + ixf(eta)
        h_cf = H + iyf(eta)
        div = (dxc(u * h_fc * grid.dy_fc) + dyc(v * h_cf * grid.dx_cf)) / grid.az_cc
        eta = eta - dtau * div
        eta = mask_immersed_cc(eta, grid)
        eta = fill_halos_cc(eta, grid)

        # u with the *new* η (forward-backward), then v with the new u
        h_u = H + ixf(eta)
        Gu = (-x_f_cross_U(ocean.coriolis, grid, u, v)
              - g * dxf(eta) / grid.dx_fc
              + tau_u / (rho * h_u))
        if ocean.lateral_viscosity is not None:
            Gu = Gu + ocean.lateral_viscosity * _laplacian_fc(grid, u)
        drag_u = ocean.bottom_drag * jnp.sqrt(u * u + ixf(iyc(v)) ** 2) / h_u
        u = (u + dtau * Gu) / (1 + dtau * drag_u)
        u = jnp.where(per_fc, 0.0, u)
        u = fill_halos_fc(u, grid)

        h_v = H + iyf(eta)
        Gv = (-y_f_cross_U(ocean.coriolis, grid, u, v)
              - g * dyf(eta) / grid.dy_cf
              + tau_v / (rho * h_v))
        if ocean.lateral_viscosity is not None:
            Gv = Gv + ocean.lateral_viscosity * _laplacian_cf(grid, v)
        drag_v = ocean.bottom_drag * jnp.sqrt(ixc(iyf(u)) ** 2 + v * v) / h_v
        v = (v + dtau * Gv) / (1 + dtau * drag_v)
        v = jnp.where(per_cf, 0.0, v)
        v = fill_halos_cf(v, grid)
        return (u, v, eta)

    return lax.fori_loop(0, n, sub, (u, v, eta))


def advect_tracer(grid, ocean: ShallowWaterOcean, u, v, c, dt, masks=None):
    """Advective-form tracer update: ∂c/∂t = −[∇·(Uc) − c ∇·U] + κ∇²c.

    The flux-form WENO divergence minus the c-weighted velocity divergence
    keeps the update monotone under the divergent SW flow (the reference's
    3-D ocean advects tracers with a non-divergent flow; in a single layer
    the free-surface divergence must be compensated)."""
    div_Uc = horizontal_div_Uc(grid, ocean.advection, u, v, c, masks=masks)
    div_U = (dxc(u * grid.dy_fc) + dyc(v * grid.dx_cf)) / grid.az_cc
    c = c - dt * (div_Uc - c * div_U)
    if ocean.tracer_diffusivity is not None:
        c = c + dt * ocean.tracer_diffusivity * _laplacian_cc(grid, c)
    return fill_halos_cc(c, grid)


def surface_stresses(grid, ocean: ShallowWaterOcean, u_ice, v_ice, a,
                     u_o, v_o):
    """Total surface stress on the ocean: open-water wind + ice-ocean drag.

    τ_io = ρₒ C_io |uᵢ − uₒ| (uᵢ − uₒ), area-weighted by the ice
    concentration at the velocity point — the equal-and-opposite partner of
    the ice's `SemiImplicitStress` bottom drag."""
    rho = ocean.density
    a_fc = ixf(a)
    a_cf = iyf(a)
    du = u_ice - u_o
    dv = v_ice - v_o
    du_at_u, dv_at_u = du, ixf(iyc(dv))
    du_at_v, dv_at_v = ixc(iyf(du)), dv
    sp_u = jnp.sqrt(du_at_u ** 2 + dv_at_u ** 2)
    sp_v = jnp.sqrt(du_at_v ** 2 + dv_at_v ** 2)
    tau_u = (1 - a_fc) * ocean.wind_stress_x + a_fc * rho * ocean.ice_ocean_drag * sp_u * du_at_u
    tau_v = (1 - a_cf) * ocean.wind_stress_y + a_cf * rho * ocean.ice_ocean_drag * sp_v * dv_at_v
    return tau_u, tau_v
