"""Coriolis parameterizations: f-plane and beta-plane.

Replaces the Oceananigans Coriolis subsystem used by the reference
(`src/SeaIceDynamics/momentum_tendencies_kernel_functions.jl:1,31,64`):
``x_f_cross_U`` at (f,c) and ``y_f_cross_U`` at (c,f) with 4-point C-grid
averages of the transverse velocity.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..utils import pytree_dataclass
from ..ops import ixy_fc_of_cf, ixy_cf_of_fc


@pytree_dataclass
class FPlane:
    f: object = 1e-4  # s⁻¹


@pytree_dataclass
class BetaPlane:
    f0: object = 1e-4
    beta: object = 1e-11
    y0: object = 0.0  # latitude/ordinate where f = f0


EARTH_ROTATION_RATE = 7.292115e-5  # rad s⁻¹


@pytree_dataclass
class LatitudeCoriolis:
    """f = 2Ω sin(φ) from the grid's resident latitude field (curvilinear /
    tripolar grids with stored `lat_cc`).  The analog of Oceananigans'
    `HydrostaticSphericalCoriolis` as consumed by the reference's momentum
    kernels (`momentum_tendencies_kernel_functions.jl:31,64` take any
    Coriolis via `x_f_cross_U`/`y_f_cross_U`).  The cell-center f is
    interpolated to (f,c)/(c,f) velocity points with the C-grid ℑx/ℑy
    averages."""
    rotation_rate: object = EARTH_ROTATION_RATE


def coriolis_f_cc(coriolis, grid):
    """f at cell centers for latitude-dependent Coriolis (padded array,
    halos inherited pointwise from the grid's `lat_cc` fold/halo images)."""
    if grid.lat_cc is None:
        raise ValueError("LatitudeCoriolis needs a grid with stored lat_cc")
    lat = jnp.broadcast_to(jnp.asarray(grid.lat_cc), grid.shape)
    return (2.0 * coriolis.rotation_rate
            * jnp.sin(jnp.deg2rad(lat))).astype(grid.np_dtype)


def _f_at_rows(coriolis, y_row):
    """Coriolis parameter along a (1, nyp) row of y coordinates."""
    if isinstance(coriolis, FPlane):
        return coriolis.f
    if isinstance(coriolis, BetaPlane):
        return coriolis.f0 + coriolis.beta * (y_row - coriolis.y0)
    raise TypeError(f"unsupported coriolis {coriolis!r}")


def x_f_cross_U(coriolis, grid, u, v):
    """(f ẑ × U)·x̂ at (f,c): −f · v̄ (the tendency subtracts this)."""
    from ..ops import ixf
    if coriolis is None:
        return jnp.zeros(grid.shape, grid.np_dtype)
    if isinstance(coriolis, LatitudeCoriolis):
        return -ixf(coriolis_f_cc(coriolis, grid)) * ixy_fc_of_cf(v)
    f = _f_at_rows(coriolis, grid.yc[None, :])
    return -f * ixy_fc_of_cf(v)


def y_f_cross_U(coriolis, grid, u, v):
    """(f ẑ × U)·ŷ at (c,f): +f · ū."""
    from ..ops import iyf
    if coriolis is None:
        return jnp.zeros(grid.shape, grid.np_dtype)
    if isinstance(coriolis, LatitudeCoriolis):
        return iyf(coriolis_f_cc(coriolis, grid)) * ixy_cf_of_fc(u)
    f = _f_at_rows(coriolis, grid.yf[None, :])
    return f * ixy_cf_of_fc(u)
