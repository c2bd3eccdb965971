"""Staggered-grid difference and interpolation operators.

JAX replacement for the Oceananigans operator layer the reference's
kernels are written against (δx/δy differences, ℑx/ℑy interpolations at
staggered locations; `src/Rheologies/Rheologies.jl:10-17`).

Every operator is a whole-array shifted-slice expression; XLA fuses chains of
them into a single stencil loop.  Shifts use ``jnp.roll``: the wrapped values
only ever pollute the outermost halo ring, which the halo fill refreshes, so
as long as the halo width covers the stencil depth accumulated between two
halo fills the interior is exact — the same contract as the reference's halo
machinery.

Index convention (see grids.py): ``u[I]`` sits on the x-face *left* of center
``I``.  Consequences:

* ``dxc`` (face→center): ``out[I] = q[I+1] - q[I]``
* ``dxf`` (center→face): ``out[I] = q[I] - q[I-1]``
* ``ixc`` (face→center): ``out[I] = (q[I+1] + q[I]) / 2``
* ``ixf`` (center→face): ``out[I] = (q[I] + q[I-1]) / 2``
"""

from __future__ import annotations

import jax.numpy as jnp


def shift_p(q, axis):
    """out[I] = q[I-1] (shift toward +I)."""
    return jnp.roll(q, 1, axis)


def shift_m(q, axis):
    """out[I] = q[I+1] (shift toward -I)."""
    return jnp.roll(q, -1, axis)


# --- differences -------------------------------------------------------------

def dxc(q):
    """δx face→center: out[I] = q[I+1] − q[I]."""
    return shift_m(q, 0) - q


def dxf(q):
    """δx center→face: out[I] = q[I] − q[I−1]."""
    return q - shift_p(q, 0)


def dyc(q):
    return shift_m(q, 1) - q


def dyf(q):
    return q - shift_p(q, 1)


# --- interpolations ----------------------------------------------------------

def ixc(q):
    """ℑx face→center."""
    return 0.5 * (shift_m(q, 0) + q)


def ixf(q):
    """ℑx center→face."""
    return 0.5 * (q + shift_p(q, 0))


def iyc(q):
    return 0.5 * (shift_m(q, 1) + q)


def iyf(q):
    return 0.5 * (q + shift_p(q, 1))


def ixy_ff(q):
    """ℑxy cc→ff (4-point average)."""
    return ixf(iyf(q))


def ixy_cc(q):
    """ℑxy ff→cc."""
    return ixc(iyc(q))


def ixy_fc_of_cf(q):
    """ℑxy (c,f)→(f,c), e.g. v interpolated to u points."""
    return ixf(iyc(q))


def ixy_cf_of_fc(q):
    """ℑxy (f,c)→(c,f), e.g. u interpolated to v points."""
    return ixc(iyf(q))
