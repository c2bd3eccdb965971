"""Halo filling, boundary conditions, and peripheral/immersed masks.

Functional replacement for Oceananigans ``fill_halo_regions!`` /
``peripheral_node`` / ``mask_immersed_field_xy!`` as used by the reference
(`src/sea_ice_model.jl:379-394`,
`src/SeaIceDynamics/split_explicit_momentum_equations.jl:226`).

All fills are pure: ``q -> q_with_fresh_halos``.  On a single device this is
the *entire* "communication" layer; in the distributed path
(`parallel/halo.py`) the same functions fill the physical-boundary sides
while ``lax.ppermute`` fills rank-internal sides.

Default boundary conditions mirror the reference:

* centered tracers (h, ℵ, hs, S, σ11, σ22, ...): periodic wrap or
  zero-gradient (no-flux) at bounded walls;
* wall-normal velocity components: zero in the halo beyond a bounded wall;
  the wall face itself is zeroed by the peripheral mask in the velocity
  kernels (impenetrability), exactly like `peripheral_node` masking in
  `split_explicit_momentum_equations.jl:226,261`.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from .grids import Grid, PERIODIC, BOUNDED, FLAT


def _meshed(grid: Grid, dim: int) -> bool:
    """True when this grid is a shard and dimension ``dim`` is split across
    the device mesh (so halo fills are ppermute exchanges)."""
    return (grid.mesh_shape is not None and grid.mesh_shape[dim] > 1
            and grid.mesh_axes is not None and grid.mesh_axes[dim] is not None)


def _exchange(q, axis, axis_name, P, H, N):
    """Ring halo exchange along array axis ``axis`` over mesh axis
    ``axis_name``: left halo ← left neighbor's rightmost interior strip, right
    halo ← right neighbor's leftmost.  The JAX replacement for the
    reference's MPI `fill_halo_regions!` (SURVEY.md §2.4): two paired
    `lax.ppermute` shifts.
    """
    fwd = [(i, (i + 1) % P) for i in range(P)]
    bwd = [(i, (i - 1) % P) for i in range(P)]
    if axis == 0:
        from_left = lax.ppermute(q[N:N + H], axis_name, fwd)
        from_right = lax.ppermute(q[H:2 * H], axis_name, bwd)
        return q.at[:H].set(from_left).at[H + N:].set(from_right)
    from_left = lax.ppermute(q[:, N:N + H], axis_name, fwd)
    from_right = lax.ppermute(q[:, H:2 * H], axis_name, bwd)
    return q.at[:, :H].set(from_left).at[:, H + N:].set(from_right)


def _exchange_pair(qs, axis, axis_name, P, H, N):
    """Ring halo exchange for several same-shape arrays at once: the strips
    are stacked into ONE ppermute payload per direction, halving the message
    count vs per-field exchanges (the deferred-exchange substep mode's
    batched u/v round; reference posts its halo sends together,
    `split_explicit_momentum_equations.jl:170-187`)."""
    fwd = [(i, (i + 1) % P) for i in range(P)]
    bwd = [(i, (i - 1) % P) for i in range(P)]
    if axis == 0:
        left = lax.ppermute(jnp.stack([q[N:N + H] for q in qs]), axis_name, fwd)
        right = lax.ppermute(jnp.stack([q[H:2 * H] for q in qs]), axis_name, bwd)
        return [q.at[:H].set(left[i]).at[H + N:].set(right[i])
                for i, q in enumerate(qs)]
    left = lax.ppermute(jnp.stack([q[:, N:N + H] for q in qs]), axis_name, fwd)
    right = lax.ppermute(jnp.stack([q[:, H:2 * H] for q in qs]), axis_name, bwd)
    return [q.at[:, :H].set(left[i]).at[:, H + N:].set(right[i])
            for i, q in enumerate(qs)]


def _bc_x_meshed(q, grid: Grid, face: bool, seam=None):
    """Physical wall BC on the x-meshed direction, applied only on the shards
    at the global domain edge.  ``seam``: pre-exchange east-wall face value to
    restore (the ring exchange clobbers it on the last shard); None when no
    exchange preceded this call (local-only fills)."""
    H, N = grid.Hx, grid.Nx
    P = grid.mesh_shape[0]
    ix = lax.axis_index(grid.mesh_axes[0])
    if face:
        left_bc = jnp.zeros_like(q[:H])
        right_bc = jnp.zeros_like(q[H + N + 1:])
        q = q.at[:H].set(jnp.where(ix == 0, left_bc, q[:H]))
        q = q.at[H + N + 1:].set(jnp.where(ix == P - 1, right_bc, q[H + N + 1:]))
        if seam is not None:
            q = q.at[H + N].set(jnp.where(ix == P - 1, seam, q[H + N]))
    else:
        q = q.at[:H].set(jnp.where(ix == 0, q[H:H + 1], q[:H]))
        q = q.at[H + N:].set(jnp.where(ix == P - 1, q[H + N - 1:H + N], q[H + N:]))
    return q


def _bc_y_meshed(q, grid: Grid, face: bool, seam=None):
    H, N = grid.Hy, grid.Ny
    P = grid.mesh_shape[1]
    iy = lax.axis_index(grid.mesh_axes[1])
    if face:
        q = q.at[:, :H].set(jnp.where(iy == 0, jnp.zeros_like(q[:, :H]), q[:, :H]))
        q = q.at[:, H + N + 1:].set(
            jnp.where(iy == P - 1, jnp.zeros_like(q[:, H + N + 1:]), q[:, H + N + 1:]))
        if seam is not None:
            q = q.at[:, H + N].set(jnp.where(iy == P - 1, seam, q[:, H + N]))
    else:
        q = q.at[:, :H].set(jnp.where(iy == 0, q[:, H:H + 1], q[:, :H]))
        q = q.at[:, H + N:].set(
            jnp.where(iy == P - 1, q[:, H + N - 1:H + N], q[:, H + N:]))
    return q


def _fill_x_distributed(q, grid: Grid, face: bool):
    H, N = grid.Hx, grid.Nx
    seam = q[H + N] if face else None  # east-wall face value, pre-exchange
    q = _exchange(q, 0, grid.mesh_axes[0], grid.mesh_shape[0], H, N)
    if grid.topology[0] == BOUNDED:
        q = _bc_x_meshed(q, grid, face, seam=seam)
    return q


def _fill_y_distributed(q, grid: Grid, face: bool):
    H, N = grid.Hy, grid.Ny
    seam = q[:, H + N] if face else None  # north-wall/seam face, pre-exchange
    q = _exchange(q, 1, grid.mesh_axes[1], grid.mesh_shape[1], H, N)
    if grid.topology[1] == BOUNDED:
        q = _bc_y_meshed(q, grid, face, seam=seam)
    return q


def _fill_x(q, grid: Grid, face: bool):
    # Single concatenate per fill (instead of chained .at[].set dynamic-update
    # -slices): one fused write of the whole array inside the EVP substep
    # loop.
    H, N = grid.Hx, grid.Nx
    topo = grid.topology[0]
    if topo == FLAT or H == 0:
        return q
    if _meshed(grid, 0):
        return _fill_x_distributed(q, grid, face)
    if topo == PERIODIC:
        return jnp.concatenate([q[N:N + H], q[H:H + N], q[H:2 * H]], axis=0)
    if topo == BOUNDED:
        if face:
            zeros = jnp.zeros_like(q[:H])
            zr = jnp.zeros_like(q[H + N + 1:])
            return jnp.concatenate([zeros, q[H:H + N + 1], zr], axis=0)
        left = jnp.broadcast_to(q[H:H + 1], (H,) + q.shape[1:])
        right = jnp.broadcast_to(q[H + N - 1:H + N], (H,) + q.shape[1:])
        return jnp.concatenate([left, q[H:H + N], right], axis=0)
    return q


def _fill_y(q, grid: Grid, face: bool):
    H, N = grid.Hy, grid.Ny
    topo = grid.topology[1]
    if topo == FLAT or H == 0:
        return q
    if _meshed(grid, 1):
        return _fill_y_distributed(q, grid, face)
    if topo == PERIODIC:
        return jnp.concatenate([q[:, N:N + H], q[:, H:H + N], q[:, H:2 * H]], axis=1)
    if topo == BOUNDED:
        if face:
            zeros = jnp.zeros_like(q[:, :H])
            zr = jnp.zeros_like(q[:, H + N + 1:])
            return jnp.concatenate([zeros, q[:, H:H + N + 1], zr], axis=1)
        left = jnp.broadcast_to(q[:, H:H + 1], (q.shape[0], H))
        right = jnp.broadcast_to(q[:, H + N - 1:H + N], (q.shape[0], H))
        return jnp.concatenate([left, q[:, H:H + N], right], axis=1)
    return q


# --- Zipper fold (tripolar north boundary) -----------------------------------
# The top edge folds onto itself with x reversed: cell (i, Ny-1+k) pairs with
# cell (Nx-1-i, Ny-k).  u and v flip sign across the fold (Zipper sign flip,
# `src/sea_ice_model.jl:57-64`); scalars and σ₁₂ keep sign (both the component
# direction and the coordinate flip under the 180° fold rotation).

def _x_fold_indices(grid: Grid, face: bool):
    Hx, Nx = grid.Hx, grid.Nx
    p = np.arange(grid.nxp)
    if face:
        src = ((Nx - (p - Hx)) % Nx) + Hx      # face i ↔ face (Nx − i) mod Nx
    else:
        src = ((Nx - 1 - (p - Hx)) % Nx) + Hx  # center i ↔ Nx − 1 − i
    return src


def _fill_y_fold(q, grid: Grid, xface: bool, yface: bool, sign: float):
    """Overwrite the north halo (and, for y-face fields, project the seam row
    onto its fold symmetry) from the x-reversed top interior rows."""
    Hy, Ny = grid.Hy, grid.Ny
    r = sign * q[_x_fold_indices(grid, xface), :]
    if not yface:
        src = [Hy + Ny - 1 - k for k in range(Hy)]
        return q.at[:, Hy + Ny:].set(r[:, src])
    seam = 0.5 * (q[:, Hy + Ny] + r[:, Hy + Ny])
    q = q.at[:, Hy + Ny].set(seam)
    if Hy > 1:
        src = [Hy + Ny - k for k in range(1, Hy)]
        q = q.at[:, Hy + Ny + 1:].set(r[:, src])
    return q


def _fill_y_fold_xmeshed(q, grid: Grid, xface: bool, yface: bool, sign: float):
    """Fold fill when the x direction is split across the device mesh: shard
    ix's fold sources live on the mirror shard Px−1−ix (plus a one-column
    offset for x-face fields), so gather the top interior rows across the
    x axis and index them globally — exact serial arithmetic, including the
    halo-corner columns (the serial fold reads interior source columns only,
    see `_x_fold_indices`)."""
    Hx, Hy, nx, Ny = grid.Hx, grid.Hy, grid.Nx, grid.Ny
    name_x = grid.mesh_axes[0]
    Px = grid.mesh_shape[0]
    Nx_g = nx * Px
    # top Hy interior rows + the seam face row, interior columns only
    block = q[Hx:Hx + nx, Hy + Ny - Hy:Hy + Ny + 1]          # (nx, Hy+1)
    gathered = lax.all_gather(block, name_x, axis=0, tiled=True)  # (Nx_g, Hy+1)
    ix = lax.axis_index(name_x)
    p = jnp.arange(q.shape[0])
    g = ix * nx + (p - Hx)                  # global column of each local column
    src = (Nx_g - g) % Nx_g if xface else (Nx_g - 1 - g) % Nx_g
    rows = sign * gathered[src, :]          # (nxp, Hy+1) fold-mirrored top rows
    # rows[:, k] = mirrored global interior row Ny−Hy+k; rows[:, Hy] = seam row
    if not yface:
        new = jnp.stack([rows[:, Hy - 1 - k] for k in range(Hy)], axis=1)
        return q.at[:, Hy + Ny:].set(new)
    seam = 0.5 * (q[:, Hy + Ny] + rows[:, Hy])
    q = q.at[:, Hy + Ny].set(seam)
    if Hy > 1:
        new = jnp.stack([rows[:, Hy - k] for k in range(1, Hy)], axis=1)
        q = q.at[:, Hy + Ny + 1:].set(new)
    return q


def _maybe_fold(q, grid: Grid, xface: bool, yface: bool, sign: float):
    if not (grid.north_fold and grid.Hy > 0):
        return q
    if _meshed(grid, 0):
        folded = _fill_y_fold_xmeshed(q, grid, xface, yface, sign)
        if _meshed(grid, 1):
            iy = lax.axis_index(grid.mesh_axes[1])
            return jnp.where(iy == grid.mesh_shape[1] - 1, folded, q)
        return folded
    if _meshed(grid, 1):
        # only the northernmost y-shard folds (`distributed_tests_utils.jl:231-257`
        # tests the fold on the top rank)
        folded = _fill_y_fold(q, grid, xface, yface, sign)
        iy = lax.axis_index(grid.mesh_axes[1])
        return jnp.where(iy == grid.mesh_shape[1] - 1, folded, q)
    return _fill_y_fold(q, grid, xface, yface, sign)


def fill_halos_cc(q, grid: Grid):
    q = _fill_x(q, grid, face=False)
    q = _fill_y(q, grid, face=False)
    return _maybe_fold(q, grid, False, False, 1.0)


def fill_halos_fc(q, grid: Grid):
    """u-like fields: face in x, center in y."""
    q = _fill_x(q, grid, face=True)
    q = _fill_y(q, grid, face=False)
    return _maybe_fold(q, grid, True, False, -1.0)


def fill_halos_cf(q, grid: Grid):
    """v-like fields: center in x, face in y."""
    q = _fill_x(q, grid, face=False)
    q = _fill_y(q, grid, face=True)
    return _maybe_fold(q, grid, False, True, -1.0)


def fill_halos_ff(q, grid: Grid):
    q = _fill_x(q, grid, face=True)
    q = _fill_y(q, grid, face=True)
    return _maybe_fold(q, grid, True, True, 1.0)


FILLERS = {
    ("c", "c"): fill_halos_cc,
    ("f", "c"): fill_halos_fc,
    ("c", "f"): fill_halos_cf,
    ("f", "f"): fill_halos_ff,
}


# fold sign per staggered location: velocity components flip across the
# Zipper fold, scalars and σ₁₂ keep sign (`src/sea_ice_model.jl:57-64`)
_FOLD_SIGN = {"cc": 1.0, "fc": -1.0, "cf": -1.0, "ff": 1.0}


def fill_halos_many(qs, locs, grid: Grid):
    """Halo fill for several same-shape fields at once: per-field results
    identical to ``FILLERS[loc](q, grid)``, but every meshed-direction
    exchange is batched into ONE ppermute payload per direction (all
    fields' strips stacked).  The reference posts its per-field halo sends
    together (`split_explicit_momentum_equations.jl:170-187`); here the
    batching additionally collapses ~2·n_fields collective rounds per step
    into two, which is the dominant fixed cost of a distributed step at
    small tile sizes.  ``locs``: "cc"/"fc"/"cf"/"ff" per field."""
    qs = list(qs)
    xface = [loc[0] == "f" for loc in locs]
    yface = [loc[1] == "f" for loc in locs]
    if _meshed(grid, 0):
        H, N = grid.Hx, grid.Nx
        seams = [q[H + N] if f else None for q, f in zip(qs, xface)]
        qs = _exchange_pair(qs, 0, grid.mesh_axes[0], grid.mesh_shape[0],
                            H, N)
        if grid.topology[0] == BOUNDED:
            qs = [_bc_x_meshed(q, grid, f, seam=s)
                  for q, f, s in zip(qs, xface, seams)]
    else:
        qs = [_fill_x(q, grid, f) for q, f in zip(qs, xface)]
    if _meshed(grid, 1):
        H, N = grid.Hy, grid.Ny
        seams = [q[:, H + N] if f else None for q, f in zip(qs, yface)]
        qs = _exchange_pair(qs, 1, grid.mesh_axes[1], grid.mesh_shape[1],
                            H, N)
        if grid.topology[1] == BOUNDED:
            qs = [_bc_y_meshed(q, grid, f, seam=s)
                  for q, f, s in zip(qs, yface, seams)]
    else:
        qs = [_fill_y(q, grid, f) for q, f in zip(qs, yface)]
    return [_maybe_fold(q, grid, xf, yf, _FOLD_SIGN[loc])
            for q, xf, yf, loc in zip(qs, xface, yface, locs)]


def fill_halos_uv(u, v, grid: Grid):
    """Joint u/v halo fill: identical result to
    ``(fill_halos_fc(u), fill_halos_cf(v))`` but with the meshed-direction
    exchanges batched into one ppermute payload per direction (the
    deferred-exchange substep mode does one such round per substep instead
    of two separate exchange rounds)."""
    u, v = fill_halos_many((u, v), ("fc", "cf"), grid)
    return u, v


# --- local-only fills (communication-avoiding wide-halo mode) -----------------
# Analog of the reference's `fill_halo_regions!(…; only_local_halos=true)`
# (`split_explicit_momentum_equations.jl:170-187`): sides split across the
# device mesh skip the exchange (their wide halos were exchanged once, before
# the substep loop), but *physical* boundary conditions are still refreshed —
# walls on global-edge shards and the Zipper fold (a within-shard mirror when
# x is not meshed), exactly like the reference's local fills which always
# apply non-MPI BCs.

def _fill_x_local(q, grid: Grid, face: bool):
    if _meshed(grid, 0):
        if grid.topology[0] == BOUNDED:
            return _bc_x_meshed(q, grid, face)
        return q
    return _fill_x(q, grid, face)


def _fill_y_local(q, grid: Grid, face: bool):
    if _meshed(grid, 1):
        if grid.topology[1] == BOUNDED:
            return _bc_y_meshed(q, grid, face)
        return q
    return _fill_y(q, grid, face)


def _maybe_fold_local(q, grid: Grid, xface: bool, yface: bool, sign: float):
    if not (grid.north_fold and grid.Hy > 0):
        return q
    if _meshed(grid, 0):
        # cross-shard fold needs an all_gather per fill — incompatible with
        # communication-avoiding substepping (guarded in make_distributed_step)
        raise NotImplementedError(
            "local-only fills cannot refresh a north fold split across the "
            "x mesh; use halo_exchange='per_substep'")
    if _meshed(grid, 1):
        folded = _fill_y_fold(q, grid, xface, yface, sign)
        iy = lax.axis_index(grid.mesh_axes[1])
        return jnp.where(iy == grid.mesh_shape[1] - 1, folded, q)
    return _fill_y_fold(q, grid, xface, yface, sign)


def fill_halos_fc_local(q, grid: Grid):
    q = _fill_y_local(_fill_x_local(q, grid, True), grid, False)
    return _maybe_fold_local(q, grid, True, False, -1.0)


def fill_halos_cf_local(q, grid: Grid):
    q = _fill_y_local(_fill_x_local(q, grid, False), grid, True)
    return _maybe_fold_local(q, grid, False, True, -1.0)


def fill_halos_cc_local(q, grid: Grid):
    """Local-only cc fill (σ11/σ22/α refresh between exchange-free substep
    chunks; scalars fold with sign +1)."""
    q = _fill_y_local(_fill_x_local(q, grid, False), grid, False)
    return _maybe_fold_local(q, grid, False, False, 1.0)


def fill_halos_ff_local(q, grid: Grid):
    """Local-only ff fill (σ12; sign +1 under the fold)."""
    q = _fill_y_local(_fill_x_local(q, grid, True), grid, True)
    return _maybe_fold_local(q, grid, True, True, 1.0)


# --- peripheral / immersed masks --------------------------------------------

def _solid_base(grid: Grid):
    """Solid-cell mask including the implicit 'outside' of bounded walls."""
    if grid.solid_cc is not None:
        return np.asarray(grid.solid_cc)
    m = np.zeros(grid.shape, bool)
    if grid.topology[0] == BOUNDED and grid.Hx > 0:
        m[:grid.Hx] = True
        m[grid.Hx + grid.Nx:] = True
    if grid.topology[1] == BOUNDED and grid.Hy > 0:
        m[:, :grid.Hy] = True
        if not grid.north_fold:  # folded north edge is connected, not a wall
            m[:, grid.Hy + grid.Ny:] = True
    return m


def peripheral_masks(grid: Grid):
    """Boolean masks at (f,c), (c,f) and (f,f) that are True wherever the
    corresponding node touches a solid cell or a bounded-domain wall.

    Mirrors `peripheral_node` (Oceananigans) as used to zero velocities in the
    momentum substeps and to kill fluxes through immersed faces.
    Face nodes are peripheral when *either* adjacent cell is solid.
    """
    s = _solid_base(grid)
    sx = np.roll(s, 1, 0)   # cell I-1
    sy = np.roll(s, 1, 1)
    sxy = np.roll(sx, 1, 1)
    per_fc = s | sx
    per_cf = s | sy
    per_ff = s | sx | sy | sxy
    return (jnp.asarray(per_fc), jnp.asarray(per_cf), jnp.asarray(per_ff))


def solid_cc_mask(grid: Grid):
    return jnp.asarray(_solid_base(grid))


def immersed_only_ff(grid: Grid):
    """(f,f) nodes peripheral due to an *immersed* cell but not due to a
    domain wall — the `immersed_peripheral_node` analog (peripheral on the
    immersed grid && !peripheral on the underlying grid) that gates immersed
    stress-divergence fluxes (`ice_stress_divergence.jl:78-81` via
    conditional_flux_ffc).  None on non-immersed grids."""
    if grid.solid_cc is None:
        return None

    def per_ff(s):
        sx = np.roll(s, 1, 0)
        sy = np.roll(s, 1, 1)
        sxy = np.roll(sx, 1, 1)
        return s | sx | sy | sxy

    full = _solid_base(grid)
    wall = _solid_base(grid.evolve(solid_cc=None))
    return jnp.asarray(per_ff(full) & ~per_ff(wall))


def mask_immersed_cc(q, grid: Grid):
    """Zero a centered field over solid cells (mask_immersed_field_xy!)."""
    if grid.solid_cc is None:
        return q
    return jnp.where(grid.solid_cc, jnp.zeros((), q.dtype), q)
