"""SPMD distributed stepping over a 2-D device mesh.

JAX replacement for the reference's MPI domain decomposition
(`Distributed(CPU(), partition=Partition(Px, Py))`, SURVEY.md §2.4): the
global state is sharded over a ``jax.sharding.Mesh``; inside ``shard_map``
each device holds its local tile padded with halos, runs the *same* serial
step code, and every halo fill along a meshed direction becomes a pair of
``lax.ppermute`` shifts (see ``fields._exchange``).  Physical boundary
conditions apply only on shards at the global domain edge, selected by
``lax.axis_index``.

Correctness contract (ported to `tests/test_distributed.py`): the distributed
step reproduces the serial step allclose on u, v, h, ℵ after 20 EVP steps for
partitions (1,4), (4,1), (2,2) (`test/distributed_tests_utils.jl:60-88`).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from jax import shard_map

from ..grids import BOUNDED, PERIODIC, FLAT
from ..model import Masks, update_state, _step
from ..fields import (fill_halos_cc, fill_halos_fc, fill_halos_cf, fill_halos_ff)


# location of each named state field on the staggered grid
_STATE_LOCS = {
    "h": "cc", "a": "cc", "hs": "cc", "S": "cc", "Tu": "cc", "Tus": "cc",
    "u": "fc", "un": "fc", "v": "cf", "vn": "cf",
    "sig11": "cc", "sig22": "cc", "sig12": "ff",
    "alpha": "cc", "P": "cc", "Delta": "cc", "zeta_cc": "cc", "zeta_ff": "ff",
    "mf_ice": "cc", "mf_snow": "cc", "mf_snowfall": "cc",
    "Qtop": "cc", "Qbot": "cc",
}

_FILLERS = {"cc": fill_halos_cc, "fc": fill_halos_fc,
            "cf": fill_halos_cf, "ff": fill_halos_ff}


def make_mesh(mesh_shape, devices=None):
    Px, Py = mesh_shape
    if devices is None:
        devices = jax.devices()
    if len(devices) < Px * Py:
        raise ValueError(f"need {Px * Py} devices, have {len(devices)}")
    return Mesh(np.array(devices[:Px * Py]).reshape(Px, Py), ("x", "y"))


def _strip(grid, q):
    return grid.interior(q)


def _shape_is_grid(grid, q):
    return hasattr(q, "shape") and getattr(q, "shape", None) == grid.shape


def _local_grid(grid, nx, ny, ix, iy, axes, mesh_shape):
    """Build the per-shard Grid: local sizes, sliced coordinates/metrics, and
    mesh info that turns halo fills into ppermute exchanges."""
    Hx, Hy = grid.Hx, grid.Hy

    def slice_x(c):
        return lax.dynamic_slice(c, (ix * nx,), (nx + 2 * Hx,))

    def slice_y(c):
        return lax.dynamic_slice(c, (iy * ny,), (ny + 2 * Hy,))

    def slice_metric(m):
        nd = getattr(m, "ndim", 0)
        if nd == 2 and m.shape == grid.shape:
            # full curvilinear/tripolar metric array: slice the shard's padded
            # window in both directions (halo columns overlap the neighbors'
            # interiors, exactly like the serial padded array's values there)
            return lax.dynamic_slice(
                m, (jnp.asarray(ix * nx, jnp.int32),
                    jnp.asarray(iy * ny, jnp.int32)),
                (nx + 2 * Hx, ny + 2 * Hy))
        if nd == 2 and m.shape[0] == 1:  # (1, nyp) latitude-dependent row
            return lax.dynamic_slice(
                m, (jnp.asarray(0, jnp.int32), jnp.asarray(iy * ny, jnp.int32)),
                (1, ny + 2 * Hy))
        if nd != 0:
            raise NotImplementedError(
                f"cannot shard metric array of shape {m.shape} on grid "
                f"{grid.shape}")
        return m

    return grid.evolve(
        Nx=nx, Ny=ny,
        mesh_axes=axes, mesh_shape=mesh_shape,
        xc=slice_x(grid.xc), xf=slice_x(grid.xf),
        yc=slice_y(grid.yc), yf=slice_y(grid.yf),
        dx_cc=slice_metric(grid.dx_cc), dx_fc=slice_metric(grid.dx_fc),
        dx_cf=slice_metric(grid.dx_cf), dx_ff=slice_metric(grid.dx_ff),
        dy_cc=slice_metric(grid.dy_cc), dy_fc=slice_metric(grid.dy_fc),
        dy_cf=slice_metric(grid.dy_cf), dy_ff=slice_metric(grid.dy_ff),
        az_cc=slice_metric(grid.az_cc), az_fc=slice_metric(grid.az_fc),
        az_cf=slice_metric(grid.az_cf), az_ff=slice_metric(grid.az_ff),
        lon_cc=None if grid.lon_cc is None else slice_metric(grid.lon_cc),
        lat_cc=None if grid.lat_cc is None else slice_metric(grid.lat_cc),
        solid_cc=None,  # reattached (exchanged) by _local_masks
    )


def _local_wall(lgrid, ix, iy):
    """Wall-band mask: True in halo bands beyond bounded *global* domain
    edges (the underlying-grid peripheral cells)."""
    Hx, Hy = lgrid.Hx, lgrid.Hy
    nx, ny = lgrid.Nx, lgrid.Ny
    col = jnp.arange(lgrid.nxp)[:, None]
    row = jnp.arange(lgrid.nyp)[None, :]
    Px, Py = lgrid.mesh_shape
    wall = jnp.zeros(lgrid.shape, bool)
    if lgrid.topology[0] == BOUNDED and Hx > 0:
        wall = wall | ((ix == 0) & (col < Hx)) | ((ix == Px - 1) & (col >= Hx + nx))
    if lgrid.topology[1] == BOUNDED and Hy > 0:
        wall = wall | ((iy == 0) & (row < Hy))
        if not lgrid.north_fold:  # folded north edge is connected, not a wall
            wall = wall | ((iy == Py - 1) & (row >= Hy + ny))
    return wall


def _local_solid(lgrid, solid_int, ix, iy):
    """Padded local solid mask: exchanged across shards, True outside bounded
    global walls (traced analog of fields._solid_base + _extend_mask)."""
    Hx, Hy = lgrid.Hx, lgrid.Hy
    nx, ny = lgrid.Nx, lgrid.Ny
    dt_ = lgrid.np_dtype

    if solid_int is not None:
        s = jnp.zeros(lgrid.shape, dt_)
        s = s.at[Hx:Hx + nx, Hy:Hy + ny].set(solid_int.astype(dt_))
        s = fill_halos_cc(s, lgrid)  # exchange + fold + zero-gradient at walls
        solid = s > 0.5
    else:
        solid = jnp.zeros(lgrid.shape, bool)
    return solid | _local_wall(lgrid, ix, iy)


def _per_masks(s):
    sx = jnp.roll(s, 1, 0)
    sy = jnp.roll(s, 1, 1)
    sxy = jnp.roll(sx, 1, 1)
    return s | sx, s | sy, s | sx | sy | sxy


def _local_masks(lgrid, solid_int, ix, iy, immersed):
    s = _local_solid(lgrid, solid_int, ix, iy)
    per_fc, per_cf, per_ff = _per_masks(s)
    if immersed:
        _, _, wall_ff = _per_masks(_local_wall(lgrid, ix, iy))
        imm_ff = per_ff & ~wall_ff
    else:
        imm_ff = None
    return Masks(solid_cc=s if immersed else None,
                 per_fc=per_fc, per_cf=per_cf, per_ff=per_ff, imm_ff=imm_ff)


# Face-y located state components.  On a north-folded grid the seam face row
# (global face Ny) is a *physical* degree of freedom; interior-only stripping
# would lose it every outer step.  There we strip rows [1, Ny] (keeping the
# seam, dropping the dead south-wall face 0) — same count, same sharding.
_Y_FACE_FIELDS = {"v", "vn", "sig12", "zeta_ff"}


def _shifted(name, grid):
    return grid.north_fold and name in _Y_FACE_FIELDS


def _strip_one(name, q, lgrid):
    if _shifted(name, lgrid):
        return q[lgrid.Hx:lgrid.Hx + lgrid.Nx,
                 lgrid.Hy + 1:lgrid.Hy + lgrid.Ny + 1]
    return lgrid.interior(q)


def _pad_one(name, q, lgrid, meshed_y):
    Hx, Hy = lgrid.Hx, lgrid.Hy
    full = jnp.zeros(lgrid.shape, q.dtype)
    if _shifted(name, lgrid):
        full = full.at[Hx:Hx + lgrid.Nx, Hy + 1:Hy + lgrid.Ny + 1].set(q)
        if meshed_y:
            # shared interface face: row Hy ← south neighbor's seam-side row
            name_y = lgrid.mesh_axes[1]
            P = lgrid.mesh_shape[1]
            fwd = [(i, (i + 1) % P) for i in range(P)]
            from_south = lax.ppermute(full[:, Hy + lgrid.Ny], name_y, fwd)
            iy = lax.axis_index(name_y)
            row = jnp.where(iy == 0, jnp.zeros_like(from_south), from_south)
            full = full.at[:, Hy].set(row)
    else:
        full = full.at[Hx:Hx + lgrid.Nx, Hy:Hy + lgrid.Ny].set(q)
    return _FILLERS[_STATE_LOCS.get(name, "cc")](full, lgrid)


def _pad_state(state, lgrid, masks=None):
    """Pad interior-only leaves back to halo-inclusive local arrays and fill
    every halo before stepping — with ALL fields' exchanges batched into one
    ppermute payload per mesh direction (plus one for the shared seam rows
    of y-face fields), instead of ~2 rounds per field.  At production tile
    sizes the per-round collective latency, not the payload, is the fixed
    cost of a distributed step; the reference likewise groups its halo
    sends (`split_explicit_momentum_equations.jl:170-187`).

    ``masks``: when given, `model.update_state`'s immersed/peripheral
    masking is applied to the embedded interiors *before* the fill — one
    combined mask+pad+fill pass instead of a second full exchange round."""
    from ..fields import fill_halos_many
    meshed_y = lgrid.mesh_shape is not None and lgrid.mesh_shape[1] > 1
    Hx, Hy, Nx, Ny = lgrid.Hx, lgrid.Hy, lgrid.Nx, lgrid.Ny

    names = [n for n in _STATE_LOCS if getattr(state, n) is not None]
    tr = list(state.tracers) if state.tracers else []

    # exactly update_state's masked set (`src/sea_ice_model.jl:379-394`):
    # prognostic cc fields + tracers over solid cells, u/v over peripherals
    _MASKED_CC = {"h", "a", "hs", "S", "Tu", "Tus",
                  "mf_ice", "mf_snow", "mf_snowfall"}

    def mask_of(name):
        if masks is None:
            return None
        if name in _MASKED_CC:
            return masks.solid_cc
        if name == "u":
            return masks.per_fc
        if name == "v":
            return masks.per_cf
        return None

    def embed(name, q):
        m = mask_of(name)
        if m is not None:
            mi = m[Hx:Hx + Nx, Hy + 1:Hy + Ny + 1] if _shifted(name, lgrid) \
                else m[Hx:Hx + Nx, Hy:Hy + Ny]
            q = jnp.where(mi, 0.0, q)
        full = jnp.zeros(lgrid.shape, q.dtype)
        if _shifted(name, lgrid):
            return full.at[Hx:Hx + Nx, Hy + 1:Hy + Ny + 1].set(q)
        return full.at[Hx:Hx + Nx, Hy:Hy + Ny].set(q)

    fulls = ([embed(n, getattr(state, n)) for n in names]
             + [embed("h", state.tracers[k]) for k in tr])
    locs = [_STATE_LOCS[n] for n in names] + ["cc"] * len(tr)

    shifted_idx = [i for i, n in enumerate(names) if _shifted(n, lgrid)]
    if meshed_y and shifted_idx:
        # shared interface face: row Hy ← south neighbor's seam-side row,
        # one stacked ppermute for all y-face fields
        name_y = lgrid.mesh_axes[1]
        Pn = lgrid.mesh_shape[1]
        fwd = [(i, (i + 1) % Pn) for i in range(Pn)]
        rows = jnp.stack([fulls[i][:, Hy + Ny] for i in shifted_idx])
        from_south = lax.ppermute(rows, name_y, fwd)
        iy = lax.axis_index(name_y)
        from_south = jnp.where(iy == 0, jnp.zeros_like(from_south),
                               from_south)
        for k, i in enumerate(shifted_idx):
            fulls[i] = fulls[i].at[:, Hy].set(from_south[k])

    filled = fill_halos_many(fulls, locs, lgrid)
    upd = dict(zip(names, filled[:len(names)]))
    if tr:
        upd["tracers"] = dict(zip(tr, filled[len(names):]))
    return state.evolve(**upd)


def _strip_state(state, lgrid):
    upd = {}
    for name in _STATE_LOCS:
        q = getattr(state, name)
        if q is not None:
            upd[name] = _strip_one(name, q, lgrid)
    if state.tracers:
        upd["tracers"] = {k: lgrid.interior(v) for k, v in state.tracers.items()}
    return state.evolve(**upd)


def strip_halos(model, state):
    """Global padded state → interior-only state (the sharded representation)."""
    return _strip_state(state, model.grid)


def unstrip_halos(model, state_int):
    """Interior-only state → global padded state with fresh halos."""
    grid = model.grid

    def pad(name, q):
        if q is None:
            return None
        return _pad_one(name, q, grid, meshed_y=False)

    upd = {name: pad(name, getattr(state_int, name)) for name in _STATE_LOCS}
    if state_int.tracers:
        upd["tracers"] = {k: pad("h", v) for k, v in state_int.tracers.items()}
    return state_int.evolve(**upd)


def _check_model_shardable(model):
    grid = model.grid
    skip = {id(l) for l in jax.tree_util.tree_leaves((grid, model.masks))}
    for leaf in jax.tree_util.tree_leaves(model):
        if id(leaf) in skip:
            continue
        if _shape_is_grid(grid, leaf):
            raise NotImplementedError(
                "distributed stepping currently requires scalar (or callable) "
                "model inputs; got a grid-shaped model array — pass it via "
                "state.tracers or a callable forcing instead")


def make_distributed_step(model, mesh_shape, devices=None):
    """Build a jitted distributed step: ``dstep(state_interior, dt) ->
    state_interior`` with every 2-D leaf sharded over the mesh.

    Use :func:`strip_halos` / :func:`unstrip_halos` to convert to/from the
    serial padded representation.
    """
    grid = model.grid
    _check_model_shardable(model)
    Px, Py = mesh_shape
    if grid.Nx % Px or grid.Ny % Py:
        raise ValueError(f"grid {grid.Nx}x{grid.Ny} not divisible by mesh {mesh_shape}")
    nx, ny = grid.Nx // Px, grid.Ny // Py
    mesh = make_mesh(mesh_shape, devices)
    axes = ("x" if Px > 1 else None, "y" if Py > 1 else None)

    # Communication-avoiding wide-halo EVP: inflate shard halos to 2N+3 so the
    # substep loop runs exchange-free (`split_explicit_momentum_equations.jl:51-64`)
    dyn = model.dynamics
    wide = (dyn is not None
            and getattr(getattr(dyn, "solver", None), "halo_exchange", None) == "wide")
    if wide:
        from ..grids import with_halo
        H_needed = 2 * dyn.solver.substeps + 3
        # inflate only mesh-split dimensions: unmeshed halos stay serial-width
        # (their fills are local; a halo wider than the interior extent would
        # be unfillable)
        hx = max(H_needed, grid.Hx) if axes[0] else grid.Hx
        hy = max(H_needed, grid.Hy) if axes[1] else grid.Hy
        if (axes[0] and hx > nx) or (axes[1] and hy > ny):
            raise ValueError(
                f"wide-halo EVP needs halo {H_needed} ≤ tile size "
                f"({nx}, {ny}); reduce substeps or use "
                f"halo_exchange='per_substep'")
        grid = with_halo(grid, (hx, hy))  # wide-padded coordinate/metric source
        model = model.evolve(grid=grid)
        if grid.north_fold and Px > 1:
            # An x-meshed fold cannot be refreshed by local fills mid-loop:
            # the mirror columns live on the partner shard.
            raise NotImplementedError(
                "wide-halo EVP with a north fold split across the x mesh is "
                "not supported; use halo_exchange='per_substep' or a "
                "(1, Py) mesh")

    immersed = grid.solid_cc is not None
    solid_int_global = (np.asarray(grid.interior(grid.solid_cc))
                        if immersed else np.zeros(grid.interior_shape, bool))

    def local_step(state_int, solid_int, dt):
        ix = lax.axis_index("x") if Px > 1 else 0
        iy = lax.axis_index("y") if Py > 1 else 0
        lgrid = _local_grid(grid, nx, ny, ix, iy, axes, (Px, Py))
        lmasks = _local_masks(lgrid, solid_int, ix, iy, immersed)
        lgrid = lgrid.evolve(solid_cc=lmasks.solid_cc)
        lmodel = model.evolve(grid=lgrid, masks=lmasks)
        # one combined mask+pad+fill pass (= _pad_state ∘ update_state, one
        # batched exchange round instead of two)
        lstate = _pad_state(state_int, lgrid, masks=lmasks)
        out = _step(lmodel, lstate, dt)
        return _strip_state(out, lgrid)

    def spec_of(tree):
        return jax.tree_util.tree_map(
            lambda l: P("x", "y") if getattr(l, "ndim", 0) == 2 else P(), tree)

    def dstep(state_int, dt):
        in_specs = (spec_of(state_int), P("x", "y"), P())
        out_specs = spec_of(state_int)
        # check_vma=False: the step rebuilds some carried fields (Qtop/Qbot
        # under prescribed fluxes) from shard-independent constants, so the
        # RK3 ``lax.scan`` carry (grids ≥ 256² per shard) would change its
        # varying-mesh-axis type between input and output.
        f = shard_map(local_step, mesh=mesh, in_specs=in_specs,
                      out_specs=out_specs, check_vma=False)
        return f(state_int, solid_int_global, jnp.asarray(dt, grid.np_dtype))

    return jax.jit(dstep), mesh
