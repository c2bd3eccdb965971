"""Multi-process / multi-host execution surface.

JAX analog of the reference's MPI launcher path
(`test/test_distributed_sea_ice.jl:40-64` spawns `mpiexec -n 4` workers;
`test/distributed_tests_utils.jl:91-105` checks per-rank output): here each
*process* owns a subset of the devices of one global ``jax.sharding.Mesh``
(NVLink within a host, the network across hosts), the SPMD step from
:mod:`.stepper` runs unchanged under ``jit``, and this module supplies the
glue that MPI provides the reference for free:

* :func:`initialize` — the ``jax.distributed`` launcher handshake
  (coordinator + process rank), the `mpiexec` analog;
* :func:`shard_state` — build globally-sharded ``jax.Array`` state from
  (replicated) host values, each process contributing only the shards it
  owns;
* :func:`gather_state` — the ``reconstruct_global_field`` analog: allgather
  every leaf back to a host-local numpy pytree (tests / serial IO);
* :func:`save_rank_snapshot` / :func:`reassemble_rank_snapshots` — per-rank
  output files keyed by global shard offsets, reassembling to the serial
  layout;
* :func:`save_sharded_checkpoint` / :func:`load_sharded_checkpoint` —
  checkpoint/restore of sharded state without ever materializing the global
  arrays on one host (bit-exact, like `io/checkpoint.py`).

Multi-node without hardware is exercised by spawning real subprocesses on
one machine with virtual CPU devices (`tests/test_multiprocess.py`), exactly
mirroring the reference's single-machine ``mpiexec`` trick.
"""

from __future__ import annotations

import glob
import os
import re

import numpy as np
import jax
import jax.numpy as jnp

from ..io.checkpoint import _path_str


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               **kwargs):
    """Join the multi-process JAX runtime (the ``mpiexec`` launch analog).

    Call once per process before any device computation.  With no arguments,
    environment-based auto-detection is used (cluster schedulers such as
    SLURM set this up); on CPU/manual clusters pass the coordinator's
    ``host:port``, the world size, and this process's rank.
    """
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id, **kwargs)


def process_index():
    return jax.process_index()


def process_count():
    return jax.process_count()


def _sharding(mesh):
    from jax.sharding import NamedSharding, PartitionSpec as P
    return (NamedSharding(mesh, P("x", "y")), NamedSharding(mesh, P()))


def shard_state(state_int, mesh):
    """Place an interior-stripped state pytree on ``mesh`` as global arrays.

    Works in both single- and multi-process settings: each process supplies
    only the shards it owns (``jax.make_array_from_callback``), so the host
    values — typically the same replicated initial condition built from
    ``initial_state`` + ``strip_halos`` on every process — are never
    transferred whole.
    """
    sh2d, sh0d = _sharding(mesh)

    def place(leaf):
        if leaf is None:
            return None
        a = np.asarray(leaf)
        if a.ndim == 2:
            return jax.make_array_from_callback(a.shape, sh2d,
                                                lambda idx, a=a: a[idx])
        return jax.make_array_from_callback(a.shape, sh0d,
                                            lambda idx, a=a: a[idx])

    return jax.tree_util.tree_map(place, state_int)


def gather_state(state_int):
    """Allgather a (possibly multi-process) sharded state into host numpy
    arrays on every process — the `reconstruct_global_field` analog."""
    from jax.experimental import multihost_utils

    def gather(leaf):
        if leaf is None:
            return None
        if isinstance(leaf, jax.Array) and not leaf.is_fully_addressable:
            return np.asarray(multihost_utils.process_allgather(leaf, tiled=True))
        return np.asarray(leaf)

    return jax.tree_util.tree_map(gather, state_int)


# --- per-rank output -----------------------------------------------------------
# (`test/distributed_tests_utils.jl:91-105`: each rank writes its own slab;
# the test reassembles and compares against the serial run)

def _shard_entries(leaf):
    """[(key_suffix, shard ndarray)] for this process's shards of ``leaf``."""
    out = []
    if isinstance(leaf, jax.Array) and leaf.ndim == 2:
        seen = set()
        for s in leaf.addressable_shards:
            i0 = 0 if s.index[0].start is None else s.index[0].start
            j0 = 0 if s.index[1].start is None else s.index[1].start
            if (i0, j0) in seen:  # replicated dims: one copy is enough
                continue
            seen.add((i0, j0))
            out.append((f"@{i0}_{j0}", np.asarray(s.data)))
    else:
        out.append(("", np.asarray(leaf)))
    return out


def save_rank_snapshot(prefix, state_int, iteration, time=None, outputs=None):
    """Write this process's shards of ``state_int`` to
    ``<prefix>_rank<P>_<iteration>.npz`` (keys ``<field>@<i0>_<j0>``)."""
    data = {}
    for name in (outputs or ("u", "v", "h", "a", "hs")):
        leaf = getattr(state_int, name, None)
        if leaf is None and getattr(state_int, "tracers", None):
            leaf = state_int.tracers.get(name)
        if leaf is None:
            continue
        for suffix, arr in _shard_entries(leaf):
            data[name + suffix] = arr
    if time is not None:
        data["time"] = np.asarray(time)
    path = f"{prefix}_rank{jax.process_index():03d}_{iteration:08d}.npz"
    np.savez(path, **data)
    return path


def reassemble_rank_snapshots(prefix, iteration, global_shape):
    """Merge all ranks' ``save_rank_snapshot`` files for ``iteration`` into
    {field: global ndarray} — the test-side `reconstruct_global_field`."""
    fields = {}
    files = sorted(glob.glob(f"{prefix}_rank*_{iteration:08d}.npz"))
    if not files:
        raise FileNotFoundError(f"no rank files for {prefix} @ {iteration}")
    for f in files:
        with np.load(f) as d:
            for key in d.files:
                if key == "time":
                    fields.setdefault("time", d[key])
                    continue
                m = re.match(r"(.+)@(\d+)_(\d+)$", key)
                if not m:
                    fields.setdefault(key, d[key])
                    continue
                name, i0, j0 = m.group(1), int(m.group(2)), int(m.group(3))
                tgt = fields.setdefault(
                    name, np.full(global_shape, np.nan, d[key].dtype))
                blk = d[key]
                tgt[i0:i0 + blk.shape[0], j0:j0 + blk.shape[1]] = blk
    return fields


# --- sharded checkpoint --------------------------------------------------------
# (sharded analog of io/checkpoint.py: bit-exact without a global gather)

def save_sharded_checkpoint(prefix, state_int, clock=None):
    """Each process writes its shards of every state leaf (keys are pytree
    paths + ``@i0_j0`` offsets) to ``<prefix>.rank<P>.npz``.  Bit-exact."""
    leaves = jax.tree_util.tree_flatten_with_path(state_int)[0]
    data = {}
    for p, leaf in leaves:
        for suffix, arr in _shard_entries(leaf):
            data[_path_str(p) + suffix] = arr
    if clock is not None:
        data["__clock__"] = np.asarray(clock)
    path = f"{prefix}.rank{jax.process_index():03d}.npz"
    np.savez(path, **data)
    return path


def load_sharded_checkpoint(prefix, template_state, mesh):
    """Restore a sharded checkpoint onto ``mesh``.

    Every process reads all rank files (small per-rank slabs), rebuilds the
    global value per leaf, and re-shards with :func:`shard_state` — so the
    restore works for any process/mesh layout, not just the writing one.
    Returns ``(state, clock)`` with bit-identical leaf values.
    """
    merged = {}
    clock = None
    for f in sorted(glob.glob(f"{prefix}.rank*.npz")):
        with np.load(f) as d:
            for key in d.files:
                if key == "__clock__":
                    clock = d[key]
                    continue
                m = re.match(r"(.+)@(\d+)_(\d+)$", key)
                if m:
                    merged.setdefault(m.group(1), []).append(
                        (int(m.group(2)), int(m.group(3)), d[key]))
                else:
                    merged.setdefault(key, d[key])

    paths, treedef = jax.tree_util.tree_flatten_with_path(template_state)
    new_leaves = []
    for p, old in paths:
        key = _path_str(p)
        got = merged.get(key)
        if got is None:
            new_leaves.append(old)
        elif isinstance(got, list):
            shape = np.asarray(old).shape
            full = np.zeros(shape, got[0][2].dtype)
            for i0, j0, blk in got:
                full[i0:i0 + blk.shape[0], j0:j0 + blk.shape[1]] = blk
            new_leaves.append(full)
        else:
            new_leaves.append(got)
    state = jax.tree_util.tree_unflatten(treedef, new_leaves)
    return shard_state(state, mesh), clock
