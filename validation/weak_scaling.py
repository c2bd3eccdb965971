"""Distributed weak-scaling harness.

Measures distributed step throughput per device on an N-device mesh with a
fixed per-device tile (weak scaling).  On virtual CPU devices the absolute
numbers say nothing about a GPU — the harness exercises the sharded step +
ppermute exchange plumbing and runs unchanged on several GPUs (the
north-star ≥80% weak-scaling measurement, BASELINE.md).

Run: JAX_PLATFORMS=cpu \
     XLA_FLAGS=--xla_force_host_platform_device_count=8 python validation/weak_scaling.py
"""
import os, sys, time
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import numpy as np
import jax

import climaseaice_jl_tpu as csi
from climaseaice_jl_tpu.parallel import make_distributed_step
from climaseaice_jl_tpu.parallel.stepper import strip_halos


def build(Nx, Ny, halo_exchange="per_substep"):
    km = 1000.0
    grid = csi.RectilinearGrid(size=(Nx, Ny), x=(0, Nx * 4 * km), y=(0, Ny * 4 * km),
                               halo=5, dtype="float32")
    dynamics = csi.SeaIceMomentumEquation(
        rheology=csi.ElastoViscoPlasticRheology(),
        coriolis=csi.FPlane(f=1.4e-4),
        top_momentum_stress={"u": 0.1, "v": 0.05},
        bottom_momentum_stress=csi.SemiImplicitStress(),
        solver=csi.SplitExplicitSolver(substeps=8,
                                       halo_exchange=halo_exchange))
    model = csi.sea_ice_model(grid, dynamics=dynamics,
                              ice_thermodynamics=csi.sea_ice_slab_thermodynamics(),
                              top_heat_flux=-20.0, bottom_heat_flux=-5.0,
                              advection=csi.WENO(order=5),
                              timestepper="ForwardEuler")
    state = csi.initial_state(model, h=1.0, a=1.0)
    return model, state


def measure(mesh_shape, tile=96, steps=10, halo_exchange="per_substep",
            repeats=3):
    """Best-of-``repeats`` timing (least-contended pass): on a shared-core
    box single measurements swing ±25 %, so the minimum per-step wall time
    is the honest throughput estimator."""
    Px, Py = mesh_shape
    model, state = build(tile * Px, tile * Py, halo_exchange)
    if mesh_shape == (1, 1):
        import climaseaice_jl_tpu as csi
        dstep = jax.jit(lambda s, dt: csi.model._step(model, s, dt))
        s = state
    else:
        dstep, mesh = make_distributed_step(model, mesh_shape)
        s = strip_halos(model, state)
    s = dstep(s, 60.0)
    jax.block_until_ready(s.h)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(steps):
            s = dstep(s, 60.0)
        jax.block_until_ready(s.h)
        best = min(best, (time.perf_counter() - t0) / steps)
    pts = tile * tile * Px * Py / best
    return pts, pts / (Px * Py)


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--tile", type=int, default=96)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    ncores = os.cpu_count() or 1
    print(f"devices: {len(jax.devices())} ({jax.devices()[0].platform}), "
          f"physical cores: {ncores}, tile {args.tile}², "
          f"best of {args.repeats}×{args.steps} steps")
    for he in ("per_substep", "overlap", "wide"):
        base = None
        for mesh_shape in ((1, 1), (1, 2), (2, 2), (2, 4)):
            n = mesh_shape[0] * mesh_shape[1]
            if n > len(jax.devices()):
                continue
            total, per_dev = measure(mesh_shape, tile=args.tile,
                                     steps=args.steps, repeats=args.repeats,
                                     halo_exchange=he)
            if base is None:
                base = per_dev
            over = " [OVERSUBSCRIBED: ranks > cores, eff not meaningful]" \
                if n > ncores else ""
            print(f"halo={he:12s} mesh={mesh_shape}: {total/1e6:8.2f}M pts/s total, "
                  f"{per_dev/1e6:6.2f}M/device, weak-scaling eff "
                  f"{per_dev/base*100:5.1f}%{over}", flush=True)
