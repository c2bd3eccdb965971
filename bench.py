"""Benchmark: grid-points/s/GPU on the EVP + advection step (the BASELINE.md
north-star metric).

Runs the flagship configuration — split-explicit αEVP (120 substeps, the
reference's default, `split_explicit_momentum_equations.jl:31`) + WENO-7
advection + slab thermodynamics, float32 — on the first GPU and prints ONE
JSON line naming the device and the card's power limit.  Without a GPU it
exits non-zero: there is no CPU fallback.  Env knobs: BENCH_N,
BENCH_SUBSTEPS, BENCH_STEPS.
"""

import json
import os
import sys
import time

import numpy as np


def build(N, substeps, dtype="float32"):
    import climaseaice_jl_tpu as csi

    km = 1000.0
    grid = csi.RectilinearGrid(size=(N, N), x=(0, 512 * km), y=(0, 512 * km),
                               halo=5, dtype=dtype,
                               topology=("periodic", "periodic"))
    dynamics = csi.SeaIceMomentumEquation(
        rheology=csi.ElastoViscoPlasticRheology(),
        coriolis=csi.FPlane(f=1.4e-4),
        top_momentum_stress={"u": 0.1, "v": 0.05},
        bottom_momentum_stress=csi.SemiImplicitStress(),
        solver=csi.SplitExplicitSolver(substeps=substeps))
    model = csi.sea_ice_model(
        grid, dynamics=dynamics,
        ice_thermodynamics=csi.sea_ice_slab_thermodynamics(),
        top_heat_flux=-20.0, bottom_heat_flux=-5.0,
        advection=csi.WENO(order=7), timestepper="SplitRungeKutta3")

    def h0(x, y):
        return 1.0 + 0.25 * np.sin(2 * np.pi * x / (512 * km)) * np.sin(2 * np.pi * y / (512 * km))

    state = csi.initial_state(model, h=h0, a=1.0)
    return model, state


def main():
    import jax
    from climaseaice_jl_tpu.model import _step
    from climaseaice_jl_tpu.utils import card_info, enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU (JAX platform {dev.platform!r})", file=sys.stderr)
        return 1
    enable_compile_cache()

    N = int(os.environ.get("BENCH_N", 512))
    substeps = int(os.environ.get("BENCH_SUBSTEPS", 120))
    steps = int(os.environ.get("BENCH_STEPS", 10))

    model, state = build(N, substeps)
    step = jax.jit(lambda s, dt: _step(model, s, dt), donate_argnums=(0,))

    dt = 120.0
    # warmup / compile
    state = step(state, dt)
    jax.block_until_ready(state.h)

    t0 = time.perf_counter()
    for _ in range(steps):
        state = step(state, dt)
    jax.block_until_ready(state.h)
    elapsed = time.perf_counter() - t0

    pts_per_s = N * N * steps / elapsed
    print(json.dumps({
        "metric": f"grid-points/s/GPU (EVP{substeps}+WENO7+thermo step, "
                  f"{N}x{N} f32, RK3)",
        "value": pts_per_s,
        "unit": "points/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card_info(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
