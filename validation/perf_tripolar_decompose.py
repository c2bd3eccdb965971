"""Per-term decomposition of the flagship tripolar step at 1152x960.

A measured per-term breakdown of the full step (RK3 + EVP-120 + WENO-7
advection + slab+snow thermo) by ablation:

  full        RK3, all physics
  mom         RK3, momentum only (no advection/thermo) -> 3x EVP-120 loops
  adv         RK3, advection+tracer update only (dynamics=None)
  thermo      RK3, thermo only (dynamics=None, advection=None)
  fe-full     ForwardEuler, all physics               -> RK3 multiplier

Usage: [SIZE=1152x960] [STEPS=10] python validation/perf_tripolar_decompose.py
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "validation"))

from run_tripolar_basin import build  # noqa: E402


def timeit(model, state, steps, dt=300.0):
    import jax
    from climaseaice_jl_tpu.model import _step
    step = jax.jit(lambda s, dt: _step(model, s, dt), donate_argnums=(0,))
    t0 = time.perf_counter()
    state = step(state, dt)
    jax.block_until_ready(state.u)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(steps):
        state = step(state, dt)
    jax.block_until_ready(state.u)
    return (time.perf_counter() - t0) / steps, compile_s


def main():
    size = os.environ.get("SIZE", "1152x960")
    steps = int(os.environ.get("STEPS", 10))
    Nx, Ny = map(int, size.split("x"))
    npts = Nx * Ny

    variants = {}

    def run(name, **evolve):
        model, state = build(Nx, Ny, substeps=120)
        if evolve:
            model = model.evolve(**evolve)
        t, comp = timeit(model, state, steps)
        variants[name] = t
        print(json.dumps({"variant": name, "ms_per_step": round(t * 1e3, 2),
                          "Mpts_per_s": round(npts / t / 1e6, 2),
                          "compile_s": round(comp, 1)}), flush=True)

    run("full")
    run("mom", advection=None, ice_thermodynamics=None,
        snow_thermodynamics=None)
    run("adv", dynamics=None, ice_thermodynamics=None,
        snow_thermodynamics=None)
    run("thermo", dynamics=None, advection=None)
    run("fe-full", timestepper="ForwardEuler")

    t = variants
    print(json.dumps({
        "summary_ms": {k: round(v * 1e3, 2) for k, v in t.items()},
        "residual_ms_full_minus_parts": round(
            (t["full"] - t["mom"] - t["adv"] - t["thermo"]) * 1e3, 2),
        "rk3_multiplier_full_over_fe": round(t["full"] / t["fe-full"], 2),
    }), flush=True)


if __name__ == "__main__":
    main()
