"""How far apart two honest runs of the flagship step land, on the CPU.

    JAX_PLATFORMS=cpu python validation/roundoff_witness.py [N ...]

For each N (default 128 256) and for α⁺ = 300 (the flagship as users run
it, γ clamped where the ice barely deforms) and α⁺ = chip_smoke's
UNCLAMPED_ALPHA (γ never clamped), one step of bench.py's configuration is
taken several ways on four virtual CPU devices, and each is compared with
the serial float64 step by relative L2 per field:

    f64 one-ulp    serial float64 from h·(1 + ε₆₄)
    f64 (2,2)      make_distributed_step over a (2, 2) mesh, float64
    f32            serial float32
and the float32 (2, 2) step against the serial float32 step (per_substep,
and wide where an N/2 tile holds its 243-cell halo).  When the relaxation is
clamped, every row saturates at the same spread: the gap between the
distributed and the serial step is the model's roundoff sensitivity, not a
fault.  When it is not, the float64 rows sit near machine epsilon and the
float32 rows near the float32 error.
"""

import dataclasses
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402


def one_step(N, alpha, dtype, policy=None, nudge=False):
    import climaseaice_jl_tpu as csi
    from climaseaice_jl_tpu.parallel import make_distributed_step, shard_state
    from climaseaice_jl_tpu.parallel.stepper import strip_halos, unstrip_halos

    jax.config.update("jax_enable_x64", dtype == "float64")
    model, state, dt = cs.flagship(N, dtype=dtype)
    model = cs.with_max_relaxation(model, alpha)
    if nudge:
        state = state.evolve(h=state.h * (1 + np.finfo(dtype).eps))
    if policy is None:
        return cs.interior_fields(model, csi.step(model, state, dt))
    solver = dataclasses.replace(model.dynamics.solver, halo_exchange=policy)
    model = model.evolve(dynamics=dataclasses.replace(model.dynamics,
                                                      solver=solver))
    dstep, mesh = make_distributed_step(model, (2, 2),
                                        devices=jax.devices()[:4])
    s1 = dstep(shard_state(strip_halos(model, state), mesh), dt)
    return cs.interior_fields(model, unstrip_halos(model, s1))


def row(label, got, ref):
    print(f"  {label:<30}" + "  ".join(
        f"{f} {cs.rel_l2(got[f], ref[f]):.3e}" for f in ref), flush=True)


def main(sizes):
    for N in sizes:
        for alpha in (300.0, cs.UNCLAMPED_ALPHA):
            print(f"N={N} alpha+={alpha:g}: relative L2", flush=True)
            ref = one_step(N, alpha, "float64")
            row("f64 one-ulp vs f64", one_step(N, alpha, "float64",
                                               nudge=True), ref)
            row("f64 (2,2) vs f64", one_step(N, alpha, "float64",
                                             "per_substep"), ref)
            s32 = one_step(N, alpha, "float32")
            row("f32 vs f64", s32, ref)
            # wide needs a halo of 2·120 + 3 cells inside each N/2 tile
            for policy in ("per_substep", "wide")[:1 + (N // 2 >= 243)]:
                row(f"f32 (2,2) {policy} vs f32",
                    one_step(N, alpha, "float32", policy), s32)


if __name__ == "__main__":
    main([int(n) for n in sys.argv[1:]] or [128, 256])
