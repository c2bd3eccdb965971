"""Fair-base weak-scaling measurement on the 4-core virtual CPU mesh.

The plain harness (weak_scaling.py) compares a (2,2) 4-rank mesh against a
(1,1) base that monopolizes all 4 host cores for its single device — on a
shared-memory box that base is inflated by ~the core count, so the
"efficiency" it reports mixes ICI-analog exchange cost with host thread
contention.  The fair base for weak scaling is THE SAME HARDWARE running 4
*independent* serial tiles concurrently (one pinned core each): the only
difference between base and mesh is then the halo exchange + sharding
overhead, which is what weak-scaling efficiency is defined to isolate.

Protocol: base = 4 taskset-pinned processes, each timing a serial 96^2
tile (min over repeats); mesh = one process on all 4 cores timing the
(2,2) distributed step (min over repeats).  Efficiency = mesh-throughput /
sum(base throughputs).

Run (no other load on the box):
    python validation/weak_scaling_fair.py [--tile 96] [--steps 10]
"""
import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

CHILD = r"""
import os, sys, time, json
sys.path.insert(0, {root!r})
sys.path.insert(0, {here!r})
import jax
from weak_scaling import build
from climaseaice_jl_tpu.parallel import make_distributed_step
from climaseaice_jl_tpu.parallel.stepper import strip_halos
import climaseaice_jl_tpu as csi

mode = sys.argv[1]           # serial | mesh
tile = int(sys.argv[2]); steps = int(sys.argv[3]); reps = int(sys.argv[4])
exchange = sys.argv[5]
if mode == "serial":
    model, state = build(tile, tile, exchange)
    step = jax.jit(lambda s, dt: csi.model._step(model, s, dt))
    s = state
    n_dev = 1
else:
    model, state = build(2 * tile, 2 * tile, exchange)
    step, mesh = make_distributed_step(model, (2, 2))
    s = strip_halos(model, state)
    n_dev = 4
s = step(s, 60.0)
jax.block_until_ready(s.h)
best = float("inf")
for _ in range(reps):
    t0 = time.perf_counter()
    out = s
    for _ in range(steps):
        out = step(out, 60.0)
    jax.block_until_ready(out.h)
    best = min(best, (time.perf_counter() - t0) / steps)
print(json.dumps({{"mode": mode, "pts_per_s": n_dev * tile * tile / best}}))
"""


def run_children(specs, tile, steps, reps, exchange):
    """specs: list of (mode, cores) — launched concurrently."""
    code = CHILD.format(root=os.path.dirname(HERE), here=HERE)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = []
    for mode, cores in specs:
        e = dict(env)
        e["XLA_FLAGS"] = ("--xla_force_host_platform_device_count="
                          + ("4" if mode == "mesh" else "1"))
        procs.append(subprocess.Popen(
            ["taskset", "-c", cores, sys.executable, "-c", code,
             mode, str(tile), str(steps), str(reps), exchange],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, env=e))
    outs = []
    for p in procs:
        out, _ = p.communicate()
        outs.append(json.loads(out.decode().strip().splitlines()[-1]))
    return outs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tile", type=int, default=96)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    for exchange in ("per_substep", "wide", "overlap"):
        base = run_children([("serial", str(i)) for i in range(4)],
                            args.tile, args.steps, args.reps, exchange)
        base_pts = sum(r["pts_per_s"] for r in base)
        mesh = run_children([("mesh", "0-3")],
                            args.tile, args.steps, args.reps, exchange)
        mesh_pts = mesh[0]["pts_per_s"]
        print(json.dumps({
            "exchange": exchange, "tile": args.tile,
            "base_4x_serial_pts_per_s": round(base_pts, 0),
            "mesh_2x2_pts_per_s": round(mesh_pts, 0),
            "weak_scaling_efficiency": round(mesh_pts / base_pts, 3),
        }), flush=True)


if __name__ == "__main__":
    main()
