"""Multi-process weak-scaling measurement (the honest CPU analog).

Single-process virtual-device meshes serialize shard execution on the CPU
backend (measured: (2,2) total throughput ~= one core's serial throughput
regardless of mesh shape), so any "efficiency" they report is meaningless.
This harness mirrors the reference's single-machine `mpiexec -n 4` trick
(`test/test_distributed_sea_ice.jl:40-64`) with real parallelism:

* mesh: 4 OS processes, each pinned to its own core (taskset), each owning
  ONE device of a global (2,2) jax.distributed mesh, timing the distributed
  step (cross-process ppermute collectives);
* base: 4 OS processes, same pinning, each timing an INDEPENDENT serial
  tile of the same per-device size.

Efficiency = mesh total pts/s / base total pts/s.  Run with no other load:
    python validation/weak_scaling_mp.py [--tile 96] [--steps 10]
"""
import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

WORKER = r"""
import os, sys, time, json
import numpy as np
sys.path.insert(0, {root!r}); sys.path.insert(0, {here!r})
import jax

mode, pid, nproc, port, tile, steps, reps, exchange = (
    sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
    int(sys.argv[5]), int(sys.argv[6]), int(sys.argv[7]), sys.argv[8])

if mode == "mesh":
    jax.distributed.initialize(coordinator_address=f"127.0.0.1:{{port}}",
                               num_processes=nproc, process_id=pid)
    assert len(jax.devices()) == nproc and len(jax.local_devices()) == 1

from weak_scaling import build
import climaseaice_jl_tpu as csi
from climaseaice_jl_tpu.parallel import make_distributed_step, shard_state
from climaseaice_jl_tpu.parallel.stepper import strip_halos

if mode == "mesh":
    model, state = build(2 * tile, 2 * tile, exchange)
    step, mesh = make_distributed_step(model, (2, 2))
    s = shard_state(strip_halos(model, state), mesh)
else:
    model, state = build(tile, tile, exchange)
    step = jax.jit(lambda s, dt: csi.model._step(model, s, dt))
    s = state

s2 = step(s, 60.0)
jax.block_until_ready(s2.h)
best = float("inf")
for _ in range(reps):
    out = s
    t0 = time.perf_counter()
    for _ in range(steps):
        out = step(out, 60.0)
    jax.block_until_ready(out.h)
    best = min(best, (time.perf_counter() - t0) / steps)
n_pts = (2 * tile) ** 2 if mode == "mesh" else tile * tile
print(json.dumps({{"mode": mode, "pid": pid,
                   "pts_per_s": n_pts / best}}), flush=True)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_set(mode, tile, steps, reps, exchange):
    code = WORKER.format(root=ROOT, here=HERE)
    with tempfile.NamedTemporaryFile("w", suffix=".py", delete=False) as f:
        f.write(code)
        path = f.name
    port = str(_free_port())
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=1",
               PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        ["taskset", "-c", str(p), sys.executable, path, mode, str(p), "4",
         port, str(tile), str(steps), str(reps), exchange],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for p in range(4)]
    outs = [p.communicate(timeout=1200)[0] for p in procs]
    os.unlink(path)
    res = []
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"worker failed:\n{out[-2000:]}")
        res.append(json.loads(out.strip().splitlines()[-1]))
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tile", type=int, default=96)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    for exchange in ("per_substep", "wide", "overlap"):
        base = run_set("serial", args.tile, args.steps, args.reps, exchange)
        base_pts = sum(r["pts_per_s"] for r in base)
        mesh = run_set("mesh", args.tile, args.steps, args.reps, exchange)
        # every rank timed the same collective-synchronized steps; the
        # slowest rank's estimate is the honest global rate
        mesh_pts = min(r["pts_per_s"] for r in mesh)
        print(json.dumps({
            "exchange": exchange, "tile": args.tile,
            "base_4x_serial_pts_per_s": round(base_pts, 0),
            "mesh_2x2_4proc_pts_per_s": round(mesh_pts, 0),
            "weak_scaling_efficiency": round(mesh_pts / base_pts, 3),
        }), flush=True)


if __name__ == "__main__":
    main()
