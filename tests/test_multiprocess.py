"""Multi-process execution surface — the mpiexec analog.

Port of `test/test_distributed_sea_ice.jl:40-64` (tests spawn real MPI
subprocesses) and `test/distributed_tests_utils.jl:91-105` (per-rank output
reassembly): two REAL OS processes, each owning 4 virtual CPU devices of one
8-device (2,4) mesh, join via `jax.distributed.initialize` and run the same
`make_distributed_step` used in-process.  The parent reassembles the ranks'
output files and compares against a serial run.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import climaseaice_jl_tpu as csi

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Shared model configuration (contractive regime — see test_distributed.py)
CONFIG = '''
import numpy as np
import climaseaice_jl_tpu as csi

KM = 1000.0
STEPS = 5
DT = 120.0

def build():
    grid = csi.RectilinearGrid(size=(32, 32), x=(-10 * KM, 10 * KM),
                               y=(-10 * KM, 10 * KM), halo=5,
                               topology=("periodic", "periodic"))
    dynamics = csi.SeaIceMomentumEquation(
        rheology=csi.ElastoViscoPlasticRheology(max_relaxation_parameter=1e4),
        coriolis=csi.FPlane(f=1e-4),
        top_momentum_stress={"u": 0.01, "v": 0.01},
        bottom_momentum_stress=csi.SemiImplicitStress(),
        solver=csi.SplitExplicitSolver(substeps=10))
    model = csi.sea_ice_model(grid, dynamics=dynamics, ice_thermodynamics=None,
                              advection=csi.WENO(order=7),
                              timestepper="ForwardEuler")
    def h0(x, y):
        return 0.3 + 0.005 * (np.sin(60 * x / (20 * KM)) + np.sin(30 * y / (20 * KM)))
    state = csi.initial_state(model, h=h0, a=1.0, u=0.1)
    return model, state
'''

WORKER = CONFIG + '''
import sys
import jax

pid, nproc, port, prefix = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                            sys.argv[4])
jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=nproc, process_id=pid)
jax.config.update("jax_enable_x64", True)
assert len(jax.devices()) == 8, len(jax.devices())
assert len(jax.local_devices()) == 4

from climaseaice_jl_tpu.parallel import (make_distributed_step, shard_state,
                                         gather_state, save_rank_snapshot,
                                         save_sharded_checkpoint,
                                         load_sharded_checkpoint)
from climaseaice_jl_tpu.parallel.stepper import strip_halos

model, state = build()
dstep, mesh = make_distributed_step(model, (2, 4))
s = shard_state(strip_halos(model, state), mesh)

ckpt_prefix = prefix + "_ckpt"
for it in range(1, STEPS + 1):
    s = dstep(s, DT)
    if it == 3:
        save_sharded_checkpoint(ckpt_prefix, s, clock=it * DT)
save_rank_snapshot(prefix, s, STEPS, time=STEPS * DT, outputs=("u", "v", "h", "a"))

# gathered output: every process reconstructs the global fields; rank 0 writes
g = gather_state(s)
if jax.process_index() == 0:
    np.savez(prefix + "_gathered.npz", u=g.u, v=g.v, h=g.h, a=g.a)

# restore the sharded checkpoint and continue: must reproduce bit-identically
s3, clock = load_sharded_checkpoint(ckpt_prefix, strip_halos(model, state), mesh)
assert float(clock) == 3 * DT
for it in range(4, STEPS + 1):
    s3 = dstep(s3, DT)
for name in ("u", "v", "h"):
    a = np.asarray(getattr(s, name).addressable_shards[0].data)
    b = np.asarray(getattr(s3, name).addressable_shards[0].data)
    assert np.array_equal(a, b), f"checkpoint restore diverged: {name}"
print(f"[rank {pid}] OK", flush=True)
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(tmp_path, script, name, nproc, local_devices, prefix):
    worker = tmp_path / name
    worker.write_text(script)
    port = _free_port()
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={local_devices}",
               PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(p), str(nproc), str(port), prefix],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for p in range(nproc)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"
        assert "OK" in out


def test_two_process_mesh_matches_serial(tmp_path):
    prefix = str(tmp_path / "out")
    _run_workers(tmp_path, WORKER, "worker.py", 2, 4, prefix)

    # serial reference in-process (same f64 CPU config via conftest)
    ns = {}
    exec(compile(CONFIG, "<config>", "exec"), ns)
    model, state = ns["build"]()
    for _ in range(ns["STEPS"]):
        state = csi.step(model, state, ns["DT"])

    from climaseaice_jl_tpu.parallel import reassemble_rank_snapshots
    got = reassemble_rank_snapshots(prefix, ns["STEPS"], (32, 32))
    assert float(got["time"]) == ns["STEPS"] * ns["DT"]
    I = model.grid.interior
    with np.load(prefix + "_gathered.npz") as gathered:
        for name in ("u", "v", "h", "a"):
            ref = np.asarray(I(getattr(state, name)))
            assert np.isfinite(got[name]).all(), name
            np.testing.assert_allclose(got[name], ref, rtol=1e-12, atol=1e-14,
                                       err_msg=name)
            # gathered (process_allgather) output equals the per-rank
            # reassembly bit-for-bit
            np.testing.assert_array_equal(gathered[name], got[name],
                                          err_msg=f"gathered {name}")


# --- hard combination 1: immersed tripolar, fold on the top rank -------------

TRIPOLAR_CONFIG = '''
import numpy as np
import climaseaice_jl_tpu as csi

STEPS = 3
DT = 60.0

def build():
    grid = csi.TripolarGrid((16, 64), southernmost_latitude=-70.0, halo=5)
    land = np.zeros((16, 64), bool)
    land[:, :2] = True
    land[5:9, 58:] = True   # landmass reaching into the fold
    grid = csi.ImmersedBoundaryGrid(grid, land)
    dyn = csi.SeaIceMomentumEquation(
        rheology=csi.ElastoViscoPlasticRheology(ice_compressive_strength=27.5),
        top_momentum_stress={"u": 0.02, "v": 0.01},
        bottom_momentum_stress=csi.SemiImplicitStress(ue=0.05, ve=-0.02),
        solver=csi.SplitExplicitSolver(substeps=6))
    model = csi.sea_ice_model(grid, dynamics=dyn, ice_thermodynamics=None,
                              advection=csi.WENO(order=5),
                              timestepper="ForwardEuler")
    rng = np.random.default_rng(7)
    state = csi.initial_state(model, h=0.5 + 0.1 * rng.random((16, 64)),
                              a=1.0, u=0.05)
    return model, state
'''

TRIPOLAR_WORKER = TRIPOLAR_CONFIG + '''
import sys
import jax

pid, nproc, port, prefix = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                            sys.argv[4])
jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=nproc, process_id=pid)
jax.config.update("jax_enable_x64", True)
assert len(jax.devices()) == 4

from climaseaice_jl_tpu.parallel import (make_distributed_step, shard_state,
                                         save_rank_snapshot)
from climaseaice_jl_tpu.parallel.stepper import strip_halos

model, state = build()
dstep, mesh = make_distributed_step(model, (1, 4))   # fold lives on rank 1
s = shard_state(strip_halos(model, state), mesh)
for it in range(1, STEPS + 1):
    s = dstep(s, DT)
save_rank_snapshot(prefix, s, STEPS, time=STEPS * DT,
                   outputs=("u", "v", "h", "a"))
print(f"[rank {pid}] OK", flush=True)
'''


def test_two_process_immersed_tripolar_fold(tmp_path):
    """Immersed tripolar with the Zipper fold handled on the top-rank shard,
    across two real processes (`distributed_tests_utils.jl:231-257` × real
    MPI-style spawning of `test_distributed_sea_ice.jl:40-64`)."""
    prefix = str(tmp_path / "tri")
    _run_workers(tmp_path, TRIPOLAR_WORKER, "worker_tri.py", 2, 2, prefix)

    ns = {}
    exec(compile(TRIPOLAR_CONFIG, "<config>", "exec"), ns)
    model, state = ns["build"]()
    for _ in range(ns["STEPS"]):
        state = csi.step(model, state, ns["DT"])

    from climaseaice_jl_tpu.parallel import reassemble_rank_snapshots
    from climaseaice_jl_tpu.parallel.stepper import _strip_one
    got = reassemble_rank_snapshots(prefix, ns["STEPS"], (16, 64))
    for name in ("u", "v", "h", "a"):
        # folded grids store y-face fields seam-shifted (stepper._Y_FACE_FIELDS)
        ref = np.asarray(_strip_one(name, getattr(state, name), model.grid))
        assert np.isfinite(got[name]).all(), name
        np.testing.assert_allclose(got[name], ref, rtol=1e-11, atol=1e-13,
                                   err_msg=name)


def _assert_f32_close(got, ref_of, names, tol_uv, tol_other):
    """Velocities relative to the largest serial speed, other fields
    relative to their own largest serial value."""
    vel_scale = max(np.abs(ref_of("u")).max(), np.abs(ref_of("v")).max(), 1e-8)
    for name in names:
        ref = ref_of(name)
        assert np.isfinite(got[name]).all(), name
        scale = vel_scale if name in ("u", "v") else max(np.abs(ref).max(), 1e-8)
        tol = tol_uv if name in ("u", "v") else tol_other
        err = np.abs(got[name] - ref).max() / scale
        assert err < tol, f"{name}: {err}"


# --- hard combination 2: 4 processes, wide-halo EVP in float32 -----------------

F32_WIDE_CONFIG = '''
import numpy as np
import climaseaice_jl_tpu as csi

KM = 1000.0
STEPS = 3
DT = 60.0

def build():
    grid = csi.RectilinearGrid(size=(48, 128), x=(-500 * KM, 500 * KM),
                               y=(-1000 * KM, 1000 * KM), halo=5,
                               dtype="float32")
    dyn = csi.SeaIceMomentumEquation(
        rheology=csi.ElastoViscoPlasticRheology(ice_compressive_strength=27.5),
        coriolis=csi.FPlane(f=1e-4),
        top_momentum_stress={"u": 0.01, "v": 0.01},
        bottom_momentum_stress=csi.SemiImplicitStress(),
        solver=csi.SplitExplicitSolver(substeps=8, halo_exchange="wide"))
    model = csi.sea_ice_model(grid, dynamics=dyn, ice_thermodynamics=None,
                              advection=None, timestepper="ForwardEuler")
    def h0(x, y):
        return 0.3 + 0.005 * (np.sin(60 * x / (1000 * KM))
                              + np.sin(30 * y / (2000 * KM)))
    state = csi.initial_state(model, h=h0, a=1.0, u=0.05)
    return model, state
'''

F32_WIDE_WORKER = F32_WIDE_CONFIG + '''
import sys
import jax

pid, nproc, port, prefix = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                            sys.argv[4])
jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=nproc, process_id=pid)
assert len(jax.devices()) == 8
assert len(jax.local_devices()) == 2

from climaseaice_jl_tpu.parallel import (make_distributed_step, shard_state,
                                         save_rank_snapshot)
from climaseaice_jl_tpu.parallel.stepper import strip_halos

model, state = build()
dstep, mesh = make_distributed_step(model, (2, 4))
s = shard_state(strip_halos(model, state), mesh)
for it in range(1, STEPS + 1):
    s = dstep(s, DT)
save_rank_snapshot(prefix, s, STEPS, time=STEPS * DT,
                   outputs=("u", "v", "sig11", "sig12"))
print(f"[rank {pid}] OK", flush=True)
'''


def test_four_process_wide_halo_f32(tmp_path):
    """Four real processes × 2 devices on a (2,4) mesh, communication-avoiding
    wide-halo EVP in float32: the reassembled run must match serial float32
    to roundoff (advection off; the grid and bounds of
    test_distributed._build_f32: in-process over (2, 4), u, v ≤ 7.8e-8 of
    the largest speed and σ ≤ 1.2e-4 of its largest value)."""
    prefix = str(tmp_path / "f32wide")
    _run_workers(tmp_path, F32_WIDE_WORKER, "worker_f32wide.py", 4, 2, prefix)

    ns = {}
    exec(compile(F32_WIDE_CONFIG, "<config>", "exec"), ns)
    model, state = ns["build"]()
    for _ in range(ns["STEPS"]):
        state = csi.step(model, state, ns["DT"])

    from climaseaice_jl_tpu.parallel import reassemble_rank_snapshots
    got = reassemble_rank_snapshots(prefix, ns["STEPS"], (48, 128))
    I = model.grid.interior
    _assert_f32_close(got, lambda n: np.asarray(I(getattr(state, n))),
                      ("u", "v", "sig11", "sig12"), 2e-6, 1e-3)


# --- capstone: 4 processes × flagship grid × float32 × advection ----------------

# Varied thickness and soft ice keep roundoff unamplified on these tripolar
# grids: serial and reassembled float32 runs agree to F32_TOL (measured on the
# CPU in-process: ≤ 2.5e-7 of the largest speed, ≤ 1.4e-6 for σ, h, ℵ).
F32_TOL = 1e-5

TRI_F32_CONFIG = '''
import numpy as np
import climaseaice_jl_tpu as csi

STEPS = 5
DT = 60.0

def build():
    grid = csi.TripolarGrid((32, 96), southernmost_latitude=-70.0, halo=5,
                            dtype="float32")
    land = np.zeros((32, 96), bool)
    land[:, :3] = True                    # southern cap
    land[10:16, 80:] = True               # landmass reaching the fold
    grid = csi.ImmersedBoundaryGrid(grid, land)
    dyn = csi.SeaIceMomentumEquation(
        rheology=csi.ElastoViscoPlasticRheology(ice_compressive_strength=27.5),
        top_momentum_stress={"u": 0.02, "v": 0.01},
        bottom_momentum_stress=csi.SemiImplicitStress(),
        solver=csi.SplitExplicitSolver(substeps=8, halo_exchange="wide"))
    model = csi.sea_ice_model(grid, dynamics=dyn, ice_thermodynamics=None,
                              advection=csi.WENO(order=7),
                              timestepper="ForwardEuler")
    rng = np.random.default_rng(11)
    state = csi.initial_state(model, h=0.5 + 0.1 * rng.random((32, 96)),
                              a=1.0, u=0.05)
    return model, state
'''

TRI_F32_WORKER = TRI_F32_CONFIG + '''
import sys
import jax

pid, nproc, port, prefix = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                            sys.argv[4])
jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=nproc, process_id=pid)
assert len(jax.devices()) == 4

from climaseaice_jl_tpu.parallel import (make_distributed_step, shard_state,
                                         save_rank_snapshot)
from climaseaice_jl_tpu.parallel.stepper import strip_halos

model, state = build()
dstep, mesh = make_distributed_step(model, (1, 4))   # fold lives on rank 3
s = shard_state(strip_halos(model, state), mesh)
for it in range(1, STEPS + 1):
    s = dstep(s, DT)
save_rank_snapshot(prefix, s, STEPS, time=STEPS * DT,
                   outputs=("u", "v", "h", "a", "sig11"))
print(f"[rank {pid}] OK", flush=True)
'''


def test_four_process_tripolar_fold_f32_full_step(tmp_path):
    """The capstone combination: FOUR real OS processes on a (1,4) mesh over
    an immersed TripolarGrid (land into the fold, fold on the top rank),
    wide-halo EVP and WENO-7 advection in float32 — the full dynamics step,
    tracers included, reassembles to serial within F32_TOL
    (`distributed_tests_utils.jl:83-86` on the reference's hardest grid,
    `:170-259`, with real spawned processes, `test_distributed_sea_ice.jl:
    40-64`)."""
    prefix = str(tmp_path / "trif32")
    _run_workers(tmp_path, TRI_F32_WORKER, "worker_trif32.py", 4, 1, prefix)

    ns = {}
    exec(compile(TRI_F32_CONFIG, "<config>", "exec"), ns)
    model, state = ns["build"]()
    for _ in range(ns["STEPS"]):
        state = csi.step(model, state, ns["DT"])

    from climaseaice_jl_tpu.parallel import reassemble_rank_snapshots
    from climaseaice_jl_tpu.parallel.stepper import _strip_one
    got = reassemble_rank_snapshots(prefix, ns["STEPS"], (32, 96))
    # folded grids store y-face fields seam-shifted (stepper._Y_FACE_FIELDS)
    _assert_f32_close(
        got, lambda n: np.asarray(_strip_one(n, getattr(state, n), model.grid)),
        ("u", "v", "h", "a", "sig11"), F32_TOL, F32_TOL)


# --- capstone variant: the fold split across the x mesh -------------------------

TRI_X_CONFIG = '''
import numpy as np
import climaseaice_jl_tpu as csi

STEPS = 3
DT = 60.0

def build():
    grid = csi.TripolarGrid((48, 96), southernmost_latitude=-70.0, halo=5,
                            dtype="float32")
    land = np.zeros((48, 96), bool)
    land[:, :3] = True
    land[18:30, 80:] = True   # landmass straddling the x seam and the fold
    grid = csi.ImmersedBoundaryGrid(grid, land)
    dyn = csi.SeaIceMomentumEquation(
        rheology=csi.ElastoViscoPlasticRheology(ice_compressive_strength=27.5),
        top_momentum_stress={"u": 0.02, "v": 0.01},
        bottom_momentum_stress=csi.SemiImplicitStress(),
        solver=csi.SplitExplicitSolver(substeps=8))
    model = csi.sea_ice_model(grid, dynamics=dyn, ice_thermodynamics=None,
                              advection=csi.WENO(order=7),
                              timestepper="ForwardEuler")
    rng = np.random.default_rng(13)
    state = csi.initial_state(model, h=0.5 + 0.1 * rng.random((48, 96)),
                              a=1.0, u=0.05)
    return model, state
'''

TRI_X_WORKER = TRI_X_CONFIG + '''
import sys
import jax

pid, nproc, port, prefix = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                            sys.argv[4])
jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=nproc, process_id=pid)
assert len(jax.devices()) == 4

from climaseaice_jl_tpu.parallel import (make_distributed_step, shard_state,
                                         save_rank_snapshot)
from climaseaice_jl_tpu.parallel.stepper import strip_halos

model, state = build()
dstep, mesh = make_distributed_step(model, (2, 2))   # fold split across x
s = shard_state(strip_halos(model, state), mesh)
for it in range(1, STEPS + 1):
    s = dstep(s, DT)
save_rank_snapshot(prefix, s, STEPS, time=STEPS * DT,
                   outputs=("u", "v", "h", "a", "sig11"))
print(f"[rank {pid}] OK", flush=True)
'''


def test_four_process_xmeshed_fold_f32(tmp_path):
    """The (2,2) variant of the capstone: the Zipper fold SPLIT ACROSS THE
    X MESH over four real OS processes, per-substep exchange with the
    cross-shard fold pairing, full float32 dynamics step with WENO-7,
    within F32_TOL of serial (reference x-splitting partitions,
    `distributed_tests_utils.jl:231-257`)."""
    prefix = str(tmp_path / "trix32")
    _run_workers(tmp_path, TRI_X_WORKER, "worker_trix32.py", 4, 1, prefix)

    ns = {}
    exec(compile(TRI_X_CONFIG, "<config>", "exec"), ns)
    model, state = ns["build"]()
    for _ in range(ns["STEPS"]):
        state = csi.step(model, state, ns["DT"])

    from climaseaice_jl_tpu.parallel import reassemble_rank_snapshots
    from climaseaice_jl_tpu.parallel.stepper import _strip_one
    got = reassemble_rank_snapshots(prefix, ns["STEPS"], (48, 96))
    _assert_f32_close(
        got, lambda n: np.asarray(_strip_one(n, getattr(state, n), model.grid)),
        ("u", "v", "h", "a", "sig11"), F32_TOL, F32_TOL)
