"""Smoke run of the sea-ice model on NVIDIA GPUs through its user entry points.

    python chip_smoke.py          one card: the 512² flagship, the same
                                  flagship with the relaxation unclamped, and
                                  the 1152×960 land-masked tripolar basin,
                                  each stepped through ``csi.Simulation`` and
                                  each first step compared with a float64 CPU
                                  reference
    python chip_smoke.py --four   four cards: the (2, 2) distributed step of
                                  the flagship at 1024², with per_substep and
                                  wide halo exchange, against the serial step
                                  on one card; nothing else runs

Every phase prints what it measured.  The step times are from one smoke run,
not a benchmark.  The last line of standard output is one JSON object,
``{"ok": true, "device": {...}}``, printed only when every phase passed.
Without a GPU, or when any phase fails, the script exits non-zero and does
not print it.
"""

import argparse
import dataclasses
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
FIELDS = ("h", "a", "u", "v")
STRESSES = ("sig11", "sig12")

# --- tolerances ---------------------------------------------------------------
# Two regimes, told apart by whether the αEVP relaxation γ = √(ζ c_α Δt/m Az)
# is clamped at α⁺ (`ElastoViscoPlasticRheology.max_relaxation_parameter`).
#
# Clamped (the flagship and the tripolar basin as users run them, α⁺ = 300):
# where the ice barely deforms, Δ → Δ_min and γ would exceed α⁺, and the
# relaxation is then not contractive.  Any roundoff-level difference grows
# over the 120 substeps until it saturates at the same spread: in float64 on
# the CPU (256² flagship) a one-ulp change of h, the (2, 2) distributed step
# and float32 all land at u ≈ 1.28e-2 relative L2 from the serial float64
# step (validation/roundoff_witness.py).  An honest float32 run can only be
# held to that spread, which hides small faults.  Limit: CLAMPED_MULTIPLE ×
# the CPU float32 run's own error against float64, never above CLAMPED_CAP.
#
# Unclamped (the flagship with α⁺ = UNCLAMPED_ALPHA, above γ's largest value
# at these widths, ≈ 6.7e3 at 1024²): the same step is well conditioned; the
# float32 errors stay near roundoff (512², CPU: h 5.8e-8 … σ₁₂ 3.7e-6) and the
# distributed step agrees with the serial one to 4e-16 in float64 (256²).
# This is the check that can fail on a wrong kernel, a lost halo or a
# reduced-precision contraction (a dropped u halo fill: u 2.96e-3 against a
# limit of 5.0e-7, tests/test_chip_smoke.py).  Limit: TIGHT_MULTIPLE × the
# CPU float32 error (floored at TIGHT_FLOOR, two float32 ulps), never above
# TIGHT_CAP.  The card's error is not the CPU's: XLA's GPU backend contracts
# a·b+c into FMAs and fuses in another order.  On the H100 the card's error
# (and, on four cards, the distributed-vs-serial gap) came to at most 1.25 ×
# the CPU float32 error on every field the floor does not cover; the
# multiple leaves about twice that.
CLAMPED_MULTIPLE = 1.5
CLAMPED_CAP = 0.2
TIGHT_MULTIPLE = 3.0
TIGHT_FLOOR = 2.4e-7
TIGHT_CAP = 1e-4
UNCLAMPED_ALPHA = 1e5

# Four cards.  Unclamped flagship: the distributed and the serial step are
# two float32 roundings of one computation, each about the float32 error from
# float64, so they are held to the tight limit above, taken from the CPU
# float32 error of the same step.  Clamped flagship: by at most
# WITNESS_MULTIPLE × the spread that a one-ulp change of h makes in the
# serial step on the same card (the saturated spread above; on four H100s
# the distributed step landed within 0.1 % of that spread on every field).
WITNESS_MULTIPLE = 1.5


def rel_l2(x, ref):
    return float(np.linalg.norm(x - ref) / max(np.linalg.norm(ref), 1e-30))


def check_physical(name, fields):
    """Finite fields, 0 ≤ ℵ ≤ 1 and h ≥ 0; returns a list of failures."""
    bad = [f"{name}: {f} not finite" for f in FIELDS + STRESSES
           if f in fields and not np.isfinite(fields[f]).all()]
    if not bad:
        if fields["a"].min() < 0 or fields["a"].max() > 1:
            bad.append(f"{name}: concentration outside [0, 1] "
                       f"({fields['a'].min()}, {fields['a'].max()})")
        if fields["h"].min() < 0:
            bad.append(f"{name}: negative thickness {fields['h'].min()}")
    return bad


def check_limits(name, errors, limits, label):
    """Print one line per field and return the fields above their limit."""
    bad = []
    for f, e in errors.items():
        ok = e <= limits[f]
        print(f"{name} {f}: {label} {e:.3e}  limit {limits[f]:.3e}  "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            bad.append(f"{name}: {f} {label} {e:.3e} above {limits[f]:.3e}")
    return bad


def limits_from(ref64, ref32, tight):
    """Per-field limits from the CPU f32 run's error against f64 (``tight``:
    the unclamped regime)."""
    fields = FIELDS + STRESSES if tight else FIELDS
    e_cpu = {f: rel_l2(ref32[f], ref64[f]) for f in fields}
    if tight:
        return {f: min(max(TIGHT_MULTIPLE * e, TIGHT_FLOOR), TIGHT_CAP)
                for f, e in e_cpu.items()}
    return {f: min(CLAMPED_MULTIPLE * e, CLAMPED_CAP) for f, e in e_cpu.items()}


def compare_fields(name, got, ref64, ref32, tight):
    """Compare the card's f32 fields with the f64 reference, bounded by the
    CPU f32 run's own error; returns a list of failures."""
    limits = limits_from(ref64, ref32, tight)
    for f in limits:
        print(f"{name} {f}: cpu f32 vs f64 {rel_l2(ref32[f], ref64[f]):.3e}  "
              f"card f32 vs cpu f32 {rel_l2(got[f], ref32[f]):.3e}",
              flush=True)
    errors = {f: rel_l2(got[f], ref64[f]) for f in limits}
    return check_physical(name, got) + check_limits(name, errors, limits,
                                                    "card f32 vs f64")


# --- configurations -------------------------------------------------------------

def with_max_relaxation(model, alpha):
    dyn = model.dynamics
    rheology = dataclasses.replace(dyn.rheology, max_relaxation_parameter=alpha)
    return model.evolve(dynamics=dataclasses.replace(dyn, rheology=rheology))


def flagship(N=512, substeps=120, dtype="float32"):
    """bench.py's configuration: N² doubly periodic, αEVP, WENO-7, slab
    thermodynamics, SplitRungeKutta3."""
    import bench
    model, state = bench.build(N, substeps, dtype)
    return model, state, 120.0


def unclamped(N=512, substeps=120, dtype="float32"):
    """The flagship with α⁺ above γ's largest value (well conditioned)."""
    model, state, dt = flagship(N, substeps, dtype)
    return with_max_relaxation(model, UNCLAMPED_ALPHA), state, dt


def tripolar(Nx=1152, Ny=960, substeps=120, dtype="float32"):
    """The land-masked tripolar Arctic basin of validation/run_tripolar_basin."""
    sys.path.insert(0, os.path.join(REPO, "validation"))
    from run_tripolar_basin import build
    model, state = build(Nx, Ny, substeps=substeps, dtype=dtype)
    return model, state, 1200.0


CASES = {"flagship": flagship, "unclamped": unclamped, "tripolar": tripolar}
TIGHT = {"unclamped"}


def interior_fields(model, state):
    return {f: np.asarray(model.grid.interior(getattr(state, f)), np.float64)
            for f in FIELDS + STRESSES}


# --- the CPU reference (runs in a child process that never opens a card) ------

def reference(cases):
    """One step of each ``(case, kwargs)`` in float32, then in float64, on
    the CPU.  Returns {"<case>/<dtype>/<field>": array}."""
    import jax
    import climaseaice_jl_tpu as csi

    out = {}
    for dtype in ("float32", "float64"):
        # f32 first: with x64 on, f64 numpy constants would promote f32 models
        jax.config.update("jax_enable_x64", dtype == "float64")
        for name, kw in cases:
            model, state, dt = CASES[name](dtype=dtype, **kw)
            s1 = csi.step(model, state, dt)
            for f, q in interior_fields(model, s1).items():
                out[f"{name}/{dtype}/{f}"] = q
    return out


def start_reference(cases):
    """Start the CPU reference in a child process (JAX_PLATFORMS=cpu)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--reference",
         json.dumps(cases)],
        env=env, stdout=subprocess.PIPE, cwd=REPO)


def finish_reference(proc, timeout=1000):
    out, _ = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"CPU reference exited {proc.returncode}")
    with np.load(io.BytesIO(out)) as z:
        return {k: z[k] for k in z.files}


# --- card phases ------------------------------------------------------------------

def device_phase(count):
    """Print the devices; fail unless JAX sees at least ``count`` GPUs."""
    import jax
    from climaseaice_jl_tpu.utils import card_info
    devs = jax.devices()
    d = devs[0]
    print(f"device: platform={d.platform} kind={d.device_kind} "
          f"count={len(devs)}", flush=True)
    if d.platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (JAX platform {d.platform!r})")
    if len(devs) < count:
        raise SystemExit(f"chip_smoke: need {count} GPUs, have {len(devs)}")
    print(f"card: {card_info()}", flush=True)
    return d


def hlo_matmuls(text):
    """Number of dot/convolution instructions in an HLO module's text (a
    float32 dot on the card may run in TF32 unless precision is pinned)."""
    return sum(text.count(op) for op in (" dot(", " convolution("))


def step_phase(name, model, state, dt, steps):
    """Compile the donated step, run one step and then ``steps`` more through
    ``Simulation``; returns the fields after the first step."""
    import jax
    import climaseaice_jl_tpu as csi
    from climaseaice_jl_tpu.model import step_donated

    g = model.grid
    t0 = time.perf_counter()
    compiled = step_donated.lower(model, state, dt).compile()
    print(f"{name}: grid {g.Nx}x{g.Ny}, "
          f"compile {time.perf_counter() - t0:.2f} s", flush=True)
    n_mm = hlo_matmuls(compiled.as_text())
    print(f"{name}: dot/convolution in HLO: {n_mm}", flush=True)
    if n_mm:
        raise RuntimeError(f"{name}: {n_mm} dot/convolution ops in the step; "
                           "pin precision=HIGHEST before trusting f32 results")
    print(f"{name}: memory_analysis {compiled.memory_analysis()}", flush=True)

    sim = csi.Simulation(model, state, dt, stop_iteration=1)
    t0 = time.perf_counter()
    sim.run()
    print(f"{name}: first step through Simulation "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    first = interior_fields(model, sim.state)

    sim.stop_iteration = 1 + steps
    t0 = time.perf_counter()
    sim.run()
    jax.block_until_ready(sim.state.h)
    per_step = (time.perf_counter() - t0) / steps
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    print(f"{name}: smoke step time {per_step * 1e3:.2f} ms over {steps} steps "
          f"({g.Nx * g.Ny / per_step:.4g} points/s; one smoke run, not a "
          f"benchmark); peak_bytes_in_use {peak}", flush=True)
    bad = check_physical(f"{name} after {1 + steps} steps",
                         interior_fields(model, sim.state))
    if bad:
        raise RuntimeError("; ".join(bad))
    return first


def beside_reference(cases, work):
    """Run ``work()`` on the card while a child process computes the CPU
    reference of ``cases``; returns ``work()``'s result and the reference."""
    proc = start_reference(cases)
    try:
        out = work()
        return out, finish_reference(proc)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def references(ref, name, fields):
    return ({f: ref[f"{name}/float64/{f}"] for f in fields},
            {f: ref[f"{name}/float32/{f}"] for f in fields})


def single_card(steps=3, sizes=None):
    """The flagship (clamped and unclamped) and the tripolar basin on one
    card, compared with the CPU."""
    sizes = sizes or {"flagship": {}, "unclamped": {}, "tripolar": {}}
    cases = list(sizes.items())

    def work():
        return {name: step_phase(name, *CASES[name](**kw), steps)
                for name, kw in cases}

    firsts, ref = beside_reference(cases, work)
    bad = []
    for name, got in firsts.items():
        bad += compare_fields(name, got, *references(ref, name, got),
                              name in TIGHT)
    if bad:
        raise RuntimeError("; ".join(bad))


def four_card_steps(N, substeps, steps, devices):
    """The serial steps on the first card, the one-ulp witness, and the
    (2, 2) steps for both exchange policies, clamped and unclamped."""
    import jax
    import climaseaice_jl_tpu as csi
    from climaseaice_jl_tpu.parallel import make_distributed_step, shard_state
    from climaseaice_jl_tpu.parallel.stepper import strip_halos, unstrip_halos

    model, state, dt = flagship(N, substeps)
    models = {"clamped": model,
              "unclamped": with_max_relaxation(model, UNCLAMPED_ALPHA)}
    t0 = time.perf_counter()
    serial = {k: interior_fields(m, csi.step(m, state, dt))
              for k, m in models.items()}
    print(f"four: serial {N}x{N} steps on one card (compile included) "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    nudged = state.evolve(h=state.h * (1 + np.finfo(np.float32).eps))
    witness = interior_fields(model, csi.step(model, nudged, dt))
    spread = {f: rel_l2(witness[f], serial["clamped"][f]) for f in FIELDS}
    print("four clamped: one-ulp witness spread " + "  ".join(
        f"{f} {e:.3e}" for f, e in spread.items()), flush=True)
    got = {}
    for policy in ("per_substep", "wide"):
        for kind, m in models.items():
            solver = dataclasses.replace(m.dynamics.solver,
                                         halo_exchange=policy)
            m = m.evolve(dynamics=dataclasses.replace(m.dynamics,
                                                      solver=solver))
            dstep, mesh = make_distributed_step(m, (2, 2), devices=devices)
            s0 = shard_state(strip_halos(m, state), mesh)
            t0 = time.perf_counter()
            s = dstep(s0, dt)
            jax.block_until_ready(s.h)
            name = f"four {policy} {kind}"
            print(f"{name}: first (2, 2) step, compile included, "
                  f"{time.perf_counter() - t0:.2f} s", flush=True)
            got[policy, kind] = interior_fields(m, unstrip_halos(m, s))
            if kind == "clamped":
                t0 = time.perf_counter()
                for _ in range(steps):
                    s = dstep(s, dt)
                jax.block_until_ready(s.h)
                per_step = (time.perf_counter() - t0) / steps
                print(f"{name}: smoke step time {per_step * 1e3:.2f} ms "
                      f"(one smoke run, not a benchmark)", flush=True)
    return serial, spread, got


def four_cards(N=1024, substeps=120, steps=3, devices=None):
    """(2, 2) distributed flagship step, per_substep and wide, clamped and
    unclamped, against the serial step on the first device, in one process;
    the unclamped serial step is also held to the CPU float64 reference."""
    import jax

    devices = devices or jax.devices()[:4]
    (serial, spread, got), ref = beside_reference(
        [("unclamped", {"N": N, "substeps": substeps})],
        lambda: four_card_steps(N, substeps, steps, devices))
    r64, r32 = references(ref, "unclamped", FIELDS + STRESSES)
    bad = (compare_fields("four serial unclamped", serial["unclamped"],
                          r64, r32, tight=True)
           + check_physical("four serial clamped", serial["clamped"]))
    limits = {"clamped": {f: WITNESS_MULTIPLE * e for f, e in spread.items()},
              "unclamped": limits_from(r64, r32, tight=True)}
    for (policy, kind), fields in got.items():
        name = f"four {policy} {kind}"
        errors = {f: rel_l2(fields[f], serial[kind][f]) for f in limits[kind]}
        bad += check_physical(name, fields) + check_limits(
            name, errors, limits[kind], "rel L2 vs serial")
    for kind in serial:
        diff = max(np.abs(got["wide", kind][f] - got["per_substep", kind][f]
                          ).max() for f in FIELDS + STRESSES)
        print(f"four {kind}: largest |wide - per_substep| {diff:.3e}",
              flush=True)
    if bad:
        raise RuntimeError("; ".join(bad))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card distributed phase")
    ap.add_argument("--reference", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.reference is not None:
        cases = json.loads(args.reference)
        buf = io.BytesIO()
        np.savez(buf, **reference(cases))
        sys.stdout.buffer.write(buf.getvalue())
        sys.stdout.buffer.flush()
        return 0

    import jax
    from climaseaice_jl_tpu.utils import enable_compile_cache

    count = 4 if args.four else 1
    d = device_phase(count)
    print(f"compile cache: {enable_compile_cache()}", flush=True)
    if args.four:
        four_cards()
    else:
        single_card()
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
