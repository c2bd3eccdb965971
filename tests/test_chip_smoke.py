"""The parts of chip_smoke.py (and bench.py's device check) that run without
a GPU: compile-cache placement, refusal without a card, the comparison
against the float64 reference, phase selection, both phases at small size
on the CPU (the four-card phase on four of the virtual devices), and a
planted fault that the comparison must catch."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import jax

import chip_smoke as cs
from climaseaice_jl_tpu import utils

REPO = cs.REPO


@pytest.mark.parametrize("env_set", [True, False], ids=["env", "default"])
def test_compile_cache_placement(env_set, monkeypatch, tmp_path):
    """$JAX_COMPILATION_CACHE_DIR when set, else <repo>/.jax_cache."""
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        expected = str(tmp_path)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        expected = os.path.join(REPO, ".jax_cache")
    old = jax.config.jax_compilation_cache_dir
    try:
        assert utils.enable_compile_cache() == expected
        assert jax.config.jax_compilation_cache_dir == expected
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def _run(args, cwd, timeout=300):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_refuses_to_run_without_gpu(script):
    r = _run([script], REPO)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_fails_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def _fields(rng, n=64):
    return {"h": 1.0 + rng.random((n, n)), "a": 0.5 + 0.4 * rng.random((n, n)),
            "u": rng.standard_normal((n, n)), "v": rng.standard_normal((n, n)),
            "sig11": rng.standard_normal((n, n)),
            "sig12": rng.standard_normal((n, n))}


@pytest.mark.parametrize("fault,message,tight", [
    ("none", None, False), ("none", None, True),
    ("nan", "u not finite", False), ("a_above_one", "outside [0, 1]", False),
    ("negative_h", "negative thickness", False),
    ("above_multiple", "v card f32 vs f64", False),
    ("above_cap", "u card f32 vs f64", False),
    ("above_multiple", "sig12 card f32 vs f64", True),
    ("above_cap", "u card f32 vs f64", True)])
def test_compare_fields(fault, message, tight):
    """Finite, bounded fields within the regime's multiple of the CPU f32
    error (clamped: CLAMPED_MULTIPLE, cap CLAMPED_CAP; unclamped:
    TIGHT_MULTIPLE, floor TIGHT_FLOOR, cap TIGHT_CAP, stresses included)
    pass; each fault is reported."""
    rng = np.random.default_rng(0)
    ref64 = _fields(rng)
    noise = {f: rng.standard_normal(q.shape) for f, q in ref64.items()}
    err = dict.fromkeys(ref64, 1e-6)
    if not tight:
        err.update(u=0.02, v=0.02)
    ref32 = {f: q + err[f] * np.abs(q).mean() * noise[f]
             for f, q in ref64.items()}
    got = {f: q + 1.2 * err[f] * np.abs(q).mean() * noise[f][::-1]
           for f, q in ref64.items()}
    if fault == "nan":
        got["u"][3, 4] = np.nan
    elif fault == "a_above_one":
        got["a"][0, 0] = 1.0 + 1e-6
    elif fault == "negative_h":
        got["h"][5, 5] = -1e-9
    elif fault == "above_multiple":
        f = "sig12" if tight else "v"
        got[f] = ref64[f] * (1 + 10 * err[f])
    elif fault == "above_cap":
        big = 1e-3 if tight else 0.3
        ref32["u"] = ref64["u"] * (1 + big)
        got["u"] = ref64["u"] * (1 + 0.8 * big)
    bad = cs.compare_fields("case", got, ref64, ref32, tight)
    if message is None:
        assert bad == []
    else:
        assert any(message in b for b in bad), bad


@pytest.mark.parametrize("text,count", [
    ("%d = f32[8,8]{1,0} dot(f32[8,8] %a, f32[8,8] %b)", 1),
    ("%c = f32[1,8,8,1] convolution(%x, %k), window={size=3x3}", 1),
    ("%f = f32[8,8] fusion(%a), kind=kLoop, calls=%fused_add", 0),
])
def test_hlo_matmuls(text, count):
    assert cs.hlo_matmuls(text) == count


@pytest.mark.parametrize("argv,phase,count", [(["--four"], "four", 4),
                                              ([], "single", 1)])
def test_phase_selection(argv, phase, count, monkeypatch, capsys):
    """--four runs the four-card phase and nothing else; without it only the
    single-card phases run.  The last line reports the device count."""
    calls = []

    class Dev:
        platform, device_kind = "gpu", "test card"

    monkeypatch.setattr(cs, "device_phase",
                        lambda n: calls.append(("device", n)) or Dev())
    monkeypatch.setattr(cs, "four_cards", lambda: calls.append("four"))
    monkeypatch.setattr(cs, "single_card", lambda: calls.append("single"))
    monkeypatch.setattr(utils, "enable_compile_cache", lambda: "cache")
    monkeypatch.setattr(jax, "devices", lambda: [Dev()] * count)
    assert cs.main(argv) == 0
    assert calls == [("device", count), phase]
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == {"ok": True, "device": {"platform": "gpu",
                                           "kind": "test card",
                                           "count": count}}


@pytest.fixture
def no_x64():
    """The card's process runs without x64; so do these tests."""
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", True)


def test_single_card_phases_small(no_x64):
    """All single-card phases at small size, with the float64 reference
    computed in a child process, exactly as on the card."""
    cs.single_card(steps=1, sizes={
        "flagship": {"N": 16, "substeps": 4},
        "unclamped": {"N": 16, "substeps": 4},
        "tripolar": {"Nx": 24, "Ny": 20, "substeps": 4}})


def test_dropped_halo_fill_is_caught(no_x64, monkeypatch):
    """Control: with the u halo fill dropped from the EVP substep loop on
    the card's side only, the unclamped comparison fails (the reference
    child runs the intact code).  Measured: u 2.96e-3 from float64 against
    a limit of 5.0e-7.  16 substeps let the stale halo reach the interior
    through the 5-cell halo."""
    from climaseaice_jl_tpu.dynamics import momentum
    jax.clear_caches()
    monkeypatch.setattr(momentum, "fill_halos_fc", lambda q, grid: q)
    try:
        with pytest.raises(RuntimeError, match="unclamped: u card f32 vs f64"):
            cs.single_card(steps=1, sizes={"unclamped": {"N": 16,
                                                         "substeps": 16}})
    finally:
        jax.clear_caches()


def test_four_card_phase_on_virtual_devices(no_x64):
    """The --four phase on four virtual CPU devices at 512² (256² shards:
    the RK3 stages run as a lax.scan inside shard_map, as on the cards)."""
    cs.four_cards(N=512, substeps=2, steps=1, devices=jax.devices()[:4])


@pytest.mark.gpu
def test_chip_smoke_on_card(gpu):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-3000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
