"""Test configuration: CPU backend with 8 virtual devices + float64.

The reference's conservation bars (energy closure rtol 1e-15, mass 1e-12;
`test/test_energy_conservation.jl:87`) require float64, so the parity/test
suite runs on CPU-JAX with x64 enabled, while the perf path runs f32 on the
GPU (SURVEY.md §7 "hard parts" #6).  The 8 virtual CPU devices mirror the
reference's mpiexec-based distributed tests on one machine
(`test/test_distributed_sea_ice.jl:41`).

Tests that need a GPU take the ``gpu`` fixture, which skips them here; run
them on the card with ``python -m pytest tests -m gpu -p no:xdist`` without
``JAX_PLATFORMS=cpu``.
"""

import os
import shutil
import subprocess

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skipped where there is none")


@pytest.fixture
def gpu():
    """Skip the test unless nvidia-smi lists a card (decided when the test
    runs, never at import, so every worker collects the same tests)."""
    exe = shutil.which("nvidia-smi")
    if exe is None or subprocess.run([exe, "-L"], capture_output=True,
                                     timeout=60).returncode != 0:
        pytest.skip("no NVIDIA GPU on this machine")
