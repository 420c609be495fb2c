"""Test harness: run on a virtual 8-device CPU mesh unless told otherwise.

Sharding correctness is validated on XLA's forced host-platform device
count (SURVEY.md §4 test strategy).  ``JAX_PLATFORMS`` defaults to ``cpu``;
tests marked ``gpu`` need a CUDA GPU and run on the card with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_sgm_pallas.py`` (they
skip elsewhere).
"""

import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA GPU (compiled Pallas/Triton kernels)"
    )


def pytest_report_header(config):
    return f"jax devices: {jax.device_count()} ({jax.default_backend()})"


import pytest


@pytest.fixture
def gpu_device():
    """The first CUDA device; skips the test where JAX has none.  Decided
    here, per test, never at import, so every worker collects the same
    tests."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a CUDA GPU: run with JAX_PLATFORMS=cuda on the card")
    return devs[0]


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop compiled executables after each test module.

    The full suite accumulates hundreds of distinct jitted programs (many
    track_step variants x 8 virtual devices); on small hosts the native
    resources behind them (mappings/threads) eventually segfault the
    process mid-compile (observed deterministically at ~140 tests in
    round 5, with every module green in isolation).  Per-module recompiles
    cost some wall time and buy a bounded footprint.
    """
    yield
    import jax

    jax.clear_caches()
