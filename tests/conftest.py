"""Test configuration: the CPU backend with an 8-device virtual mesh, so
sharding tests run anywhere, per the multi-host test strategy in SURVEY.md
§4, unless JAX_PLATFORMS names another platform. Tests marked `gpu` take the
`gpu` fixture and skip without an NVIDIA GPU."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

import json
import pathlib

import pytest


@pytest.fixture(autouse=True, scope="module")
def _release_compiled_executables():
    """Drop live compiled executables between test modules. The XLA CPU
    JIT segfaults deterministically once a single process accumulates the
    full suite's compile volume (reproduced: the alignment modules then ONE
    more jit compile crashes in backend_compile_and_load);
    releasing executables at module boundaries keeps the process under
    that cliff. Costs a few cross-module recompiles, all cache-warm."""
    yield
    jax.clear_caches()


@pytest.fixture
def gpu():
    """The card, for tests of the CUDA kernels (no interpret mode exists)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; on the card run `python chip_smoke.py`")
    return dev

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
TEST_DATA = pathlib.Path(__file__).parent.parent / "stringdecomposer_tpu" / "test_data"


@pytest.fixture(scope="session")
def random_cases():
    # two independently seeded reference-binary fixture sets
    cases = []
    for name in ["random_cases.json", "random_cases_b.json"]:
        with open(FIXTURES / name) as f:
            cases.extend(json.load(f))
    return cases


@pytest.fixture(scope="session")
def edlib_cases():
    cases = []
    for name in ["edlib_cases.json", "edlib_cases_b.json"]:
        with open(FIXTURES / name) as f:
            cases.extend(json.load(f))
    return cases


@pytest.fixture(scope="session")
def test_data_dir():
    return TEST_DATA
