"""The device-route router (ops/backend.py) and the CUDA wrappers' host-side
choices (ops/gpu_kernels.py): which implementation each (op, platform,
input) gets, and which kernel instantiation holds a given column. All of
it is plain Python, so it is checked here on the CPU; the kernels
themselves are checked on the card (tests/test_gpu_kernels.py)."""

import os
import subprocess
import sys

import pytest

from stringdecomposer_tpu.ops import backend, gpu_kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("op, plat, mode, facts, want", [
    ("chain_dp", "cpu", "auto", dict(n_mono=24, mono_len=176), "scan"),
    ("chain_dp", "gpu", "auto", dict(n_mono=24, mono_len=176), "cuda"),
    ("chain_dp", "gpu", "scan", dict(n_mono=24, mono_len=176), "scan"),
    ("chain_dp", "gpu", "auto", dict(n_mono=200, mono_len=176), "scan"),  # > 32 warps
    ("chain_dp", "gpu", "auto", dict(n_mono=24, mono_len=600), "scan"),  # > 512 cells
    ("chain_dp", "rocm", "auto", dict(n_mono=24, mono_len=176), "scan"),
    ("nw_pairs", "cpu", "auto", dict(q_len=215), "scan"),
    ("nw_pairs", "gpu", "auto", dict(q_len=215), "cuda"),
    ("nw_pairs", "gpu", "auto", dict(q_len=5000), "scan"),  # > 1024 rows
    ("nw_cross", "gpu", "auto", dict(q_len=255), "cuda"),
    ("nw_cross", "gpu", "scan", dict(q_len=255), "scan"),
    ("nw_cross", "cpu", "auto", dict(q_len=255), "scan"),
    ("hw_distance", "gpu", "auto", {}, "scan"),
    ("hw_distance", "cpu", "auto", {}, "scan"),
])
def test_router_choice(op, plat, mode, facts, want):
    assert backend.choose(op, plat, mode, **facts) == want


@pytest.mark.parametrize("op, mode", [("banded", "auto"), ("chain_dp", "pallas")])
def test_router_rejects_unknown(op, mode):
    with pytest.raises(ValueError):
        backend.choose(op, "gpu", mode)


def test_resolve_on_cpu_is_the_scan():
    from stringdecomposer_tpu.ops.chain_dp import chain_dp_forward
    from stringdecomposer_tpu.ops.hw_filter import hw_distance_batch
    from stringdecomposer_tpu.ops.identity import nw_identity_batch, nw_identity_cross

    assert backend.platform() == "cpu"
    assert backend.resolve("chain_dp", n_mono=24, mono_len=176) is chain_dp_forward
    assert backend.resolve("nw_pairs", q_len=215) is nw_identity_batch
    assert backend.resolve("nw_cross", q_len=215) is nw_identity_cross
    assert backend.resolve("hw_distance") is hw_distance_batch


@pytest.mark.parametrize("n_mono, mono_len, want", [
    (24, 176, (6, 1)),  # DXZ1 + RC: one warp per monomer row
    (2, 8, (2, 1)),
    (48, 176, (6, 2)),  # two rows per warp once M > 32
    (100, 100, (4, 4)),
    (128, 192, (6, 4)),
    (129, 8, None),  # 33 warps of 4 rows
    (24, 513, None),  # longer than 32 * 16 cells
    (0, 176, None),
])
def test_chain_dp_config(n_mono, mono_len, want):
    assert gpu_kernels.chain_dp_config(n_mono, mono_len) == want


@pytest.mark.parametrize("q_len, want", [
    (0, 1), (31, 1), (32, 2), (215, 7), (255, 8), (1023, 32), (1024, None),
])
def test_nw_config(q_len, want):
    """Cells per thread: the fewest whose 32 lanes hold q_len + 1 rows."""
    assert gpu_kernels.nw_config(q_len) == want


def test_chain_configs_match_cuda_source():
    """The Python instantiation lists name exactly what sdkernels.cu
    instantiates (a missing one would only fail on the card)."""
    import re

    with open(gpu_kernels._SRC) as f:
        src = f.read()
    chain = src[src.index("#define SD_CHAIN_CONFIGS"):].split("\n\n")[0]
    got = tuple((int(a), int(b)) for a, b in re.findall(r"X\((\d+), (\d+)\)", chain))
    assert got == gpu_kernels.CHAIN_CONFIGS
    nw = src[src.index("#define SD_NW_CPTS"):].split("\n\n")[0]
    assert tuple(int(c) for c in re.findall(r"X\((\d+)\)", nw)) == gpu_kernels.NW_CPTS


def test_library_path_is_keyed_by_source():
    path = gpu_kernels.library_path()
    assert os.path.dirname(path) == os.path.join(os.path.dirname(gpu_kernels._SRC), "build")
    assert path == gpu_kernels.library_path()
    assert os.path.basename(path).startswith("libsdkernels-")


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_placement(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins and nothing else is set in code;
    without it the cache is the checkout's fixed .jax_cache directory."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    code = ("from stringdecomposer_tpu.utils.compile_cache import enable_compile_cache\n"
            "enable_compile_cache()\nimport jax\n"
            "print(jax.config.jax_compilation_cache_dir)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, check=True).stdout.strip()
    assert out == (str(tmp_path / env_dir) if env_dir else os.path.join(REPO, ".jax_cache"))


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, where):
    """chip_smoke.py never reports success on the CPU, nor outside the repo."""
    script = os.path.join(REPO, "chip_smoke.py")
    if where == "alone":
        with open(script) as f:
            (tmp_path / "chip_smoke.py").write_text(f.read())
        script = str(tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, script], cwd=os.path.dirname(script),
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
