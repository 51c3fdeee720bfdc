"""JAX entry points for the CUDA kernels in ops/cuda/sdkernels.cu.

The library is compiled with nvcc for Hopper (sm_90a) on first use, into
ops/cuda/build/ (git-ignored), under a name keyed by the source's hash, and
its two FFI handlers are registered for the CUDA platform:

  sd_chain_dp     -> chain_dp_forward_cuda (ops/chain_dp.chain_dp_forward's
                     contract; the block walk stays in jnp)
  sd_nw_identity  -> nw_identity_batch_cuda (ops/identity.nw_identity_batch's
                     contract) and nw_identity_cross_cuda (every
                     (query, target) pair, ops/identity.nw_identity_cross)

Each thread of a kernel keeps CPT consecutive cells of a DP column in
registers, so a kernel instantiation covers columns of up to 32*CPT cells;
the choice of instantiation (and whether any fits, for the router in
ops/backend.py) is plain Python here and runs on any host. There is no
interpret mode: the kernels run only on an NVIDIA GPU, and the tests that
call them carry the `gpu` marker.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .chain_dp import INF, block_walk

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda", "sdkernels.cu")
_BUILD_DIR = os.path.join(os.path.dirname(_SRC), "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

WARP = 32
# (cells per thread, rows per warp) instantiations of the chain-DP kernel,
# smallest first; sdkernels.cu SD_CHAIN_CONFIGS lists the same
CHAIN_CONFIGS = ((2, 1), (4, 1), (6, 1), (8, 1), (12, 1), (16, 1), (2, 2),
                 (4, 2), (6, 2), (8, 2), (12, 2), (2, 4), (4, 4), (6, 4))
MAX_WARPS = 32  # 1024 threads per block
# cells-per-thread instantiations of the NW kernel (sdkernels.cu SD_NW_CPTS)
NW_CPTS = (1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 16, 24, 32)


def chain_dp_config(n_mono: int, mono_len: int) -> tuple[int, int] | None:
    """(cells per thread, rows per warp) for an [n_mono, mono_len] monomer
    tensor: the fewest rows per warp (most warps), then the fewest cells
    that hold the padded monomer length. None if no instantiation fits."""
    if n_mono < 1 or mono_len < 1:
        return None
    for rows in (1, 2, 4):
        if -(-n_mono // rows) > MAX_WARPS:
            continue
        for cpt, r in CHAIN_CONFIGS:
            if r == rows and WARP * cpt >= mono_len:
                return cpt, rows
    return None


def nw_config(q_len: int) -> int | None:
    """Cells per thread for queries of up to q_len chars (q_len + 1 rows)."""
    for cpt in NW_CPTS:
        if WARP * cpt >= q_len + 1:
            return cpt
    return None


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(set CUDA_HOME)")


def library_path() -> str:
    """Path of the compiled library for the current source and flags."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(jax.__version__.encode())
    return os.path.join(_BUILD_DIR, f"libsdkernels-{h.hexdigest()[:16]}.so")


def build_library() -> str:
    """Compile sdkernels.cu unless this source's library already exists."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", jax.ffi.include_dir(), "-o", tmp, _SRC]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr[-4000:]}")
    os.replace(tmp, path)
    return path


_lib = None


def _register() -> None:
    global _lib
    if _lib is not None:
        return
    lib = ctypes.cdll.LoadLibrary(build_library())
    for name, sym in (("sd_chain_dp", "SdChainDp"), ("sd_nw_identity", "SdNwIdentity")):
        jax.ffi.register_ffi_target(name, jax.ffi.pycapsule(getattr(lib, sym)),
                                    platform="CUDA")
    _lib = lib


@partial(
    jax.jit,
    static_argnames=("ins", "dele", "mismatch", "match", "max_blocks", "return_debug"),
)
def chain_dp_forward_cuda(
    windows: jnp.ndarray,  # [B, W] int8, padded with READ_PAD
    window_lens: jnp.ndarray,  # [B] int32
    mono: jnp.ndarray,  # [M, L] or per-window [B, M, L] int8
    mono_lens: jnp.ndarray,  # [M] or [B, M] int32
    ins: int = -1,
    dele: int = -1,
    mismatch: int = -1,
    match: int = 1,
    max_blocks: int = 0,
    return_debug: bool = False,
):
    """ops/chain_dp.chain_dp_forward on the CUDA chain-DP kernel: same
    (blocks, counts) and, with return_debug, the same (chain, end, spend)."""
    _register()
    B, W = windows.shape
    M, L = mono.shape[-2], mono.shape[-1]
    cfg = chain_dp_config(M, L)
    if cfg is None:
        raise ValueError(f"no chain-DP kernel for {M} monomers of length {L}")
    cpt, rows = cfg
    out = jax.ShapeDtypeStruct((B, W, M), jnp.int32)
    end, spend = jax.ffi.ffi_call("sd_chain_dp", (out, out))(
        windows.astype(jnp.int8), mono.astype(jnp.int8), mono_lens.astype(jnp.int32),
        ins=np.int32(ins), dele=np.int32(dele), mismatch=np.int32(mismatch),
        match=np.int32(match), cpt=np.int32(cpt), rows=np.int32(rows),
    )
    blocks, counts = block_walk(end, spend, window_lens, max_blocks or W)
    if return_debug:
        chain = jnp.concatenate(
            [jnp.full((B, 1), INF, jnp.int32), end[:, :-1].max(axis=2)], axis=1)
        return blocks, counts, (chain, end, spend)
    return blocks, counts


def _nw_call(q, q_lens, t, t_lens, n_out: int, cpt: int, cross: bool):
    """[n_out, 2] int32 (distance, columns)."""
    _register()
    return jax.ffi.ffi_call(
        "sd_nw_identity", jax.ShapeDtypeStruct((n_out, 2), jnp.int32))(
        q.astype(jnp.int8), q_lens.astype(jnp.int32), t.astype(jnp.int8),
        t_lens.astype(jnp.int32), cpt=np.int32(cpt), cross=np.int32(cross))


@partial(jax.jit, static_argnames=("cpt",))
def nw_pairs_jit(q, q_lens, t, t_lens, cpt):
    out = _nw_call(q, q_lens, t, t_lens, q.shape[0], cpt, cross=False)
    D, Ln = out[:, 0], out[:, 1]
    return D, Ln - D, Ln  # matches = columns - distance on a unit-cost path


def nw_identity_batch_cuda(q, q_lens, t, t_lens):
    """ops/identity.nw_identity_batch on the CUDA NW kernel. Pass q_lens as
    NumPy: the kernel instantiation is picked from the longest query."""
    ql = np.asarray(q_lens, dtype=np.int32)
    cpt = nw_config(int(ql.max(initial=0)))
    if cpt is None:
        raise ValueError(f"no NW kernel for queries of length {int(ql.max())}")
    return nw_pairs_jit(q, jnp.asarray(ql), t, t_lens, cpt=cpt)


def nw_identity_cross_cuda(q, q_lens, targets, t_lens, q_len: int):
    """ops/identity.nw_identity_cross on the CUDA NW kernel: [n * M, 2]
    (distance, columns) for every (query row, target row) pair, row-major.
    Traceable; q_len (static) bounds the longest query."""
    cpt = nw_config(q_len)
    if cpt is None:
        raise ValueError(f"no NW kernel for queries of length {q_len}")
    return _nw_call(q, q_lens, targets, t_lens, q.shape[0] * targets.shape[0],
                    cpt, cross=True)
