"""Device-route choice: the one place that maps (platform, op) to code.

Ops:
  chain_dp     chain-DP forward + on-device block walk (pipeline, sharding)
  nw_pairs     NW identity of independent (query, target) pairs
  nw_cross     NW identity of every (block, monomer) pair of a chunk
               (the packed finishing path)
  hw_distance  HW (infix) distances of the --ed_thr monomer pre-filter

Routes:
  scan  plain jnp/lax programs that XLA compiles for any platform
        (ops/chain_dp.py, ops/identity.py, ops/hw_filter.py);
  cuda  hand-written Hopper kernels (ops/cuda/sdkernels.cu) called through
        jax.ffi (ops/gpu_kernels.py); GPU only, no interpret mode.

`backend` is "auto" (the table below, then the input's shape) or "scan"
(the plain XLA path on every platform, the reference a card run is checked
against). Input-dependent choices live here too: a CUDA kernel takes only
the shapes its register-resident column can hold, and larger inputs take
the scan route.
"""

from __future__ import annotations

import numpy as np

OPS = ("chain_dp", "nw_pairs", "nw_cross", "hw_distance")
BACKENDS = ("auto", "scan")

# (platform, op) -> route under backend="auto"; anything absent is "scan"
ROUTES = {
    ("gpu", "chain_dp"): "cuda",
    ("gpu", "nw_pairs"): "cuda",
    ("gpu", "nw_cross"): "cuda",
}


def platform() -> str:
    """The JAX platform the device work runs on ("cpu", "gpu", ...)."""
    import jax

    return jax.default_backend()


def choose(op: str, plat: str, backend: str = "auto", *, n_mono: int = 0,
           mono_len: int = 0, q_len: int = 0) -> str:
    """Route name for `op` on platform `plat`.

    Input facts: `n_mono` and `mono_len` are the chain DP's monomer count and
    padded monomer length; `q_len` is the longest NW query of the call."""
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}; expected one of {OPS}")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    route = "scan" if backend == "scan" else ROUTES.get((plat, op), "scan")
    if route == "cuda":
        from . import gpu_kernels as gk

        if op == "chain_dp" and gk.chain_dp_config(n_mono, mono_len) is None:
            return "scan"
        if op in ("nw_pairs", "nw_cross") and gk.nw_config(q_len) is None:
            return "scan"
    return route


def resolve(op: str, backend: str = "auto", **facts):
    """The implementation `choose` picks on this process's platform."""
    route = choose(op, platform(), backend, **facts)
    if route == "cuda":
        from . import gpu_kernels as gk

        return {
            "chain_dp": gk.chain_dp_forward_cuda,
            "nw_pairs": gk.nw_identity_batch_cuda,
            "nw_cross": gk.nw_identity_cross_cuda,
        }[op]
    if op == "chain_dp":
        from .chain_dp import chain_dp_forward

        return chain_dp_forward
    if op == "nw_pairs":
        from .identity import nw_identity_batch

        return nw_identity_batch
    if op == "nw_cross":
        from .identity import nw_identity_cross

        return nw_identity_cross
    from .hw_filter import hw_distance_batch

    return hw_distance_batch


def nw_pairs_fn(backend: str = "auto"):
    """Pairwise NW identity (the ops/identity.nw_identity_batch contract)
    whose route is chosen per call from the longest query."""

    def nw_pairs(q, q_lens, t, t_lens):
        ql = np.asarray(q_lens, dtype=np.int32)
        impl = resolve("nw_pairs", backend, q_len=int(ql.max(initial=0)))
        return impl(q, ql, t, t_lens)

    return nw_pairs
