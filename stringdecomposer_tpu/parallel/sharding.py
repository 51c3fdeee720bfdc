"""Data-parallel execution of the chain DP over a device mesh.

shard_map over a 1-D "data" mesh: the window batch (and per-window outputs)
are sharded on axis 0, the monomer tensor is replicated. Each device runs
the identical chain-DP program on its window shard — the device equivalent
of the reference's OpenMP loop over chunks (src/main.cpp:86-102), with no
cross-device communication at all (windows are independent by construction
of the halo chunking scheme, src/main.cpp:73-75). The per-device program is
the router's choice (ops/backend.py); a CUDA kernel's FFI call runs inside
shard_map on each device's shard.
"""

from __future__ import annotations

from functools import partial

import jax
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import backend as backend_router
from ..ops.identity import nw_identity_batch
from .mesh import get_mesh


def make_sharded_forward(mesh: Mesh | None = None, inner_fn=None):
    """Returns a forward_fn with the chain_dp_forward signature that shards
    the window batch across the mesh. Pads the batch up to a multiple of the
    device count; padding windows are discarded by the caller (counts of
    padded rows are simply ignored since the caller slices by task list).

    `inner_fn` is the per-device chain-DP program; by default the router's
    choice for this platform and monomer tensor."""
    mesh = mesh or get_mesh()
    n_dev = mesh.devices.size

    def forward(windows, window_lens, mono, mono_lens, *, ins=-1, dele=-1,
                mismatch=-1, match=1, max_blocks=0):
        B = windows.shape[0]
        B_pad = (B + n_dev - 1) // n_dev * n_dev
        # per-window monomer tensors (the ed_thr route, rank 3) shard on the
        # window axis alongside the windows; the shared rank-2 tensor
        # replicates
        per_window = getattr(mono, "ndim", 2) == 3
        if B_pad != B:
            pad = B_pad - B
            windows = np.concatenate([windows, np.repeat(windows[-1:], pad, axis=0)])
            window_lens = np.concatenate([window_lens, np.repeat(window_lens[-1:], pad)])
            if per_window:
                import jax.numpy as jnp

                mono = jnp.concatenate([mono, jnp.repeat(mono[-1:], pad, axis=0)])
                mono_lens = jnp.concatenate(
                    [mono_lens, jnp.repeat(mono_lens[-1:], pad, axis=0)]
                )

        inner = partial(
            inner_fn or backend_router.resolve(
                "chain_dp", n_mono=mono.shape[-2], mono_len=mono.shape[-1]),
            ins=ins, dele=dele, mismatch=mismatch, match=match,
            max_blocks=max_blocks or windows.shape[1],
        )
        mono_spec = P("data", None, None) if per_window else P(None, None)
        lens_spec = P("data", None) if per_window else P(None)
        sharded = shard_map(
            inner,
            mesh=mesh,
            in_specs=(P("data", None), P("data"), mono_spec, lens_spec),
            out_specs=(P("data", None, None), P("data")),
            check_vma=False,
        )
        blocks, counts = jax.jit(sharded)(windows, window_lens, mono, mono_lens)
        return blocks[:B], counts[:B]

    return forward


def make_sharded_identity(mesh: Mesh | None = None):
    """Identity-kernel wrapper sharding the PAIR axis across the mesh.

    The finishing stage's (block x monomer) score batches are as
    embarrassingly parallel as the DP windows; without this every device
    but one idles through rescoring. Same contract as
    ops/identity.nw_identity_batch: (dist, matches, columns) per pair. The
    route and the kernel's static column size are chosen from the GLOBAL
    batch's longest query, so every shard runs the same program and results
    are bit-identical at any device count (tested at 2/4/8)."""
    mesh = mesh or get_mesh()
    n_dev = mesh.devices.size

    def kernel(q, q_lens, t, t_lens):
        import jax.numpy as jnp

        ql_np = np.asarray(q_lens, dtype=np.int32)
        tl_np = np.asarray(t_lens, dtype=np.int32)
        Pn = q.shape[0]
        gran = 8 * n_dev
        P_pad = -(-max(Pn, 1) // gran) * gran
        pad = P_pad - Pn
        qp = jnp.pad(jnp.asarray(q), ((0, pad), (0, 0)))
        tp = jnp.pad(jnp.asarray(t), ((0, pad), (0, 0)))
        qlp = jnp.pad(jnp.asarray(ql_np), (0, pad))
        tlp = jnp.pad(jnp.asarray(tl_np), (0, pad))
        # the route and its host-side sizing are decided out here, where the
        # lengths are still NumPy (inside shard_map they are tracers)
        max_q = int(ql_np.max(initial=0))
        inner = backend_router.resolve("nw_pairs", q_len=max_q)
        if inner is not nw_identity_batch:
            from ..ops.gpu_kernels import nw_pairs_jit, nw_config

            inner = partial(nw_pairs_jit, cpt=nw_config(max_q))
        sharded = shard_map(
            inner,
            mesh=mesh,
            in_specs=(P("data", None), P("data"), P("data", None), P("data")),
            out_specs=(P("data"), P("data"), P("data")),
            check_vma=False,
        )
        D, mt, ln = jax.jit(sharded)(qp, qlp, tp, tlp)
        return D[:Pn], mt[:Pn], ln[:Pn]

    return kernel
