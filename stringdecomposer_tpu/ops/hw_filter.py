"""Batched infix (HW-mode) edit distance — the ed_thr monomer pre-filter.

The reference optionally shrinks the DP's monomer set per chunk: edlib HW
distance of every monomer against the chunk, keep the best plus all within
ed_thr, ordered by (distance, input index) (reference: src/main.cpp:128-149).
Distance in HW mode is the minimum over all end positions of a semi-global
NW with a free start in the target:

    D[0][j] = 0,  D[i][0] = i,
    D[i][j] = min(D[i-1][j-1] + sub, D[i-1][j] + 1, D[i][j-1] + 1)
    dist = min_j D[m][j]

Edit distance is unique (no co-optimal-path ambiguity), so a plain batched
scan over chunk positions reproduces edlib's HW numbers exactly. The scan
carries one column over monomer positions per (window, monomer) pair; the
within-column "up" chain folds into a prefix min (same trick as
ops/chain_dp.py).

On the device the filter does not make the chain DP cheaper (shapes are
static; dropped monomers become masked rows) — it exists for output parity:
the monomer subset and its ORDER change tie-breaking in the DP and
traceback.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

BIG = np.int32(1 << 28)


@jax.jit
def hw_distance_batch(
    windows: jnp.ndarray,  # [B, W] int8 codes (pad with a never-matching code)
    window_lens: jnp.ndarray,  # [B] int32
    mono: jnp.ndarray,  # [M, L] int8 codes (PAD_CODE-padded)
    mono_lens: jnp.ndarray,  # [M] int32
) -> jnp.ndarray:
    """Returns dist[B, M] int32: HW edit distance of each monomer vs each
    window (min over end positions, free target prefix)."""
    B, W = windows.shape
    M, L = mono.shape
    mono_i = mono.astype(jnp.int32)
    win_i = windows.astype(jnp.int32)
    i_idx = jnp.arange(L + 1, dtype=jnp.int32)  # [L+1] monomer axis rows
    # column rows: row 0 = boundary, rows 1..L = monomer positions
    mono_col = jnp.concatenate(
        [jnp.full((M, 1), -1, jnp.int32), mono_i], axis=1
    )  # [M, L+1]
    end_mask = i_idx[None, :] == mono_lens[:, None]  # [M, L+1] one-hot at m

    D0 = jnp.broadcast_to(i_idx[None, None, :], (B, M, L + 1))  # D[i][0] = i
    best0 = jnp.sum(jnp.where(end_mask[None], D0, 0), axis=2)  # dist at j=0: m

    def step(carry, x):
        D, best = carry
        wchar, j = x  # [B], scalar
        sub = jnp.where(mono_col[None] == wchar[:, None, None], 0, 1)  # [B, M, L+1]
        left = D + 1
        diag = jnp.concatenate([jnp.full_like(D[:, :, :1], BIG), D[:, :, :-1]], axis=2) + sub
        cand = jnp.minimum(left, diag)
        cand = cand.at[:, :, 0].set(0)  # free target prefix: D[0][j] = 0
        Dn = jax.lax.cummin(cand - i_idx[None, None, :], axis=2) + i_idx[None, None, :]
        endD = jnp.sum(jnp.where(end_mask[None], Dn, 0), axis=2)  # [B, M]
        active = j <= window_lens  # [B]
        best = jnp.where(active[:, None], jnp.minimum(best, endD), best)
        D = jnp.where(active[:, None, None], Dn, D)
        return (D, best), None

    xs = (win_i[:, :].T, jnp.arange(1, W + 1, dtype=jnp.int32))
    (_, best), _ = jax.lax.scan(step, (D0, best0), xs)
    return best


def filter_monomers(
    dist_row: np.ndarray, ed_thr: int
) -> np.ndarray:
    """Per-window monomer selection + ordering (src/main.cpp:135-149):
    sort by (distance, input index); keep index 0 (the best) plus every
    subsequent monomer with distance <= ed_thr. Returns the kept original
    indices in DP order."""
    order = np.lexsort((np.arange(len(dist_row)), dist_row))
    keep = [order[0]]
    for idx in order[1:]:
        if dist_row[idx] <= ed_thr:
            keep.append(idx)
    return np.asarray(keep, dtype=np.int32)


@partial(jax.jit, static_argnames=("ed_thr",))
def filter_monomers_device(
    dist: jnp.ndarray,  # [B, M] int32 HW distances
    mono: jnp.ndarray,  # [M, L] int8 monomer codes
    mono_lens: jnp.ndarray,  # [M] int32
    ed_thr: int,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Device-side batched filter_monomers: the (distance, index) ordering
    and keep rule of src/main.cpp:135-149, producing the per-window DP
    monomer tensor ON DEVICE. For large monomer libraries (M >> 24) this
    replaces a host-side [B, M, L] rebuild + upload per batch with two
    argsorts and a row gather that never leave HBM; only the tiny [B, M]
    permutation (for mapping block monomer ids back to input indices)
    returns to the host.

    Returns (mono_w [B, M, L], lens_w [B, M] with dropped rows = 0,
    perm [B, M] original indices in DP order)."""
    B, M = dist.shape
    idx = jnp.arange(M, dtype=jnp.int32)[None, :]
    # ascending (distance, input index) == the reference lexsort
    order = jnp.argsort(dist * jnp.int32(M) + idx, axis=1)
    dist_sorted = jnp.take_along_axis(dist, order, axis=1)
    kept = (idx == 0) | (dist_sorted <= ed_thr)
    # stable-compact kept rows to the front, preserving the sorted order
    order2 = jnp.argsort(jnp.where(kept, 0, jnp.int32(M)) + idx, axis=1)
    perm = jnp.take_along_axis(order, order2, axis=1)
    n_keep = kept.sum(axis=1)
    lens_w = jnp.where(idx < n_keep[:, None], mono_lens[perm], 0)
    return mono[perm], lens_w, perm
