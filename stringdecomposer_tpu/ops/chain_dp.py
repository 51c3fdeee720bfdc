"""Chain DP — the compute core, as a plain JAX/XLA program.

Re-design of the reference's AlignPartClassicDP + traceback
(reference: src/main.cpp:151-270). The reference fills a ~180 MB score cube
with a per-cell triple loop, then walks it backward cell-by-cell. Neither the
cube nor the walk suits an accelerator (device-memory footprint, and the
device->host link is far too slow to ship per-cell data), so this program:

  1. carries ONE [M, L] score column through a `lax.scan` over read positions
     (the only sequential axis), updating all M*L cells per step;
  2. folds the same-column deletion chain into a constant-offset prefix max
     (dp[k] = k*del + cummax_k(cand[k] - k*del) — exactly the reference
     recurrence, see ops/oracle.py for the derivation);
  3. propagates, per cell, the *block start position* the reference traceback
     would reach from that cell (`sp`), so no backward pass over scores is
     ever needed. The propagation replays the traceback's exact priority
     (deletion, insertion — unguarded at k==0, diagonal, enter;
     src/main.cpp:242-263):
       - deletion chains: the backward deletion-walk provably lands on the
         EARLIEST k' achieving the prefix max, so `sp` rides a pair-cummax
         (score, payload) whose tie rule keeps the earlier element;
       - insertion inherits sp from the cell above, diagonal from the
         upper-left, and `enter` stamps the current read position.
  4. walks the block chain ON DEVICE (ops: argmax + gathers, one iteration
     per block, ~W/170 iterations) and returns only [max_blocks] block
     records per window — a few KB instead of megabytes.

Outputs are bit-identical to the reference traceback (tested against the
NumPy spec and reference-binary fixtures in tests/test_chain_dp.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

INF = -1_000_000  # src/main.cpp:156
NEG = np.int32(-(1 << 30))  # numpy scalar: importing must not init a backend
READ_PAD = 6  # never equals any monomer code (monomer pad is 5)


def _pair_cummax(t: jnp.ndarray, payload: jnp.ndarray, axis: int):
    """Cumulative (max, argpayload) with ties keeping the EARLIER element —
    the landing rule of the reference's backward deletion walk."""

    def combine(a, b):  # a is the earlier prefix
        ta, pa = a
        tb, pb = b
        take_b = tb > ta
        return jnp.where(take_b, tb, ta), jnp.where(take_b, pb, pa)

    return jax.lax.associative_scan(combine, (t, payload), axis=axis)


@partial(
    jax.jit,
    static_argnames=("ins", "dele", "mismatch", "match", "max_blocks", "return_debug"),
)
def chain_dp_forward(
    windows: jnp.ndarray,  # [B, W] int8, padded with READ_PAD
    window_lens: jnp.ndarray,  # [B] int32 true lengths
    mono: jnp.ndarray,  # [M, L] int8, padded with PAD_CODE(5)
    mono_lens: jnp.ndarray,  # [M] int32
    ins: int = -1,
    dele: int = -1,
    mismatch: int = -1,
    match: int = 1,
    max_blocks: int = 0,  # 0 -> W (safe upper bound: one block per position)
    return_debug: bool = False,  # additionally return (chain, end, spend)
):
    """Chain DP + on-device block walk over a batch of read windows.

    Returns (blocks[B, max_blocks, 4] int32, counts[B] int32) where each
    block record is (monomer_idx, start, end, identity) in window-local
    coordinates, ordered by ascending position, identical to the reference
    traceback output.
    """
    B, W = windows.shape
    if max_blocks == 0:
        max_blocks = W
    # mono may be shared [M, L] or per-window [B, M, L] (the ed_thr filter
    # reorders/masks the monomer set per chunk, src/main.cpp:135-149)
    if mono.ndim == 2:
        mono_b = jnp.broadcast_to(mono[None], (B,) + mono.shape)
        lens_b = jnp.broadcast_to(mono_lens[None], (B,) + mono_lens.shape)
    else:
        mono_b, lens_b = mono, mono_lens
    M, L = mono_b.shape[1], mono_b.shape[2]
    k_idx = jnp.arange(L, dtype=jnp.int32)
    k_del = k_idx * dele  # [L]
    end_mask = k_idx[None, None, :] == (lens_b[:, :, None] - 1)  # [B, M, L]
    mono_i32 = mono_b.astype(jnp.int32)

    def mm_of(read_char):  # [B] -> [B, M, L]
        return jnp.where(
            mono_i32 == read_char[:, None, None], match, mismatch
        ).astype(jnp.int32)

    def masked_ends(dp):  # [B, M, L] -> [B, M] scores at dp[i][j][len_j-1]
        return jnp.max(jnp.where(end_mask, dp, NEG), axis=2)

    def gather_ends(x):  # payload at end cells (sum works: one cell per row)
        return jnp.sum(jnp.where(end_mask, x, 0), axis=2)

    # ---- init column i = 0 (src/main.cpp:171-182); sp == 0 everywhere:
    # the traceback always closes the running block with start 0 when it
    # reaches read position 0 (src/main.cpp:258-262).
    read0 = windows[:, 0].astype(jnp.int32)
    mm0 = mm_of(read0)
    cand0 = (k_idx[None, None, :] - 1) * dele + mm0
    cand0 = cand0.at[:, :, 0].set(mm0[:, :, 0])
    dp0 = jax.lax.cummax(cand0 - k_del[None, None, :], axis=2) + k_del[None, None, :]
    sp0 = jnp.zeros_like(dp0)

    # ---- scan over read positions 1..W-1 (src/main.cpp:183-208) ----
    def step(carry, x):
        prev, sp_prev = carry
        read_char, i = x
        mm = mm_of(read_char.astype(jnp.int32))
        chain_i = jnp.max(jnp.where(end_mask, prev, NEG), axis=(1, 2))  # [B]
        prev_shift = jnp.concatenate(
            [jnp.full_like(prev[:, :, :1], NEG), prev[:, :, :-1]], axis=2
        )
        sp_prev_shift = jnp.concatenate(
            [jnp.zeros_like(sp_prev[:, :, :1]), sp_prev[:, :, :-1]], axis=2
        )
        enter = chain_i[:, None, None] + mm + k_del[None, None, :]
        diag = prev_shift + mm
        diag = diag.at[:, :, 0].set(NEG)
        insr = prev + ins
        cand = jnp.maximum(enter, jnp.maximum(diag, insr.at[:, :, 0].set(NEG)))
        t = cand - k_del[None, None, :]
        dp = jax.lax.cummax(t, axis=2) + k_del[None, None, :]
        # Payload decided *as if* this cell explains the score, with the
        # reference's check order at the landing cell: ins, diag, enter
        # (src/main.cpp:245-257). At strict-increase cells dp == cand, so
        # these checks compare the same numbers the reference traceback
        # compares; flat cells inherit the earlier payload via the pair scan.
        ins_eq = dp == prev + ins  # unguarded at k==0, like src/main.cpp:245
        diag_eq = dp == diag  # diag already NEG at k==0
        candstart = jnp.where(ins_eq, sp_prev, jnp.where(diag_eq, sp_prev_shift, i))
        _, sp = _pair_cummax(t, candstart, axis=2)
        new_carry = (dp, sp)
        return new_carry, (chain_i, masked_ends(dp), gather_ends(sp))

    xs = (windows[:, 1:].T, jnp.arange(1, W, dtype=jnp.int32))
    (_, _), (chain_rest, end_rest, spend_rest) = jax.lax.scan(step, (dp0, sp0), xs)

    chain = jnp.concatenate(
        [jnp.full((B, 1), INF, dtype=jnp.int32), chain_rest.T], axis=1
    )  # [B, W]
    end = jnp.concatenate([masked_ends(dp0)[:, None], end_rest.swapaxes(0, 1)], axis=1)
    spend = jnp.concatenate([gather_ends(sp0)[:, None], spend_rest.swapaxes(0, 1)], axis=1)

    blocks, counts = block_walk(end, spend, window_lens, max_blocks)
    if return_debug:
        return blocks, counts, (chain, end, spend)
    return blocks, counts


@partial(jax.jit, static_argnames=("max_blocks",))
def block_walk(
    end: jnp.ndarray,  # [B, W, M] int32 (padded monomer rows must be < all real)
    spend: jnp.ndarray,  # [B, W, M] int32
    window_lens: jnp.ndarray,  # [B] int32
    max_blocks: int,
):
    """On-device block walk (replaces the backward traceback;
    src/main.cpp:209-269). One iteration per block. The chain score at a
    block start s is recomputed as max_j end[s-1, j] (it equals the stored
    dp[s][M][0] of the reference by construction, src/main.cpp:185)."""

    def walk_one(end_w, spend_w, n):
        j0 = jnp.argmax(end_w[n - 1])  # strict > keeps smallest j (ref:209-216)

        def cond(st):
            i, _, _, _ = st
            return i >= 0

        def body(st):
            i, j, cnt, blocks = st
            s = spend_w[i, j]
            prev_col = end_w[jnp.maximum(s - 1, 0)]  # column before the block
            chain_s = jnp.max(prev_col)
            ident = jnp.where(s > 0, end_w[i, j] - chain_s, end_w[i, j])
            blocks = blocks.at[cnt].set(
                jnp.stack([j.astype(jnp.int32), s, i, ident])
            )
            # chain jump: first monomer whose end cell equals the chain score
            # == leftmost argmax of the previous column (src/main.cpp:230-237)
            nj = jnp.argmax(prev_col).astype(jnp.int32)
            return s - 1, nj, cnt + 1, blocks

        blocks0 = jnp.zeros((max_blocks, 4), dtype=jnp.int32)
        _, _, cnt, blocks = jax.lax.while_loop(
            cond, body, (n - 1, j0.astype(jnp.int32), jnp.int32(0), blocks0)
        )
        return blocks, cnt

    return jax.vmap(walk_one)(end, spend, window_lens)


def build_window_batch(
    read_codes_list: list[np.ndarray], width: int
) -> tuple[np.ndarray, np.ndarray]:
    """Right-pad encoded windows to a fixed width with READ_PAD."""
    B = len(read_codes_list)
    out = np.full((B, width), READ_PAD, dtype=np.int8)
    lens = np.empty(B, dtype=np.int32)
    for b, rc in enumerate(read_codes_list):
        out[b, : len(rc)] = rc
        lens[b] = len(rc)
    return out, lens
