"""Batched fitting-alignment %identity — replaces every edlib use.

The reference rescoring stage (main.py:29-60) calls the edlib binding ~48
times per monomer block (NW mode, task="path"), parses the extended CIGAR,
and computes identity = 100 * (match columns) / (total alignment columns).
The catch: among co-optimal alignments, (matches, columns) depends on WHICH
path edlib's traceback picks. Reading the vendored traceback
(reference: src/edlib.cpp:945-1144) gives its exact local preference at every
cell, in priority order:

    1. up   (consume a query char;  uScore + 1 == currScore)
    2. left (consume a target char; lScore + 1 == currScore)
    3. diagonal (match if ulScore == currScore else mismatch)

The Ukkonen band never alters this choice (out-of-band neighbours have
distance > k >= d, so their equality can never hold), hence a full-matrix
forward propagation of (distance, matches, columns) under the same
preference reproduces edlib's returned path exactly — no CIGAR, no
traceback, no per-cell output. On the device the within-column "up" chain folds
into a constant-offset prefix min (pair-cummin with earliest-tie, the same
trick as ops/chain_dp.py), so the kernel is a single scan over target
positions, batched over thousands of (block, monomer) pairs.

Identity is then 100 * matches / columns computed in float64 on host with
the reference's exact operation order (main.py:59-60).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

BIG = np.int32(1 << 28)


# ---------------------------------------------------------------------------
# NumPy executable spec (tested against reference-edlib fixtures)
# ---------------------------------------------------------------------------
def nw_path_spec(q: str | np.ndarray, t: str | np.ndarray) -> tuple[int, int, int]:
    """Returns (edit_distance, match_columns, total_columns) of the alignment
    edlib NW task="path" would return. O(|q|*|t|) NumPy reference."""
    qa = np.frombuffer(q.encode(), dtype=np.uint8) if isinstance(q, str) else q
    ta = np.frombuffer(t.encode(), dtype=np.uint8) if isinstance(t, str) else t
    m, n = len(qa), len(ta)
    D = np.zeros((m + 1, n + 1), dtype=np.int32)
    D[:, 0] = np.arange(m + 1)
    D[0, :] = np.arange(n + 1)
    for i in range(1, m + 1):
        sub = (qa[i - 1] != ta) .astype(np.int32)
        for j in range(1, n + 1):
            D[i, j] = min(D[i - 1, j] + 1, D[i, j - 1] + 1, D[i - 1, j - 1] + sub[j - 1])
    # forward pred propagation with the edlib traceback preference
    Mt = np.zeros((m + 1, n + 1), dtype=np.int32)
    Ln = np.zeros((m + 1, n + 1), dtype=np.int32)
    Mt[0, :] = 0
    Ln[0, :] = np.arange(n + 1)
    Mt[:, 0] = 0
    Ln[:, 0] = np.arange(m + 1)
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            if D[i - 1, j] + 1 == D[i, j]:  # up first (src/edlib.cpp:1023)
                Mt[i, j] = Mt[i - 1, j]
                Ln[i, j] = Ln[i - 1, j] + 1
            elif D[i, j - 1] + 1 == D[i, j]:  # then left (src/edlib.cpp:1057)
                Mt[i, j] = Mt[i, j - 1]
                Ln[i, j] = Ln[i, j - 1] + 1
            else:  # diagonal (src/edlib.cpp:1088)
                is_match = qa[i - 1] == ta[j - 1]
                Mt[i, j] = Mt[i - 1, j - 1] + (1 if is_match else 0)
                Ln[i, j] = Ln[i - 1, j - 1] + 1
    return int(D[m, n]), int(Mt[m, n]), int(N := Ln[m, n])


def aai_from_counts(matches: int, total: int) -> float:
    """identity in percent, with the reference's float op order
    (main.py:56-60: aai /= total; return aai*100)."""
    if total == 0:
        return 0.0
    return (float(matches) / float(total)) * 100.0


# ---------------------------------------------------------------------------
# Batched JAX kernel
# ---------------------------------------------------------------------------
@partial(jax.jit, static_argnames=())
def nw_identity_batch(
    q: jnp.ndarray,  # [P, Lq] int8/int32 codes, padded arbitrarily
    q_lens: jnp.ndarray,  # [P] int32
    t: jnp.ndarray,  # [P, Lt] codes
    t_lens: jnp.ndarray,  # [P] int32
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Returns (dist[P], matches[P], columns[P]) int32 of the edlib-preferred
    co-optimal NW alignment for every pair. Scan over target positions; the
    carried state is one DP column per pair."""
    P, Lq = q.shape
    _, Lt = t.shape
    q = q.astype(jnp.int32)
    t = t.astype(jnp.int32)
    i_idx = jnp.arange(Lq + 1, dtype=jnp.int32)  # [Lq+1]
    qcol = jnp.concatenate([jnp.full((P, 1), -1, jnp.int32), q], axis=1)  # align rows

    def pair_cummin(tv, mt, ln):
        def combine(a, b):  # earlier prefix is a; ties keep a (earliest)
            ta_, ma_, la_ = a
            tb_, mb_, lb_ = b
            take_b = tb_ < ta_
            return (
                jnp.where(take_b, tb_, ta_),
                jnp.where(take_b, mb_, ma_),
                jnp.where(take_b, lb_, la_),
            )

        return jax.lax.associative_scan(combine, (tv, mt, ln), axis=1)

    # initial column j=0: D=i, Mt=0, Ln=i
    D0 = jnp.broadcast_to(i_idx[None, :], (P, Lq + 1))
    Mt0 = jnp.zeros((P, Lq + 1), jnp.int32)
    Ln0 = D0

    # outputs captured when j == t_len (and for t_len == 0 from the init col)
    qmask = i_idx[None, :] == q_lens[:, None]  # [P, Lq+1] one-hot at q_len

    def capture(D, Mt, Ln):
        g = lambda x: jnp.sum(jnp.where(qmask, x, 0), axis=1)
        return g(D), g(Mt), g(Ln)

    out0 = capture(D0, Mt0, Ln0)

    def step(carry, j):
        D, Mt, Ln, out = carry
        tchar = jnp.take_along_axis(t, (j - 1)[None].repeat(P)[:, None], axis=1)[:, 0]
        sub = jnp.where(qcol == tchar[:, None], 0, 1)  # [P, Lq+1]; row 0 unused
        # candidates (left, diag) with the traceback's left-before-diag tie
        leftD = D + 1
        diagD = jnp.concatenate([jnp.full((P, 1), BIG, jnp.int32), D[:, :-1]], axis=1) + sub
        take_left = leftD <= diagD
        candD = jnp.where(take_left, leftD, diagD)
        Mt_shift = jnp.concatenate([jnp.zeros((P, 1), jnp.int32), Mt[:, :-1]], axis=1)
        Ln_shift = jnp.concatenate([jnp.zeros((P, 1), jnp.int32), Ln[:, :-1]], axis=1)
        candMt = jnp.where(take_left, Mt, Mt_shift + (1 - sub))
        candLn = jnp.where(take_left, Ln, Ln_shift) + 1
        # boundary row i=0: D=j, Mt=0, Ln=j
        candD = candD.at[:, 0].set(j)
        candMt = candMt.at[:, 0].set(0)
        candLn = candLn.at[:, 0].set(j)
        # fold the up-chain: D[i] = min(cand[i], D[i-1]+1); pair-cummin with
        # earliest tie reproduces the backward up-walk's landing cell
        tv = candD - i_idx[None, :]
        lv = candLn - i_idx[None, :]
        run, runMt, runLn = pair_cummin(tv, candMt, lv)
        Dn = run + i_idx[None, :]
        Mtn = runMt
        Lnn = runLn + i_idx[None, :]
        # freeze columns past each pair's target length
        active = (j <= t_lens)[:, None]
        Dn = jnp.where(active, Dn, D)
        Mtn = jnp.where(active, Mtn, Mt)
        Lnn = jnp.where(active, Lnn, Ln)
        hit = (j == t_lens)[:, None]
        cap = capture(Dn, Mtn, Lnn)
        out = tuple(jnp.where(hit[:, 0], c, o) for c, o in zip(cap, out))
        return (Dn, Mtn, Lnn, out), None

    (_, _, _, out), _ = jax.lax.scan(
        step, (D0, Mt0, Ln0, out0), jnp.arange(1, Lt + 1, dtype=jnp.int32)
    )
    return out


def nw_identity_cross(q, q_lens, targets, t_lens, q_len: int = 0):
    """[n * M, 2] int32 (distance, columns) for every (query row, target
    row) pair, row-major — the cross product of the packed finishing path,
    on nw_identity_batch. Traceable; q_len (the CUDA route's column bound)
    is unused here."""
    n, M = q.shape[0], targets.shape[0]
    D, _, Ln = nw_identity_batch(
        jnp.repeat(q, M, axis=0), jnp.repeat(q_lens, M),
        jnp.tile(targets, (n, 1)), jnp.tile(t_lens, n),
    )
    return jnp.stack([D, Ln], axis=1)


def _blocks_from_read(read_dev, starts, lens, Lq):
    """[n_pad, Lq] int32 block substrings gathered from the resident read."""
    lane = jnp.arange(Lq, dtype=jnp.int32)[None, :]
    idx = jnp.clip(starts[:, None] + lane, 0, read_dev.shape[0] - 1)
    return jnp.where(lane < lens[:, None], read_dev[idx].astype(jnp.int32), 7)


def _homo_collapse(q, lens, Lq):
    """Run-collapse rows on device: keep first lane + change points, then a
    stable argsort on (dropped, lane) compacts kept chars to the front."""
    lane = jnp.arange(Lq, dtype=jnp.int32)[None, :]
    prev = jnp.roll(q, 1, axis=1)
    keep = ((lane == 0) | (q != prev)) & (lane < lens[:, None])
    order = jnp.argsort(~keep, axis=1, stable=True)
    qh = jnp.take_along_axis(q, order, axis=1)
    hlens = keep.sum(axis=1).astype(jnp.int32)
    return jnp.where(lane < hlens[:, None], qh, 7), hlens


def nw_identity_packed_both(
    read_dev,  # [N] int8 device codes (uploaded once per read)
    starts,  # np [n] block starts (into read_dev)
    lens,  # np [n] block lengths (end - start + 1)
    t_raw_dev,  # [M, Lt] device monomer codes (raw)
    tl_raw,  # np [M] int32
    t_homo_dev,  # [M, Lt_h] device monomer codes (homopolymer-compressed)
    tl_homo,  # np [M] int32
    n_pad: int,
    Lq: int,
    backend: str = "auto",
) -> jnp.ndarray:
    """Device-side finishing dispatch: extracts the n block substrings from
    the resident read, homopolymer-compresses them ON DEVICE, scores the
    (block x monomer) cross product for both variants, and returns ONE
    [2, n_pad * M, 2] int32 array of (distance, columns) per (variant,
    pair) — the only device->host transfer of the group. matches =
    columns - distance. Replaces the per-block convert_read slicing of the
    reference (main.py:124-142).

    n_pad (row menu) and Lq (>= max block length) are the caller's compile
    keys; the NW route is picked from the longest block (homo-collapse never
    lengthens a sequence), rounded to the kernel's 32-row granularity so it
    adds few keys of its own."""
    from .backend import resolve

    max_len = int(np.asarray(lens).max()) if len(lens) else 0
    q_len = -(-(max_len + 1) // 32) * 32 - 1
    cross = resolve("nw_cross", backend, q_len=q_len)
    starts_np = np.zeros(n_pad, dtype=np.int32)
    lens_np = np.zeros(n_pad, dtype=np.int32)
    starts_np[: len(starts)] = starts
    lens_np[: len(lens)] = lens
    return _packed_both_jit(
        read_dev, jnp.asarray(starts_np), jnp.asarray(lens_np),
        t_raw_dev, jnp.asarray(np.asarray(tl_raw, dtype=np.int32)),
        t_homo_dev, jnp.asarray(np.asarray(tl_homo, dtype=np.int32)),
        Lq=Lq, cross=cross, q_len=q_len,
    )


@partial(jax.jit, static_argnames=("Lq", "cross", "q_len"))
def _packed_both_jit(read_dev, starts, lens, t_raw, tl_raw, t_homo, tl_homo,
                     Lq, cross, q_len):
    q = _blocks_from_read(read_dev, starts, lens, Lq)
    raw = cross(q, lens, t_raw, tl_raw, q_len=q_len)
    qh, hlens = _homo_collapse(q, lens, Lq)
    homo = cross(qh, hlens, t_homo, tl_homo, q_len=q_len)
    return jnp.stack([raw, homo])
