"""General batched sequence alignment — full capability parity with the
reference's vendored edlib (src/edlib.h:36-71: modes NW/SHW/HW x tasks
DISTANCE/LOC/PATH, k-threshold, standard+extended CIGAR).

Batched design: instead of Myers bit-parallelism (src/edlib.cpp:409-430),
a scalar-CPU trick, the whole DP column is one [P, Lq+1] int32 vector per
pair, a `lax.scan` walks target positions, and the within-column insertion
chain folds into a prefix-min ladder — so thousands of pairs align per device
step. Small-k NW queries take a Ukkonen band fast path (dp_banded_nw_batch:
O(k*Lt) cells, src/edlib.cpp:559-571 restored; ~18x at 20 kbp / k=16);
otherwise the full DP is cheaper than banding bookkeeping at batch scale and
the k-threshold applies to the exact distance afterwards. Both preserve
edlib's contract (dist > k => editDistance == -1, src/edlib.h:102-108).

Semantics matched to the reference (validated against 210 reference-generated
fixtures in tests/fixtures/align_cases.json):

  - mode NW: global; endLocations = [|t|-1] (src/edlib.cpp:215-219).
  - mode SHW: target suffix free; all optimal end locations, ascending.
  - mode HW: target prefix+suffix free; per-end start location = the
    SMALLEST start achieving the optimum, via edlib's reversed-SHW rule
    "taking last location as start" (src/edlib.cpp:226-258).
  - task path: alignment/CIGAR for the FIRST (start, end) pair only
    (src/edlib.cpp:269-272), with the traceback's local preference
    up > left > diagonal (src/edlib.cpp:1023-1088) reproduced by forward
    move recording (see ops/identity.py for the equivalence argument).
  - memory-bounded path: like the reference (src/edlib.cpp:1188-1213),
    pairs whose move table exceeds a size bound switch to Hirschberg
    divide-and-conquer (_hirschberg_ops) — O(Lq+Lt) memory, a co-optimal
    path with deterministic split ties, batched per recursion level.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

BIG = np.int32(1 << 28)

# edlib edit-op codes (src/edlib.h:84-87); I consumes query, D consumes target
EDOP_MATCH, EDOP_INSERT, EDOP_DELETE, EDOP_MISMATCH = 0, 1, 2, 3
_EXT_CHAR = {EDOP_MATCH: "=", EDOP_INSERT: "I", EDOP_DELETE: "D", EDOP_MISMATCH: "X"}
_STD_CHAR = {EDOP_MATCH: "M", EDOP_INSERT: "I", EDOP_DELETE: "D", EDOP_MISMATCH: "M"}


def _encode_any(seq) -> np.ndarray:
    """Arbitrary byte alphabet -> uint8 codes (edlib supports any chars,
    src/edlib.cpp:1420-1459; equality is all the DP ever needs)."""
    if isinstance(seq, np.ndarray):
        return seq.astype(np.uint8)
    if isinstance(seq, bytes):
        return np.frombuffer(seq, dtype=np.uint8)
    return np.frombuffer(str(seq).encode(), dtype=np.uint8)


@dataclass
class _EqEncoding:
    """Role-specific transforms implementing the additionalEqualities
    relation (src/edlib.h:133-149; symmetric like the reference's
    equalityDefinitions matrix, src/edlib.cpp:1429-1437).

    mode="mask" (<=32 distinct symbols, the hot path): q_lut maps a byte to
    an int32 bitmask over the compact alphabet, t_lut to a compact id, and
    the kernels test equality with `(qmask >> id) & 1` — two vector ops, no
    gather. mode="lut" (up to the reference's full 256-symbol transformed
    alphabet, src/edlib.cpp:16,1420-1459): q_lut maps to `id * stride`,
    t_lut to `id`, and the kernels gather `eq_flat[q + t]` — one gather per
    cell, slower but contract-complete. Compact id 0 is reserved for
    padding/boundaries (row/column 0 of eq_flat is all zeros, so pads never
    match anything)."""

    mode: str
    q_lut: np.ndarray  # [256] int32
    t_lut: np.ndarray  # [256] int32
    eq_flat: np.ndarray | None  # [stride*stride] int32 ("lut" mode only)


def _equality_encoding(codes_list: list[np.ndarray], pairs) -> _EqEncoding:
    present = np.zeros(256, dtype=bool)
    for c in codes_list:
        present[np.unique(c)] = True
    symbols = np.flatnonzero(present)
    A = len(symbols)
    eq = np.zeros((256, 256), dtype=bool)
    eq[symbols, symbols] = True
    for a, b in pairs:
        ca = ord(a) if isinstance(a, str) else int(a)
        cb = ord(b) if isinstance(b, str) else int(b)
        eq[ca, cb] = eq[cb, ca] = True
    if A <= 32:
        ids = np.full(256, 0, dtype=np.int32)
        ids[symbols] = np.arange(A, dtype=np.int32)
        # build in int64 then reinterpret: a mask using bit 31 (exactly 32
        # symbols) overflows a direct int32 assignment, but the kernels'
        # shift-and-1 extraction is bit-pattern exact either way
        mask64 = np.zeros(256, dtype=np.int64)
        for b in symbols:
            mask64[b] = sum(1 << int(ids[s]) for s in symbols if eq[b, s])
        return _EqEncoding("mask", mask64.astype(np.uint32).view(np.int32),
                           ids, None)
    # big-alphabet fallback: ids 1..A (0 = pad sentinel), flat equality table
    stride = A + 1
    ids = np.zeros(256, dtype=np.int32)
    ids[symbols] = np.arange(1, A + 1, dtype=np.int32)
    eq_flat = np.zeros(stride * stride, dtype=np.int32)
    for a in symbols:
        row = ids[a] * stride
        for b in symbols:
            if eq[a, b]:
                eq_flat[row + ids[b]] = 1
    return _EqEncoding("lut", ids * stride, ids, eq_flat)


# ---------------------------------------------------------------------------
# Device kernels
# ---------------------------------------------------------------------------
def _sub_fn(qcol, tchar, use_mask, eq_flat=None):
    """Substitution cost row: 0 where query/target chars are "equal".

    use_mask=False: qcol holds raw codes, plain equality. use_mask=True:
    qcol holds per-position int32 bitmasks over a compact alphabet and
    tchar holds compact symbol ids — ((qmask >> id) & 1) implements the
    additionalEqualities relation (src/edlib.h:133-149) with two cheap
    vector ops and no gather (alphabet must fit 32 symbols; IUPAC's 16 do).
    With eq_flat (alphabets up to 256 symbols, _EqEncoding mode="lut"):
    qcol holds id*stride, tchar holds ids, equality is one gather.
    """
    if eq_flat is not None:
        return 1 - jnp.take(eq_flat, qcol + tchar[:, None], axis=0)
    if use_mask:
        return 1 - ((qcol >> tchar[:, None]) & 1)
    return jnp.where(qcol == tchar[:, None], 0, 1)


@partial(jax.jit, static_argnames=("free_target_prefix", "use_mask"))
def dp_lastrow_batch(
    q: jnp.ndarray,  # [P, Lq] uint8/int32 codes (bitmasks if use_mask)
    q_lens: jnp.ndarray,  # [P] int32
    t: jnp.ndarray,  # [P, Lt]
    t_lens: jnp.ndarray,  # [P] int32 (only used by callers for masking)
    free_target_prefix: bool = False,  # True for HW
    use_mask: bool = False,
    eq_flat: jnp.ndarray | None = None,  # big-alphabet equality table
) -> jnp.ndarray:
    """Last DP row per pair: out[p, j] = dist(q[p][:q_len], t[p][:j]) for
    j = 0..Lt (entries past t_len are garbage; callers mask)."""
    P, Lq = q.shape
    _, Lt = t.shape
    q = q.astype(jnp.int32)
    t = t.astype(jnp.int32)
    i_idx = jnp.arange(Lq + 1, dtype=jnp.int32)
    boundary_code = jnp.zeros((P, 1), jnp.int32) if use_mask else jnp.full((P, 1), -1, jnp.int32)
    qcol = jnp.concatenate([boundary_code, q], axis=1)
    qmask = i_idx[None, :] == q_lens[:, None]

    def capture(C):
        return jnp.sum(jnp.where(qmask, C, 0), axis=1)

    C0 = jnp.broadcast_to(i_idx[None, :], (P, Lq + 1))

    def step(C, j):
        tchar = jax.lax.dynamic_index_in_dim(t, j - 1, axis=1, keepdims=False)
        sub = _sub_fn(qcol, tchar, use_mask, eq_flat)
        left = C + 1
        diag = jnp.concatenate([jnp.full((P, 1), BIG, jnp.int32), C[:, :-1]], axis=1) + sub
        cand = jnp.minimum(left, diag)
        boundary = jnp.int32(0) if free_target_prefix else j
        cand = cand.at[:, 0].set(boundary)
        Cn = jax.lax.cummin(cand - i_idx[None, :], axis=1) + i_idx[None, :]
        return Cn, capture(Cn)

    _, rows = jax.lax.scan(step, C0, jnp.arange(1, Lt + 1, dtype=jnp.int32))
    return jnp.concatenate([capture(C0)[:, None], rows.T], axis=1)  # [P, Lt+1]


@partial(jax.jit, static_argnames=("k", "use_mask"))
def dp_banded_nw_batch(
    q: jnp.ndarray,  # [P, Lq] codes (bitmasks if use_mask)
    q_lens: jnp.ndarray,  # [P] int32
    t: jnp.ndarray,  # [P, Lt]
    t_lens: jnp.ndarray,  # [P] int32
    k: int,
    use_mask: bool = False,
    eq_flat: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Banded NW distance (the Ukkonen band, src/edlib.cpp:559-571, as a
    lane window): only the 2k+1 diagonals |i-j| <= k are computed, so a
    small-k query costs O(k*Lt) instead of O(Lq*Lt) — the reference's
    small-k asymptotics restored. Returns dist[P] (exact wherever the true
    distance is <= k; anything larger may surface as > k, which is all the
    k-threshold contract needs). Pairs with |q_len - t_len| > k are
    unreachable and must be pre-filtered by the caller.

    Layout: lane b of the carried band holds row i = j + b - k at target
    column j; `left` is a lane shift of the previous column, `diag` stays in
    lane, the within-column up-chain folds with the same cummin trick as
    dp_lastrow_batch, and the query chars under the band come from one
    dynamic_slice per step (the band slides one position per column).
    """
    P, Lq = q.shape
    _, Lt = t.shape
    Bw = 2 * k + 1
    q = q.astype(jnp.int32)
    t = t.astype(jnp.int32)
    b_idx = jnp.arange(Bw, dtype=jnp.int32)[None, :]  # [1, Bw]
    # pad q so the slice [j-1-k, j-1+k] never clamps (a clamped
    # dynamic_slice would shift real lanes): k+1 junk in front, enough junk
    # behind to cover target columns past the query end
    pad_code = 0 if use_mask else -1
    qp = jnp.pad(q, ((0, 0), (k + 1, k + 1 + max(0, Lt - Lq))),
                 constant_values=pad_code)

    # column j=0: D(i, 0) = i at lane b = i + k
    i0 = b_idx - k
    D0 = jnp.where((i0 >= 0) & (i0 <= q_lens[:, None]), i0, BIG)
    D0 = jnp.broadcast_to(D0, (P, Bw))

    def step(carry, j):
        D = carry
        i_here = j + b_idx - k  # [1, Bw] row of lane b at column j
        tchar = jax.lax.dynamic_index_in_dim(t, j - 1, axis=1, keepdims=False)
        qwin = jax.lax.dynamic_slice_in_dim(qp, j, Bw, axis=1)  # q[i_here - 1]
        sub = _sub_fn(qwin, tchar, use_mask, eq_flat)
        left = jnp.concatenate([D[:, 1:], jnp.full((P, 1), BIG, jnp.int32)], axis=1) + 1
        diag = D + sub
        cand = jnp.minimum(left, diag)
        # boundary row i==0 enters the band while j <= k
        cand = jnp.where(i_here == 0, j, cand)
        valid = (i_here >= 0) & (i_here <= q_lens[:, None])
        cand = jnp.where(valid, cand, BIG)
        # up-chain: D[b] = min(cand[b], D[b-1] + 1) along lanes
        Dn = jax.lax.cummin(cand - b_idx, axis=1) + b_idx
        Dn = jnp.where(valid, Dn, BIG)
        # capture at (q_len, t_len): lane b = q_len - j + k when j == t_len
        hit = (j == t_lens)[:, None] & (i_here == q_lens[:, None])
        return Dn, jnp.sum(jnp.where(hit, Dn, 0), axis=1)

    _, caps = jax.lax.scan(step, D0, jnp.arange(1, Lt + 1, dtype=jnp.int32))
    dist = caps.sum(axis=0)  # exactly one hit column per pair (t_len >= 1)
    # t_len == 0 pairs: dist = q_len (all deletions of q ... insertions)
    return jnp.where(t_lens == 0, q_lens, dist)


@partial(jax.jit, static_argnames=("k", "use_mask"))
def dp_banded_lastrow_batch(
    q: jnp.ndarray,  # [P, Lq]
    q_lens: jnp.ndarray,  # [P] int32
    t: jnp.ndarray,  # [P, Lt]
    t_lens: jnp.ndarray,  # [P] int32
    k: int,
    use_mask: bool = False,
    eq_flat: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Banded NW final COLUMN: out[p, b] = dist(q[p][:i], t[p][:t_len]) for
    row i = t_len + b - k, b in [0, 2k], BIG for rows outside [0, q_len] or
    values whose optimal path leaves the band (Ukkonen: any banded value
    <= k is exact). This is the Hirschberg sweep primitive: with the pair's
    exact distance d known, every forward/backward last-row sweep only needs
    rows |i - jm| <= d, so a level costs O(k * Lt_sub) cells instead of
    O(Lq * Lt_sub) (src/edlib.cpp:547-571's banding, recast as a sliding
    lane window; same recurrence as dp_banded_nw_batch)."""
    P, Lq = q.shape
    _, Lt = t.shape
    Bw = 2 * k + 1
    q = q.astype(jnp.int32)
    t = t.astype(jnp.int32)
    b_idx = jnp.arange(Bw, dtype=jnp.int32)[None, :]
    pad_code = 0 if use_mask else -1
    qp = jnp.pad(q, ((0, 0), (k + 1, k + 1 + max(0, Lt - Lq))),
                 constant_values=pad_code)
    i0 = b_idx - k
    D0 = jnp.where((i0 >= 0) & (i0 <= q_lens[:, None]), i0, BIG)
    D0 = jnp.broadcast_to(D0, (P, Bw))
    cap0 = jnp.where(t_lens[:, None] == 0, D0, BIG)

    def step(carry, j):
        D, cap = carry
        i_here = j + b_idx - k
        tchar = jax.lax.dynamic_index_in_dim(t, j - 1, axis=1, keepdims=False)
        qwin = jax.lax.dynamic_slice_in_dim(qp, j, Bw, axis=1)
        sub = _sub_fn(qwin, tchar, use_mask, eq_flat)
        left = jnp.concatenate([D[:, 1:], jnp.full((P, 1), BIG, jnp.int32)], axis=1) + 1
        diag = D + sub
        cand = jnp.minimum(left, diag)
        cand = jnp.where(i_here == 0, j, cand)
        valid = (i_here >= 0) & (i_here <= q_lens[:, None])
        cand = jnp.where(valid, cand, BIG)
        Dn = jax.lax.cummin(cand - b_idx, axis=1) + b_idx
        Dn = jnp.where(valid, Dn, BIG)
        cap = jnp.where((j == t_lens)[:, None], Dn, cap)
        return (Dn, cap), None

    (_, cap), _ = jax.lax.scan(step, (D0, cap0),
                               jnp.arange(1, Lt + 1, dtype=jnp.int32))
    return jnp.minimum(cap, BIG)


def _banded_final_column(q, ql, t, tl, k, use_mask=False, eq_flat=None):
    """One banded final-column sweep (dp_banded_lastrow_batch), rows split
    across the devices."""
    return _rows_sharded(
        lambda a, b, c, d, *e: dp_banded_lastrow_batch(
            a, b, c, d, k=int(k), use_mask=use_mask,
            eq_flat=e[0] if e else None),
        (q, ql, t, tl), (eq_flat,) if eq_flat is not None else ())


# minimum padded length before exact NW distance (k=-1) switches from the
# one full sweep to banded k-doubling (below this the full sweep is one
# cheap fused call and doubling only adds dispatches)
NW_DOUBLING_MIN_LEN = 4096

# data-parallel alignment batches: "auto" shards the batch axis of every
# routed sweep across the visible devices (shard_map, zero collectives —
# rows are independent pairs; the reference's pip-edlib binding is strictly
# single-core). "off" pins single-device. Read once at import.
ALIGN_DATA_PARALLEL = os.environ.get("SDTPU_ALIGN_DP", "auto")


def _rows_sharded(fn, arrays, replicated=()):
    """Run fn(*arrays, *replicated) with the leading axis of `arrays` split
    across the device mesh — bit-identical to single-device execution (each
    row is an independent pair; out rows come back in order). Falls through
    on one device, small batches, or SDTPU_ALIGN_DP=off."""
    devs = jax.devices()
    n_dev = len(devs)
    P0 = arrays[0].shape[0]
    if ALIGN_DATA_PARALLEL == "off" or n_dev == 1 or P0 < n_dev:
        return fn(*arrays, *replicated)
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec

    Pp = -(-P0 // n_dev) * n_dev
    padded = [np.pad(np.asarray(a), [(0, Pp - P0)] + [(0, 0)] * (a.ndim - 1))
              for a in arrays]
    mesh = Mesh(np.array(devs), ("rows",))
    specs = tuple(PartitionSpec("rows") for _ in arrays) + tuple(
        PartitionSpec() for _ in replicated)
    out = shard_map(
        lambda *xs: fn(*xs), mesh=mesh, in_specs=specs,
        out_specs=PartitionSpec("rows"), check_vma=False,
    )(*padded, *replicated)
    return out[:P0]


def _rows_pow2(arr, lens, idx):
    """Row-subset arr[idx] padded to a pow2 row count (length-0 filler rows)
    so the doubling loop's shrinking subsets reuse cached jits."""
    m = 1 << max(0, int(np.ceil(np.log2(max(1, len(idx))))))
    out = np.zeros((m, arr.shape[1]), arr.dtype)
    out[: len(idx)] = arr[idx]
    lo = np.zeros(m, np.int32)
    lo[: len(idx)] = lens[idx]
    return out, lo


def _lastrow_sharded(q, ql, t, tl, free_target_prefix=False, use_mask=False,
                     eq_flat=None):
    """dp_lastrow_batch with the batch axis split over the mesh (rows are
    independent pairs; eq_flat replicates)."""
    return _rows_sharded(
        lambda a, b, c, d, *e: dp_lastrow_batch(
            a, b, c, d, free_target_prefix=free_target_prefix,
            use_mask=use_mask, eq_flat=e[0] if e else None),
        (q, ql, t, tl), (eq_flat,) if eq_flat is not None else ())


def _banded_nw_dist(q, ql, t, tl, k, use_mask=False, eq_flat=None):
    """Banded NW distance (dp_banded_nw_batch), rows split across the
    devices. Callers pre-filter pairs with |q_len - t_len| > k, and only
    results <= k are trusted (Ukkonen)."""
    return np.asarray(_rows_sharded(
        lambda a, b, c, d, *e: dp_banded_nw_batch(
            a, b, c, d, k=int(k), use_mask=use_mask,
            eq_flat=e[0] if e else None),
        (q, ql, t, tl), (eq_flat,) if eq_flat is not None else ()))


@partial(jax.jit, static_argnames=("k", "use_mask"))
def dp_banded_shw_rows(
    q: jnp.ndarray,  # [P, Lq]
    q_lens: jnp.ndarray,  # [P] int32
    t: jnp.ndarray,  # [P, Lt]
    t_lens: jnp.ndarray,  # [P] int32
    k: int,
    use_mask: bool = False,
    eq_flat: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Banded SHW scan: out[p, j] = dist(q[p][:q_len], t[p][:j]) for target
    columns j in 1..Lt wherever row q_len is inside the band (|q_len - j|
    <= k), BIG elsewhere/past t_len. SHW cells are plain NW cells (the
    suffix is free only at the READ-OFF row), so the |i - j| <= k band is
    exact for values <= k — every end location the k-threshold contract can
    observe lies in columns [q_len - k, q_len + k], making a small-k SHW
    scan O(k * min(Lt, q_len + k)) instead of O(Lq * Lt)."""
    P, Lq = q.shape
    _, Lt = t.shape
    Bw = 2 * k + 1
    q = q.astype(jnp.int32)
    t = t.astype(jnp.int32)
    b_idx = jnp.arange(Bw, dtype=jnp.int32)[None, :]
    pad_code = 0 if use_mask else -1
    qp = jnp.pad(q, ((0, 0), (k + 1, k + 1 + max(0, Lt - Lq))),
                 constant_values=pad_code)
    i0 = b_idx - k
    D0 = jnp.where((i0 >= 0) & (i0 <= q_lens[:, None]), i0, BIG)
    D0 = jnp.broadcast_to(D0, (P, Bw))

    def step(D, j):
        i_here = j + b_idx - k
        tchar = jax.lax.dynamic_index_in_dim(t, j - 1, axis=1, keepdims=False)
        qwin = jax.lax.dynamic_slice_in_dim(qp, j, Bw, axis=1)
        sub = _sub_fn(qwin, tchar, use_mask, eq_flat)
        left = jnp.concatenate([D[:, 1:], jnp.full((P, 1), BIG, jnp.int32)], axis=1) + 1
        diag = D + sub
        cand = jnp.minimum(left, diag)
        cand = jnp.where(i_here == 0, j, cand)
        valid = (i_here >= 0) & (i_here <= q_lens[:, None])
        cand = jnp.where(valid, cand, BIG)
        Dn = jax.lax.cummin(cand - b_idx, axis=1) + b_idx
        Dn = jnp.where(valid, Dn, BIG)
        hit = (i_here == q_lens[:, None]) & (j <= t_lens)[:, None]
        return Dn, jnp.min(jnp.where(hit, Dn, BIG), axis=1)

    _, rows = jax.lax.scan(step, D0, jnp.arange(1, Lt + 1, dtype=jnp.int32))
    return rows.T  # [P, Lt], column j at index j-1


@partial(jax.jit, static_argnames=("use_mask",))
def dp_hw_chunk_batch(
    q: jnp.ndarray,  # [P, R] query rows 1..R (codes/bitmasks)
    q_lens: jnp.ndarray,  # [P] int32
    c_in: jnp.ndarray,  # [P, R+1] carried DP column (rows 0..R)
    t: jnp.ndarray,  # [P, Wc] target chunk
    t_lens: jnp.ndarray,  # [P] int32 valid columns in this chunk
    wm_thr: jnp.ndarray,  # [] int32: k, the liveness threshold
    use_mask: bool = False,
    eq_flat: jnp.ndarray | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """One target chunk of the adaptive-row HW scan (the batched recast of the
    reference's banded semi-global pass, src/edlib.cpp:547-728: edlib prunes
    rows per 64-row block adaptively; here rows are pruned per CHUNK, with
    the live height decided on the host between chunks).

    HW recurrence over live rows 0..R (row 0 free: a new start at every
    column, src/edlib.cpp:226-239). Returns (c_out [P, R+1], ends [P, Wc] =
    row-q_len value per column or BIG when q_len > R, wm [P] = highest row
    with value <= wm_thr after the chunk). Values along any alignment path
    are non-decreasing, so a cell whose value exceeds k can never lie on a
    path to a <= k end; rows above the carried watermark reach <= k only
    within Wc diagonal steps plus k insertion climbs, which bounds the next
    chunk's live height (see _hw_banded_scan)."""
    P, R = q.shape
    _, Wc = t.shape
    q = q.astype(jnp.int32)
    t = t.astype(jnp.int32)
    i_idx = jnp.arange(R + 1, dtype=jnp.int32)
    boundary_code = jnp.zeros((P, 1), jnp.int32) if use_mask else jnp.full((P, 1), -1, jnp.int32)
    qcol = jnp.concatenate([boundary_code, q], axis=1)
    row_valid = i_idx[None, :] <= q_lens[:, None]
    endmask = i_idx[None, :] == q_lens[:, None]

    def step(C, j):
        tchar = jax.lax.dynamic_index_in_dim(t, j, axis=1, keepdims=False)
        sub = _sub_fn(qcol, tchar, use_mask, eq_flat)
        left = C + 1
        diag = jnp.concatenate([jnp.full((P, 1), BIG, jnp.int32), C[:, :-1]], axis=1) + sub
        cand = jnp.minimum(left, diag)
        cand = cand.at[:, 0].set(0)  # free start (HW prefix)
        Cn = jax.lax.cummin(cand - i_idx[None, :], axis=1) + i_idx[None, :]
        Cn = jnp.where(row_valid, Cn, BIG)
        Cn = jnp.where((j < t_lens)[:, None], Cn, C)  # past t_len: freeze
        endv = jnp.sum(jnp.where(endmask & (j < t_lens)[:, None], Cn, 0), axis=1)
        endv = jnp.where((q_lens <= R) & (j < t_lens), endv, BIG)
        return Cn, endv

    c_out, ends = jax.lax.scan(step, c_in, jnp.arange(Wc, dtype=jnp.int32))
    live = (c_out <= wm_thr) & row_valid
    wm = jnp.max(jnp.where(live, i_idx[None, :], -1), axis=1)
    return c_out, ends.T, wm


def _hw_banded_scan(q, ql, t, tl, k, use_mask, eq_flat, Wc=256):
    """Adaptive-row HW scan over column chunks: returns [P, Lt] row-q_len
    values (BIG where provably > k). Host decides each chunk's live height
    R from the previous chunk's watermark wm = highest row with value <= k:
    a cell in the next chunk with value <= k climbs at most Wc rows
    diagonally plus k by insertions above a carried live row (or a fresh
    row-0 start), so R = wm + Wc + k + 1 covers every observable cell.
    Typical cost: O((k + Wc) * Lt) cells vs the full O(Lq * Lt) — the
    data-dependent pruning of the reference's banded semi-global pass
    (src/edlib.cpp:547-728) at chunk granularity."""
    P, Lq = q.shape
    Lt = t.shape[1]
    BIGI = int(BIG)
    out = np.full((P, Lt), BIGI, dtype=np.int64)
    # column 0: C(i, 0) = i (free start at row 0 only helps later columns)
    wm = np.minimum(np.asarray(ql, dtype=np.int64), k)
    C_cur = None
    R_prev = 0
    for j0 in range(0, Lt, Wc):
        if not np.any(j0 < np.asarray(tl)):
            break
        need = int(wm.max()) + Wc + k + 1
        R = min(Lq, 1 << int(np.ceil(np.log2(max(8, need)))))
        c_in = np.full((P, R + 1), BIGI, dtype=np.int32)
        if C_cur is None:
            base = np.arange(R + 1, dtype=np.int32)[None, :]
            c_in = np.where(base <= np.asarray(ql)[:, None], base, BIGI).astype(np.int32)
        else:
            keep = min(R_prev, R) + 1
            c_in[:, :keep] = C_cur[:, :keep]
        tl_chunk = np.clip(np.asarray(tl) - j0, 0, Wc).astype(np.int32)
        c_out, ends, wm_d = dp_hw_chunk_batch(
            q[:, :R], np.minimum(np.asarray(ql), R).astype(np.int32),
            jnp.asarray(c_in), t[:, j0 : j0 + Wc], tl_chunk,
            jnp.int32(k), use_mask=use_mask, eq_flat=eq_flat)
        ends = np.asarray(ends)
        w = min(Wc, Lt - j0)
        out[:, j0 : j0 + w] = ends[:, :w]
        # rows past R are pruned (> k): their end values must not leak
        out[:, j0 : j0 + w] = np.where(
            (np.asarray(ql)[:, None] <= R), out[:, j0 : j0 + w], BIGI)
        C_cur = np.asarray(c_out)
        wm = np.maximum(np.asarray(wm_d, dtype=np.int64), 0)
        R_prev = R
    return out


@partial(jax.jit, static_argnames=("use_mask",))
def dp_moves_batch(
    q: jnp.ndarray, q_lens: jnp.ndarray, t: jnp.ndarray, t_lens: jnp.ndarray,
    use_mask: bool = False,
    eq_flat: jnp.ndarray | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Global-NW move matrix for the PATH task.

    Returns (dist[P], moves[P, Lt+1, Lq+1] uint8) where moves[p, j, i] is the
    traceback step at cell (i, j) under edlib's preference order
    up > left > diag (src/edlib.cpp:1023-1088): EDOP_INSERT consumes a query
    char (up), EDOP_DELETE a target char (left), MATCH/MISMATCH both.
    Boundary rows/columns are handled by the host walker.
    """
    P, Lq = q.shape
    _, Lt = t.shape
    q = q.astype(jnp.int32)
    t = t.astype(jnp.int32)
    i_idx = jnp.arange(Lq + 1, dtype=jnp.int32)
    boundary_code = jnp.zeros((P, 1), jnp.int32) if use_mask else jnp.full((P, 1), -1, jnp.int32)
    qcol = jnp.concatenate([boundary_code, q], axis=1)
    qmask = i_idx[None, :] == q_lens[:, None]
    C0 = jnp.broadcast_to(i_idx[None, :], (P, Lq + 1))

    def step(C, j):
        tchar = jax.lax.dynamic_index_in_dim(t, j - 1, axis=1, keepdims=False)
        sub = _sub_fn(qcol, tchar, use_mask, eq_flat)
        left = C + 1
        diag = jnp.concatenate([jnp.full((P, 1), BIG, jnp.int32), C[:, :-1]], axis=1) + sub
        cand = jnp.minimum(left, diag)
        cand = cand.at[:, 0].set(j)
        Cn = jax.lax.cummin(cand - i_idx[None, :], axis=1) + i_idx[None, :]
        up = jnp.concatenate([jnp.full((P, 1), BIG, jnp.int32), Cn[:, :-1]], axis=1) + 1
        mv = jnp.where(
            up == Cn,
            EDOP_INSERT,
            jnp.where(
                left == Cn,
                EDOP_DELETE,
                jnp.where(sub == 0, EDOP_MATCH, EDOP_MISMATCH),
            ),
        ).astype(jnp.uint8)
        return Cn, (mv, jnp.sum(jnp.where(qmask, Cn, 0), axis=1))

    Cend, (moves, rowvals) = jax.lax.scan(step, C0, jnp.arange(1, Lt + 1, dtype=jnp.int32))
    mv0 = jnp.zeros((1, P, Lq + 1), jnp.uint8) + EDOP_INSERT  # column j=0: up
    moves = jnp.concatenate([mv0, moves], axis=0).transpose(1, 0, 2)  # [P, Lt+1, Lq+1]
    row0 = jnp.sum(jnp.where(qmask, C0, 0), axis=1)
    allrows = jnp.concatenate([row0[:, None], rowvals.T], axis=1)
    dist = jnp.take_along_axis(allrows, t_lens[:, None], axis=1)[:, 0]
    return dist, moves


# ---------------------------------------------------------------------------
# Host assembly
# ---------------------------------------------------------------------------
def _pad_batch(codes: list[np.ndarray], mult: int = 16) -> tuple[np.ndarray, np.ndarray]:
    n = len(codes)
    L = max(1, max((len(c) for c in codes), default=1))
    L = (L + mult - 1) // mult * mult
    dtype = codes[0].dtype if codes else np.uint8
    arr = np.zeros((n, L), dtype=dtype)
    lens = np.zeros(n, dtype=np.int32)
    for i, c in enumerate(codes):
        arr[i, : len(c)] = c
        lens[i] = len(c)
    return arr, lens


def _moves_to_ops(moves: np.ndarray, qlen: int, tlen: int) -> list[int]:
    """Walk moves[j, i] back from (qlen, tlen) to the edit-op list."""
    i, j = qlen, tlen
    ops: list[int] = []
    while i > 0 or j > 0:
        if i == 0:
            mv = EDOP_DELETE
        elif j == 0:
            mv = EDOP_INSERT
        else:
            mv = int(moves[j, i])
        ops.append(mv)
        if mv == EDOP_INSERT:
            i -= 1
        elif mv == EDOP_DELETE:
            j -= 1
        else:
            i -= 1
            j -= 1
    ops.reverse()
    return ops


def _ops_to_cigar(ops: list[int], extended: bool) -> str:
    """Run-length encode an edit-op list into a CIGAR string
    (query-perspective; src/edlib.cpp:298-347)."""
    chars = _EXT_CHAR if extended else _STD_CHAR
    out: list[str] = []
    pos = 0
    n = len(ops)
    while pos < n:
        c = chars[ops[pos]]
        run = pos
        while run < n and chars[ops[run]] == c:
            run += 1
        out.append(f"{run - pos}{c}")
        pos = run
    return "".join(out)


def _moves_to_cigar(moves: np.ndarray, qlen: int, tlen: int, extended: bool) -> str:
    return _ops_to_cigar(_moves_to_ops(moves, qlen, tlen), extended)


# ---------------------------------------------------------------------------
# Memory-bounded PATH: Hirschberg divide & conquer
# ---------------------------------------------------------------------------
# Mirrors the reference's algorithm switch (src/edlib.cpp:1188-1213: full
# traceback while the table fits a memory bound, else
# obtainAlignmentHirschberg, src/edlib.cpp:1234-1400): pairs whose move
# matrix would exceed MOVES_CELL_LIMIT cells take the divide-and-conquer
# route in O(Lq+Lt) memory. Like the reference, the two routes return
# (possibly different) co-optimal paths: Hirschberg splits are resolved with
# a deterministic smallest-row tie rule, the base cases reuse the canonical
# up>left>diag move recorder, and the reported cost always equals the exact
# edit distance (asserted in tests on both validity and optimality).
MOVES_CELL_LIMIT = 1 << 22  # ~4 MB of move codes per pair
# one dp_moves_batch call materializes [n, maxLt+1, maxLq+1] uint8 cells —
# the per-PAIR limit above does not bound the per-CALL allocation, so both
# the batched PATH route and the Hirschberg base cases cap aggregate cells
# per call too (round-2 advisor finding: 4096 pairs just under the pair
# limit would otherwise allocate tens of GB)
MOVES_BATCH_CELL_BUDGET = 1 << 26  # ~64 MB of move codes per device call

# The reference's Hirschberg engage rule (src/edlib.cpp:1190-1213): switch to
# the memory-bounded route when the traceback data would exceed 1 MB, sized as
# (2*sizeof(Word) + sizeof(int)) * ceil(Lq/64) * Lt + 2*sizeof(int) * Lt.
# Byte parity REQUIRES mirroring this exactly: the two routes return different
# co-optimal paths (measured: 17/90 reference CIGARs change when the bound is
# shrunk), so route choice is output-visible, not just a memory knob. Tests
# shrink this module global to force engagement on small fixtures.
HB_MEM_BOUND = 1 << 20


def _hb_engages(lq: int, lt: int) -> bool:
    """True when the reference would take the Hirschberg route
    (src/edlib.cpp:1190-1193, Word = 8 bytes, int = 4 bytes)."""
    return (2 * 8 + 4) * (-(-lq // 64)) * lt + 2 * 4 * lt >= HB_MEM_BOUND


def _hirschberg_ops(q: np.ndarray, t: np.ndarray,
                    cell_limit: int | None = None,
                    enc: _EqEncoding | None = None,
                    dist: int | None = None) -> list[int]:
    """With `enc` set, q/t are RAW byte codes and every DP call transforms
    on the fly — necessary because the recursion's forward/backward sweeps
    SWAP query/target roles (the symmetry dist(a, b) = dist(b, a) holds for
    the relation, but the q/t representations are role-specific).
    `dist` = the pair's exact NW distance when the caller knows it (the
    align_batch path always does); it seeds the exact-distance-first banding
    of every sweep and is otherwise established by banded k-doubling."""
    if cell_limit is None:
        # resolve the module global at CALL time so a configured/patched
        # MOVES_CELL_LIMIT governs the router in _align_chunk and this
        # recursion's base cases consistently (round-2 advisor finding:
        # a def-time default let the two limits disagree)
        cell_limit = MOVES_CELL_LIMIT
    # Edit-op list of an optimal NW alignment of (q, t) without ever
    # materializing an O(Lq*Lt) table. The recursion is processed level by
    # level so every split's forward/backward last rows — exactly what
    # dp_lastrow_batch computes — run as ONE device batch per level.
    use_mask = enc is not None
    eq_flat = None
    if use_mask:
        # lut-mode ids reach A <= 256, past uint8; keep them int32
        t_dtype = np.uint8 if enc.eq_flat is None else np.int32
        as_q = lambda x: enc.q_lut[x]
        as_t = lambda x: enc.t_lut[x].astype(t_dtype)
        eq_flat = enc.eq_flat
    else:
        as_q = as_t = lambda x: x
    # power-of-two padded batches: recursion levels roughly halve problem
    # sizes, so shapes repeat across levels and runs instead of compiling a
    # fresh megabase-length scan per level (a compile storm measured at ~6x
    # the actual compute)
    def _pad_pow2(codes):
        arr, lens = _pad_batch(codes, mult=1)
        L = 1 << max(4, int(np.ceil(np.log2(max(1, arr.shape[1])))))
        n = 1 << max(0, int(np.ceil(np.log2(len(codes)))))
        out = np.zeros((n, L), dtype=arr.dtype)  # int32 for equality bitmasks
        out[: len(codes), : arr.shape[1]] = arr
        return out, np.pad(lens, (0, n - len(codes)))

    def _exact_nw_dist(sq, st) -> int:
        """Exact NW distance by banded k-doubling (src/edlib.cpp:194-212):
        try a small band, trust the result iff it is <= k (Ukkonen), else
        double. Only runs when the caller did not already know the distance
        (the align_batch path always does)."""
        lq, lt = len(sq), len(st)
        kd = abs(lq - lt) + 8
        while True:
            kd = 1 << int(np.ceil(np.log2(max(2, kd))))  # pow2: cached jits
            if 4 * kd + 2 >= min(lq, lt):
                qb, qlb = _pad_pow2([as_q(sq)])
                tb, tlb = _pad_pow2([as_t(st)])
                row = np.asarray(dp_lastrow_batch(
                    qb, qlb, tb, tlb, use_mask=use_mask, eq_flat=eq_flat))[0]
                return int(row[lt])
            qb, qlb = _pad_pow2([as_q(sq)])
            tb, tlb = _pad_pow2([as_t(st)])
            d = int(_banded_nw_dist(
                qb, qlb, tb, tlb, k=int(kd), use_mask=use_mask,
                eq_flat=eq_flat)[0])
            if d <= kd:
                return d
            kd *= 2

    if dist is None:
        dist = _exact_nw_dist(q, t) if len(q) and len(t) else None

    # ordered segments: ("ops", list) resolved | ("task", q, t, d) pending,
    # d = the segment's exact NW distance, inherited from the parent split
    # (leftScore/rightScore, src/edlib.cpp:1377-1385) so every level's
    # sweeps can band to |i - jm| <= d instead of sweeping all Lq rows —
    # the exact-distance-first banding that turns a level from O(Lq * Lt)
    # into O(d * Lt) cells
    segments: list[tuple] = [("task", q, t, dist)]
    while any(s[0] == "task" for s in segments):
        # classify pending tasks: trivial, base (move matrix fits), split
        base: list[int] = []
        jobs: list[int] = []
        for si, seg in enumerate(segments):
            if seg[0] != "task":
                continue
            _, sq, st, sd = seg
            lq, lt = len(sq), len(st)
            if lq == 0:
                segments[si] = ("ops", [EDOP_DELETE] * lt)
            elif lt == 0:
                segments[si] = ("ops", [EDOP_INSERT] * lq)
            elif lt == 1 or (not _hb_engages(lq, lt)
                             and (lq + 1) * (lt + 1) <= cell_limit):
                # base iff the reference's own recursion would base here
                # (obtainAlignment re-checks the 1MB rule per level,
                # src/edlib.cpp:1190-1213) AND the move tensor fits our
                # device budget; lt == 1 must be a base case regardless (a
                # split's jm would be 0 and never make progress) — the
                # reference can only hit Hirschberg at lt == 1 for Lq in the
                # tens of millions (28 bytes/row), far past its own limits
                base.append(si)
            else:
                jobs.append(si)
        # resolve base tasks in bounded bites (the [n, Lt+1, Lq+1] move
        # tensor of a batch must stay well under HBM)
        bite_n = max(1, MOVES_BATCH_CELL_BUDGET // cell_limit)
        for bs in range(0, len(base), bite_n):
            part = base[bs : bs + bite_n]
            qb, qlb = _pad_pow2([as_q(segments[si][1]) for si in part])
            tb, tlb = _pad_pow2([as_t(segments[si][2]) for si in part])
            _, moves = dp_moves_batch(qb, qlb, tb, tlb, use_mask=use_mask,
                                      eq_flat=eq_flat)
            moves = np.asarray(moves)
            for ii, si in enumerate(part):
                _, sq, st = segments[si][:3]
                segments[si] = ("ops", _moves_to_ops(moves[ii], len(sq), len(st)))
        if not jobs:
            continue
        nj = len(jobs)
        # band half-width for this level: the fwd sweep needs rows
        # |i - jm| <= d, the bwd sweep (reversed coordinates) additionally
        # shifts by |lq - lt|; one shared static width keeps the jit cached
        kb = 0
        max_lq = 0
        for si in jobs:
            _, sq, st, sd = segments[si]
            kb = max(kb, int(sd) + abs(len(sq) - len(st)))
            max_lq = max(max_lq, len(sq))
        kb = 1 << int(np.ceil(np.log2(max(8, kb + 1))))
        banded = 2 * kb + 1 < max_lq
        if banded:
            fq, ft, bq, bt = [], [], [], []
            for si in jobs:
                _, sq, st, _ = segments[si]
                jm = len(st) // 2
                # fwd band at column jm: f[i] = dist(q[:i], t[:jm])
                fq.append(sq)
                ft.append(st[:jm].copy())
                # bwd band at column lt-jm of the reversed halves:
                # cap[i''] = dist(q[i:], t[jm:]) with i = lq - i''
                bq.append(sq[::-1].copy())
                bt.append(st[jm:][::-1].copy())
            q_all, ql_all = _pad_pow2([as_q(x) for x in fq + bq])
            t_all, tl_all = _pad_pow2([as_t(x) for x in ft + bt])
            caps = np.asarray(_banded_final_column(
                q_all, ql_all, t_all, tl_all, k=int(kb),
                use_mask=use_mask, eq_flat=eq_flat))
        else:
            # narrow problems: the plain full sweep is cheaper than band
            # bookkeeping. fwd[i] = dist(q[:i], t[:jm]) = lastrow(t[:jm], q)
            fwd_q, fwd_t, bwd_q, bwd_t = [], [], [], []
            for si in jobs:
                _, sq, st, _ = segments[si]
                jm = len(st) // 2
                fwd_q.append(st[:jm].copy())
                fwd_t.append(sq)
                bwd_q.append(st[jm:][::-1].copy())
                bwd_t.append(sq[::-1].copy())
            q_all, ql_all = _pad_pow2([as_q(x) for x in fwd_q + bwd_q])
            t_all, tl_all = _pad_pow2([as_t(x) for x in fwd_t + bwd_t])
            rows = np.asarray(_lastrow_sharded(
                q_all, ql_all, t_all, tl_all, use_mask=use_mask,
                eq_flat=eq_flat))
        # replace each split task by (left half, right half) in order;
        # reverse iteration keeps earlier segment indices valid
        for rev_i in range(nj - 1, -1, -1):
            si = jobs[rev_i]
            _, sq, st, sd = segments[si]
            lq, lt = len(sq), len(st)
            jm = lt // 2
            best_tot = int(sd)
            if banded:
                fband = caps[rev_i]
                bband = caps[nj + rev_i]

                def fval(i):
                    bi = i - jm + kb
                    return int(fband[bi]) if 0 <= bi < 2 * kb + 1 else int(BIG)

                def bval(i):
                    bi = (lq - i) - (lt - jm) + kb
                    return int(bband[bi]) if 0 <= bi < 2 * kb + 1 else int(BIG)
            else:
                f = rows[rev_i, : lq + 1]
                b = rows[nj + rev_i, : lq + 1][::-1]
                fval = lambda i: int(f[i])  # noqa: E731
                bval = lambda i: int(b[i])  # noqa: E731
            # the reference's split-row scan order (src/edlib.cpp:1326-1361):
            # interior rows ascending FIRST (its main loop covers left-column
            # rows 0..Lq-2, i.e. split rows 1..Lq-1), then the row-0 boundary
            # ("whole left target deleted"), then the row-Lq boundary. Plain
            # smallest-row argmin diverges whenever row 0 ties an interior
            # row — output-visible, so the order is mirrored exactly. Rows
            # outside the band cannot be optimal (f or b would exceed d), so
            # the banded scan sees every candidate the reference's does.
            i_star = -1
            lo = max(1, jm - kb) if banded else 1
            hi = min(lq - 1, jm + kb) if banded else lq - 1
            for i in range(lo, hi + 1):
                if fval(i) + bval(i) == best_tot:
                    i_star = i
                    break
            if i_star < 0 and fval(0) + bval(0) == best_tot:
                i_star = 0
            if i_star < 0:
                assert fval(lq) + bval(lq) == best_tot, (lq, lt, sd)
                i_star = lq
            segments[si : si + 1] = [
                ("task", sq[:i_star].copy(), st[:jm].copy(), fval(i_star)),
                ("task", sq[i_star:].copy(), st[jm:].copy(), bval(i_star)),
            ]
    out: list[int] = []
    for seg in segments:
        out.extend(seg[1])
    return out


def align_batch(
    queries: list,
    targets: list,
    mode: str = "NW",
    task: str = "distance",
    k: int = -1,
    cigar_format: str = "extended",
    chunk: int = 4096,
    additional_equalities: list[tuple] | None = None,
) -> list[dict]:
    """Batched edlibAlign (src/edlib.cpp:141-296): one result dict per pair
    with keys editDistance, endLocations, startLocations, cigar — identical
    values to the reference library (see tests/test_align.py).
    `additional_equalities`: (charA, charB) pairs treated as equal in the
    DP, exactly like EdlibEqualityPair (src/edlib.h:133-149)."""
    assert mode in ("NW", "SHW", "HW")
    assert task in ("distance", "locations", "path")
    P = len(queries)
    assert len(targets) == P
    results: list[dict] = []
    for s in range(0, P, chunk):
        results.extend(
            _align_chunk(
                [_encode_any(x) for x in queries[s : s + chunk]],
                [_encode_any(x) for x in targets[s : s + chunk]],
                mode, task, k, cigar_format, additional_equalities,
            )
        )
    return results


def _align_chunk(qs, ts, mode, task, k, cigar_format, equalities=None) -> list[dict]:
    use_mask = equalities is not None
    enc = None
    eq_flat = None
    qs_raw, ts_raw = qs, ts
    if use_mask:
        # queries become per-position bitmasks over the compact alphabet
        # (<=32 symbols) or id*stride gather offsets (lut mode, up to the
        # reference's 256, src/edlib.cpp:16,1420-1459); targets become
        # compact ids. The reversed-SHW start pass and the batched path
        # reuse these (slicing/reversing preserves per-position
        # transforms). Hirschberg gets the RAW arrays + the encoding
        # because its sweeps swap query/target roles.
        enc = _equality_encoding(qs + ts, equalities)
        eq_flat = enc.eq_flat
        t_dtype = np.uint8 if eq_flat is None else np.int32
        qs = [enc.q_lut[x] for x in qs]
        ts = [enc.t_lut[x].astype(t_dtype) for x in ts]
    q, ql = _pad_batch(qs)
    t, tl = _pad_batch(ts)
    n = len(qs)

    dists = np.empty(n, dtype=np.int64)
    ends: list[list[int]] = []
    # small-k fast path (NW only): the Ukkonen band computes O(k*Lt) cells
    # instead of O(Lq*Lt) (src/edlib.cpp:559-571); exact wherever the true
    # distance is <= k, which is all the k-threshold contract observes
    if mode == "NW" and 0 <= k and 2 * (2 * k + 1) < q.shape[1]:
        band = _banded_nw_dist(q, ql, t, tl, k=int(k), use_mask=use_mask,
                               eq_flat=eq_flat)
        for p in range(n):
            if abs(int(ql[p]) - int(tl[p])) > k:
                dists[p] = k + 1  # corner outside the band: provably > k
            else:
                dists[p] = band[p]
            ends.append([int(tl[p]) - 1])
    elif mode == "SHW" and 0 <= k and 2 * (2 * k + 1) < q.shape[1]:
        # small-k SHW fast path: every end the k-threshold contract can
        # observe lies in target columns [q_len - k, q_len + k] (SHW cells
        # are NW cells, so the |i - j| <= k band is exact for values <= k,
        # src/edlib.cpp:547-571); the scan also stops at max(q_len) + k
        # columns — O(k * q_len) cells instead of O(Lq * Lt)
        Ltc = min(t.shape[1], int(ql.max()) + k + 1)
        rows_b = np.asarray(_rows_sharded(
            lambda a, b, c, d, *e: dp_banded_shw_rows(
                a, b, c, d, k=int(k), use_mask=use_mask,
                eq_flat=e[0] if e else None),
            (q, ql, np.ascontiguousarray(np.asarray(t)[:, :Ltc]), tl),
            (eq_flat,) if eq_flat is not None else ()))
        for p in range(n):
            row = rows_b[p, : min(Ltc, int(tl[p]))]
            d0 = int(ql[p])  # column j=0: empty target, always exact
            m = int(row.min()) if row.size else d0
            dists[p] = min(m, d0)
            es = [-1] if d0 == dists[p] else []
            es += [int(j) for j in np.flatnonzero(row == dists[p])]
            ends.append(es)
    elif mode == "HW" and 0 <= k and q.shape[1] > 2 * (2 * k + 256):
        # small-k HW on a tall query: the adaptive-row chunk scan —
        # O((k + chunk) * Lt) cells instead of O(Lq * Lt), values above k
        # reported as BIG, which is all the k-threshold contract observes
        # (src/edlib.cpp:547-728's banded semi-global)
        rows_b = _hw_banded_scan(q, ql, t, tl, int(k), use_mask, eq_flat)
        for p in range(n):
            row = rows_b[p, : tl[p]]
            d0 = int(ql[p])  # column j=0: empty target span
            m = int(row.min()) if row.size else d0
            dists[p] = min(m, d0)
            es = [-1] if d0 == dists[p] else []
            es += [int(j) for j in np.flatnonzero(row == dists[p])]
            ends.append(es)
    elif mode == "NW" and k < 0 and q.shape[1] >= NW_DOUBLING_MIN_LEN:
        # exact distance by banded k-doubling — the reference's own k=-1
        # strategy (src/edlib.cpp:194-212): band kd, trust any result
        # <= kd (Ukkonen), double the unresolved pairs; a pair whose band
        # would cover most of its DP takes the one full sweep instead.
        # Similar pairs (d << L) cost O(d * Lt) instead of O(Lq * Lt).
        unresolved = np.arange(n)
        kd = 128
        while unresolved.size:
            m_len = np.minimum(ql[unresolved], tl[unresolved])
            go_full = unresolved[4 * kd + 2 >= m_len]
            unresolved = unresolved[4 * kd + 2 < m_len]
            for part in (go_full[s : s + 512] for s in
                         range(0, len(go_full), 512)):
                if not len(part):
                    continue
                qi, qli = _rows_pow2(q, ql, part)
                ti, tli = _rows_pow2(t, tl, part)
                rows = np.asarray(_lastrow_sharded(
                    qi, qli, ti, tli, use_mask=use_mask, eq_flat=eq_flat))
                dists[part] = rows[np.arange(len(part)), tl[part]]
            if unresolved.size:
                qi, qli = _rows_pow2(q, ql, unresolved)
                ti, tli = _rows_pow2(t, tl, unresolved)
                d = _banded_nw_dist(qi, qli, ti, tli, k=int(kd),
                                    use_mask=use_mask, eq_flat=eq_flat)
                d = d[: len(unresolved)]
                ok = (d <= kd) & (np.abs(ql[unresolved].astype(np.int64)
                                         - tl[unresolved]) <= kd)
                dists[unresolved[ok]] = d[ok]
                unresolved = unresolved[~ok]
            kd *= 2
        ends = [[int(tl[p]) - 1] for p in range(n)]
    else:
        rows = np.asarray(_lastrow_sharded(
            q, ql, t, tl, free_target_prefix=(mode == "HW"),
            use_mask=use_mask, eq_flat=eq_flat))
        for p in range(n):
            row = rows[p, : tl[p] + 1]
            if mode == "NW":
                dists[p] = row[tl[p]]
                ends.append([int(tl[p]) - 1])
            else:
                dists[p] = row.min()
                ends.append([int(j) - 1 for j in np.flatnonzero(row == dists[p])])

    # k-threshold contract (src/edlib.h:102-108)
    found = np.ones(n, dtype=bool) if k < 0 else (dists <= k)

    starts: list[list[int] | None] = [None] * n
    if task in ("locations", "path"):
        if mode == "HW":
            # reversed-SHW start derivation, batched over (pair, end) — the
            # smallest optimal start per end (src/edlib.cpp:240-258)
            idx: list[tuple[int, int]] = []
            rqs: list[np.ndarray] = []
            rts: list[np.ndarray] = []
            for p in range(n):
                if not found[p]:
                    continue
                # the optimal start for end e spans at most q_len + dist
                # target chars (each extra char costs >= 1), so the reversed
                # target slice is clamped to that length — the start pass on
                # a megabase target costs O((q_len + d)^2) per end, not
                # O(q_len * e) (the reference's banded semi-global pass,
                # src/edlib.cpp:547-571, achieves the same bound adaptively)
                span = int(ql[p]) + int(dists[p]) + 1
                for e in ends[p]:
                    if e >= 0:
                        idx.append((p, e))
                        rqs.append(qs[p][::-1].copy())
                        lo = max(-1, e - span)
                        rts.append(ts[p][e : lo if lo >= 0 else None : -1].copy())
            if idx:
                rq, rql = _pad_batch(rqs)
                rt, rtl = _pad_batch(rts)
                rrows = np.asarray(_lastrow_sharded(
                    rq, rql, rt, rtl, use_mask=use_mask, eq_flat=eq_flat))
            for p in range(n):
                if found[p]:
                    starts[p] = [0] * len(ends[p])
            for ii, (p, e) in enumerate(idx):
                row = rrows[ii, : rtl[ii] + 1]
                best_rev = int(np.flatnonzero(row == row.min()).max())  # last location
                starts[p][ends[p].index(e)] = e - (best_rev - 1)
        else:
            for p in range(n):
                if found[p]:
                    starts[p] = [0] * len(ends[p])

    cigars: list[str | None] = [None] * n
    if task == "path":
        # NW path on (q, t[start0:end0+1]) for the first location pair.
        # Pairs whose move matrix would blow MOVES_CELL_LIMIT take the
        # Hirschberg route (O(Lq+Lt) memory, src/edlib.cpp:1188-1213).
        extended = cigar_format == "extended"
        idx2: list[int] = []
        pqs: list[np.ndarray] = []
        pts: list[np.ndarray] = []
        for p in range(n):
            if not found[p] or not ends[p]:
                continue
            e0, s0 = ends[p][0], starts[p][0]
            if e0 < 0:
                cigars[p] = f"{len(qs[p])}I" if len(qs[p]) else ""
                continue
            sub_t = ts[p][s0 : e0 + 1].copy()
            if (_hb_engages(len(qs[p]), len(sub_t))
                    or (len(qs[p]) + 1) * (len(sub_t) + 1) > MOVES_CELL_LIMIT):
                cigars[p] = _ops_to_cigar(
                    _hirschberg_ops(qs_raw[p], ts_raw[p][s0 : e0 + 1].copy(),
                                    enc=enc, dist=int(dists[p])), extended)
                continue
            idx2.append(p)
            pqs.append(qs[p])
            pts.append(sub_t)
        if idx2:
            # aggregate cell budget: every pair passed the per-pair limit,
            # but the batch pads all pairs to the chunk max, so a chunk of
            # large-but-legal pairs could still allocate tens of GB. Group
            # size-sorted pairs into bites whose PADDED cell total stays
            # under MOVES_BATCH_CELL_BUDGET (order of device calls is
            # irrelevant: each writes its own cigars[p] slots).
            def _flush_moves(bite: list[int]) -> None:
                pq, pql = _pad_batch([pqs[ii] for ii in bite])
                pt, ptl = _pad_batch([pts[ii] for ii in bite])
                _, moves = dp_moves_batch(pq, pql, pt, ptl, use_mask=use_mask,
                                          eq_flat=eq_flat)
                moves = np.asarray(moves)
                for jj, ii in enumerate(bite):
                    cigars[idx2[ii]] = _moves_to_cigar(
                        moves[jj], int(pql[jj]), int(ptl[jj]), extended
                    )

            order = sorted(
                range(len(idx2)),
                key=lambda ii: (len(pqs[ii]) + 1) * (len(pts[ii]) + 1),
                reverse=True,
            )
            bite: list[int] = []
            max_lq = max_lt = 0
            for ii in order:
                nlq = max(max_lq, len(pqs[ii]) + 1)
                nlt = max(max_lt, len(pts[ii]) + 1)
                if bite and (len(bite) + 1) * nlq * nlt > MOVES_BATCH_CELL_BUDGET:
                    _flush_moves(bite)
                    bite = []
                    nlq, nlt = len(pqs[ii]) + 1, len(pts[ii]) + 1
                bite.append(ii)
                max_lq, max_lt = nlq, nlt
            if bite:
                _flush_moves(bite)

    out = []
    for p in range(n):
        if not found[p]:
            out.append(
                {"editDistance": -1, "endLocations": [], "startLocations": None, "cigar": None}
            )
        else:
            out.append(
                {
                    "editDistance": int(dists[p]),
                    "endLocations": ends[p],
                    "startLocations": starts[p],
                    "cigar": cigars[p],
                }
            )
    return out


def align(query, target, mode: str = "NW", task: str = "distance", k: int = -1,
          additionalEqualities: list | None = None) -> dict:
    """Single-pair convenience with the pip-edlib result shape and argument
    names (main.py:34 uses align(...)['editDistance'] / ['cigar'];
    additionalEqualities matches the pip binding's keyword)."""
    r = align_batch([query], [target], mode=mode, task=task, k=k,
                    additional_equalities=additionalEqualities)[0]
    if r["editDistance"] == -1:
        return {"editDistance": -1, "locations": [], "cigar": None}
    starts = r["startLocations"] or [None] * len(r["endLocations"])
    return {
        "editDistance": r["editDistance"],
        "locations": list(zip(starts, r["endLocations"])),
        "cigar": r["cigar"],
    }
