"""Rescoring / finishing stage — the reference's convert_tsv pipeline
(main.py:107-184) rebuilt around ONE batched device kernel.

For every monomer block the reference makes up to 48 sequential edlib calls
(all monomers, raw + homopolymer-compressed; main.py:124-142). Here all
(block, monomer, variant) pairs across ALL reads become one flat pair batch
for ops/identity.nw_identity_batch, then the per-block logic (second-best
selection, homopolymer sort, reliability flag, formatting) runs host-side
with the reference's exact ordering semantics:

  - the monomer iteration order of this stage is the INTERLEAVED RC order of
    the reference Python loader (main.py:79-84), which differs from the DP
    stage's appended order — both tie-breaking behaviors are preserved;
  - second-best: first strict improvement wins (main.py:131-135);
  - homopolymer ranking: stable sort on -score (main.py:142);
  - identity float op order (m/L)*100 and "{:.2f}" formatting (main.py:59,157).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .io.fasta import Record, encode
from .models.reliability import classify, load_coefficients
from .ops import backend as backend_router
from .utils.stagetimer import stage


def homo_compress(seq: str) -> str:
    """Collapse homopolymer runs (main.py:87-92)."""
    if not seq:
        return seq
    arr = np.frombuffer(seq.encode(), dtype=np.uint8)
    keep = np.concatenate([[True], arr[1:] != arr[:-1]])
    return arr[keep].tobytes().decode()


@dataclass
class FinishedBlock:
    monomer_name: str
    start: int
    end: int
    score: float
    second_best: str
    second_best_score: float
    homo_best: str
    homo_best_score: float
    homo_second_best: str
    homo_second_best_score: float
    alt: dict  # name -> score (empty in light mode)
    reliable: bool


class Rows:
    """Array-backed finished blocks for one read chunk.

    The finishing stage keeps its results as column arrays end-to-end —
    write_final_rows emits them through the native formatter without ever
    creating a per-block Python object (at 20 Mbp the FinishedBlock +
    alt-dict materialization alone cost ~1.6 s and the per-row f-strings
    ~8 s). Iteration/indexing materializes real FinishedBlock instances, so
    API consumers and tests see the same objects as before.

    Name columns are indices: best/homo into `names` (the full interleaved
    monomer order), second-best and the alt matrix into `uniq_names`
    (first-occurrence unique names — the reference collapses scores into a
    name-keyed dict, main.py:123-126). -1 encodes "None".
    """

    __slots__ = ("names", "uniq_names", "best_idx", "best_upos", "starts",
                 "ends", "score", "sb_idx", "sb_score", "hb_idx", "hb_score",
                 "hs_idx", "hs_score", "reliable", "alt")

    def __init__(self, names, uniq_names, best_idx, best_upos, starts, ends,
                 score, sb_idx, sb_score, hb_idx, hb_score, hs_idx, hs_score,
                 reliable, alt):
        self.names = names
        self.uniq_names = uniq_names
        self.best_idx = best_idx
        self.best_upos = best_upos
        self.starts = starts
        self.ends = ends
        self.score = score
        self.sb_idx = sb_idx
        self.sb_score = sb_score
        self.hb_idx = hb_idx
        self.hb_score = hb_score
        self.hs_idx = hs_idx
        self.hs_score = hs_score
        self.reliable = reliable
        self.alt = alt  # [n, U] float64 or None (light mode)

    def __len__(self) -> int:
        return len(self.starts)

    def _name(self, table, idx: int) -> str:
        return "None" if idx < 0 else table[idx]

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        if i < 0:
            i += len(self)
        if not 0 <= i < len(self):
            raise IndexError(i)
        alt = (dict(zip(self.uniq_names, self.alt[i].tolist()))
               if self.alt is not None else {})
        return FinishedBlock(
            self._name(self.names, int(self.best_idx[i])),
            int(self.starts[i]), int(self.ends[i]), float(self.score[i]),
            self._name(self.uniq_names, int(self.sb_idx[i])),
            float(self.sb_score[i]),
            self._name(self.names, int(self.hb_idx[i])), float(self.hb_score[i]),
            self._name(self.names, int(self.hs_idx[i])), float(self.hs_score[i]),
            alt, bool(self.reliable[i]),
        )

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    @staticmethod
    def concat(parts: list["Rows"]) -> "Rows":
        """Concatenate chunks of one read (same name tables)."""
        if len(parts) == 1:
            return parts[0]
        first = parts[0]
        cat = np.concatenate
        alt = (None if first.alt is None
               else cat([p.alt for p in parts], axis=0))
        return Rows(
            first.names, first.uniq_names,
            cat([p.best_idx for p in parts]), cat([p.best_upos for p in parts]),
            cat([p.starts for p in parts]), cat([p.ends for p in parts]),
            cat([p.score for p in parts]),
            cat([p.sb_idx for p in parts]), cat([p.sb_score for p in parts]),
            cat([p.hb_idx for p in parts]), cat([p.hb_score for p in parts]),
            cat([p.hs_idx for p in parts]), cat([p.hs_score for p in parts]),
            cat([p.reliable for p in parts]), alt,
        )


def _batched_identity(pairs_q, pairs_t, chunk=4096, kernel=None):
    """pairs_*: list of np int8 code arrays; returns (matches, totals) int64."""
    kernel = kernel or backend_router.nw_pairs_fn()
    P = len(pairs_q)
    matches = np.zeros(P, dtype=np.int64)
    totals = np.zeros(P, dtype=np.int64)
    pos = 0
    while pos < P:
        qs = pairs_q[pos : pos + chunk]
        ts = pairs_t[pos : pos + chunk]
        n = len(qs)
        # round paddings up to 128 to bound the number of
        # distinct compiled shapes across chunks
        Lq = max(1, max(len(x) for x in qs))
        Lt = max(1, max(len(x) for x in ts))
        Lq = (Lq + 127) // 128 * 128
        Lt = (Lt + 127) // 128 * 128
        q = np.full((n, Lq), 7, dtype=np.int8)
        t = np.full((n, Lt), 7, dtype=np.int8)
        ql = np.zeros(n, dtype=np.int32)
        tl = np.zeros(n, dtype=np.int32)
        for i, (a, b) in enumerate(zip(qs, ts)):
            q[i, : len(a)] = a
            ql[i] = len(a)
            t[i, : len(b)] = b
            tl[i] = len(b)
        _, mt, ln = kernel(q, ql, t, tl)
        matches[pos : pos + n] = np.asarray(mt)
        totals[pos : pos + n] = np.asarray(ln)
        pos += n
    return matches, totals


def _start_host_copy(*arrays) -> None:
    """Kick off device->host transfers immediately after dispatch so they
    overlap later device work instead of serializing at gather time."""
    for a in arrays:
        start = getattr(a, "copy_to_host_async", None)  # absent on NumPy
        if start is not None:
            start()


def _blocks_x_monomers(
    blocks: list[np.ndarray],  # Nb encoded block substrings
    targets: list[np.ndarray],  # M encoded monomer variants
    kernel=None,
    block_chunk: int = 4096,
) -> tuple[np.ndarray, np.ndarray]:
    """(matches, totals) int64 arrays of shape [Nb, M] for every
    (block, monomer) combination. Blocks and monomers are uploaded once;
    the cross-product expansion runs on device."""
    kernel = kernel or backend_router.nw_pairs_fn()
    Nb, M = len(blocks), len(targets)
    matches = np.zeros((Nb, M), dtype=np.int64)
    totals = np.zeros((Nb, M), dtype=np.int64)
    if Nb == 0:
        return matches, totals
    for s, n, mt, ln in _dispatch_blocks_x_monomers(blocks, targets, kernel,
                                                    block_chunk):
        matches[s : s + n] = np.asarray(mt).reshape(-1, M)[:n]
        totals[s : s + n] = np.asarray(ln).reshape(-1, M)[:n]
    return matches, totals


def _dispatch_blocks_x_monomers(blocks, targets, kernel, block_chunk=4096):
    """Queue every chunk's device call WITHOUT syncing; yields
    (start, n, matches_dev, totals_dev) so the caller (or a zipped pair of
    dispatchers, see _finish_group) gathers results while the device chews
    through the queue — JAX's async dispatch keeps the chip busy across the
    chunk boundary that a per-chunk np.asarray would serialize."""
    import jax.numpy as jnp

    Nb, M = len(blocks), len(targets)
    if Nb == 0:
        return []
    t, tl = _pad_codes(targets)
    td = jnp.asarray(t)
    # every distinct (rows, Lq) is a compile key: floor Lq at 256 (real
    # monomer blocks are ~170 bp, so per-chunk maxima jitter around one
    # 128-boundary — the floor collapses them to ONE key; rare longer
    # outliers still widen)
    Lq_all = max(1, max(len(b) for b in blocks))
    Lq_all = max(256, (Lq_all + 127) // 128 * 128)
    bc = min(block_chunk, -(-Nb // 8) * 8)
    pending = []
    for s in range(0, Nb, bc):
        part = blocks[s : s + bc]
        # right-size the tail chunk from a 3-value menu {8, 1024, bc}: full
        # padding would waste up to bc-1 rows of kernel work, but every
        # distinct row count is a compile key, so the menu stays tiny
        n = len(part)
        n_pad = min(bc, 8 if n <= 8 else 1024 if n <= 1024 else 2048 if n <= 2048 else bc)
        q = np.zeros((n_pad, Lq_all), dtype=np.int8)  # pad rows: len-0 queries
        ql = np.zeros(n_pad, dtype=np.int32)
        for i, b in enumerate(part):
            q[i, : len(b)] = b
            ql[i] = len(b)
        qd = jnp.asarray(q)
        qs = jnp.repeat(qd, M, axis=0)
        # pair lengths stay NumPy: the route and the kernel's column size
        # are picked from the longest query host-side, and a device-resident
        # length vector would force a device->host sync per chunk
        qls = np.repeat(ql, M)
        ts = jnp.tile(td, (n_pad, 1))
        tls = np.tile(tl, n_pad)
        _, mt, ln = kernel(qs, qls, ts, tls)
        _start_host_copy(mt, ln)
        pending.append((s, len(part), mt, ln))
    return pending


def _pad_codes(
    codes: list[np.ndarray], mult: int = 128, rows: int | None = None,
    min_len: int = 1,
) -> tuple[np.ndarray, np.ndarray]:
    """Pad to [rows, L128]; extra rows are length-0 queries (never win)."""
    L = max(min_len, max((len(c) for c in codes), default=1))
    L = (L + mult - 1) // mult * mult
    n = max(rows or 0, len(codes))
    arr = np.zeros((n, L), dtype=np.int8)
    lens = np.zeros(n, dtype=np.int32)
    for i, c in enumerate(codes):
        arr[i, : len(c)] = c
        lens[i] = len(c)
    return arr, lens


def finish_reads(
    # [(read_name, [{m,start,end}])] or [(read_name, blocks, key)] — the
    # optional key selects the sequence in reads_by_name (positional keys
    # make duplicate read names safe; the raw-TSV --resume path has only
    # names, where duplicates are inherently ambiguous — the reference
    # outright crashes on them, main.py:65)
    per_read_blocks: list[tuple],
    reads_by_name: dict,  # key -> sequence (uppercase)
    monomers_interleaved: list[Record],
    second_best: bool = False,
    model_file: str | None = None,
    flush_pairs: int = 1 << 20,
    kernel=None,
    threads: int = 1,
    backend: str = "auto",
) -> list[tuple[str, list[FinishedBlock]]]:
    """Rescore every block; returns finished blocks per read, same order.

    Memory is bounded: reads accumulate into the flat pair batch only until
    `flush_pairs` pairs are pending, then the batch is scored and finished —
    a 100 Mbp assembly streams through in ~1M-pair bites instead of
    materializing ~30M encoded pairs at once. Up to 4 groups stay in flight
    (dispatch split from gather), and with `threads > 1` the host-side
    encode/dispatch of later groups runs on a thread pool while earlier
    groups assemble — the analog of the reference's OpenMP gather
    (src/main.cpp:84-121)."""
    out: list[tuple[str, list[FinishedBlock]]] = []
    group: list[tuple[str, list[dict]]] = []
    pending = 0
    M = len(monomers_interleaved)
    stride = 2 * M if second_best else 1
    max_blocks = max(1, flush_pairs // stride)

    fin = AsyncFinisher(
        reads_by_name, monomers_interleaved, second_best=second_best,
        model_file=model_file, kernel=kernel, threads=threads, backend=backend,
    )

    def flush():
        nonlocal group, pending
        if group:
            out.extend(fin.submit_group(group))
            group, pending = [], 0

    try:
        for e in per_read_blocks:
            read_name, blocks, key = _entry(e)
            # a single centromere-scale "read" is split too: adjacent
            # same-name groups concatenate to identical output bytes, and
            # the classifier is row-wise, so block-level splitting is
            # observationally safe
            for s in range(0, max(len(blocks), 1), max_blocks):
                chunk = blocks[s : s + max_blocks]
                group.append((read_name, chunk, key))
                pending += len(chunk) * stride
                if pending >= flush_pairs:
                    flush()
        flush()
        out.extend(fin.drain())
    finally:
        fin.close()
    # re-merge split reads so callers see one group per input read; chunks
    # concatenate as arrays (Rows) so the native emitter path survives the
    # merge — mixed/legacy parts fall back to a materialized list
    merged: list[tuple[str, Rows | list[FinishedBlock]]] = []
    gi = 0
    for e in per_read_blocks:
        read_name, blocks, _ = _entry(e)
        need = max(1, -(-max(len(blocks), 1) // max_blocks))
        parts = [out[gi + k][1] for k in range(need)]
        gi += need
        if all(isinstance(p, Rows) for p in parts):
            merged.append((read_name, Rows.concat(parts)))
        else:
            fblocks: list[FinishedBlock] = []
            for p in parts:
                fblocks.extend(p)
            merged.append((read_name, fblocks))
    return merged


class _CodesCache:
    """Lazily encodes each read ONCE; block substrings become int8 slice
    views instead of per-block str->encode->str roundtrips (the reference
    re-slices and re-validates the string per block, main.py:124-130; at
    20 Mbp that is ~10^5 tiny Python/NumPy calls on the host's critical
    path). The cache lives as long as its reads_by_name dict (the codes add
    ~1 byte/bp to the 1-byte/bp strings already held); streaming callers
    create one cache per bounded read group.

    Keys are whatever the caller groups reads by — the display name, or a
    positional index when the input may carry DUPLICATE read names (the
    reference crashes on those: SeqIO.to_dict raises, main.py:65; here the
    fresh/streaming runners key positionally so every block group scores
    against its own read)."""

    def __init__(self, reads_by_key: dict):
        self.reads = reads_by_key
        self.codes: dict = {}

    def get(self, key) -> np.ndarray:
        c = self.codes.get(key)
        if c is None:
            c = self.codes[key] = encode(self.reads[key])
        return c


def _entry(e) -> tuple[str, list, object]:
    """Normalize a group entry: (name, blocks) or (name, blocks, key) ->
    (name, blocks, key); key defaults to the display name."""
    if len(e) == 3:
        return e
    name, blocks = e
    return name, blocks, name


def _homo_codes(c: np.ndarray) -> np.ndarray:
    """homo_compress on already-encoded int8 codes (distinct ACGTN chars
    map to distinct codes, so run collapse commutes with encoding)."""
    if len(c) == 0:
        return c
    return c[np.concatenate(([True], c[1:] != c[:-1]))]


class _DeviceFinishCtx:
    """Device residency for the packed finishing path (--second-best with
    the router's NW kernel): monomer tensors upload once, each read's codes
    upload once (FIFO-bounded) and block substrings/homo collapse/pair
    expansion all happen on device — the per-group host->device traffic
    drops to one [n] starts/lens vector and the device->host traffic to one
    array. See ops/identity.nw_identity_packed_both."""

    MAX_READS = 8  # resident read codes (FIFO eviction)

    def __init__(self, mono_codes: list[np.ndarray], homo_codes: list[np.ndarray],
                 backend: str = "auto"):
        import jax.numpy as jnp

        self.backend = backend
        t_raw, tl_raw = _pad_codes(mono_codes)
        t_homo, tl_homo = _pad_codes(homo_codes)
        self.t_raw = jnp.asarray(t_raw)
        self.tl_raw = tl_raw
        self.t_homo = jnp.asarray(t_homo)
        self.tl_homo = tl_homo
        self._reads: dict[str, object] = {}

    def read_dev(self, name: str, codes: np.ndarray):
        dev = self._reads.get(name)
        if dev is None:
            while len(self._reads) >= self.MAX_READS:
                self._reads.pop(next(iter(self._reads)))
            dev = self._reads[name] = _upload_read(codes)
        return dev


def _upload_read(codes: np.ndarray):
    """Device copy of a read's codes, zero-padded to a power of two (at
    least 1024): the read length is a compile key of the packed path, and
    the buckets keep a stream of reads to a few keys."""
    import jax.numpy as jnp

    n = 1 << max(10, (len(codes) - 1).bit_length())
    buf = np.zeros(n, dtype=np.int8)
    buf[: len(codes)] = codes
    return jnp.asarray(buf)


def _dispatch_group_packed(
    per_read_blocks: list[tuple[str, list[dict]]],
    codes_cache: _CodesCache,
    ctx: _DeviceFinishCtx,
    block_chunk: int = 4096,
) -> list[tuple]:
    """Packed-path dispatch: one device call + one result array per block
    chunk, covering both raw and homo variants."""
    from .ops.identity import nw_identity_packed_both

    n_names = sum(len(blocks) for _, blocks, _ in per_read_blocks)
    starts = np.fromiter(
        (d["start"] for _, blocks, _ in per_read_blocks for d in blocks),
        dtype=np.int64, count=n_names,
    )
    lens = np.fromiter(
        (d["end"] - d["start"] + 1 for _, blocks, _ in per_read_blocks for d in blocks),
        dtype=np.int32, count=n_names,
    )
    group_keys = [key for _, blocks, key in per_read_blocks if blocks]
    uniq_keys = list(dict.fromkeys(group_keys))
    if len(uniq_keys) == 1:
        read_dev = ctx.read_dev(uniq_keys[0], codes_cache.get(uniq_keys[0]))
    else:
        # multi-read group: concatenate the group's reads host-side and
        # shift starts; uploads ~= the old substring matrices, but the homo
        # collapse and padding still move off the host
        offs = {}
        parts = []
        off = 0
        for key in uniq_keys:
            c = codes_cache.get(key)
            offs[key] = off
            parts.append(c)
            off += len(c)
        read_dev = _upload_read(np.concatenate(parts) if parts else
                                np.zeros(1, dtype=np.int8))
        shift = np.fromiter(
            (offs[key] for _, blocks, key in per_read_blocks for _ in blocks),
            dtype=np.int64, count=n_names,
        )
        starts = starts + shift
    Nb = len(starts)
    pending = []
    bc = block_chunk
    for s in range(0, max(Nb, 1), bc):
        part_lens = lens[s : s + bc]
        if len(part_lens) == 0:
            break
        n = len(part_lens)
        n_pad = min(bc, 8 if n <= 8 else 1024 if n <= 1024 else 2048 if n <= 2048 else bc)
        Lq = max(256, (int(part_lens.max()) + 127) // 128 * 128)
        dev = nw_identity_packed_both(
            read_dev, starts[s : s + bc], part_lens,
            ctx.t_raw, ctx.tl_raw, ctx.t_homo, ctx.tl_homo,
            n_pad=n_pad, Lq=Lq, backend=ctx.backend,
        )
        _start_host_copy(dev)
        pending.append((s, n, dev))
    return pending


def _dispatch_finish_group(
    per_read_blocks: list[tuple[str, list[dict]]],
    codes_cache: _CodesCache,
    mono_codes: list[np.ndarray],
    homo_codes: list[np.ndarray],
    name_to_idx: dict[str, int],
    second_best: bool,
    kernel,
    dev_ctx: _DeviceFinishCtx | None = None,
) -> dict:
    """Encode one group's block substrings and QUEUE all of its identity
    device calls without gathering; the returned handle is materialized by
    _gather_finish_group. Splitting dispatch from gather lets the pipeline
    keep several groups in flight while the DP stage's batches share the
    device queue (the producer/consumer overlap)."""
    with stage("fin.dispatch"):
        return _dispatch_finish_group_inner(
            [_entry(e) for e in per_read_blocks], codes_cache, mono_codes,
            homo_codes, name_to_idx, second_best, kernel, dev_ctx)


def _dispatch_finish_group_inner(
    per_read_blocks, codes_cache, mono_codes, homo_codes, name_to_idx,
    second_best, kernel, dev_ctx=None,
) -> dict:
    if second_best and dev_ctx is not None:
        n = sum(len(blocks) for _, blocks, _ in per_read_blocks)
        return {
            "group": per_read_blocks, "n": n, "second_best": True,
            "pend_packed": _dispatch_group_packed(
                per_read_blocks, codes_cache, dev_ctx),
        }
    subs: list[np.ndarray] = []
    homo_subs: list[np.ndarray] = []
    for _, blocks, key in per_read_blocks:
        codes = codes_cache.get(key)
        for d in blocks:
            sub = codes[d["start"] : d["end"] + 1]
            subs.append(sub)
            if second_best:
                homo_subs.append(_homo_codes(sub))
    pg = {"group": per_read_blocks, "n": len(subs), "second_best": second_best}
    if second_best:
        # blocks upload once; the M-fold pair expansion happens ON DEVICE
        # (jnp.repeat/tile), so host->device traffic is 2*M times smaller
        # than shipping explicit pairs. Raw and homo variants are BOTH
        # dispatched before either is gathered: the device queue stays full
        # while the host materializes results.
        pg["pend_raw"] = _dispatch_blocks_x_monomers(subs, mono_codes, kernel)
        pg["pend_homo"] = _dispatch_blocks_x_monomers(homo_subs, homo_codes, kernel)
    else:
        pairs_t = [
            mono_codes[name_to_idx[d["m"]]]
            for _, blocks, _ in per_read_blocks for d in blocks
        ]
        pg["pend_light"] = _dispatch_pairs(subs, pairs_t, kernel)
    return pg


def _dispatch_pairs(pairs_q, pairs_t, kernel, chunk=4096):
    """Light-mode analog of _dispatch_blocks_x_monomers: queue the
    per-pair identity calls, return (pos, n, matches_dev, totals_dev)."""
    pending = []
    pos = 0
    P = len(pairs_q)
    while pos < P:
        qs = pairs_q[pos : pos + chunk]
        ts = pairs_t[pos : pos + chunk]
        # batch dim from the same tiny {8, 1024, chunk} menu as
        # _dispatch_blocks_x_monomers: per-read dispatch would otherwise
        # compile one kernel per distinct block count
        n = len(qs)
        n_pad = min(chunk, 8 if n <= 8 else 1024 if n <= 1024 else 2048 if n <= 2048 else chunk)
        q, ql = _pad_codes(qs, rows=n_pad, min_len=256)
        t, tl = _pad_codes(ts, rows=n_pad, min_len=256)
        _, mt, ln = kernel(q.astype(np.int8), ql, t.astype(np.int8), tl)
        _start_host_copy(mt, ln)
        pending.append((pos, len(qs), mt, ln))
        pos += len(qs)
    return pending


def _gather_finish_group(
    pg: dict,
    mono_names: list[str],
    name_to_idx: dict[str, int],
    coef,
) -> list[tuple[str, list[FinishedBlock]]]:
    """Materialize a dispatched group's device results and run the
    vectorized per-block host logic (main.py:107-150)."""
    per_read_blocks = pg["group"]
    second_best = pg["second_best"]
    M_ = len(mono_names)
    n = pg["n"]
    with stage("fin.gather"):
        if second_best:
            mt_raw = np.zeros((n, M_), dtype=np.int64)
            ln_raw = np.zeros((n, M_), dtype=np.int64)
            mt_homo = np.zeros((n, M_), dtype=np.int64)
            ln_homo = np.zeros((n, M_), dtype=np.int64)
            if "pend_packed" in pg:
                for s, cn, dev in pg["pend_packed"]:
                    arr = np.asarray(dev).astype(np.int64)  # [2, n_pad*M, 2]
                    for v, (mt_o, ln_o) in enumerate(((mt_raw, ln_raw),
                                                      (mt_homo, ln_homo))):
                        d2 = arr[v].reshape(-1, M_, 2)[:cn]
                        ln_o[s : s + cn] = d2[..., 1]
                        mt_o[s : s + cn] = d2[..., 1] - d2[..., 0]  # cols - D
            else:
                for pend, mt_o, ln_o in ((pg["pend_raw"], mt_raw, ln_raw),
                                         (pg["pend_homo"], mt_homo, ln_homo)):
                    for s, cn, mt, ln in pend:
                        mt_o[s : s + cn] = np.asarray(mt).reshape(-1, M_)[:cn]
                        ln_o[s : s + cn] = np.asarray(ln).reshape(-1, M_)[:cn]
        else:
            matches = np.zeros(n, dtype=np.int64)
            totals = np.zeros(n, dtype=np.int64)
            for s, cn, mt, ln in pg["pend_light"]:
                matches[s : s + cn] = np.asarray(mt)[:cn]
                totals[s : s + cn] = np.asarray(ln)[:cn]
    with stage("fin.assemble"):
        return _assemble_group(
            per_read_blocks, second_best, mono_names, name_to_idx, coef,
            mt_raw if second_best else None, ln_raw if second_best else None,
            mt_homo if second_best else None, ln_homo if second_best else None,
            matches if not second_best else None, totals if not second_best else None,
        )


def _finish_group(
    per_read_blocks: list[tuple[str, list[dict]]],
    reads_by_name: dict[str, str],
    monomers_interleaved: list[Record],
    second_best: bool,
    model_file: str | None,
    kernel=None,
) -> list[tuple[str, list[FinishedBlock]]]:
    """One-shot dispatch+gather of a single group (test/debug convenience;
    the pipelined callers drive dispatch/gather directly)."""
    mono_names = [m.name for m in monomers_interleaved]
    name_to_idx = {n: i for i, n in enumerate(mono_names)}
    mono_codes = [encode(m.seq) for m in monomers_interleaved]
    homo_codes = [encode(homo_compress(m.seq)) for m in monomers_interleaved]
    coef = load_coefficients(model_file)
    kernel = kernel or backend_router.nw_pairs_fn()
    pg = _dispatch_finish_group(
        per_read_blocks, _CodesCache(reads_by_name), mono_codes, homo_codes,
        name_to_idx, second_best, kernel,
    )
    return _gather_finish_group(pg, mono_names, name_to_idx, coef)


def _assemble_group(
    per_read_blocks, second_best, mono_names, name_to_idx, coef,
    mt_raw, ln_raw, mt_homo, ln_homo, matches, totals,
) -> list[tuple[str, list[FinishedBlock]]]:
    M = len(mono_names)
    # ---- per-block host logic (main.py:107-150), vectorized over the whole
    # group: the reference's per-block Python loops (24 aai calls + a sort
    # per block) become a handful of NumPy ops on the [Nb, M] score matrix.
    # Bit-exactness: aai's float op order (m/L)*100 is elementwise, argmax
    # returns the FIRST max (== "first strict improvement wins",
    # main.py:131-135), stable argsort == the reference's stable sort on
    # -score (main.py:142).
    out: list[tuple[str, Rows]] = []
    # first-occurrence unique names + last-occurrence column per name: the
    # reference collapses the score list into a name-keyed dict
    # (main.py:123-126), so with duplicate monomer names the LAST
    # occurrence's score represents the name, every column carrying the best
    # block's name is excluded from second-best, and tie-breaking order is
    # the FIRST-occurrence order of names (dict insertion order). With a
    # single distinct name the reference keeps (None, -1) — never -inf
    # (round-2 advisor finding).
    uniq_names: list[str] = []
    upos: dict[str, int] = {}
    for nm in mono_names:
        if nm not in upos:
            upos[nm] = len(uniq_names)
            uniq_names.append(nm)
    U = len(uniq_names)
    if second_best:
        Nb = mt_raw.shape[0]
        with np.errstate(invalid="ignore"):
            sc_all = np.where(ln_raw == 0, 0.0,
                              (mt_raw.astype(np.float64) / ln_raw) * 100.0)
            hsc_all = np.where(ln_homo == 0, 0.0,
                               (mt_homo.astype(np.float64) / ln_homo) * 100.0)
        best_idx_all = np.fromiter(
            (name_to_idx[d["m"]] for _, blocks, _ in per_read_blocks for d in blocks),
            dtype=np.int32, count=Nb,
        )
        best_upos_all = np.fromiter(
            (upos[d["m"]] for _, blocks, _ in per_read_blocks for d in blocks),
            dtype=np.int32, count=Nb,
        )
        rows = np.arange(Nb)
        best_score_all = sc_all[rows, best_idx_all] if Nb else np.zeros(0)
        last_col = np.zeros(U, dtype=np.int64)
        for j, nm in enumerate(mono_names):
            last_col[upos[nm]] = j
        alt_all = sc_all[:, last_col]  # name-collapsed [Nb, U] (alt rows)
        if Nb and U > 1:
            masked = alt_all.copy()
            masked[rows, best_upos_all] = -np.inf
            sb_idx_all = masked.argmax(axis=1).astype(np.int32)  # first max
            sb_score_all = masked[rows, sb_idx_all]
        else:
            sb_idx_all = np.full(Nb, -1, dtype=np.int32)
            sb_score_all = np.full(Nb, -1.0)
        # homopolymer ranking: stable argsort on -score, top-2 columns
        if Nb:
            horder = np.argsort(-hsc_all, axis=1, kind="stable")
            hb_idx_all = horder[:, 0].astype(np.int32)
            hb_score_all = hsc_all[rows, hb_idx_all]
            if M > 1:
                hs_idx_all = horder[:, 1].astype(np.int32)
                hs_score_all = hsc_all[rows, hs_idx_all]
            else:
                # a single-column batch has no homo runner-up; the reference
                # cannot reach this (RC doubling makes M >= 2)
                hs_idx_all = np.full(Nb, -1, dtype=np.int32)
                hs_score_all = np.full(Nb, -1.0)
        else:
            hb_idx_all = hs_idx_all = np.zeros(0, dtype=np.int32)
            hb_score_all = hs_score_all = np.zeros(0)
    else:
        Nb = len(matches)
        with np.errstate(invalid="ignore"):
            best_score_all = np.where(
                totals == 0, 0.0, (matches.astype(np.float64) / totals) * 100.0
            )
        best_idx_all = np.fromiter(
            (name_to_idx[d["m"]] for _, blocks, _ in per_read_blocks for d in blocks),
            dtype=np.int32, count=Nb,
        )
        best_upos_all = np.full(Nb, -1, dtype=np.int32)
        sb_idx_all = hb_idx_all = hs_idx_all = np.full(Nb, -1, dtype=np.int32)
        sb_score_all = hb_score_all = hs_score_all = np.full(Nb, -1.0)
        alt_all = None
    starts_all = np.fromiter(
        (d["start"] for _, blocks, _ in per_read_blocks for d in blocks),
        dtype=np.int64, count=Nb,
    )
    ends_all = np.fromiter(
        (d["end"] for _, blocks, _ in per_read_blocks for d in blocks),
        dtype=np.int64, count=Nb,
    )
    # reliability flags (main.py:149) — row-wise, so one group-level call
    reliable_all = classify(best_score_all, sb_score_all, coef)
    bi = 0
    for read_name, blocks, _ in per_read_blocks:
        n = len(blocks)
        s = slice(bi, bi + n)
        out.append((read_name, Rows(
            mono_names, uniq_names,
            best_idx_all[s], best_upos_all[s], starts_all[s], ends_all[s],
            best_score_all[s], sb_idx_all[s], sb_score_all[s],
            hb_idx_all[s], hb_score_all[s], hs_idx_all[s], hs_score_all[s],
            reliable_all[s], alt_all[s] if alt_all is not None else None,
        )))
        bi += n
    return out


class AsyncFinisher:
    """Bounded-in-flight finishing: submit() encodes one chunk's blocks and
    QUEUES its identity device calls immediately; results gather FIFO.

    The producer (decompose_stream) keeps DP batches dispatched ahead, so
    gathering a finishing group here overlaps with later windows' DP on
    the device queue, and the host-side assembly of group k overlaps the
    device work of everything after it — the producer/consumer overlap the
    round-2 verdict asked for (the two stages previously ran back-to-back
    with zero overlap, pipeline.py round-2 line 316-338)."""

    def __init__(
        self,
        reads_by_name: dict[str, str],
        monomers_interleaved: list[Record],
        second_best: bool = False,
        model_file: str | None = None,
        kernel=None,
        max_inflight: int = 3,
        threads: int = 1,
        backend: str = "auto",
    ):
        self.codes = _CodesCache(reads_by_name)
        self.mono_names = [m.name for m in monomers_interleaved]
        self.name_to_idx = {n: i for i, n in enumerate(self.mono_names)}
        self.mono_codes = [encode(m.seq) for m in monomers_interleaved]
        self.homo_codes = [encode(homo_compress(m.seq)) for m in monomers_interleaved]
        self.coef = load_coefficients(model_file)
        self.second_best = second_best
        self.kernel = kernel or backend_router.nw_pairs_fn(backend)
        self.max_inflight = max_inflight
        # packed device path with the router's cross-product NW; a caller's
        # own kernel (the sharded one of --data-parallel) keeps the generic
        # pairwise contract
        self.dev_ctx = (_DeviceFinishCtx(self.mono_codes, self.homo_codes, backend)
                        if second_best and kernel is None else None)
        self.pool = None
        if threads and threads > 1:
            from concurrent.futures import ThreadPoolExecutor

            self.pool = ThreadPoolExecutor(max_workers=threads)
        from collections import deque

        self._q: deque = deque()

    def _dispatch(self, group):
        return _dispatch_finish_group(
            group, self.codes, self.mono_codes, self.homo_codes,
            self.name_to_idx, self.second_best, self.kernel,
            dev_ctx=self.dev_ctx,
        )

    def submit_group(self, group: list[tuple[str, list[dict]]]):
        """Queue one group's scoring; returns any groups that became ready
        (in submission order) once the in-flight bound is exceeded. With a
        thread pool, the encode+dispatch runs off the caller's thread — the
        producer keeps feeding DP batches while -t workers prep finishing
        groups (the reference's OpenMP gather, src/main.cpp:84-121)."""
        self._q.append(self.pool.submit(self._dispatch, group) if self.pool
                       else self._dispatch(group))
        out = []
        while len(self._q) > self.max_inflight:
            out.extend(self._gather_one())
        return out

    def submit(self, read_name: str, blocks: list[dict], key=None):
        """`key` selects the sequence in reads_by_key when it isn't the
        display name (positional keys make duplicate read names safe)."""
        return self.submit_group(
            [(read_name, blocks, read_name if key is None else key)])

    def _gather_one(self):
        pg = self._q.popleft()
        if self.pool is not None:
            pg = pg.result()
        return _gather_finish_group(pg, self.mono_names, self.name_to_idx,
                                    self.coef)

    def drain(self):
        """Gather every remaining group, in order; retires the pool."""
        out = []
        while self._q:
            out.extend(self._gather_one())
        if self.pool is not None:
            self.pool.shutdown(wait=True)
            self.pool = None
        return out

    def close(self):
        """Error-path teardown: abandon queued groups and stop the pool.
        Idempotent; a clean drain() already retired everything. Without
        this, an exception between submit and drain leaks a live thread
        pool per request under --serve (and its queued dispatch closures
        pin the encoded reads)."""
        self._q.clear()
        if self.pool is not None:
            self.pool.shutdown(wait=True, cancel_futures=True)
            self.pool = None


def write_final_tsv(
    path_final: str,
    path_alt: str,
    finished: list[tuple[str, list[FinishedBlock]]],
    identity_th: int = 0,
) -> None:
    """Final 12-column + alt 6-column TSVs (main.py:153-165)."""
    with open(path_alt, "w") as falt, open(path_final, "w") as fout:
        write_final_rows(fout, falt, finished, identity_th)


def write_final_rows(fout, falt, finished, identity_th: int = 0) -> None:
    """Row emission shared by the one-shot and streaming runners.

    Array-backed groups (Rows) emit through the native C++ formatter —
    integer/score-to-text conversion is the dominant host cost at assembly
    scale (the alt file carries U rows per block); both glibc snprintf and
    CPython produce the correctly-rounded decimal for "%.2f"/"{:.2f}", so
    the bytes are identical (asserted by tests/test_native.py). Fallbacks:
    object-block groups, or a missing native library, take the Python path
    below, whose "{:.2f}" memoization still wins ~2x (identity percentages
    are m/L*100 ratios — only a few thousand distinct doubles per assembly).
    """
    memo: dict[float, str] = {}

    def f2(x) -> str:
        x = float(x)
        s = memo.get(x)
        if s is None:
            s = memo[x] = f"{x:.2f}"
        return s

    for read_name, blocks in finished:
        if isinstance(blocks, Rows) and len(blocks):
            from .runtime.native import format_final_native

            res = format_final_native(
                read_name, blocks.names, blocks.uniq_names, blocks.best_idx,
                blocks.best_upos, blocks.starts, blocks.ends, blocks.score,
                blocks.sb_idx, blocks.sb_score, blocks.hb_idx, blocks.hb_score,
                blocks.hs_idx, blocks.hs_score, blocks.reliable, blocks.alt,
                identity_th,
            )
            if res is not None:
                fout.write(res[0].decode("utf-8"))
                falt.write(res[1].decode("utf-8"))
                continue
        rows: list[str] = []
        alt_rows: list[str] = []
        for b in blocks:
            if b.score >= identity_th:
                se = f"{b.start}\t{b.end}"
                rows.append(
                    f"{read_name}\t{b.monomer_name}\t{se}\t{f2(b.score)}\t"
                    f"{b.second_best}\t{f2(b.second_best_score)}\t"
                    f"{b.homo_best}\t{f2(b.homo_best_score)}\t"
                    f"{b.homo_second_best}\t{f2(b.homo_second_best_score)}\t"
                    f"{'+' if b.reliable else '?'}\n"
                )
                for name, sc in b.alt.items():
                    star = "*" if name == b.monomer_name else "-"
                    alt_rows.append(f"{read_name}\t{name}\t{se}\t{f2(sc)}\t{star}\n")
        fout.write("".join(rows))
        falt.write("".join(alt_rows))
