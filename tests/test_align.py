"""ops/align.py vs 210 reference-edlib-generated fixtures: every mode
(NW/SHW/HW) x task (distance/locations/path), k-thresholds, both CIGAR
formats, byte-equal CIGARs and identical location arrays."""

import json
import pathlib

import pytest

from stringdecomposer_tpu.ops.align import align, align_batch

FIXTURES = pathlib.Path(__file__).parent / "fixtures"


@pytest.fixture(scope="module")
def align_cases():
    # two independently seeded reference-edlib fixture sets (420 cases)
    cases = []
    for name in ["align_cases.json", "align_cases_b.json"]:
        with open(FIXTURES / name) as f:
            cases.extend(json.load(f))
    return cases


def _by_mode(cases, mode):
    return [c for c in cases if c["mode"] == mode]


@pytest.mark.parametrize("mode", ["NW", "SHW", "HW"])
def test_path_task_full_parity(align_cases, mode):
    cases = _by_mode(align_cases, mode)
    assert len(cases) >= 60
    res = align_batch(
        [c["q"] for c in cases], [c["t"] for c in cases],
        mode=mode, task="path", k=-1,
    )
    # apply each case's own k afterwards via a second batched call where k>=0
    for c, r in zip(cases, res):
        if c["k"] >= 0:
            r = align_batch([c["q"]], [c["t"]], mode=mode, task="path", k=c["k"])[0]
        assert r["editDistance"] == c["ed"], (c["q"], c["t"])
        if c["ed"] == -1:
            assert r["endLocations"] == [] and r["cigar"] is None
            continue
        assert r["endLocations"] == c["endLocations"], (mode, c["q"], c["t"])
        assert r["startLocations"] == c["startLocations"], (mode, c["q"], c["t"])
        assert r["cigar"] == c["cigar"], (mode, c["q"], c["t"])


def test_standard_cigar(align_cases):
    cases = [c for c in align_cases if c["ed"] >= 0][::5]
    for c in cases:
        r = align_batch([c["q"]], [c["t"]], mode=c["mode"], task="path",
                        cigar_format="standard")[0]
        assert r["cigar"] == c["cigar_std"], (c["mode"], c["q"], c["t"])


def test_distance_task_skips_locations(align_cases):
    c = next(c for c in align_cases if c["mode"] == "HW" and c["ed"] > 0)
    r = align_batch([c["q"]], [c["t"]], mode="HW", task="distance")[0]
    assert r["editDistance"] == c["ed"]
    assert r["endLocations"] == c["endLocations"]
    assert r["startLocations"] is None and r["cigar"] is None


def test_pip_edlib_result_shape(align_cases):
    """align() mirrors the pip edlib dict the reference rescoring consumes
    (main.py:34: align(...)['editDistance'] / ['cigar'])."""
    c = next(c for c in align_cases if c["mode"] == "NW" and c["ed"] > 0)
    r = align(c["q"], c["t"], mode="NW", task="path")
    assert r["editDistance"] == c["ed"]
    assert r["cigar"] == c["cigar"]
    assert r["locations"] == [(0, len(c["t"]) - 1)]


# ---------------------------------------------------------------------------
# Memory-bounded PATH (Hirschberg; src/edlib.cpp:1188-1400)
# ---------------------------------------------------------------------------
def _validate_ops(ops, q, t, expect_dist):
    """An op list is a valid OPTIMAL alignment: consumes q and t exactly,
    '='/'X' agree with the characters, and its cost equals the exact
    edit distance."""
    from stringdecomposer_tpu.ops.align import (
        EDOP_DELETE, EDOP_INSERT, EDOP_MATCH, EDOP_MISMATCH,
    )

    i = j = cost = 0
    for op in ops:
        if op == EDOP_INSERT:
            i += 1
            cost += 1
        elif op == EDOP_DELETE:
            j += 1
            cost += 1
        else:
            assert (q[i] == t[j]) == (op == EDOP_MATCH), (i, j, op)
            cost += int(op == EDOP_MISMATCH)
            i += 1
            j += 1
    assert i == len(q) and j == len(t)
    assert cost == expect_dist, (cost, expect_dist)


def _ref_dist(q, t):
    import numpy as np

    from stringdecomposer_tpu.ops.align import _pad_batch, dp_lastrow_batch

    qb, ql = _pad_batch([q])
    tb, tl = _pad_batch([t])
    return int(np.asarray(dp_lastrow_batch(qb, ql, tb, tl))[0, len(t)])


def test_hirschberg_valid_and_optimal():
    """Tiny cell_limit forces deep recursion on modest pairs; the resulting
    path must be a valid optimal alignment at O(Lq+Lt) memory."""
    import numpy as np

    from stringdecomposer_tpu.ops.align import _encode_any, _hirschberg_ops

    rng = np.random.default_rng(11)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    for lq, lt in [(150, 150), (300, 80), (80, 300), (257, 256), (1, 500),
                   (500, 1), (199, 201)]:
        q = rng.choice(alpha, lq).astype(np.uint8)
        if rng.random() < 0.5:
            t = q.copy()
            for _ in range(max(1, lt // 10)):
                p = int(rng.integers(len(t)))
                t[p] = rng.choice(alpha)
            t = t[:lt] if len(t) >= lt else np.concatenate(
                [t, rng.choice(alpha, lt - len(t)).astype(np.uint8)])
        else:
            t = rng.choice(alpha, lt).astype(np.uint8)
        ops = _hirschberg_ops(q, t, cell_limit=256)
        _validate_ops(ops, q, t, _ref_dist(q, t))


def test_align_batch_big_pair_routes_to_hirschberg(monkeypatch):
    """align_batch path task on a pair above MOVES_CELL_LIMIT: no move
    matrix, CIGAR still a valid optimal alignment; small pairs in the same
    batch keep their canonical (fixture-pinned) CIGARs."""
    import re

    import numpy as np

    import stringdecomposer_tpu.ops.align as A

    monkeypatch.setattr(A, "MOVES_CELL_LIMIT", 64 * 64)
    rng = np.random.default_rng(5)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    big_q = rng.choice(alpha, 300).astype(np.uint8)
    big_t = np.concatenate([big_q[:150], rng.choice(alpha, 160).astype(np.uint8)])
    small_q, small_t = b"ACGT", b"AGGT"
    rs = A.align_batch([big_q, small_q], [big_t, small_t], task="path")
    # small pair: canonical moves-path CIGAR
    assert rs[1]["cigar"] == "1=1X2="
    # big pair: expand CIGAR to ops, validate
    ops = []
    code = {"=": A.EDOP_MATCH, "X": A.EDOP_MISMATCH, "I": A.EDOP_INSERT,
            "D": A.EDOP_DELETE}
    for cnt, ch in re.findall(r"(\d+)([=XID])", rs[0]["cigar"]):
        ops.extend([code[ch]] * int(cnt))
    _validate_ops(ops, big_q, big_t, rs[0]["editDistance"])
    assert rs[0]["editDistance"] == _ref_dist(big_q, big_t)


# ---------------------------------------------------------------------------
# additionalEqualities (src/edlib.h:133-149)
# ---------------------------------------------------------------------------
def test_additional_equalities_reference_parity():
    """60 reference-edlib-generated cases with IUPAC-style equality pairs
    (N~ACGT, R~AG, Y~CT, plus subset configs), all modes x path x k."""
    import json
    import pathlib

    fixtures = pathlib.Path(__file__).parent / "fixtures" / "edlib_eq_cases.json"
    with open(fixtures) as f:
        cases = json.load(f)
    full = [("N", "A"), ("N", "C"), ("N", "G"), ("N", "T"),
            ("R", "A"), ("R", "G"), ("Y", "C"), ("Y", "T")]
    for c in cases:
        eqs = full[: c["npairs"]]
        r = align_batch([c["q"]], [c["t"]], mode=c["mode"], task="path",
                        k=c["k"], additional_equalities=eqs)[0]
        assert r["editDistance"] == c["ed"], (c["q"], c["t"], c["mode"])
        if c["ed"] < 0:
            continue
        assert r["endLocations"] == c["endLocations"], (c["q"], c["t"], c["mode"])
        if c["startLocations"]:
            assert r["startLocations"] == c["startLocations"], (c["q"], c["t"])
        assert r["cigar"] == c["cigar"], (c["q"], c["t"], c["mode"])


def test_equalities_hirschberg_route(monkeypatch):
    """Equality-aware path through the memory-bounded route: distance equal
    to the mask-space DP, CIGAR a valid optimal alignment under the
    relation."""
    import re

    import numpy as np

    import stringdecomposer_tpu.ops.align as A

    monkeypatch.setattr(A, "MOVES_CELL_LIMIT", 48 * 48)
    rng = np.random.default_rng(9)
    alpha = list(b"ACGTNRY")
    q = bytes(rng.choice(alpha, 220).tolist())
    t = bytes(rng.choice(alpha, 260).tolist())
    eqs = [("N", "A"), ("N", "C"), ("N", "G"), ("N", "T"),
           ("R", "A"), ("R", "G"), ("Y", "C"), ("Y", "T")]
    r = A.align_batch([q], [t], task="path", additional_equalities=eqs)[0]
    # reference distance from the plain (small) route
    want = align_batch([q], [t], task="distance", additional_equalities=eqs)[0]
    assert r["editDistance"] == want["editDistance"]
    # validate the CIGAR against the equality relation
    eq = {(a, b) for a, b in eqs} | {(b, a) for a, b in eqs}
    def same(x, y):
        cx, cy = chr(x), chr(y)
        return cx == cy or (cx, cy) in eq
    i = j = cost = 0
    for cnt, ch in re.findall(r"(\d+)([=XID])", r["cigar"]):
        for _ in range(int(cnt)):
            if ch == "I":
                i += 1; cost += 1
            elif ch == "D":
                j += 1; cost += 1
            else:
                assert same(q[i], t[j]) == (ch == "="), (i, j, ch)
                cost += ch == "X"
                i += 1; j += 1
    assert (i, j) == (len(q), len(t))
    assert cost == r["editDistance"]


# ---------------------------------------------------------------------------
# k-banded NW (Ukkonen band; src/edlib.cpp:559-571)
# ---------------------------------------------------------------------------
def test_banded_nw_matches_full():
    """Banded and full NW agree on the whole k-threshold contract
    (editDistance when <= k, -1 when above), over random and near-identical
    pairs and boundary ks."""
    import numpy as np

    rng = np.random.default_rng(31)
    alpha = list(b"ACGT")
    qs, ts = [], []
    for lq, lt in [(300, 300), (300, 295), (280, 310), (64, 64), (33, 31)]:
        q = bytes(rng.choice(alpha, lq).tolist())
        if rng.random() < 0.6:  # near-identical: small true distance
            t = bytearray(q[:lt].ljust(lt, b"A"))
            for _ in range(4):
                t[int(rng.integers(lt))] = int(rng.choice(alpha))
            t = bytes(t)
        else:
            t = bytes(rng.choice(alpha, lt).tolist())
        qs.append(q)
        ts.append(t)
    for k in [0, 1, 3, 8, 20, 50]:
        got = align_batch(qs, ts, mode="NW", task="distance", k=k)
        want = align_batch(qs, ts, mode="NW", task="distance", k=-1)
        for p, (g, w) in enumerate(zip(got, want)):
            expect = w["editDistance"] if w["editDistance"] <= k else -1
            assert g["editDistance"] == expect, (p, k, g, w)


def test_banded_nw_with_path_and_equalities():
    """Banded distance gate composes with the path task and equalities."""
    r = align_batch(["ACGTNCGT"], ["ACGTACGA"], mode="NW", task="path", k=2,
                    additional_equalities=[("N", "A")])[0]
    assert r["editDistance"] == 1
    assert r["cigar"] == "7=1X"
    r2 = align_batch(["ACGTACGT" * 20], ["TTTT" * 40], mode="NW",
                     task="path", k=3)[0]
    assert r2["editDistance"] == -1 and r2["cigar"] is None


def test_equalities_32_symbol_alphabet():
    """Exactly 32 distinct symbols: the top bitmask bit (bit 31) must not
    overflow the int32 LUT (round-2 review regression)."""
    syms = bytes(range(65, 97))  # 32 distinct bytes
    q = syms
    t = syms[::-1]
    eqs = [(chr(syms[0]), chr(syms[-1]))]
    r = align_batch([q], [t], task="distance", additional_equalities=eqs)[0]
    r_plain = align_batch([q], [t], task="distance")[0]
    # the (first, last) equality saves exactly the two end mismatches
    assert r["editDistance"] <= r_plain["editDistance"]
    assert r["editDistance"] >= 0


def test_equalities_wide_alphabet_hirschberg(monkeypatch):
    """>8 distinct symbols through the memory-bounded path: equality
    bitmasks need int32 all the way down (a uint8 pad buffer silently
    truncated bits 8+; round-2 review regression)."""
    import re

    import numpy as np

    import stringdecomposer_tpu.ops.align as A

    monkeypatch.setattr(A, "MOVES_CELL_LIMIT", 32 * 32)
    rng = np.random.default_rng(13)
    syms = list(b"ABCDEFGHIJKL")  # 12 symbols -> ids up to 11
    q = bytes(rng.choice(syms, 150).tolist())
    t = bytes(rng.choice(syms, 160).tolist())
    eqs = [("K", "A"), ("L", "B")]  # equalities touching high compact ids
    r = A.align_batch([q], [t], task="path", additional_equalities=eqs)[0]
    want = A.align_batch([q], [t], task="distance", additional_equalities=eqs)[0]
    assert r["editDistance"] == want["editDistance"]
    eq = {("K", "A"), ("A", "K"), ("L", "B"), ("B", "L")}
    i = j = cost = 0
    for cnt, ch in re.findall(r"(\d+)([=XID])", r["cigar"]):
        for _ in range(int(cnt)):
            if ch == "I":
                i += 1; cost += 1
            elif ch == "D":
                j += 1; cost += 1
            else:
                same = q[i] == t[j] or (chr(q[i]), chr(t[j])) in eq
                assert same == (ch == "="), (i, j, ch)
                cost += ch == "X"
                i += 1; j += 1
    assert (i, j) == (len(q), len(t)) and cost == r["editDistance"]


def test_moves_batch_aggregate_cell_budget(monkeypatch):
    """The batched PATH route must bound the PADDED per-call move tensor,
    not just each pair: many pairs each under MOVES_CELL_LIMIT must split
    into multiple dp_moves_batch calls whose aggregate padded cells stay
    under MOVES_BATCH_CELL_BUDGET, with identical results (round-2 advisor
    finding: one call over the whole chunk could allocate tens of GB)."""
    import numpy as np

    import stringdecomposer_tpu.ops.align as A

    rng = np.random.default_rng(11)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    qs = [rng.choice(alpha, int(n)).astype(np.uint8) for n in
          rng.integers(20, 60, size=12)]
    ts = [rng.choice(alpha, int(n)).astype(np.uint8) for n in
          rng.integers(20, 60, size=12)]
    want = A.align_batch(qs, ts, task="path")

    calls = {"n": 0, "max_cells": 0}
    real = A.dp_moves_batch

    def counting(pq, pql, pt, ptl, use_mask=False, eq_flat=None):
        calls["n"] += 1
        calls["max_cells"] = max(calls["max_cells"],
                                 pq.shape[0] * (pq.shape[1] + 1) * (pt.shape[1] + 1))
        return real(pq, pql, pt, ptl, use_mask=use_mask, eq_flat=eq_flat)

    budget = 2 * 80 * 80  # forces ~4 bites for 12 pairs of ~64-padded len
    monkeypatch.setattr(A, "MOVES_BATCH_CELL_BUDGET", budget)
    monkeypatch.setattr(A, "dp_moves_batch", counting)
    got = A.align_batch(qs, ts, task="path")
    assert calls["n"] >= 3
    assert calls["max_cells"] <= budget + 80 * 80  # padding fuzz of one pair
    assert got == want


def test_hirschberg_route_reference_byte_parity(monkeypatch):
    """180 fixtures generated by the reference edlib with its Hirschberg
    memory bound shrunk (HB_BOUND = 2048 and 512) so obtainAlignmentHirschberg
    engages on small pairs: our route must return the reference's SPECIFIC
    co-optimal path byte-for-byte, across NW/SHW/HW and several recursion
    depths. This pins the engage formula (src/edlib.cpp:1190-1193), the
    lt/2 target split, and the split-row scan order (interior rows
    ascending, then row 0, then row Lq — src/edlib.cpp:1326-1361); the two
    routes differ on 17/90 of these pairs, so any divergence is caught."""
    import json

    import stringdecomposer_tpu.ops.align as A

    with open(FIXTURES / "hirschberg_cases.json") as f:
        cases = json.load(f)
    by_bound = {}
    for c in cases:
        by_bound.setdefault(c["bound"], []).append(c)
    assert set(by_bound) == {512, 2048}
    for bound, group in sorted(by_bound.items()):
        monkeypatch.setattr(A, "HB_MEM_BOUND", bound)
        for mode in ["NW", "SHW", "HW"]:
            sub = [c for c in group if c["mode"] == mode]
            res = A.align_batch([c["q"] for c in sub], [c["t"] for c in sub],
                                mode=mode, task="path")
            for c, r in zip(sub, res):
                assert r["editDistance"] == c["ed"], (bound, mode)
                assert r["cigar"] == c["cigar"], (bound, mode, c["q"][:40])


def test_wide_alphabet_equalities_reference_parity():
    """36 reference-edlib cases over a 62-symbol alphabet (26 case-folding
    pairs + 10 digit wildcards): alphabets past 32 distinct symbols take the
    _EqEncoding mode="lut" gather path (reference supports up to 256,
    src/edlib.cpp:16,1420-1459 — round 2 raised ValueError here). Full
    parity: ed, CIGAR, end/start locations, k-threshold, all modes."""
    import json

    with open(FIXTURES / "edlib_wide_eq_cases.json") as f:
        cases = json.load(f)
    alpha = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789"
    pairs_all = [(alpha[i], alpha[26 + i]) for i in range(26)] + \
                [(chr(ord("0") + i), chr(ord("A") + (i % 5))) for i in range(10)]
    assert any(c["ed"] >= 0 for c in cases)
    for c in cases:
        r = align_batch([c["q"]], [c["t"]], mode=c["mode"], task="path",
                        k=c["k"], additional_equalities=pairs_all[: c["npairs"]])[0]
        assert r["editDistance"] == c["ed"], (c["mode"], c["k"])
        if c["ed"] < 0:
            continue
        assert r["cigar"] == c["cigar"], (c["mode"], c["q"][:30])
        assert r["endLocations"] == c["endLocations"]
        if c["startLocations"]:
            assert r["startLocations"] == c["startLocations"]


def test_banded_hirschberg_low_divergence():
    """Low-divergence long pairs take the banded sweep branch (band width
    tracks the exact distance, not Lq); the path must stay valid+optimal
    and identical to the full-sweep recursion's output — the split rows are
    determined by the same (f + b == d) scan order, banded or not."""
    import numpy as np

    from stringdecomposer_tpu.ops.align import _hirschberg_ops

    rng = np.random.default_rng(23)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    t = rng.choice(alpha, 4096).astype(np.uint8)
    q = t.copy()
    mut = rng.random(4096) < 0.02
    q[mut] = rng.choice(alpha, int(mut.sum()))
    ops = _hirschberg_ops(q, t, cell_limit=1024)   # banding engages: d ~ 60
    _validate_ops(ops, q, t, _ref_dist(q, t))
    # known-distance path (align_batch route) must agree exactly
    ops2 = _hirschberg_ops(q, t, cell_limit=1024, dist=_ref_dist(q, t))
    assert ops == ops2


def test_banded_shw_matches_full(align_cases):
    """SHW with 0 <= k takes dp_banded_shw_rows; results must equal the
    full-scan route (which the reference fixtures pin) for every fixture
    pair and k in a spread that includes not-found cases."""
    cases = [c for c in align_cases if c["mode"] == "SHW"][:40]
    qs = [c["q"] for c in cases]
    ts = [c["t"] for c in cases]
    for k in [0, 1, 3, 10]:
        got = align_batch(qs, ts, mode="SHW", task="locations", k=k)
        want = [align_batch([q], [t], mode="SHW", task="locations", k=10**9)[0]
                for q, t in zip(qs, ts)]
        for g, w, c in zip(got, want, cases):
            if w["editDistance"] <= k:
                assert g["editDistance"] == w["editDistance"], c["q"]
                assert g["endLocations"] == w["endLocations"], c["q"]
                assert g["startLocations"] == w["startLocations"]
            else:
                assert g["editDistance"] == -1
                assert g["endLocations"] == []


def test_banded_hw_matches_full():
    """Tall-query HW with small k takes the adaptive-row chunk scan
    (_hw_banded_scan); distance, end locations, and start locations must
    equal the full free-prefix scan's, including the not-found contract."""
    import numpy as np

    import stringdecomposer_tpu.ops.align as A

    rng = np.random.default_rng(5)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    q = rng.choice(alpha, 4000).astype(np.uint8)
    t = rng.choice(alpha, 20000).astype(np.uint8)
    for off in (3000, 12000):
        seg = q.copy()
        mut = rng.random(4000) < 0.01
        seg[mut] = rng.choice(alpha, int(mut.sum()))
        t[off:off + 4000] = seg
    want = align_batch([q], [t], mode="HW", task="locations", k=10**9)[0]
    assert 0 < want["editDistance"] <= 80  # the planted copy is findable
    for k in (80, 200, want["editDistance"] - 1):
        got = align_batch([q], [t], mode="HW", task="locations", k=k)[0]
        if want["editDistance"] <= k:
            assert got["editDistance"] == want["editDistance"]
            assert got["endLocations"] == want["endLocations"]
            assert got["startLocations"] == want["startLocations"]
        else:
            assert got["editDistance"] == -1 and got["endLocations"] == []


def test_nw_distance_doubling_matches_full(monkeypatch):
    """k=-1 NW distances via banded k-doubling (the reference's own
    strategy, src/edlib.cpp:194-212) equal the one-shot full sweep, for
    similar, dissimilar, and degenerate pairs in one batch."""
    import numpy as np

    from stringdecomposer_tpu.ops import align

    rng = np.random.default_rng(30)
    alpha = np.array(list("ACGT"))
    qs, ts = [], []
    for div in (0.0, 0.01, 0.2, 1.0):
        n = int(rng.integers(600, 1400))
        a = rng.integers(0, 4, n)
        b = a.copy() if div < 1.0 else rng.integers(0, 4, n + 37)
        nm = int(n * div) if div < 1.0 else 0
        for i in sorted(rng.choice(n, nm, replace=False).tolist(),
                        reverse=True):
            b[i] = (b[i] + 1 + rng.integers(3)) % 4
        qs.append("".join(alpha[a]))
        ts.append("".join(alpha[b]))
    qs.append("")  # degenerate rows ride along
    ts.append("ACGT")
    want = [r["editDistance"]
            for r in align.align_batch(qs, ts, mode="NW", task="distance")]
    monkeypatch.setattr(align, "NW_DOUBLING_MIN_LEN", 64)
    got = [r["editDistance"]
           for r in align.align_batch(qs, ts, mode="NW", task="distance")]
    assert got == want


# ---------------------------------------------------------------------------
# Banded and k-limited scan routes vs independent NumPy specs
# ---------------------------------------------------------------------------
def _semi_spec(q, t, free_prefix):
    """(best, end locations) of the last DP row, edlib SHW (free_prefix
    False: D[0][j] = j) or HW (True: D[0][j] = 0); end -1 = empty target."""
    import numpy as np

    qa, ta = np.frombuffer(q.encode(), np.uint8), np.frombuffer(t.encode(), np.uint8)
    n = len(ta)
    jj = np.arange(n + 1)
    row = np.zeros(n + 1, np.int64) if free_prefix else jj.copy()
    for i in range(1, len(qa) + 1):
        cand = np.empty(n + 1, np.int64)
        cand[0] = i
        cand[1:] = np.minimum(row[1:] + 1, row[:-1] + (ta != qa[i - 1]))
        row = np.minimum.accumulate(cand - jj) + jj
    best = int(row.min())
    return best, [int(j) - 1 for j in np.flatnonzero(row == best)]


def _mutated_pairs(rng, n_pairs, lo, hi, max_mut):
    import numpy as np

    alpha = np.array(list("ACGT"))
    pairs = []
    for _ in range(n_pairs):
        a = rng.integers(0, 4, int(rng.integers(lo, hi)))
        b = a.copy()
        for i in sorted(rng.choice(len(b), int(rng.integers(0, max_mut)),
                                   replace=False).tolist(), reverse=True):
            r = rng.random()
            if r < 0.6:
                b[i] = (b[i] + 1 + rng.integers(3)) % 4
            elif r < 0.8:
                b = np.delete(b, i)
            else:
                b = np.insert(b, i, rng.integers(4))
        pairs.append(("".join(alpha[a]), "".join(alpha[b])))
    return pairs


@pytest.mark.parametrize("route", [
    "nw_band_k1", "nw_band_k8", "nw_band_k64", "nw_doubling", "nw_path_hirschberg",
    "shw_k48", "hw_k48", "shw_full", "hw_full",
])
def test_scan_routes_match_spec(route, monkeypatch):
    """Each alignment route of ops/align.py (Ukkonen-banded NW, k-doubling,
    Hirschberg path, banded/chunked SHW and HW, full sweeps) against the
    NumPy specs: exact wherever the k-threshold contract observes."""
    import re

    import numpy as np

    import stringdecomposer_tpu.ops.align as A
    from stringdecomposer_tpu.ops.identity import nw_path_spec

    rng = np.random.default_rng(sum(map(ord, route)))
    if route.startswith("nw_"):
        pairs = _mutated_pairs(rng, 3, 150, 320, 40)
        if route == "nw_doubling":
            monkeypatch.setattr(A, "NW_DOUBLING_MIN_LEN", 64)
        if route == "nw_path_hirschberg":
            monkeypatch.setattr(A, "MOVES_CELL_LIMIT", 1 << 12)
        k = int(route[len("nw_band_k"):]) if route.startswith("nw_band") else -1
        task = "path" if route == "nw_path_hirschberg" else "distance"
        res = align_batch([a for a, _ in pairs], [b for _, b in pairs],
                          mode="NW", task=task, k=k)
        for (a, b), r in zip(pairs, res):
            d = nw_path_spec(a, b)[0]
            assert r["editDistance"] == (d if k < 0 or d <= k else -1), (route, d)
            if task == "path":
                ops = re.findall(r"(\d+)([=XID])", r["cigar"])
                n = {c: sum(int(x) for x, y in ops if y == c) for c in "=XID"}
                assert n["="] + n["X"] + n["I"] == len(a)
                assert n["="] + n["X"] + n["D"] == len(b)
                assert n["X"] + n["I"] + n["D"] == d
        return
    mode = route[:3].upper().rstrip("_")
    k = 48 if route.endswith("k48") else -1
    pairs = []
    lo, hi = (750, 900) if route == "hw_k48" else (100, 400)  # HW band: tall queries
    for a, b in _mutated_pairs(rng, 4, lo, hi, 20):
        pad = lambda m: "".join(rng.choice(list("ACGT"), m))  # noqa: E731
        pairs.append((a, pad(int(rng.integers(0, 300))) + b + pad(int(rng.integers(0, 300)))))
    pairs.append(("", "ACGTACGT"))
    res = align_batch([a for a, _ in pairs], [b for _, b in pairs],
                      mode=mode, task="locations", k=k)
    for (a, b), r in zip(pairs, res):
        best, ends = _semi_spec(a, b, free_prefix=mode == "HW")
        if 0 <= k < best:
            assert r["editDistance"] == -1 and r["endLocations"] == [], route
        else:
            assert r["editDistance"] == best, route
            assert r["endLocations"] == ends, route


def test_align_data_parallel_byte_identical(monkeypatch):
    """SDTPU_ALIGN_DP: results over the 8-device virtual mesh (the default
    in this suite) are byte-identical to forced single-device execution —
    rows are independent pairs, sharding must be invisible."""
    import jax
    import numpy as np

    from stringdecomposer_tpu.ops import align as A

    assert len(jax.devices()) >= 2  # conftest forces the virtual mesh
    rng = np.random.default_rng(16)
    alpha = np.array(list("ACGT"))
    qs, ts = [], []
    for _ in range(19):  # odd, > n_dev: exercises row padding
        n = int(rng.integers(50, 500))
        a = rng.integers(0, 4, n)
        b = a.copy()
        for i in sorted(rng.choice(n, int(rng.integers(0, 12)),
                                   replace=False).tolist(), reverse=True):
            b[i] = (b[i] + 1 + rng.integers(3)) % 4
        qs.append("".join(alpha[a]))
        ts.append("".join(alpha[b]))
    for mode, task in (("NW", "path"), ("SHW", "locations"),
                       ("HW", "locations")):
        sharded = A.align_batch(qs, ts, mode=mode, task=task, k=40)
        monkeypatch.setattr(A, "ALIGN_DATA_PARALLEL", "off")
        single = A.align_batch(qs, ts, mode=mode, task=task, k=40)
        monkeypatch.setattr(A, "ALIGN_DATA_PARALLEL", "auto")
        assert sharded == single, (mode, task)
