"""Identity kernel vs reference-edlib fixtures (NW + task=path CIGARs)."""

import re

import numpy as np
import pytest

from stringdecomposer_tpu.io.fasta import encode
from stringdecomposer_tpu.ops.identity import (
    aai_from_counts,
    nw_identity_batch,
    nw_path_spec,
)


def cigar_counts(cigar: str) -> tuple[int, int]:
    """(match_columns, total_columns) from an extended CIGAR, exactly like
    the reference's aai() parsing (main.py:47-59)."""
    total = 0
    n = 0
    for c in cigar:
        if c.isdigit():
            n = n * 10 + int(c)
        else:
            total += n
            n = 0
    matches = sum(int(m[:-1]) for m in re.findall(r"\d+=", cigar))
    return matches, total


def test_spec_matches_edlib_fixtures(edlib_cases):
    for idx, case in enumerate(edlib_cases):
        ed, mt, ln = nw_path_spec(case["q"], case["t"])
        want_mt, want_ln = cigar_counts(case["cigar"])
        assert ed == case["ed"], f"case {idx} distance"
        assert (mt, ln) == (want_mt, want_ln), (
            f"case {idx}: got matches={mt} len={ln}, want {want_mt} {want_ln} "
            f"(q={case['q']} t={case['t']} cigar={case['cigar']})"
        )


def test_batch_kernel_matches_spec(edlib_cases):
    cases = edlib_cases[::7]  # subsample for speed
    Lq = max(len(c["q"]) for c in cases)
    Lt = max(len(c["t"]) for c in cases)
    P = len(cases)
    q = np.zeros((P, Lq), dtype=np.int8)
    t = np.zeros((P, Lt), dtype=np.int8)
    ql = np.zeros(P, dtype=np.int32)
    tl = np.zeros(P, dtype=np.int32)
    for p, c in enumerate(cases):
        q[p, : len(c["q"])] = encode(c["q"])
        ql[p] = len(c["q"])
        t[p, : len(c["t"])] = encode(c["t"])
        tl[p] = len(c["t"])
    D, Mt, Ln = (np.asarray(x) for x in nw_identity_batch(q, ql, t, tl))
    for p, c in enumerate(cases):
        ed, mt, ln = nw_path_spec(c["q"], c["t"])
        assert D[p] == ed and Mt[p] == mt and Ln[p] == ln, f"pair {p}"


def test_aai_reference_op_order():
    # 100*(m/L) with the reference's op order: aai/=total then *100
    assert aai_from_counts(0, 10) == 0.0
    assert aai_from_counts(10, 10) == 100.0
    assert f"{aai_from_counts(157, 170):.2f}" == f"{(157/170)*100:.2f}"


def _pairs(kind):
    """Pair sets at the shapes a kernel's layout can get wrong."""
    rng = np.random.default_rng(3)
    seq = lambda n: "".join(rng.choice(list("ACGT"), int(n)))  # noqa: E731
    if kind == "edge_lengths":  # empty target / query, single chars
        return [("A", ""), ("ACGT" * 8, "ACGT" * 8), ("G" * 17, "G" * 16),
                ("ACGT", "T"), ("", "ACG"), ("AC", "")]
    if kind == "row_boundaries":  # query rows at 32-lane multiples, skews
        pairs = [(seq(a), seq(b)) for a, b in [(31, 31), (32, 40), (63, 64), (64, 1),
                                              (1, 126), (95, 96), (127, 128), (2, 2)]]
        unit = seq(17)
        pairs += [((unit * 9)[: int(rng.integers(80, 126))], unit * int(rng.integers(1, 7)))
                  for _ in range(6)]
        return pairs
    # extreme_variance: short pairs and long outliers padded into one batch
    return ([(seq(rng.integers(5, 30)), seq(rng.integers(5, 30))) for _ in range(12)]
            + [(seq(rng.integers(200, 250)), seq(rng.integers(200, 250))) for _ in range(3)])


@pytest.mark.parametrize("kind", ["edge_lengths", "row_boundaries", "extreme_variance"])
def test_batch_kernel_matches_spec_at_edges(kind):
    pairs = _pairs(kind)
    P = len(pairs)
    Lq = max(1, max(len(a) for a, _ in pairs))
    Lt = max(1, max(len(b) for _, b in pairs))
    q = np.full((P, Lq), 7, dtype=np.int8)
    t = np.full((P, Lt), 7, dtype=np.int8)
    ql = np.array([len(a) for a, _ in pairs], dtype=np.int32)
    tl = np.array([len(b) for _, b in pairs], dtype=np.int32)
    for p, (a, b) in enumerate(pairs):
        q[p, : len(a)] = encode(a) if a else []
        t[p, : len(b)] = encode(b) if b else []
    D, Mt, Ln = (np.asarray(x) for x in nw_identity_batch(q, ql, t, tl))
    for p, (a, b) in enumerate(pairs):
        assert (D[p], Mt[p], Ln[p]) == nw_path_spec(a, b), (kind, p)


def test_cross_matches_pairwise():
    """nw_identity_cross (the packed path's entry): row-major (query,
    target) order, (distance, columns) per pair."""
    from stringdecomposer_tpu.ops.identity import nw_identity_cross

    rng = np.random.default_rng(4)
    qs = [encode("".join(rng.choice(list("ACGT"), n))) for n in (5, 40, 0, 63)]
    ts = [encode("".join(rng.choice(list("ACGT"), n))) for n in (17, 23, 64)]
    q = np.zeros((len(qs), 64), np.int8)
    t = np.zeros((len(ts), 64), np.int8)
    for i, c in enumerate(qs):
        q[i, : len(c)] = c
    for i, c in enumerate(ts):
        t[i, : len(c)] = c
    ql = np.array([len(c) for c in qs], np.int32)
    tl = np.array([len(c) for c in ts], np.int32)
    got = np.asarray(nw_identity_cross(q, ql, t, tl))
    D, _, Ln = (np.asarray(x) for x in nw_identity_batch(
        np.repeat(q, len(ts), 0), np.repeat(ql, len(ts)), np.tile(t, (len(qs), 1)),
        np.tile(tl, len(qs))))
    np.testing.assert_array_equal(got, np.stack([D, Ln], axis=1))
