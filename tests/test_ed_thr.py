"""ed_thr monomer pre-filter vs reference-binary fixtures."""

import json
import pathlib

import numpy as np
import pytest

from stringdecomposer_tpu.io.fasta import Record, add_reverse_complement, encode, pad_monomers
from stringdecomposer_tpu.ops.hw_filter import filter_monomers, hw_distance_batch
from stringdecomposer_tpu.ops.chain_dp import build_window_batch
from stringdecomposer_tpu.ops.oracle import Scoring
from stringdecomposer_tpu.pipeline import PipelineConfig, decompose_reads
from stringdecomposer_tpu.report import format_raw_rows

FIXTURES = pathlib.Path(__file__).parent / "fixtures"


@pytest.fixture(scope="module")
def ed_thr_cases():
    cases = []
    for name in ["ed_thr_cases.json", "ed_thr_cases_b.json"]:
        with open(FIXTURES / name) as f:
            cases.extend(json.load(f))
    return cases


def test_hw_distance_matches_spec(edlib_cases):
    """HW distance vs a brute-force NumPy infix DP on random pairs."""

    def hw_ref(q, t):
        m, n = len(q), len(t)
        D = np.zeros((m + 1, n + 1), dtype=np.int32)
        D[:, 0] = np.arange(m + 1)
        D[0, :] = 0
        for i in range(1, m + 1):
            for j in range(1, n + 1):
                D[i, j] = min(
                    D[i - 1, j] + 1, D[i, j - 1] + 1,
                    D[i - 1, j - 1] + (0 if q[i - 1] == t[j - 1] else 1),
                )
        return int(D[m].min())

    cases = [c for c in edlib_cases[:40]]
    Lq = max(len(c["q"]) for c in cases)
    Lt = max(len(c["t"]) for c in cases)
    mono = np.full((len(cases), Lq), 5, np.int8)
    ml = np.zeros(len(cases), np.int32)
    win = np.full((len(cases), Lt), 6, np.int8)
    wl = np.zeros(len(cases), np.int32)
    for i, c in enumerate(cases):
        mono[i, : len(c["q"])] = encode(c["q"])
        ml[i] = len(c["q"])
        win[i, : len(c["t"])] = encode(c["t"])
        wl[i] = len(c["t"])
    # batch as [B=1 window set per pair] trick: evaluate pairwise via diagonal
    dist = np.asarray(hw_distance_batch(win, wl, mono, ml))
    for i, c in enumerate(cases):
        assert dist[i, i] == hw_ref(c["q"], c["t"]), i


def test_ed_thr_pipeline_matches_reference(ed_thr_cases):
    for idx, case in enumerate(ed_thr_cases):
        monomers = add_reverse_complement([Record(n, s) for n, s in case["monomers"]])
        cfg = PipelineConfig(
            scoring=Scoring(*case["scoring"]),
            part_size=case["part_size"],
            overlap=case["overlap"],
            device_batch=3,
            ed_thr=case["ed_thr"],
        )
        reads = [Record("read0", case["read"])]
        result = decompose_reads(reads, monomers, cfg)
        rows = []
        names = [m.name for m in monomers]
        for rname, blocks in result:
            rows.extend(format_raw_rows(rname, blocks, names))
        got = "".join(r + "\n" for r in rows)
        assert got == case["raw"], f"case {idx} (ed_thr={case['ed_thr']})"
