"""JAX chain-DP kernel (forward sp-propagation + on-device block walk) vs the
NumPy spec and the reference-binary fixtures."""

import numpy as np
import pytest

from stringdecomposer_tpu.io.fasta import Record, add_reverse_complement, encode, pad_monomers
from stringdecomposer_tpu.ops import oracle
from stringdecomposer_tpu.ops.chain_dp import build_window_batch, chain_dp_forward
from stringdecomposer_tpu.ops.oracle import Scoring
from stringdecomposer_tpu.ops.traceback import blocks_from_device
from stringdecomposer_tpu.pipeline import PipelineConfig, decompose_reads
from stringdecomposer_tpu.report import format_raw_rows


def _pad8(x):
    return (x + 7) // 8 * 8


def _forward_single(codes, mono, lens, sc, debug=False):
    wbatch, wlens = build_window_batch([codes], len(codes))
    return chain_dp_forward(
        wbatch, wlens, mono, lens,
        ins=sc.ins, dele=sc.dele, mismatch=sc.mismatch, match=sc.match,
        return_debug=debug,
    )


def test_forward_matches_oracle_cube(random_cases):
    """chain/end debug arrays of the scan kernel == the NumPy spec's cube."""
    for case in random_cases[:8]:
        monomers = add_reverse_complement([Record(n, s) for n, s in case["monomers"]])
        mono, lens = pad_monomers(monomers, pad_to=_pad8(max(len(m.seq) for m in monomers)))
        sc = Scoring(*case["scoring"])
        seq = case.get("read") or case["reads"][1][1]
        codes = encode(seq[:80])
        dp, chain = oracle.chain_dp_cube(codes, mono, lens, sc)
        _, _, (ch, e, _sp) = _forward_single(codes, mono, lens, sc, debug=True)
        assert np.array_equal(np.asarray(ch[0]), chain)
        ends = np.stack([dp[:, j, lens[j] - 1] for j in range(len(monomers))], axis=1)
        assert np.array_equal(np.asarray(e[0]), ends)


def test_device_blocks_match_oracle(random_cases):
    for idx, case in enumerate(random_cases):
        monomers = add_reverse_complement([Record(n, s) for n, s in case["monomers"]])
        mono, lens = pad_monomers(monomers, pad_to=_pad8(max(len(m.seq) for m in monomers)))
        sc = Scoring(*case["scoring"])
        reads = case.get("reads") or [["read0", case["read"]]]
        for _, seq in reads:
            for off, ln in oracle.make_windows(len(seq), case["part_size"], case["overlap"]):
                codes = encode(seq[off : off + ln])
                want = oracle.decompose_window_oracle(codes, mono, lens, sc)
                blocks, counts = _forward_single(codes, mono, lens, sc)
                got = blocks_from_device(np.asarray(blocks[0]), int(counts[0]))
                assert got == want, f"case {idx} window {off}"


def test_pipeline_matches_reference_raw(random_cases):
    """Full JAX pipeline (batched, padded) == reference binary raw TSV."""
    for idx, case in enumerate(random_cases):
        monomers = add_reverse_complement([Record(n, s) for n, s in case["monomers"]])
        cfg = PipelineConfig(
            scoring=Scoring(*case["scoring"]),
            part_size=case["part_size"],
            overlap=case["overlap"],
            device_batch=3,  # deliberately small to exercise batch padding
        )
        reads = [Record(n, s) for n, s in (case.get("reads") or [["read0", case["read"]]])]
        result = decompose_reads(reads, monomers, cfg)
        rows = []
        names = [m.name for m in monomers]
        for rname, blocks in result:
            rows.extend(format_raw_rows(rname, blocks, names))
        got = "".join(r + "\n" for r in rows)
        assert got == case["raw"], f"case {idx}"


@pytest.mark.slow
def test_full_read_byte_parity(test_data_dir):
    from stringdecomposer_tpu.io.fasta import load_fasta
    from stringdecomposer_tpu.report import write_raw_tsv
    import tempfile, os, filecmp

    reads = load_fasta(test_data_dir / "read.fa")
    monomers = add_reverse_complement(load_fasta(test_data_dir / "DXZ1_star_monomers.fa"))
    result = decompose_reads(reads, monomers, PipelineConfig())
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "raw.tsv")
        write_raw_tsv(out, result, [m.name for m in monomers])
        assert filecmp.cmp(out, test_data_dir / "raw_decomposition_oracle.tsv", shallow=False)


def _case_windows(case):
    monomers = add_reverse_complement([Record(n, s) for n, s in case["monomers"]])
    mono, lens = pad_monomers(monomers, pad_to=_pad8(max(len(m.seq) for m in monomers)))
    seq = case.get("read") or case["reads"][1][1]
    return mono, lens, [encode(seq[:60]), encode(seq[:37]), encode(seq[:64])]


@pytest.mark.parametrize("ci", [0, 1, 2, 3])
def test_padded_batch_matches_oracle(random_cases, ci):
    """Windows of different lengths share one READ_PAD-padded batch (the
    pipeline's layout for every route): each window's blocks equal the NumPy
    spec run on that window alone."""
    case = random_cases[ci]
    mono, lens, wins = _case_windows(case)
    sc = Scoring(*case["scoring"])
    wb, wl = build_window_batch(wins, 64)
    bl, ct = chain_dp_forward(wb, wl, mono, lens, ins=sc.ins, dele=sc.dele,
                              mismatch=sc.mismatch, match=sc.match)
    for b, codes in enumerate(wins):
        got = blocks_from_device(np.asarray(bl[b]), int(ct[b]))
        assert got == oracle.decompose_window_oracle(codes, mono, lens, sc), (ci, b)


def test_per_window_monomers_match_oracle(random_cases):
    """The ed_thr filter hands the DP a per-window [B, M, L] monomer tensor
    with rows reordered and dropped (length 0) per window
    (src/main.cpp:135-149): each window equals the spec run on its own
    monomer subset."""
    mono, lens, wins = _case_windows(random_cases[0])
    wb, wl = build_window_batch(wins, 64)
    B, M, L = len(wins), mono.shape[0], mono.shape[1]
    rng = np.random.default_rng(0)
    mono_b = np.full((B, M, L), 5, dtype=np.int8)
    lens_b = np.zeros((B, M), dtype=np.int32)
    keeps = []
    for b in range(B):
        keep = rng.permutation(M)[: M - b]  # different subset per window
        mono_b[b, : len(keep)] = mono[keep]
        lens_b[b, : len(keep)] = lens[keep]
        keeps.append(keep)
    bl, ct = chain_dp_forward(wb, wl, mono_b, lens_b)
    for b, codes in enumerate(wins):
        got = blocks_from_device(np.asarray(bl[b]), int(ct[b]))
        k = keeps[b]
        assert got == oracle.decompose_window_oracle(codes, mono[k], lens[k], Scoring()), b


def test_large_monomer_library_matches_oracle():
    """M=128 (64 fwd + RC), the HOR-scale row count: oracle-exact. Small
    windows keep the CPU scan fast."""
    rng = np.random.default_rng(23)
    alpha = np.array(list("ACGT"))
    fwd = [
        Record(f"m{j}", "".join(rng.choice(alpha, int(rng.integers(20, 40)))))
        for j in range(64)
    ]
    monomers = add_reverse_complement(fwd)
    mono, lens = pad_monomers(monomers, pad_to=_pad8(max(len(m.seq) for m in monomers)))
    W = 96
    wins = []
    for b in range(2):
        unit = fwd[int(rng.integers(64))].seq
        arr = np.array(list((unit * (W // len(unit) + 2))[: int(rng.integers(50, W))]))
        idx = rng.integers(0, len(arr), max(1, len(arr) // 10))
        arr[idx] = rng.choice(alpha, len(idx))
        wins.append(encode("".join(arr)))
    wb, wl = build_window_batch(wins, W)
    bl, ct = chain_dp_forward(wb, wl, mono, lens)
    bl, ct = np.asarray(bl), np.asarray(ct)
    for b in range(len(wins)):
        want = [(k.monomer, k.start, k.end, k.identity)
                for k in oracle.decompose_window_oracle(wins[b], mono, lens, Scoring())]
        got = [(g.monomer, g.start, g.end, g.identity)
               for g in blocks_from_device(bl[b], ct[b])]
        assert got == want, b
