"""CUDA kernels (ops/gpu_kernels.py) vs the plain lax.scan programs, on the
card, at the pipeline's real widths. Every DP state is int32 and the
pipeline holds no float32 matrix product on this path (reliability flags
are decided in float64 on the host, models/reliability.py), so TF32 does not
apply and every comparison is bit-exact: tolerance 0.

These tests carry the `gpu` marker and skip without an NVIDIA GPU; on the
card they run inside `python chip_smoke.py` (or
`JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu_kernels.py`).
"""

import os
import sys

import numpy as np
import pytest

from stringdecomposer_tpu.io.fasta import (
    add_rc_interleaved, add_reverse_complement, encode, load_fasta, pad_monomers,
)
from stringdecomposer_tpu.ops.chain_dp import build_window_batch, chain_dp_forward
from stringdecomposer_tpu.ops.identity import nw_identity_batch, nw_path_spec

pytestmark = pytest.mark.gpu

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "..", "stringdecomposer_tpu", "test_data")


@pytest.fixture(scope="module")
def dxz1():
    """DXZ1 monomers + RC, padded as the pipeline pads them ([24, 176])."""
    mono_recs = add_reverse_complement(load_fasta(os.path.join(DATA, "DXZ1_star_monomers.fa")))
    L = -(-max(len(m.seq) for m in mono_recs) // 8) * 8
    mono, lens = pad_monomers(mono_recs, pad_to=L)
    return mono, lens


@pytest.fixture(scope="module")
def array_windows():
    """5,500-bp windows of a synthesized DXZ1 array (scripts/scale_smoke)."""
    sys.path.insert(0, os.path.join(HERE, "..", "scripts"))
    from scale_smoke import synthesize

    fwd = load_fasta(os.path.join(DATA, "DXZ1_star_monomers.fa"))
    asm = synthesize(64 * 5000 + 500, fwd, np.random.default_rng(7))
    codes = encode(asm)
    return [codes[o : o + 5500] for o in range(0, 64 * 5000, 5000)]


@pytest.mark.parametrize("B", [24, 48, 64])
def test_chain_dp_cuda_matches_scan(gpu, dxz1, array_windows, B):
    from stringdecomposer_tpu.ops.gpu_kernels import chain_dp_forward_cuda

    mono, lens = dxz1
    wins = array_windows[:B]
    wins[-1] = wins[-1][:3001]  # one short window: padded tail positions
    wb, wl = build_window_batch(wins, 5500)
    want = chain_dp_forward(wb, wl, mono, lens, max_blocks=687, return_debug=True)
    got = chain_dp_forward_cuda(wb, wl, mono, lens, max_blocks=687, return_debug=True)
    for name, a, b in zip(("blocks", "counts"), want[:2], got[:2]):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=name)
    for name, a, b in zip(("chain", "end", "spend"), want[2], got[2]):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=name)


def test_chain_dp_cuda_per_window_monomers(gpu, dxz1, array_windows):
    """--ed_thr hands the DP a per-window [B, M, L] monomer tensor with rows
    reordered and dropped (length 0) per window."""
    import jax.numpy as jnp

    from stringdecomposer_tpu.ops.gpu_kernels import chain_dp_forward_cuda
    from stringdecomposer_tpu.ops.hw_filter import filter_monomers_device, hw_distance_batch

    mono, lens = dxz1
    wb, wl = build_window_batch(array_windows[:24], 5500)
    dist = hw_distance_batch(wb, wl, mono, lens)
    mono_w, lens_w, _ = filter_monomers_device(dist, jnp.asarray(mono), jnp.asarray(lens), 40)
    assert int(np.asarray(lens_w == 0).sum()) > 0  # some rows really dropped
    want = chain_dp_forward(wb, wl, mono_w, lens_w, return_debug=True)
    got = chain_dp_forward_cuda(wb, wl, mono_w, lens_w, return_debug=True)
    for a, b in zip(want[:2] + want[2], got[:2] + got[2]):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_chain_dp_cuda_matches_oracle(gpu, dxz1, array_windows):
    """One full window against the NumPy spec of the reference DP and
    traceback (ops/oracle.py)."""
    from stringdecomposer_tpu.ops.gpu_kernels import chain_dp_forward_cuda
    from stringdecomposer_tpu.ops.oracle import Scoring, decompose_window_oracle
    from stringdecomposer_tpu.ops.traceback import blocks_from_device

    mono, lens = dxz1
    win = array_windows[3]
    wb, wl = build_window_batch([win], 5500)
    bl, ct = chain_dp_forward_cuda(wb, wl, mono, lens)
    got = [(b.monomer, b.start, b.end, b.identity)
           for b in blocks_from_device(np.asarray(bl)[0], int(np.asarray(ct)[0]))]
    want = [(b.monomer, b.start, b.end, b.identity)
            for b in decompose_window_oracle(win, mono, lens, Scoring())]
    assert got == want


@pytest.fixture(scope="module")
def finishing_pairs():
    """The golden read's real finishing mix: every raw-decomposition block
    against every interleaved monomer, raw and homopolymer-compressed."""
    from stringdecomposer_tpu.finishing import _homo_codes, _pad_codes
    from stringdecomposer_tpu.report import parse_raw_tsv

    read = encode(load_fasta(os.path.join(DATA, "read.fa"), upper=True)[0].seq)
    with open(os.path.join(DATA, "raw_decomposition_oracle.tsv")) as f:
        (_, blocks), = parse_raw_tsv(f.read())
    monos = add_rc_interleaved(load_fasta(os.path.join(DATA, "DXZ1_star_monomers.fa"), upper=True))
    out = {}
    for variant in ("raw", "homo"):
        f = _homo_codes if variant == "homo" else (lambda c: c)
        subs = [f(read[d["start"] : d["end"] + 1]) for d in blocks]
        targets = [f(encode(m.seq)) for m in monos]
        qs = [s for s in subs for _ in targets]
        ts = [t for _ in subs for t in targets]
        q, ql = _pad_codes(qs, min_len=256)
        t, tl = _pad_codes(ts, min_len=256)
        out[variant] = (q, ql, t, tl, subs, targets)
    return out


@pytest.mark.parametrize("variant", ["raw", "homo"])
def test_nw_cuda_matches_scan(gpu, finishing_pairs, variant):
    from stringdecomposer_tpu.ops.gpu_kernels import nw_identity_batch_cuda

    q, ql, t, tl, _, _ = finishing_pairs[variant]
    assert len(ql) == 557 * 24  # 557 golden blocks x 24 monomers
    want = nw_identity_batch(q, ql, t, tl)
    got = nw_identity_batch_cuda(q, ql, t, tl)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_nw_cuda_matches_edlib_spec_sample(gpu, finishing_pairs):
    """A sample of real pairs against the NumPy spec of edlib's path."""
    from stringdecomposer_tpu.ops.gpu_kernels import nw_identity_batch_cuda

    q, ql, t, tl, _, _ = finishing_pairs["raw"]
    idx = np.random.default_rng(0).choice(len(ql), 24, replace=False)
    D, mt, ln = (np.asarray(x) for x in nw_identity_batch_cuda(q[idx], ql[idx], t[idx], tl[idx]))
    for n, p in enumerate(idx):
        want = nw_path_spec(q[p, : ql[p]], t[p, : tl[p]])
        assert (int(D[n]), int(mt[n]), int(ln[n])) == want, p


def test_packed_cross_cuda_matches_scan(gpu, finishing_pairs):
    """The packed finishing path (block extraction, on-device homo collapse,
    cross product) on the router's kernel vs the same path on the scan."""
    import jax.numpy as jnp

    from stringdecomposer_tpu.finishing import _pad_codes
    from stringdecomposer_tpu.ops.identity import nw_identity_packed_both
    from stringdecomposer_tpu.report import parse_raw_tsv

    read = encode(load_fasta(os.path.join(DATA, "read.fa"), upper=True)[0].seq)
    with open(os.path.join(DATA, "raw_decomposition_oracle.tsv")) as f:
        (_, blocks), = parse_raw_tsv(f.read())
    starts = np.array([d["start"] for d in blocks], np.int64)
    lens = np.array([d["end"] - d["start"] + 1 for d in blocks], np.int32)
    _, _, _, _, _, raw_t = finishing_pairs["raw"]
    _, _, _, _, _, homo_t = finishing_pairs["homo"]
    t_raw, tl_raw = _pad_codes(raw_t)
    t_homo, tl_homo = _pad_codes(homo_t)
    args = (jnp.asarray(read), starts, lens, jnp.asarray(t_raw), tl_raw,
            jnp.asarray(t_homo), tl_homo)
    want = nw_identity_packed_both(*args, n_pad=1024, Lq=256, backend="scan")
    got = nw_identity_packed_both(*args, n_pad=1024, Lq=256, backend="auto")
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
