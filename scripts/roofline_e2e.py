#!/usr/bin/env python3
"""Kernel-only device rates + the two-stage e2e roofline.

Measures, with block_until_ready (no pipeline, no host assembly):
  - the chain-DP kernel on a full [B, 5504] window batch  -> assignments/s
  - the packed finishing kernel (raw+homo x M cross product) on a
    representative 4096-block group                        -> blocks/s

and prints roofline = 1 / (1/dp + 1/fin): the throughput an e2e
`--second-best` run would hit if BOTH stages ran back-to-back on the device
with zero host cost. The e2e gap metric (bench.py `e2e_vs_roofline`) is
measured against this, not against the DP stage alone (round-4 verdict
weak #1: the old `e2e_vs_dp_stage` ratio mixed mandatory finishing work
into "overhead").

Usage: python scripts/roofline_e2e.py [--reps 5]
"""

import argparse
import json
import os
import sys
import time

here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, here)
sys.path.insert(0, os.path.join(here, "scripts"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device-batch", type=int, default=152)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from scale_smoke import synthesize
    from stringdecomposer_tpu.finishing import _DeviceFinishCtx, homo_compress
    from stringdecomposer_tpu.io.fasta import (add_reverse_complement,
                                               add_rc_interleaved, encode,
                                               load_fasta, pad_monomers)
    from stringdecomposer_tpu.ops import backend
    from stringdecomposer_tpu.ops.chain_dp import build_window_batch
    from stringdecomposer_tpu.ops.identity import nw_identity_packed_both
    from stringdecomposer_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    data = os.path.join(here, "stringdecomposer_tpu", "test_data")
    monomers_fwd = load_fasta(os.path.join(data, "DXZ1_star_monomers.fa"))
    monomers_dp = add_reverse_complement(monomers_fwd)
    monomers_fin = add_rc_interleaved(load_fasta(
        os.path.join(data, "DXZ1_star_monomers.fa"), upper=True))
    rng = np.random.default_rng(0)
    asm = synthesize(2_000_000, monomers_fwd, rng)
    codes = encode(asm)

    # ---- DP kernel only: B full windows, median-of-reps device wall
    B = args.device_batch
    W = 5504
    mono, mono_lens = pad_monomers(monomers_dp, pad_to=192)
    wins = [codes[i * 5000 : i * 5000 + 5500] for i in range(B)]
    wbatch, wlens = build_window_batch(wins, 5500)
    cap = min(W, max(256, 5500 // 8))

    forward = backend.resolve("chain_dp", n_mono=mono.shape[0], mono_len=mono.shape[1])

    def dp_once():
        jax.block_until_ready(forward(wbatch, wlens, mono, mono_lens, max_blocks=cap))

    dp_once()  # warm
    dp_times = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        dp_once()
        dp_times.append(time.perf_counter() - t0)
    dp_wall = sorted(dp_times)[len(dp_times) // 2]
    # ~5000/171 assignments per window (alpha-satellite density)
    blocks_per_window = 5000 / 171.0
    dp_rate = B * blocks_per_window / dp_wall

    # ---- finishing kernel only: 4096 blocks x (raw+homo) x M
    mono_codes = [encode(m.seq) for m in monomers_fin]
    homo_codes = [encode(homo_compress(m.seq)) for m in monomers_fin]
    ctx = _DeviceFinishCtx(mono_codes, homo_codes)
    n = 4096
    starts = (rng.integers(0, len(codes) - 400, n)).astype(np.int64)
    lens = rng.integers(150, 195, n).astype(np.int32)
    read_dev = jnp.asarray(codes)
    Lq = 256

    def fin_once():
        jax.block_until_ready(nw_identity_packed_both(
            read_dev, starts, lens, ctx.t_raw, ctx.tl_raw, ctx.t_homo,
            ctx.tl_homo, n_pad=n, Lq=Lq))

    fin_once()  # warm
    fin_times = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        fin_once()
        fin_times.append(time.perf_counter() - t0)
    fin_wall = sorted(fin_times)[len(fin_times) // 2]
    fin_rate = n / fin_wall

    roofline = 1.0 / (1.0 / dp_rate + 1.0 / fin_rate)
    print(json.dumps({
        "dp_kernel_wall_s": round(dp_wall, 4),
        "dp_kernel_assignments_per_s": round(dp_rate, 1),
        "fin_kernel_wall_s": round(fin_wall, 4),
        "fin_kernel_blocks_per_s": round(fin_rate, 1),
        "two_stage_roofline_per_s": round(roofline, 1),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
