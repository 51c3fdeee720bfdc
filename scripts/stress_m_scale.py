#!/usr/bin/env python3
"""Large monomer libraries (M >> 24): correctness vs the oracle at M=128+,
then throughput vs M on the real chip (VERDICT r1 next-#5; real HOR sets
run hundreds of monomers — reference replication point: src/main.cpp:95).

Usage: python scripts/stress_m_scale.py [--quick]
"""

import os
import sys
import time

import numpy as np


def synth_monomers(m_fwd: int, rng, lo=160, hi=185):
    from stringdecomposer_tpu.io.fasta import Record

    alpha = np.array(list("ACGT"))
    return [
        Record(f"m{j}", "".join(rng.choice(alpha, int(rng.integers(lo, hi)))))
        for j in range(m_fwd)
    ]


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, here)
    from stringdecomposer_tpu.io.fasta import add_reverse_complement, encode, pad_monomers
    from stringdecomposer_tpu.ops.chain_dp import build_window_batch
    from stringdecomposer_tpu.ops.oracle import Scoring, decompose_window_oracle
    from stringdecomposer_tpu.ops.traceback import blocks_from_device
    from stringdecomposer_tpu.ops import backend

    quick = "--quick" in sys.argv
    rng = np.random.default_rng(17)
    fails = 0
    t_all = time.perf_counter()

    # ---- correctness: M in {128, 256} vs NumPy oracle on small windows ----
    for m_fwd in ([64] if quick else [64, 128]):
        monomers = add_reverse_complement(synth_monomers(m_fwd, rng))
        M = len(monomers)
        Lpad = (max(len(m.seq) for m in monomers) + 7) // 8 * 8
        mono, lens = pad_monomers(monomers, pad_to=Lpad)
        alpha = np.array(list("ACGT"))
        W = 320
        wins = []
        for b in range(4):
            unit = monomers[int(rng.integers(m_fwd))].seq
            reps = W // len(unit) + 2
            arr = np.array(list((unit * reps)[: int(rng.integers(W // 2, W))]))
            idx = rng.integers(0, len(arr), max(1, len(arr) // 12))
            arr[idx] = rng.choice(alpha, len(idx))
            wins.append(encode("".join(arr)))
        wb, wl = build_window_batch(wins, W)
        fwd = backend.resolve("chain_dp", n_mono=M, mono_len=Lpad)
        bl, ct = fwd(wb, wl, mono, lens)
        bl, ct = np.asarray(bl), np.asarray(ct)
        for b in range(len(wins)):
            want = [
                (k.monomer, k.start, k.end, k.identity)
                for k in decompose_window_oracle(wins[b], mono, lens, Scoring())
            ]
            got = [
                (g.monomer, g.start, g.end, g.identity)
                for g in blocks_from_device(bl[b], ct[b])
            ]
            if got != want:
                fails += 1
                print(f"M={M} window {b}: MISMATCH")
                print("  got ", got[:5])
                print("  want", want[:5])
        print(f"M={M}: correctness vs oracle ok ({len(wins)} windows)", flush=True)

    # ---- throughput vs M on the current backend ----
    if backend.platform() != "cpu" and not quick:
        for m_fwd in [12, 64, 128, 256]:
            monomers = add_reverse_complement(synth_monomers(m_fwd, rng))
            M = len(monomers)
            Lpad = (max(len(m.seq) for m in monomers) + 7) // 8 * 8
            mono, lens = pad_monomers(monomers, pad_to=Lpad)
            W = 5504
            B = max(24, 2048 // M * 8)
            alpha = np.array(list("ACGT"))
            unit = monomers[0].seq
            base = (unit * (W // len(unit) + 2))[:W]
            wins = []
            for _ in range(B):
                arr = np.array(list(base))
                idx = rng.integers(0, W, W // 20)
                arr[idx] = rng.choice(alpha, len(idx))
                wins.append(encode("".join(arr)))
            wb, wl = build_window_batch(wins, W)
            fwd = backend.resolve("chain_dp", n_mono=M, mono_len=Lpad)
            r = fwd(wb, wl, mono, lens)
            np.asarray(r[0])  # warm + sync
            t0 = time.perf_counter()
            r = fwd(wb, wl, mono, lens)
            n_blocks = int(np.asarray(r[1]).sum())
            dt = time.perf_counter() - t0
            avg_len = float(np.mean([len(m.seq) for m in monomers]))
            cells = B * (W - 1) * M * avg_len
            print(
                f"M={M:4d}: B={B:3d} {n_blocks} assignments in {dt:.2f}s = "
                f"{n_blocks/dt:.0f}/s, {cells/dt/1e9:.1f} Gcells/s", flush=True,
            )

    print(f"M-SCALE DONE: {fails} failures in {time.perf_counter()-t_all:.0f}s")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
