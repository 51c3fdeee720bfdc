#!/usr/bin/env python3
"""Benchmark: chain-DP (raw decomposition) throughput on the device.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

Baseline (BASELINE.md): the reference C++ dp stage emits 557 monomer
assignments for the 94,871 bp test read in 3.58 s on one CPU thread
(~156 assignments/s). Correctness is asserted in-run: the raw TSV must be
byte-identical to the reference binary's output before any number is
reported, and the full overlapped pipeline (DP + rescoring interleaved on
the device queue) must reproduce the reference golden final TSV.
"""

import json
import sys
import time

BASELINE_ASSIGN_PER_S = 557 / 3.58  # reference dp binary, 1 CPU thread


def main() -> int:
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    data = os.path.join(here, "stringdecomposer_tpu", "test_data")

    from stringdecomposer_tpu.io.fasta import add_reverse_complement, load_fasta
    from stringdecomposer_tpu.pipeline import PipelineConfig, decompose_reads
    from stringdecomposer_tpu.report import format_raw_rows

    reads = load_fasta(os.path.join(data, "read.fa"))
    monomers = add_reverse_complement(load_fasta(os.path.join(data, "DXZ1_star_monomers.fa")))
    cfg = PipelineConfig(device_batch=152)

    # correctness gate 1: raw TSV byte equality with the reference binary
    result = decompose_reads(reads, monomers, cfg)  # also warms the compile cache
    rows = []
    names = [m.name for m in monomers]
    for rname, blocks in result:
        rows.extend(format_raw_rows(rname, blocks, names))
    got = "".join(r + "\n" for r in rows)
    with open(os.path.join(data, "raw_decomposition_oracle.tsv")) as f:
        if got != f.read():
            print(json.dumps({"metric": "CORRECTNESS_FAILURE", "value": 0,
                              "unit": "", "vs_baseline": 0}))
            return 1
    n_assignments = len(rows)

    # throughput: repeat the read to saturate the device batch
    REP = 32
    reps = max(1, REP)
    big_reads = reads * reps
    decompose_reads(big_reads, monomers, cfg)  # warm any new shapes
    # median of 5 repeats
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        decompose_reads(big_reads, monomers, cfg)
        times.append(time.perf_counter() - t0)
    dt = sorted(times)[len(times) // 2]
    assign_per_s = n_assignments * reps / dt
    # DP cell throughput: windows x positions x monomers x avg monomer len
    n_windows = sum(max(1, (len(r.seq) - 500 + 4999) // 5000) for r in big_reads)
    avg_len = sum(len(m.seq) for m in monomers) / len(monomers)
    cells = n_windows * 5500 * len(monomers) * avg_len
    gcells = cells / dt / 1e9

    # correctness gate 2 + e2e throughput: the OVERLAPPED pipeline
    # (pipeline.run streams raw rows as windows finalize and interleaves the
    # finishing stage's identity batches with later windows' DP on the device
    # queue). Gate: golden final TSV on the CHM13 read; throughput: warm
    # MEDIAN-OF-3 runs on 1.6 Mbp and 20 Mbp synthetic assemblies, BOTH at
    # the same thread setting (-t 1; round-4 verdict weak #4) and both
    # warm-run first (round 4's 20 Mbp leg silently paid cold tail-shape
    # compiles inside the timed region).
    import tempfile

    from stringdecomposer_tpu.pipeline import run as pipeline_run

    with tempfile.TemporaryDirectory() as td:
        out = pipeline_run(
            os.path.join(data, "read.fa"),
            os.path.join(data, "DXZ1_star_monomers.fa"),
            out_dir=td, second_best=True, device_batch=152,
        )
        with open(out) as f_got, open(
            os.path.join(data, "final_decomposition_fc89af8.tsv")
        ) as f_want:
            if f_got.read() != f_want.read():
                print(json.dumps({"metric": "CORRECTNESS_FAILURE_E2E", "value": 0,
                                  "unit": "", "vs_baseline": 0}))
                return 1

    sys.path.insert(0, os.path.join(here, "scripts"))
    import numpy as np
    from scale_smoke import synthesize
    from stringdecomposer_tpu.utils import stagetimer

    monomers_fwd = load_fasta(os.path.join(data, "DXZ1_star_monomers.fa"))
    mono_fa = os.path.join(data, "DXZ1_star_monomers.fa")

    def e2e_point(n_bp: int, seed: int, timed_reps: int = 3):
        """Median warm e2e (rows, rows/s) + a stage split of the last rep."""
        asm = synthesize(n_bp, monomers_fwd, np.random.default_rng(seed))
        with tempfile.TemporaryDirectory() as td:
            asm_fa = os.path.join(td, "asm.fa")
            with open(asm_fa, "w") as f:
                f.write(">asm\n" + asm + "\n")
            pipeline_run(asm_fa, mono_fa, out_dir=os.path.join(td, "w"),
                         second_best=True, device_batch=152)  # warm
            times = []
            for rep in range(timed_reps):
                if rep == timed_reps - 1:
                    stagetimer.enable()
                t0 = time.perf_counter()
                final = pipeline_run(asm_fa, mono_fa,
                                     out_dir=os.path.join(td, f"t{rep}"),
                                     second_best=True, device_batch=152)
                times.append(time.perf_counter() - t0)
            stagetimer.disable()
            with open(final) as f:
                n_rows = sum(1 for _ in f)
        dt = sorted(times)[len(times) // 2]
        split = {k: round(v, 3) for k, v in sorted(stagetimer.snapshot().items())}
        return n_rows, n_rows / dt, split

    n_e2e, e2e_assign_per_s, split_16 = e2e_point(1_600_000, 0)
    n_20, e2e_20m_per_s, split_20 = e2e_point(20_000_000, 1, timed_reps=3)

    print(json.dumps({
        "metric": "monomer assignments/s per chip (raw DP stage, test read, TSV byte-verified)",
        "value": round(assign_per_s, 1),
        "unit": "assignments/s",
        "vs_baseline": round(assign_per_s / BASELINE_ASSIGN_PER_S, 2),
        "extra": {
            "dp_gcells_per_s": round(gcells, 2),
            "e2e_second_best_assignments_per_s": round(e2e_assign_per_s, 1),
            "e2e_vs_dp_stage": round(assign_per_s / e2e_assign_per_s, 2),
            "e2e_20mbp_assignments_per_s": round(e2e_20m_per_s, 1),
            "e2e_20mbp_vs_dp_stage": round(assign_per_s / e2e_20m_per_s, 2),
            "stage_split_1p6mbp_s": split_16,
            "stage_split_20mbp_s": split_20,
            "e2e_includes": "full pipeline.run (-t 1, median of 3 warm runs): overlapped DP + 48-way rescoring + reliability + TSV write; golden-byte-verified on the test read",
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
