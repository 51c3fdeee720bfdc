#!/usr/bin/env python3
"""A/B the -t/--threads host parallelism on a synthetic assembly.

Round-2 verdict item 6 done-criterion: 20 Mbp e2e (--second-best) improves
measurably with -t 4 vs -t 1 and stays byte-identical. Runs the full
pipeline twice per thread count (first pass warms every compiled shape),
times the warm pass, and diffs all three output TSVs.

Usage: python scripts/ab_threads.py [Mbp] [threads_list]
       python scripts/ab_threads.py 20 1,4
"""

import os
import sys
import tempfile
import time


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, here)
    sys.path.insert(0, os.path.join(here, "scripts"))
    import numpy as np

    from scale_smoke import synthesize
    from stringdecomposer_tpu.io.fasta import load_fasta
    from stringdecomposer_tpu.pipeline import run as pipeline_run

    mbp = float(sys.argv[1]) if len(sys.argv) > 1 else 20.0
    threads_list = [int(x) for x in (sys.argv[2] if len(sys.argv) > 2 else "1,4").split(",")]
    data = os.path.join(here, "stringdecomposer_tpu", "test_data")
    mono_fa = os.path.join(data, "DXZ1_star_monomers.fa")
    monomers_fwd = load_fasta(mono_fa)
    asm = synthesize(int(mbp * 1e6), monomers_fwd, np.random.default_rng(1))

    outputs: dict[int, dict[str, str]] = {}
    walls: dict[int, float] = {}
    with tempfile.TemporaryDirectory() as td:
        asm_fa = os.path.join(td, "asm.fa")
        with open(asm_fa, "w") as f:
            f.write(">asm\n" + asm + "\n")
        # warm every compiled shape once (threads don't change shapes)
        pipeline_run(asm_fa, mono_fa, out_dir=os.path.join(td, "warm"),
                     second_best=True, device_batch=152, threads=threads_list[0])
        for t in threads_list:
            od = os.path.join(td, f"t{t}")
            t0 = time.perf_counter()
            final = pipeline_run(asm_fa, mono_fa, out_dir=od,
                                 second_best=True, device_batch=152, threads=t)
            walls[t] = time.perf_counter() - t0
            outputs[t] = {}
            for suffix in ("", "_alt", "_raw"):
                p = os.path.join(od, f"final_decomposition{suffix}.tsv")
                with open(p) as f:
                    outputs[t][suffix] = f.read()
            n = outputs[t][""].count("\n")
            print(f"-t {t}: {walls[t]:8.2f}s  ({n / walls[t]:,.0f} assignments/s)",
                  flush=True)

    base = threads_list[0]
    ok = all(outputs[t] == outputs[base] for t in threads_list[1:])
    print("BYTES_IDENTICAL" if ok else "BYTES_DIFFER", flush=True)
    for t in threads_list[1:]:
        print(f"-t {t} speedup vs -t {base}: {walls[base] / walls[t]:.2f}x")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
