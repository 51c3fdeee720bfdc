#!/usr/bin/env python3
"""A/B of the device routes: the router's kernels vs plain XLA, in one process.

`kernels`: each kernel alone at the pipeline's shapes, timed to
block_until_ready, median of --reps + 3 calls after a warm call:
  chain_dp  one device batch, [64, 5500] windows x 24 DXZ1 monomers (+RC);
  nw_cross  one packed finishing chunk, 4096 golden-read blocks x 24
            monomers, raw + homopolymer-compressed (196,608 pairs).

End to end: one whole `pipeline.run --second-best` job per input and route,
on two inputs:
  golden  the CHM13 test read (94,871 bp) repeated 32 times;
  array   a 3 Mbp DXZ1-like centromere array (scripts/scale_smoke.synthesize,
          seed 0).
Routes: "router" (ops/backend.py's choice for this platform) and "scan"
(PipelineConfig.backend="scan": the lax.scan chain DP and NW identity).
Each (input, route) is warmed once, then timed --reps times, interleaved
(scan, router, router, scan, ...). The final TSVs of both routes must be
byte-equal, or the script exits 1 before printing any time.

Usage: python scripts/kernel_ab.py [--routes scan,router] [--reps 2]
                                   [--inputs kernels,golden,array]
Prints one JSON line per (input, route) and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(HERE, "stringdecomposer_tpu", "test_data")


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def write_inputs(td: str, names: list[str]) -> dict[str, str]:
    import numpy as np

    sys.path.insert(0, os.path.join(HERE, "scripts"))
    from scale_smoke import synthesize

    from stringdecomposer_tpu.io.fasta import load_fasta

    out = {}
    if "golden" in names:
        rd = load_fasta(os.path.join(DATA, "read.fa"))[0]
        p = os.path.join(td, "golden32.fa")
        with open(p, "w") as f:
            for i in range(32):
                f.write(f">{rd.name}_{i}\n{rd.seq}\n")
        out["golden"] = p
    if "array" in names:
        mono = load_fasta(os.path.join(DATA, "DXZ1_star_monomers.fa"))
        asm = synthesize(3_000_000, mono, np.random.default_rng(0))
        p = os.path.join(td, "array3m.fa")
        with open(p, "w") as f:
            f.write(">array3m\n" + asm + "\n")
        out["array"] = p
    return out


def kernel_times(routes: list[str], reps: int, dev) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(0, os.path.join(HERE, "scripts"))
    from scale_smoke import synthesize

    from stringdecomposer_tpu.finishing import _pad_codes, _upload_read, homo_compress
    from stringdecomposer_tpu.io.fasta import (
        add_rc_interleaved, add_reverse_complement, encode, load_fasta, pad_monomers)
    from stringdecomposer_tpu.ops import backend
    from stringdecomposer_tpu.ops.chain_dp import build_window_batch
    from stringdecomposer_tpu.ops.identity import nw_identity_packed_both
    from stringdecomposer_tpu.report import parse_raw_tsv

    mono_fa = os.path.join(DATA, "DXZ1_star_monomers.fa")
    mono_recs = add_reverse_complement(load_fasta(mono_fa))
    mono, lens = pad_monomers(mono_recs, pad_to=-(-max(len(m.seq) for m in mono_recs) // 8) * 8)
    codes = encode(synthesize(64 * 5000 + 500, load_fasta(mono_fa), np.random.default_rng(0)))
    wb, wl = build_window_batch([codes[o : o + 5500] for o in range(0, 320000, 5000)], 5500)
    wb, wl = jnp.asarray(wb), jnp.asarray(wl)
    read = encode(load_fasta(os.path.join(DATA, "read.fa"), upper=True)[0].seq)
    with open(os.path.join(DATA, "raw_decomposition_oracle.tsv")) as f:
        (_, blocks), = parse_raw_tsv(f.read())
    blocks = (blocks * 8)[:4096]
    starts = np.array([d["start"] for d in blocks], np.int64)
    blens = np.array([d["end"] - d["start"] + 1 for d in blocks], np.int32)
    monos = add_rc_interleaved(load_fasta(mono_fa, upper=True))
    t_raw, tl_raw = _pad_codes([encode(m.seq) for m in monos])
    t_homo, tl_homo = _pad_codes([encode(homo_compress(m.seq)) for m in monos])
    fin_args = (_upload_read(read), starts, blens, jnp.asarray(t_raw), tl_raw,
                jnp.asarray(t_homo), tl_homo)
    mode = {"scan": "scan", "router": "auto"}
    calls = {
        "chain_dp": lambda r: backend.resolve("chain_dp", mode[r], n_mono=mono.shape[0],
                                              mono_len=mono.shape[1])(
            wb, wl, mono, lens, max_blocks=687),
        "nw_cross": lambda r: nw_identity_packed_both(
            *fin_args, n_pad=4096, Lq=256, backend=mode[r]),
    }
    for name, call in calls.items():
        times: dict[str, list[float]] = {r: [] for r in routes}
        for r in routes:
            jax.block_until_ready(call(r))  # compile + warm
        for i in range(reps + 3):
            for r in (routes if i % 2 == 0 else routes[::-1]):
                t0 = time.perf_counter()
                jax.block_until_ready(call(r))
                times[r].append(time.perf_counter() - t0)
        for r in routes:
            ts = sorted(times[r])
            print(json.dumps({
                "kernel": name, "route": r, "wall_s": ts, "median_s": ts[len(ts) // 2],
                "device": f"{dev.platform} {dev.device_kind}", "card": card_line(),
            }), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--routes", default="scan,router")
    ap.add_argument("--inputs", default="kernels,golden,array")
    ap.add_argument("--reps", type=int, default=2)
    a = ap.parse_args()
    sys.path.insert(0, HERE)
    import jax

    from stringdecomposer_tpu.pipeline import run

    dev = jax.devices()[0]
    routes = a.routes.split(",")
    mono_fa = os.path.join(DATA, "DXZ1_star_monomers.fa")
    print(f"card: {card_line()}; jax {jax.__version__}, {dev.platform} "
          f"{dev.device_kind} x{len(jax.devices())}", flush=True)
    if "kernels" in a.inputs.split(","):
        kernel_times(routes, a.reps, dev)
    with tempfile.TemporaryDirectory() as td:
        inputs = write_inputs(td, a.inputs.split(","))
        for name, fa in inputs.items():
            finals = {}
            times: dict[str, list[float]] = {r: [] for r in routes}
            for r in routes:  # warm (compile) + output bytes
                t0 = time.perf_counter()
                final = run(fa, mono_fa, out_dir=os.path.join(td, f"{name}_{r}"),
                            second_best=True, backend="scan" if r == "scan" else "auto")
                warm = time.perf_counter() - t0
                with open(final, "rb") as f:
                    finals[r] = f.read()
                print(f"{name} {r}: warm run {warm:.3f} s", flush=True)
            if len(set(finals.values())) != 1:
                print(f"{name}: final TSVs differ between routes {routes}")
                return 1
            order = []
            for i in range(a.reps):
                order += routes if i % 2 == 0 else routes[::-1]
            for r in order:
                t0 = time.perf_counter()
                run(fa, mono_fa, out_dir=os.path.join(td, f"{name}_{r}_t"),
                    second_best=True, backend="scan" if r == "scan" else "auto")
                times[r].append(time.perf_counter() - t0)
            n_rows = finals[routes[0]].count(b"\n")
            for r in routes:
                ts = sorted(times[r])
                print(json.dumps({
                    "input": name, "route": r, "rows": n_rows,
                    "wall_s": ts, "median_s": ts[len(ts) // 2],
                    "device": f"{dev.platform} {dev.device_kind}",
                    "card": card_line(),
                }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
