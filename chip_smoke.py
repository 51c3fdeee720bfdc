#!/usr/bin/env python3
"""Card check: drives the decomposition pipeline on one NVIDIA GPU, in this
one process, and exits nonzero if any phase fails.

  1. device: JAX must see a GPU; prints the card, JAX version, and whether
     the native host library and the CUDA kernel library loaded;
  2. golden CLI run (`cli.main`, --second-best): final and raw TSVs
     byte-equal to the reference; then --serve answers two jobs from stdin;
  3. a 3 Mbp DXZ1-like array (scripts/scale_smoke.synthesize, seed 0)
     through pipeline.run --second-best, once on the router's kernels and
     once on the plain scan path (backend="scan"): final, alt and raw TSVs
     byte-equal; prints wall seconds and peak device memory;
  4. kernel parity at real widths: the `gpu`-marked tests, in this process.

With --four-cards it runs only the --data-parallel path over four cards:
the golden read (byte-equal to the reference) and the 3 Mbp array
(byte-equal to the same array over a one-device mesh).

The last line of stdout is {"ok": true, "device": {...}}; nothing else is
printed after it and it is never printed on failure.

Usage: python chip_smoke.py [--four-cards]
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "stringdecomposer_tpu", "test_data")
READ = os.path.join(DATA, "read.fa")
MONO = os.path.join(DATA, "DXZ1_star_monomers.fa")
GOLDEN_FINAL = os.path.join(DATA, "final_decomposition_fc89af8.tsv")
GOLDEN_RAW = os.path.join(DATA, "raw_decomposition_oracle.tsv")
ARRAY_BP = 3_000_000


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)
    print(f"PASS {what}", flush=True)


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip().splitlines()[0]


def read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def outputs(out_dir: str) -> dict[str, bytes]:
    return {k: read_bytes(os.path.join(out_dir, f"final_decomposition{k}.tsv"))
            for k in ("", "_alt", "_raw")}


def write_array(td: str) -> str:
    import numpy as np

    sys.path.insert(0, os.path.join(HERE, "scripts"))
    from scale_smoke import synthesize

    from stringdecomposer_tpu.io.fasta import load_fasta

    asm = synthesize(ARRAY_BP, load_fasta(MONO), np.random.default_rng(0))
    path = os.path.join(td, "array3m.fa")
    with open(path, "w") as f:
        f.write(">array3m\n" + asm + "\n")
    return path


def phase_device():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SmokeFailure(f"no GPU: JAX's first device is {dev.platform}")
    print(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}, "
          f"jax {jax.__version__}", flush=True)
    print(f"card: {card_line()}", flush=True)
    sys.path.insert(0, HERE)
    from stringdecomposer_tpu.ops import gpu_kernels
    from stringdecomposer_tpu.runtime.native import load_native

    print(f"native host library loaded: {load_native() is not None}", flush=True)
    t0 = time.perf_counter()
    lib = gpu_kernels.build_library()
    print(f"CUDA kernel library: {os.path.basename(lib)} "
          f"({time.perf_counter() - t0:.1f} s to build or find)", flush=True)
    return dev


def phase_golden(td: str) -> None:
    from stringdecomposer_tpu import cli

    out = os.path.join(td, "golden")
    t0 = time.perf_counter()
    rc = cli.main([READ, MONO, "-o", out, "--second-best"])
    check(rc == 0, f"golden CLI run exits 0 ({time.perf_counter() - t0:.1f} s)")
    got = outputs(out)
    check(got[""] == read_bytes(GOLDEN_FINAL), "golden final TSV byte-equal")
    check(got["_raw"] == read_bytes(GOLDEN_RAW), "golden raw TSV byte-equal")

    jobs = "".join(f"{READ} {MONO} -o {os.path.join(td, f'serve{i}')} --second-best\n"
                   for i in range(2))
    buf = io.StringIO()
    stdin, sys.stdin = sys.stdin, io.StringIO(jobs)
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["--serve"])
        dt = time.perf_counter() - t0
    finally:
        sys.stdin = stdin
    replies = [json.loads(x) for x in buf.getvalue().splitlines() if x.startswith("{")]
    print(f"serve replies: {replies}", flush=True)
    check(rc == 0 and len(replies) == 2 and all(r["status"] == "ok" for r in replies),
          f"--serve answered 2 jobs ({dt:.1f} s)")
    for i in range(2):
        got = outputs(os.path.join(td, f"serve{i}"))
        check(got[""] == read_bytes(GOLDEN_FINAL), f"serve job {i} final TSV byte-equal")


def phase_array(td: str, card: str) -> None:
    import jax

    from stringdecomposer_tpu.pipeline import run

    fa = write_array(td)
    dev = jax.devices()[0]
    res = {}
    for route in ("auto", "scan"):
        out = os.path.join(td, f"array_{route}")
        t0 = time.perf_counter()
        run(fa, MONO, out_dir=out, second_best=True, backend=route)
        dt = time.perf_counter() - t0
        peak = dev.memory_stats().get("peak_bytes_in_use", -1)
        res[route] = outputs(out)
        rows = res[route][""].count(b"\n")
        print(f"3 Mbp array, backend={route}: {dt:.3f} s wall incl. compile, "
              f"{rows} rows, peak_bytes_in_use {peak} [{card}]", flush=True)
    for k in ("", "_alt", "_raw"):
        check(res["auto"][k] == res["scan"][k],
              f"3 Mbp final{k or ''} TSV byte-equal: router kernels vs plain scan")


def phase_parity() -> None:
    import pytest

    class Count:
        def __init__(self):
            self.n = {"passed": 0, "failed": 0, "skipped": 0}

        def pytest_runtest_logreport(self, report):
            if report.when == "call" or report.outcome != "passed":
                self.n[report.outcome] += 1

    c = Count()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(HERE, "tests", "test_gpu_kernels.py")], plugins=[c])
    check(rc == 0 and c.n["failed"] == 0 and c.n["skipped"] == 0 and c.n["passed"] > 0,
          f"gpu-marked kernel parity tests: {c.n}")


def phase_four_cards(td: str) -> None:
    import jax

    from stringdecomposer_tpu import cli
    from stringdecomposer_tpu.parallel.mesh import get_mesh
    from stringdecomposer_tpu.parallel.sharding import make_sharded_forward, make_sharded_identity
    from stringdecomposer_tpu.pipeline import run

    devs = jax.devices()
    if len(devs) != 4:
        raise SmokeFailure(f"--four-cards needs 4 GPUs, JAX sees {len(devs)}")
    out = os.path.join(td, "golden4")
    t0 = time.perf_counter()
    rc = cli.main([READ, MONO, "-o", out, "--second-best", "--data-parallel"])
    check(rc == 0, f"golden --data-parallel over 4 cards exits 0 ({time.perf_counter() - t0:.1f} s)")
    got = outputs(out)
    check(got[""] == read_bytes(GOLDEN_FINAL), "4-card golden final TSV byte-equal")
    check(got["_raw"] == read_bytes(GOLDEN_RAW), "4-card golden raw TSV byte-equal")

    fa = write_array(td)
    res = {}
    for n in (4, 1):
        mesh = get_mesh(devs[:n])
        out = os.path.join(td, f"array_mesh{n}")
        t0 = time.perf_counter()
        run(fa, MONO, out_dir=out, second_best=True,
            forward_fn=make_sharded_forward(mesh), identity_kernel=make_sharded_identity(mesh))
        print(f"3 Mbp array over a {n}-card mesh: {time.perf_counter() - t0:.3f} s wall "
              f"incl. compile", flush=True)
        res[n] = outputs(out)
    for k in ("", "_alt", "_raw"):
        check(res[4][k] == res[1][k], f"3 Mbp final{k} TSV byte-equal: 4-card vs 1-card mesh")


def main() -> int:
    four = "--four-cards" in sys.argv[1:]
    dev = phase_device()
    card = card_line()
    with tempfile.TemporaryDirectory() as td:
        if four:
            phase_four_cards(td)
        else:
            phase_golden(td)
            phase_array(td, card)
            phase_parity()
    import jax

    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
