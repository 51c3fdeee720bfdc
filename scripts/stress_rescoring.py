#!/usr/bin/env python3
"""Randomized stress of the router's NW-identity kernel (the CUDA kernel on
a GPU) vs the lax.scan program and the NumPy spec of edlib's path.

Usage: python scripts/stress_rescoring.py [n_cases] [seed]
"""

import os
import sys
import time

import numpy as np


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, here)
    from stringdecomposer_tpu.ops.backend import nw_pairs_fn
    from stringdecomposer_tpu.ops.identity import nw_identity_batch, nw_path_spec

    n_cases = int(sys.argv[1]) if len(sys.argv) > 1 else 12
    seed = int(sys.argv[2]) if len(sys.argv) > 2 else 1
    rng = np.random.default_rng(seed)
    fails = 0
    t0 = time.perf_counter()
    for case in range(n_cases):
        P = int(rng.integers(3, 40)) * 8
        Lq = int(rng.integers(2, 220))
        Lt = int(rng.integers(2, 220))
        q = rng.integers(0, 4, size=(P, Lq), dtype=np.int8)
        t = rng.integers(0, 4, size=(P, Lt), dtype=np.int8)
        ql = rng.integers(1, Lq + 1, size=P).astype(np.int32)
        tl = rng.integers(0, Lt + 1, size=P).astype(np.int32)
        d1, m1, l1 = (np.asarray(x) for x in nw_pairs_fn()(q, ql, t, tl))
        d0, m0, l0 = (np.asarray(x) for x in nw_identity_batch(q, ql, t, tl))
        if not ((d0 == d1).all() and (m0 == m1).all() and (l0 == l1).all()):
            fails += 1
            bad = int(np.flatnonzero((d0 != d1) | (m0 != m1) | (l0 != l1))[0])
            print(f"case {case}: NW MISMATCH pair {bad}: "
                  f"got {d1[bad], m1[bad], l1[bad]} want {d0[bad], m0[bad], l0[bad]}")
        # spot-check the jnp kernel against the O(n^2) spec on 3 pairs
        for p in rng.integers(0, P, 3):
            spec = nw_path_spec(q[p, : ql[p]], t[p, : tl[p]])
            if spec != (int(d0[p]), int(m0[p]), int(l0[p])):
                fails += 1
                print(f"case {case}: SPEC MISMATCH pair {p}: {spec} vs jnp")
        print(f"case {case}: done (P={P} Lq={Lq} Lt={Lt})", flush=True)
    print(f"STRESS DONE: {fails} failures in {time.perf_counter() - t0:.0f}s")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
