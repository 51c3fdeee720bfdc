"""Command-line interface — drop-in replacement for the reference CLI
(reference: main.py:201-245). All eleven reference flags are accepted with
identical names, defaults, and output files; device and scale-out knobs
are added under their own names.

Usage:
    stringdecomposer-tpu <sequences.fa> <monomers.fa> [options]
    python -m stringdecomposer_tpu <sequences.fa> <monomers.fa> [options]
"""

from __future__ import annotations

import argparse
import os
import pathlib
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="stringdecomposer-tpu",
        description="Decomposes string into blocks alphabet (JAX, GPU-accelerated)",
    )
    from .__version__ import __version__

    p.add_argument("--version", action="version",
                   version=f"stringdecomposer-tpu {__version__}")
    p.add_argument("sequences", help="fasta-file with long reads or genomic sequences")
    p.add_argument("monomers", help="fasta-file with monomers")
    p.add_argument(
        "-t", "--threads", default="1", required=False,
        help="host threads for the finishing stage's encode/dispatch "
        "(device count is auto-detected; 1 = synchronous)",
    )
    p.add_argument("-o", "--out-dir", default=".", required=False,
                   help="output directory (by default .)")
    p.add_argument("--out-file", default="final_decomposition", required=False,
                   help='output tsv-file (by default "final_decomposition")')
    p.add_argument(
        "-i", "--min-identity", type=int, default=0, required=False,
        help="only monomer alignments with percent identity >= MIN_IDENTITY "
        "are printed (by default MIN_IDENTITY=0)",
    )
    p.add_argument(
        "-s", "--scoring", default="-1,-1,-1,1", required=False,
        help='scoring scheme "insertion,deletion,mismatch,match" '
        '(default "-1,-1,-1,1"); honored by the DP (the reference v1.1.2 '
        "silently ignored it)",
    )
    p.add_argument("-b", "--batch-size", type=str, default="5000", required=False,
                   help="window size for long-read chunking (by default 5000)")
    p.add_argument("--second-best", dest="second_best", action="store_true",
                   help="generate second best monomer and homopolymer scores")
    p.add_argument(
        "--ed_thr", type=int, default=-1, required=False,
        help="align only monomers with edit distance less than ed_thr for "
        "each segment (by default align all monomers)",
    )
    p.add_argument("-v", "--overlap", type=str, default="500", required=False,
                   help="window overlap (halo) size (by default 500)")
    # --- device and scale-out additions ---
    p.add_argument("--device-batch", type=int, default=64,
                   help="windows per device step (data-parallel batch)")
    p.add_argument("--data-parallel", action="store_true",
                   help="shard the window batch across all visible devices")
    p.add_argument("--profile-dir", default=None,
                   help="write a jax.profiler trace of the DP stage here")
    p.add_argument("--coordinator", default=None,
                   help="jax.distributed coordinator address host:port "
                   "(multi-host; topology is then taken from jax)")
    p.add_argument("--num-hosts", type=int, default=1,
                   help="number of cooperating hosts (reads are sharded "
                   "round-robin; host 0 merges and finishes)")
    p.add_argument("--host-id", type=int, default=0,
                   help="this host's index in [0, num-hosts)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="process count for --coordinator (defaults to env)")
    p.add_argument("--resume", action="store_true",
                   help="reuse existing raw-TSV fragments/checkpoints "
                   "instead of recomputing the DP stage")
    p.add_argument("--stream-reads", type=int, default=0,
                   help="process reads in groups of N with incremental "
                   "output (bounded memory for flowcell-scale FASTAs)")
    p.add_argument("--serve", action="store_true",
                   help="serving mode: read one job per stdin line "
                   "(same arguments, no program name), keep kernels warm "
                   "across jobs, emit one JSON status line per job")
    p.add_argument("--precompile", metavar="MONOMERS_FA", default=None,
                   help="(with --serve) compile the DP shape menu for this "
                   "monomer set before accepting jobs, so no job pays a "
                   "mid-stream compile")
    return p


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--serve" in argv:
        argv.remove("--serve")
        return serve(argv)
    args = build_parser().parse_args(argv)
    return _execute(args)


def serve(default_argv: list[str]) -> int:
    """Serving mode: one warm process, jobs streamed on stdin.

    Each line is a CLI invocation without the program name
    (`seqs.fa monomers.fa -o out [flags...]`); flags passed alongside
    --serve apply to every job. One JSON status line per job on stdout.
    Compiled kernels stay warm across jobs, so steady-state latency is the
    device time, not the cold-start compile.
    """
    import json
    import shlex

    if "--precompile" in default_argv:
        i = default_argv.index("--precompile")
        if i + 1 >= len(default_argv):
            print("--precompile needs a monomers FASTA", file=sys.stderr)
            return 2
        warm_monomers = default_argv[i + 1]
        del default_argv[i : i + 2]
        # the serve-level flags that are compile keys; job lines inherit them
        pre = argparse.ArgumentParser(add_help=False)
        pre.add_argument("--device-batch", type=int, default=64)
        pre.add_argument("-b", "--batch-size", type=str, default="5000")
        pre.add_argument("-v", "--overlap", type=str, default="500")
        pre.add_argument("--second-best", action="store_true")
        pre.add_argument("-s", "--scoring", default="-1,-1,-1,1")
        pre.add_argument("-t", "--threads", default="1")
        ns, _ = pre.parse_known_args(default_argv)
        from .pipeline import precompile_menu

        precompile_menu(
            warm_monomers,
            device_batch=ns.device_batch,
            batch_size=int(ns.batch_size),
            overlap=int(ns.overlap),
            second_best=ns.second_best,
            scoring=ns.scoring,
            threads=max(1, int(ns.threads)),
        )

    parser = build_parser()
    for line in sys.stdin:
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            args = parser.parse_args(shlex.split(line) + default_argv)
            rc = _execute(args)
            print(
                json.dumps(
                    {
                        "status": "ok" if rc == 0 else "error",
                        "rc": rc,
                        "final": os.path.join(args.out_dir, args.out_file + ".tsv"),
                    }
                ),
                flush=True,
            )
        except SystemExit as e:  # argparse error on this job line
            print(json.dumps({"status": "error", "rc": int(e.code or 2),
                              "error": "bad arguments"}), flush=True)
        except Exception as e:  # noqa: BLE001 - keep serving
            print(json.dumps({"status": "error", "rc": 1, "error": str(e)}),
                  flush=True)
    return 0


def _execute(args) -> int:
    pathlib.Path(args.out_dir).mkdir(parents=True, exist_ok=True)

    from .utils.logging import get_logger

    logger = get_logger(os.path.join(args.out_dir, "stringdecomposer.log"),
                        logger_name="stringdecomposer")
    logger.info("cmd: %s", sys.argv)

    from .io.fasta import InvalidSymbolError
    from .pipeline import run

    multihost_mode = args.coordinator is not None or args.num_hosts > 1
    forward_fn = None
    identity_kernel = None
    if args.data_parallel and not multihost_mode:
        # multihost builds its own sharded kernels AFTER jax.distributed
        # bring-up (building them here would initialize the backend first
        # and break --coordinator startup)
        from .parallel.sharding import make_sharded_forward, make_sharded_identity

        forward_fn = make_sharded_forward()
        identity_kernel = make_sharded_identity()

    profiler_cm = None
    if args.profile_dir:
        import jax

        profiler_cm = jax.profiler.trace(args.profile_dir)
        profiler_cm.__enter__()
    multihost = multihost_mode
    try:
        if multihost:
            from .parallel.multihost import HostTopology, run_multihost

            run_multihost(
                args.sequences,
                args.monomers,
                out_dir=args.out_dir,
                out_file=args.out_file,
                min_identity=args.min_identity,
                scoring=args.scoring,
                batch_size=int(args.batch_size),
                overlap=int(args.overlap),
                second_best=args.second_best,
                ed_thr=args.ed_thr,
                device_batch=args.device_batch,
                topology=HostTopology(args.num_hosts, args.host_id),
                coordinator=args.coordinator,
                num_processes=args.num_processes,
                process_id=args.host_id if args.coordinator else None,
                resume=args.resume,
                data_parallel=args.data_parallel,
                stream_reads=args.stream_reads,
                threads=max(1, int(args.threads)),
            )
        else:
            run(
                args.sequences,
                args.monomers,
                out_dir=args.out_dir,
                out_file=args.out_file,
                min_identity=args.min_identity,
                scoring=args.scoring,
                batch_size=int(args.batch_size),
                overlap=int(args.overlap),
                second_best=args.second_best,
                ed_thr=args.ed_thr,
                device_batch=args.device_batch,
                forward_fn=forward_fn,
                resume=args.resume,
                stream_reads=args.stream_reads,
                identity_kernel=identity_kernel,
                threads=max(1, int(args.threads)),
            )
    except InvalidSymbolError as e:
        logger.error("ERROR: %s", e)
        return 255  # reference binary exit(-1) semantics (main.cpp:336)
    finally:
        if profiler_cm:
            profiler_cm.__exit__(None, None, None)

    logger.info("Thank you for using StringDecomposer!")
    return 0


if __name__ == "__main__":
    sys.exit(main())
