"""Multi-host execution: per-host read sharding + deterministic TSV merge.

The reference is single-node (SURVEY.md §2: OpenMP threads + one fork/exec,
no network communication). The scale-out model here replaces that with:

  - `jax.distributed.initialize` for process topology (parallel/mesh.py);
  - reads sharded across hosts round-robin by input index — DCN carries only
    input distribution, never DP traffic (windows are independent by
    construction of the halo chunking scheme, src/main.cpp:73-75);
  - each host runs the ordinary single-host pipeline on its local devices
    (data-parallel window sharding within the host via parallel/sharding.py)
    and writes a raw-TSV *fragment* plus a `.done` sentinel — the fragment
    is a per-host checkpoint, so a failed run resumes per host;
  - host 0 merges fragments by global read index, reproducing the
    reference's order-restoring sort (src/main.cpp:103-120) across hosts:
    output bytes are identical to a single-host run for any host count.

No collective rides the output path; the merge is pure filesystem, so the
same code runs under real `jax.distributed` on a pod slice or as plain
processes in tests.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass

logger = logging.getLogger("stringdecomposer")


@dataclass
class HostTopology:
    num_hosts: int = 1
    host_id: int = 0


def detect_topology() -> HostTopology:
    """Topology from an initialized jax.distributed runtime (1 host if
    uninitialized)."""
    import jax

    return HostTopology(num_hosts=jax.process_count(), host_id=jax.process_index())


def shard_indices(n_reads: int, topo: HostTopology) -> list[int]:
    """Global read indices owned by this host (round-robin by input index,
    the multi-host analog of the reference's chunk interleaving)."""
    return list(range(topo.host_id, n_reads, topo.num_hosts))


def fragment_path(out_dir: str, out_file: str, host_id: int) -> str:
    return os.path.join(out_dir, f"{out_file}_raw.shard{host_id:05d}.tsv")


def final_fragment_path(out_dir: str, out_file: str, host_id: int) -> str:
    return os.path.join(out_dir, f"{out_file}.shard{host_id:05d}.tsv")


def alt_fragment_path(out_dir: str, out_file: str, host_id: int) -> str:
    return os.path.join(out_dir, f"{out_file}_alt.shard{host_id:05d}.tsv")


def _sentinel(frag: str) -> str:
    return frag + ".done"


def _sentinel_matches(path: str, fingerprint: str) -> bool:
    """True iff the sentinel exists and was written for `fingerprint`.

    Checking content (not mere existence) means a stale sentinel from a
    previous run with different inputs — or one mid-rewrite by another
    host — never admits its fragment into the merge."""
    try:
        with open(path) as f:
            return f.read().strip() == fingerprint
    except OSError:
        return False


_HEARTBEAT_PERIOD = 10.0


def _heartbeat(frag: str) -> str:
    return frag + ".alive"


class _HeartbeatThread:
    """Touches the host's `.alive` file every few seconds while the DP
    stage runs, so host 0 can distinguish 'still computing' from 'dead'.
    (A fragment file is only written at stage end, so its size carries no
    liveness signal during compute.)"""

    def __init__(self, frag: str, period: float = _HEARTBEAT_PERIOD):
        import threading

        self._path = _heartbeat(frag)
        self._period = period
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                with open(self._path, "w") as f:
                    f.write(str(time.time()))
            except OSError:
                pass
            self._stop.wait(self._period)

    def __enter__(self) -> "_HeartbeatThread":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
        # a left-behind .alive from a finished run would bypass the
        # "never-heartbeated -> grace from wait start" fallback on the NEXT
        # run into the same out_dir and get a healthy host declared dead
        try:
            os.remove(self._path)
        except OSError:
            pass


def _wait_for(
    paths: list[str],
    fingerprint: str,
    timeout: float = 3600.0,
    poll: float = 0.2,
    liveness_grace: float = 120.0,
    salvage: bool = False,
) -> list[str]:
    """Block until every sentinel exists with the current fingerprint.

    Dead-host detection: a host whose sentinel is missing AND whose
    heartbeat file has not been touched for `liveness_grace` seconds is
    declared dead. With salvage=False host 0 fails fast with a message
    naming it (instead of silently burning the whole `timeout`); with
    salvage=True the stalled sentinel paths are RETURNED so the caller can
    recompute those shards itself. A host that never wrote a heartbeat
    gets the same grace measured from when the wait began (covers
    startup/compile skew). The reference has no multi-host story at all
    (src/main.cpp:103-120 is single-process)."""
    start_wall = time.time()
    deadline = time.monotonic() + timeout
    missing = list(paths)
    while missing:
        missing = [p for p in missing if not _sentinel_matches(p, fingerprint)]
        if not missing:
            return []
        now_wall = time.time()
        stalled = []
        for p in missing:
            hb = _heartbeat(p[: -len(".done")])
            try:
                last = os.path.getmtime(hb)
            except OSError:
                last = start_wall
            if now_wall - last > liveness_grace:
                stalled.append(p)
        if stalled:
            if salvage:
                return stalled
            hosts = ", ".join(
                p.rsplit(".shard", 1)[1].split(".")[0].lstrip("0") or "0"
                for p in stalled
            )
            raise RuntimeError(
                f"host(s) {hosts} appear dead: no heartbeat for "
                f"{liveness_grace:.0f}s (sentinels still missing: {stalled}). "
                "Re-run with --resume to recompute only the missing fragments."
            )
        if time.monotonic() > deadline:
            raise TimeoutError(f"timed out waiting for host fragments: {missing}")
        time.sleep(poll)
    return []


def _merge_by_counts(
    dest: str, frags: list[str], counts: list[list[int]], topo: HostTopology,
    n_reads: int,
) -> str:
    """Interleave per-host fragments back into global read order.

    Each fragment holds its host's reads in ascending global index (the
    single-host pipeline preserves input order), so the merge is one
    sequential pass per fragment — the cross-host version of the
    reference's index re-sort (src/main.cpp:103-120). The pass is fully
    streaming: one open file handle per host, rows copied line-by-line,
    so merge memory is O(num_hosts), flat in the input size (a centromere
    assembly's TSV can be many GB)."""
    handles = []
    try:
        handles = [open(f) for f in frags]
        cursors = [0] * topo.num_hosts
        with open(dest + ".tmp", "w") as out:
            for gi in range(n_reads):
                h = gi % topo.num_hosts
                for _ in range(counts[h][cursors[h]]):
                    out.write(handles[h].readline())
                cursors[h] += 1
    finally:
        for fh in handles:
            fh.close()
    os.replace(dest + ".tmp", dest)
    return dest


def merge_raw_fragments(
    out_dir: str, out_file: str, topo: HostTopology, n_reads: int
) -> str:
    # the sidecar written next to each fragment records exact per-read row
    # counts, so zero-block reads and duplicate read names merge unambiguously
    counts: list[list[int]] = []
    for h in range(topo.num_hosts):
        frag = fragment_path(out_dir, out_file, h)
        with open(frag + ".reads") as f:
            counts.append(
                [int(ln.rsplit("\t", 1)[1]) for ln in f.read().split("\n")[:-1]]
            )
    return _merge_by_counts(
        os.path.join(out_dir, out_file + "_raw.tsv"),
        [fragment_path(out_dir, out_file, h) for h in range(topo.num_hosts)],
        counts, topo, n_reads,
    )


def merge_final_fragments(
    out_dir: str, out_file: str, topo: HostTopology, n_reads: int
) -> str:
    """Merge the per-host FINAL and ALT fragments (each host finishes its
    own shard; the reference finishes everything in one process,
    main.py:124-142). Counts sidecar: read \\t final_rows \\t alt_rows."""
    fin_counts: list[list[int]] = []
    alt_counts: list[list[int]] = []
    for h in range(topo.num_hosts):
        ffrag = final_fragment_path(out_dir, out_file, h)
        with open(ffrag + ".reads") as f:
            rows = [ln.split("\t") for ln in f.read().split("\n")[:-1]]
        fin_counts.append([int(r[1]) for r in rows])
        alt_counts.append([int(r[2]) for r in rows])
    _merge_by_counts(
        os.path.join(out_dir, out_file + "_alt.tsv"),
        [alt_fragment_path(out_dir, out_file, h) for h in range(topo.num_hosts)],
        alt_counts, topo, n_reads,
    )
    return _merge_by_counts(
        os.path.join(out_dir, out_file + ".tsv"),
        [final_fragment_path(out_dir, out_file, h) for h in range(topo.num_hosts)],
        fin_counts, topo, n_reads,
    )


def run_multihost(
    sequences_path: str,
    monomers_path: str,
    out_dir: str = ".",
    out_file: str = "final_decomposition",
    min_identity: int = 0,
    scoring: str = "-1,-1,-1,1",
    batch_size: int = 5000,
    overlap: int = 500,
    second_best: bool = False,
    ed_thr: int = -1,
    device_batch: int = 16,
    topology: HostTopology | None = None,
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    resume: bool = False,
    data_parallel: bool = False,
    barrier_timeout: float = 3600.0,
    liveness_grace: float = 120.0,
    salvage_dead_hosts: bool = True,
    stream_reads: int = 0,
    threads: int = 1,
) -> str | None:
    """Full pipeline across hosts. Returns the final TSV path on host 0,
    None on other hosts.

    If `coordinator` is given, `jax.distributed` is initialized and the
    topology is taken from it; otherwise `topology` (or single-host) is
    used, which lets plain processes cooperate through the shared out_dir.
    With `resume=True` a host whose fragment sentinel already exists skips
    its DP stage entirely (per-host checkpoint/restart).

    With `stream_reads > 0` each host streams the FASTA (iter_fasta),
    retaining only the reads it owns in groups of that size — RSS stays
    flat in the input size on EVERY host (round 2 materialized the full
    read set num_hosts times), and output bytes are unchanged.
    """
    import pathlib

    from ..finishing import finish_reads
    from ..io.fasta import add_rc_interleaved, add_reverse_complement, iter_fasta, load_fasta, validate_acgtn
    from ..ops.oracle import Scoring
    from ..pipeline import PipelineConfig, decompose_reads
    from .mesh import initialize_distributed

    if coordinator is not None:
        initialize_distributed(coordinator, num_processes, process_id)
        topology = detect_topology()
        if (num_processes or 1) > 1 and topology.num_hosts == 1:
            # runtimes that cannot aggregate processes into one device view
            # still gave us a working coordination barrier; fall back to the
            # explicit topology so hosts never race on the same fragment
            logger.warning(
                "jax.distributed reports a single process; using explicit "
                "topology %s/%s", process_id, num_processes,
            )
            topology = HostTopology(num_processes, process_id or 0)
    topo = topology or HostTopology()
    identity_kernel = None
    if data_parallel:
        # AFTER jax.distributed bring-up: get_mesh()/jax.devices() inside
        # initializes the backend, which must not precede initialize()
        from .sharding import make_sharded_identity

        identity_kernel = make_sharded_identity()
    pathlib.Path(out_dir).mkdir(parents=True, exist_ok=True)

    monomers_fwd = load_fasta(monomers_path)
    validate_acgtn(monomers_fwd, monomers_path)
    n_reads = -1  # total input reads; host 0 needs it for the merges
    if stream_reads > 0:
        reads = None  # never materialized; shards stream via iter_fasta
    else:
        reads = load_fasta(sequences_path)
        validate_acgtn(reads, sequences_path)
        n_reads = len(reads)
    monomers_dp = add_reverse_complement(monomers_fwd)

    from ..pipeline import stage_fingerprint

    fp = stage_fingerprint(
        sequences_path, monomers_path, scoring, batch_size, overlap, ed_thr
    )
    # the sentinel covers the host's raw AND final/alt fragments, so the
    # fingerprint must also pin the finishing-stage parameters
    fp += f"|fin:{int(second_best)}:{min_identity}"
    frag = fragment_path(out_dir, out_file, topo.host_id)
    resumable = False
    if resume and os.path.exists(_sentinel(frag)):
        with open(_sentinel(frag)) as f:
            resumable = f.read().strip() == fp
        if not resumable:
            logger.warning(
                "--resume: host %d fragment was produced from different "
                "inputs; recomputing", topo.host_id,
            )
    ins, dele, mm, match = (int(x) for x in scoring.split(","))
    cfg = PipelineConfig(
        scoring=Scoring(ins, dele, mm, match),
        part_size=batch_size,
        overlap=overlap,
        device_batch=device_batch,
        ed_thr=ed_thr,
    )
    forward_fn = None
    if data_parallel:
        from .sharding import make_sharded_forward

        forward_fn = make_sharded_forward()

    monomers_fin = add_rc_interleaved(load_fasta(monomers_path, upper=True))
    dp_names = [m.name for m in monomers_dp]

    def compute_shard(host_id: int) -> None:
        """DP stage + FINISHING for one host's read shard -> raw fragment +
        final/alt fragments + sidecars + one sentinel covering all of them
        (atomic renames). Every host rescoring its own shard is the
        multi-host analog of the single-process finishing loop
        (reference main.py:124-142); round 2 ran the whole finishing stage
        on host 0 alone. Deterministic: recomputing a shard on a DIFFERENT
        machine (dead-host salvage) yields byte-identical files, so even a
        concurrent late write by the presumed-dead host is harmless.

        With stream_reads > 0 the shard streams through in bounded groups
        (only owned reads are ever retained) and rows append incrementally
        to the .tmp files — the atomic rename contract is unchanged."""
        nonlocal n_reads
        from ..finishing import write_final_rows
        from ..report import format_raw_rows

        fragh = fragment_path(out_dir, out_file, host_id)
        ffrag = final_fragment_path(out_dir, out_file, host_id)
        afrag = alt_fragment_path(out_dir, out_file, host_id)
        # drop any stale sentinel/fragments/heartbeat BEFORE recomputing:
        # host 0 must never observe an old-fingerprint sentinel next to a
        # mid-rewrite fragment (silently-wrong-merge race on rerun into a
        # reused out_dir)
        for stale in (_sentinel(fragh), fragh, fragh + ".reads", ffrag,
                      ffrag + ".reads", afrag, _heartbeat(fragh)):
            try:
                os.remove(stale)
            except OSError:
                pass

        def flush_group(group, fr, frc, fo, fa, foc) -> None:
            """One group: DP + raw rows/sidecar + finishing rows/sidecar."""
            validate_acgtn(group, sequences_path)
            result = decompose_reads(group, monomers_dp, cfg, forward_fn=forward_fn)
            for r, (rname, blocks) in zip(group, result):
                for row in format_raw_rows(rname, blocks, dp_names):
                    fr.write(row + "\n")
                frc.write(f"{r.name.split()[0]}\t{len(blocks)}\n")
            per_read_raw = [
                (r.name.split()[0],
                 [{"m": dp_names[b.monomer].split()[0],
                   "start": b.start, "end": b.end} for b in blocks],
                 gi)  # positional key: duplicate names stay distinct
                for gi, (r, (_, blocks)) in enumerate(zip(group, result))
            ]
            reads_by_key = {gi: r.seq.upper() for gi, r in enumerate(group)}
            finished = finish_reads(
                per_read_raw, reads_by_key, monomers_fin,
                second_best=second_best, kernel=identity_kernel,
                threads=threads,
            )
            write_final_rows(fo, fa, finished, identity_th=min_identity)
            for rname, blocks in finished:
                nf = sum(1 for b in blocks if b.score >= min_identity)
                na = sum(len(b.alt) for b in blocks if b.score >= min_identity)
                foc.write(f"{rname}\t{nf}\t{na}\n")

        with _HeartbeatThread(fragh):
            # write-then-rename so a crash mid-write never leaves a truncated
            # fragment that a later merge or --resume could mistake for complete
            with open(fragh + ".tmp", "w") as fr, \
                    open(fragh + ".reads.tmp", "w") as frc, \
                    open(ffrag + ".tmp", "w") as fo, \
                    open(afrag + ".tmp", "w") as fa, \
                    open(ffrag + ".reads.tmp", "w") as foc:
                if stream_reads > 0:
                    group: list = []
                    seen = 0
                    for gi, rec in enumerate(iter_fasta(sequences_path)):
                        seen = gi + 1
                        if gi % topo.num_hosts != host_id:
                            continue  # non-owned reads are never retained
                        group.append(rec)
                        if len(group) >= stream_reads:
                            flush_group(group, fr, frc, fo, fa, foc)
                            group = []
                    if group:
                        flush_group(group, fr, frc, fo, fa, foc)
                    n_reads = seen
                else:
                    mine = shard_indices(n_reads, HostTopology(topo.num_hosts, host_id))
                    local = [reads[i] for i in mine]
                    logger.info(
                        "host %d/%d: decomposing %d of %d reads",
                        host_id, topo.num_hosts, len(local), n_reads,
                    )
                    flush_group(local, fr, frc, fo, fa, foc)
            os.replace(fragh + ".tmp", fragh)
            os.replace(fragh + ".reads.tmp", fragh + ".reads")
            os.replace(ffrag + ".tmp", ffrag)
            os.replace(afrag + ".tmp", afrag)
            os.replace(ffrag + ".reads.tmp", ffrag + ".reads")
            with open(_sentinel(fragh) + ".tmp", "w") as f:
                f.write(fp + "\n")
            os.replace(_sentinel(fragh) + ".tmp", _sentinel(fragh))

    if not resumable:
        compute_shard(topo.host_id)
    else:
        logger.info("host %d: fragment exists, resuming past DP stage", topo.host_id)

    if topo.host_id != 0:
        return None

    # host 0: wait for every fragment; salvage shards of hosts that died
    # (missing sentinel + stale heartbeat) by recomputing them locally.
    # _wait_for returns the DEAD subset as soon as any host is declared
    # dead, even while other hosts are still computing — so after each
    # salvage we must re-enter the wait until EVERY sentinel matches;
    # merging earlier would open() fragments of still-live hosts that do
    # not exist yet (round-2 advisor finding). One shared deadline bounds
    # the whole loop.
    sentinels = [
        _sentinel(fragment_path(out_dir, out_file, h)) for h in range(topo.num_hosts)
    ]
    deadline = time.monotonic() + barrier_timeout
    while True:
        stalled = _wait_for(
            sentinels,
            fp,
            timeout=max(1.0, deadline - time.monotonic()),
            liveness_grace=liveness_grace,
            salvage=salvage_dead_hosts,
        )
        if not stalled:
            break
        dead = sorted(
            int(p.rsplit(".shard", 1)[1].split(".")[0]) for p in stalled
        )
        logger.warning(
            "host(s) %s appear dead (no heartbeat for %.0fs); host 0 is "
            "salvaging their shards locally", dead, liveness_grace,
        )
        for h in dead:
            compute_shard(h)
    if n_reads < 0:
        # streaming host 0 resumed past its own compute: one cheap counting
        # pass (headers only are retained) establishes the merge length
        n_reads = sum(1 for _ in iter_fasta(sequences_path))
    raw_path = merge_raw_fragments(out_dir, out_file, topo, n_reads)
    logger.info("Saved merged raw decomposition to %s", raw_path)
    # final/alt rows were produced per host alongside each shard's DP; the
    # merge is the same streaming count-guided interleave as the raw one
    final_path = merge_final_fragments(out_dir, out_file, topo, n_reads)
    logger.info("Transformation finished. Results can be found in %s", final_path)
    return final_path
