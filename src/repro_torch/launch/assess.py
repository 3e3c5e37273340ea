"""Quality-assessment launcher of the port (the paper's workflow as a CLI).

A thin shell over the ``repro_torch.qa`` pipeline, with the JAX package's
flags and error rules; the scan runs on the card (``--device cuda``, the
default) through the hand-written kernels, and fails where there is no
card rather than carrying on on the CPU:

  PYTHONPATH=src python -m repro_torch.launch.assess --nt data.nt \\
      --base http://ex/
  PYTHONPATH=src python -m repro_torch.launch.assess --synthetic 1000000 \\
      --chunks 32 --checkpoint-dir ckpt/ --backend twopass
  PYTHONPATH=src python -m repro_torch.launch.assess --nt data.nt \\
      --device cpu            # the kernels' plain torch versions

Incremental assessment + monitoring (``repro_torch.store``; a store
written by ``python -m repro.launch.assess --store`` is reused as is):

  # first run scans everything and freezes per-segment state
  python -m repro_torch.launch.assess --nt data.nt --store qstore/
  # subsequent runs rescan only changed segments
  python -m repro_torch.launch.assess --nt data.nt --store qstore/
  # live monitoring: re-assess whenever the file changes, append each
  # snapshot to qstore/history.jsonl and print per-metric deltas
  python -m repro_torch.launch.assess --nt data.nt --store qstore/ --watch

The multi-tenant service (``repro_torch.serve``), the same as
``python -m repro_torch.launch.qa_serve``:

  python -m repro_torch.launch.assess --serve 8080 --store-root qroot/

A mesh of N ranks (``launch.mesh``): the command starts N processes of
itself, each scanning its row shard (or, with ``--store``, its share of
the rescanned segments) through the kernels, with counters and registers
reduced over ``torch.distributed``; rank 0 alone prints, writes ``--dqv``
and writes the store, and the exit code is nonzero if any rank fails:

  python -m repro_torch.launch.assess --nt data.nt --mesh 4
  python -m repro_torch.launch.assess --synthetic 100000 --mesh 2 \\
      --device cpu            # gloo ranks on the CPU
"""
from __future__ import annotations

import argparse
import os
import sys
import time

# how long the ranks of a --mesh run may take in all: a rank that fails
# ends the run at once, and a collective waits at most
# launch.mesh.DEFAULT_TIMEOUT for its peers, so this only bounds a run
# whose ranks all hang outside a collective
MESH_DEADLINE = 24 * 3600.0


def _print_result(res, t_ingest, t_eval, dqv=False, out=None, err=None):
    from ..core import report

    out = out if out is not None else sys.stdout
    err = err if err is not None else sys.stderr
    if res.exec_stats is not None:
        s = res.exec_stats
        evals = s.chunk_eval_seconds
        line = (f"# chunks={s.chunks_total} attempts={s.attempts} "
                f"resumed_from={s.resumed_from} mode={s.mode} "
                f"passes/chunk={s.passes_per_chunk} "
                f"host-blocked {sum(evals):.2f}s of "
                f"{s.wall_seconds:.2f}s wall")
        if s.bytes_total:
            line += (f"\n# segments: {s.segments_reused} reused, "
                     f"{s.segments_rescanned} rescanned | bytes rescanned "
                     f"{s.bytes_rescanned:,}/{s.bytes_total:,} "
                     f"({s.bytes_rescanned / max(s.bytes_total, 1):.1%})")
        if s.stragglers:
            line += f"\n# stragglers: {s.stragglers}"
        print(line, file=err)
    print(f"# {res.n_triples:,} triples | prep {t_ingest:.2f}s | "
          f"eval {t_eval:.2f}s | {res.passes} pass(es)", file=err)
    if dqv:
        print(report.to_json(res), file=out)
    else:
        for k, v in sorted(res.values.items()):
            print(f"{k:10s} {v:.6f}", file=out)


def file_signature(path: str) -> tuple[int, int, int]:
    """Change-detection signature of ``path``: ``(st_mtime_ns, st_size,
    st_ino)`` from a single ``os.stat`` call.

    Nanosecond mtime plus the inode catch same-size *atomic replaces*
    (tmp file + ``os.replace`` swaps the inode) that a coarse
    ``(getmtime, getsize)`` pair misses inside mtime granularity; taking
    everything from one ``stat`` also removes the race where the file is
    replaced between separate mtime and size calls.  Shared by the
    ``--watch`` poll loop here and the ``repro_torch.serve`` daemon's
    dataset watcher.  Raises ``OSError`` when the file is missing mid-poll.
    """
    st = os.stat(path)
    return (st.st_mtime_ns, st.st_size, st.st_ino)


def watch(pipe, path: str, *, interval: float = 2.0,
          max_assessments: int | None = None, dqv: bool = False,
          out=None) -> int:
    """Monitor ``path``: re-assess on every content-signature change
    (``file_signature``: mtime_ns / size / inode).

    Each assessment goes through the pipeline's incremental store (so only
    changed segments are rescanned and a snapshot lands in the store's
    ``history.jsonl``) and prints per-metric deltas against the previous
    run.  Returns the number of assessments performed;
    ``max_assessments`` bounds the loop (None = run until interrupted).
    Progress goes to ``out``, the process's stderr at call time by default.
    """
    if out is None:
        out = sys.stderr
    last_sig = None
    prev_values = None
    runs = 0
    while max_assessments is None or runs < max_assessments:
        try:
            sig = file_signature(path)
        except OSError:
            time.sleep(interval)
            continue
        if sig == last_sig:
            time.sleep(interval)
            continue
        last_sig = sig
        t0 = time.time()
        try:
            res = pipe.run(path)
        except OSError:
            # the file vanished between the poll and the read (writer
            # doing delete-then-recreate) — retry on the next poll
            last_sig = None
            time.sleep(interval)
            continue
        t_eval = time.time() - t0
        print(f"== change detected ({time.strftime('%H:%M:%S')}) ==",
              file=out)
        # honor a captured stream fully: results only go to the process
        # stdout when monitoring the default stderr console
        _print_result(res, 0.0, t_eval, dqv=dqv,
                      out=sys.stdout if out is sys.stderr else out, err=out)
        if prev_values is not None:
            deltas = {k: res.values[k] - prev_values[k]
                      for k in res.values if k in prev_values
                      and res.values[k] != prev_values[k]}
            if deltas:
                moved = " ".join(f"{k}{d:+.6f}" for k, d in
                                 sorted(deltas.items()))
                print(f"# deltas: {moved}", file=out)
            else:
                print("# deltas: none", file=out)
        prev_values = dict(res.values)
        runs += 1
    return runs


def main(argv=None):
    from ..core.evaluator import BACKENDS

    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.assess")
    ap.add_argument("--nt", help="N-Triples file to assess")
    ap.add_argument("--base", action="append", default=[],
                    help="internal base namespace (repeatable)")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="assess N synthetic triples instead of a file")
    ap.add_argument("--metrics", default="all", help="'paper' | 'all' | csv")
    ap.add_argument("--backend", choices=BACKENDS, default="fused_scan",
                    help="fused_scan: one pass, counters and sketches in "
                         "one kernel; twopass: qap_count plus one hll_fold "
                         "per sketch (1+S passes); torch: the plain torch "
                         "versions")
    ap.add_argument("--device", default="cuda",
                    help="where the scan runs: cuda (default; fails "
                         "without a card), cuda:N, or cpu (the kernels' "
                         "plain torch versions)")
    ap.add_argument("--no-fused", action="store_true",
                    help="paper-faithful one-pass-per-metric mode")
    ap.add_argument("--chunks", type=int, default=0,
                    help=">0: fault-tolerant chunked scan with this many "
                         "chunks")
    ap.add_argument("--stream", type=int, default=0, metavar="TRIPLES",
                    help=">0: bounded-memory streaming ingest of --nt, "
                         "yielding chunks of this many triples")
    ap.add_argument("--prefetch", type=int, default=0, metavar="N",
                    help=">0: async pipelined chunk executor — ingest + "
                         "copy of the next chunk to the card overlap the "
                         "scan (1 = double buffering)")
    ap.add_argument("--speculate", action="store_true",
                    help="speculatively re-execute straggler chunks: a "
                         "chunk whose eval outlives the straggler "
                         "threshold gets a backup copy; first completion "
                         "wins (the merge is idempotent)")
    ap.add_argument("--mesh", type=int, default=0, metavar="RANKS",
                    help=">0: shard every scan's rows over this many ranks "
                         "(1-D data-parallel mesh, one process a rank; "
                         "counters sum- and HLL registers max-reduced "
                         "over torch.distributed — bit-identical to the "
                         "local run). nccl when every rank has a card of "
                         "its own, else gloo; with cuda each rank takes "
                         "its own card. 0 = no mesh")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--store", default=None, metavar="DIR",
                    help="incremental assessment against the persistent "
                         "segment store at DIR: unchanged segments are "
                         "served from frozen state, results stay "
                         "bit-identical to a cold run, and every run "
                         "appends a snapshot to DIR/history.jsonl")
    ap.add_argument("--segment-bytes", type=int, default=0,
                    help="target segment size for --store (0 = default)")
    ap.add_argument("--max-history", type=int, default=0, metavar="N",
                    help="with --store: keep only the newest N snapshots "
                         "in history.jsonl (0 = unbounded)")
    ap.add_argument("--compact", action="store_true",
                    help="with --store: maintenance mode — GC "
                         "unreferenced segment files, rewrite the "
                         "manifest, apply --max-history retention, then "
                         "exit (no assessment; --nt not needed)")
    ap.add_argument("--watch", action="store_true",
                    help="with --nt and --store: poll the file and "
                         "re-assess on change (dataset monitoring)")
    ap.add_argument("--watch-interval", type=float, default=2.0,
                    metavar="SECONDS", help="poll interval for --watch")
    ap.add_argument("--watch-max", type=int, default=None, metavar="N",
                    help="stop --watch after N assessments (testing/CI)")
    ap.add_argument("--dqv", action="store_true", help="emit DQV JSON-LD")
    ap.add_argument("--serve", type=int, default=None, metavar="PORT",
                    help="run the multi-tenant assessment service daemon "
                         "(repro_torch.serve) on PORT instead of a one-shot "
                         "run; needs --store-root (equivalent to "
                         "python -m repro_torch.launch.qa_serve)")
    ap.add_argument("--store-root", default=None, metavar="DIR",
                    help="dataset root for --serve: one segment-store "
                         "directory per registered dataset under DIR")
    args = ap.parse_args(argv)

    if args.mesh:
        limit = os.cpu_count() or 1     # one process a rank
        if not 1 <= args.mesh <= limit:
            ap.error(f"--mesh: devices must be in [1, {limit}], got "
                     f"{args.mesh}")
        if args.serve is not None or args.compact or args.watch:
            ap.error("--mesh applies to one-shot runs, not to --serve, "
                     "--compact or --watch")
        _check_run_flags(ap, args)
        from . import mesh as mesh_mod
        if mesh_mod.RDZV_ENV not in os.environ:
            # the launching process: start the ranks, each running this
            # same command; rank 0 prints to this process's streams
            try:
                mesh_mod.launch_ranks(
                    args.mesh,
                    ["-m", "repro_torch.launch.assess",
                     *(sys.argv[1:] if argv is None else argv)],
                    timeout=MESH_DEADLINE, inherit=(0,))
            except mesh_mod.RankFailure as e:
                print(f"# mesh run failed: {e}", file=sys.stderr)
                return 1
            return 0
        try:
            return _run(ap, args)
        finally:
            mesh_mod.close_ranks()

    if args.serve is not None:
        if not args.store_root:
            ap.error("--serve needs --store-root (one store dir per "
                     "dataset lives under it)")
        from . import qa_serve
        fwd = ["--port", str(args.serve), "--store-root", args.store_root,
               "--metrics", args.metrics, "--backend", args.backend,
               "--device", args.device]
        for b in args.base:
            fwd += ["--base", b]
        if args.prefetch:
            fwd += ["--prefetch", str(args.prefetch)]
        if args.speculate:
            fwd += ["--speculate"]
        if args.segment_bytes:
            fwd += ["--segment-bytes", str(args.segment_bytes)]
        if args.watch_interval != 2.0:
            fwd += ["--poll-interval", str(args.watch_interval)]
        return qa_serve.main(fwd)

    if args.compact:
        if not args.store:
            ap.error("--compact needs --store")
        from ..store import SegmentStore
        stats = SegmentStore.compact_dir(args.store,
                                         max_history=args.max_history)
        print(f"# compacted {args.store}: "
              f"{stats['segments_kept']} segment(s) kept, "
              f"{stats['segments_removed']} removed "
              f"({stats['bytes_reclaimed']:,} bytes reclaimed), "
              f"{stats['history_dropped']} history snapshot(s) dropped",
              file=sys.stderr)
        return

    _check_run_flags(ap, args)
    return _run(ap, args)


def _check_run_flags(ap, args) -> None:
    """Reject flag combinations of an assessment run (before any rank
    starts, under ``--mesh``)."""
    if args.store and args.synthetic:
        ap.error("--store diffs raw dataset bytes; use --nt, "
                 "not --synthetic")
    if args.store and (args.chunks or args.stream or args.checkpoint_dir):
        ap.error("--store supersedes --chunks/--stream/--checkpoint-dir: "
                 "segmentation replaces chunking, and the store itself is "
                 "the persistence (frozen states double as in-run crash "
                 "recovery)")
    if args.watch and not (args.nt and args.store):
        ap.error("--watch needs --nt and --store")
    if not (args.watch or args.synthetic or args.nt):
        ap.error("need --nt or --synthetic")


def _run(ap, args):
    """One assessment as the flags describe it; under ``--mesh`` this runs
    on every rank, and only rank 0 prints."""
    from .. import qa
    from ..rdf import synth_encoded

    pipe = (qa.pipeline().metrics(args.metrics).backend(args.backend)
            .device(args.device))
    speaks = True
    if args.mesh:
        import torch
        from .mesh import make_assessment_mesh
        kind = torch.device(args.device).type    # each rank takes its card
        mesh = make_assessment_mesh(args.mesh, device=kind)
        pipe = pipe.device(kind).shard(mesh)
        speaks = mesh.get_local_rank() == 0
    if args.no_fused:
        pipe = pipe.per_metric()
    if args.chunks:
        pipe = pipe.chunked(args.chunks, checkpoint_dir=args.checkpoint_dir)
    if args.stream:
        pipe = pipe.streamed(args.stream,
                             checkpoint_dir=args.checkpoint_dir)
    if args.prefetch:
        pipe = pipe.pipelined(args.prefetch)
    if args.speculate:
        pipe = pipe.speculative()
    if args.store:
        pipe = pipe.incremental(args.store,
                                segment_bytes=args.segment_bytes,
                                max_history=args.max_history)
    if args.base:
        pipe = pipe.base(*args.base)

    if args.watch:
        print(f"# {pipe.describe()}", file=sys.stderr)
        print(f"# watching {args.nt} every {args.watch_interval}s "
              f"(history: {os.path.join(args.store, 'history.jsonl')})",
              file=sys.stderr)
        try:
            watch(pipe, args.nt, interval=args.watch_interval,
                  max_assessments=args.watch_max, dqv=args.dqv)
        except KeyboardInterrupt:
            print("# watch stopped", file=sys.stderr)
        return

    t0 = time.time()
    if args.synthetic:
        source = synth_encoded(args.synthetic, seed=0)
    else:
        source = args.nt if args.store else pipe.ingest(args.nt)
    t_ingest = time.time() - t0

    if speaks:
        print(f"# {pipe.describe()}", file=sys.stderr)
    t0 = time.time()
    res = pipe.run(source)
    t_eval = time.time() - t0
    if speaks:
        _print_result(res, t_ingest, t_eval, dqv=args.dqv)
    return 0


if __name__ == "__main__":
    rc = main()
    if rc:                  # a failed mesh run
        sys.exit(rc)
