"""Assessment-as-a-service launcher of the port (the ``repro_torch.serve``
daemon): every job rescans through the scan kernels on the card
(``--device cuda``, the default, and ``--backend fused_scan``); without a
card the jobs fail rather than run on the CPU.

  PYTHONPATH=src python -m repro_torch.launch.qa_serve --port 8080 \\
      --store-root qroot/ --metrics paper --base http://ex/
  PYTHONPATH=src python -m repro_torch.launch.qa_serve --port 8080 \\
      --store-root qroot/ --device cpu     # the kernels' plain versions

Then, from any DQV consumer (a datosgov-style pipeline loading reports
into a triplestore, a dashboard, plain curl)::

  curl -X PUT --data-binary @data.nt localhost:8080/datasets/my/data
  curl localhost:8080/datasets/my/jobs
  curl localhost:8080/datasets/my/report
  curl localhost:8080/datasets/my/history
  curl localhost:8080/metrics

``python -m repro_torch.launch.assess --serve PORT --store-root DIR``
forwards here, so either entry point works.  The HTTP API, the journal
and the store root's layout are the JAX daemon's
(``python -m repro.launch.qa_serve``): either daemon takes over a root
the other wrote.

Shutdown is graceful on SIGTERM and SIGINT (container orchestrators get
clean rollouts): the HTTP listener stops accepting, running jobs drain,
the job journal is flushed, and the process exits 0.  Jobs still queued
at that point stay in the journal and replay on the next start.
"""
from __future__ import annotations

import argparse
import signal
import sys


def main(argv=None):
    from ..core.evaluator import BACKENDS

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.qa_serve",
        description="multi-tenant RDF quality-assessment service over "
                    "the incremental segment store")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--host", default="127.0.0.1",
                    help="bind address (default loopback; bind wider "
                         "only behind something that authenticates)")
    ap.add_argument("--store-root", required=True, metavar="DIR",
                    help="dataset root: one registry entry + segment "
                         "store per dataset under DIR")
    ap.add_argument("--metrics", default="all", help="'paper'|'all'|csv")
    ap.add_argument("--backend", choices=BACKENDS, default="fused_scan",
                    help="fused_scan: counters and sketches in one kernel; "
                         "twopass: qap_count plus one hll_fold per sketch; "
                         "torch: the plain torch versions")
    ap.add_argument("--device", default="cuda",
                    help="where the scans run: cuda (default; jobs fail "
                         "without a card), cuda:N, or cpu")
    ap.add_argument("--base", action="append", default=[],
                    help="internal base namespace (repeatable)")
    ap.add_argument("--workers", type=int, default=2,
                    help="job worker pool: distinct datasets assess "
                         "concurrently; one dataset is serialized")
    ap.add_argument("--prefetch", type=int, default=0, metavar="N",
                    help=">0: async pipelined chunk executor per job")
    ap.add_argument("--speculate", action="store_true",
                    help="speculative straggler re-execution per job")
    ap.add_argument("--segment-bytes", type=int, default=0,
                    help="target store segment size (0 = default)")
    ap.add_argument("--max-queued", type=int, default=64,
                    help="waiting-job cap: further submissions get HTTP "
                         "429 + Retry-After (0 = unbounded)")
    ap.add_argument("--max-attempts", type=int, default=3,
                    help="attempts per job: transient failures retry "
                         "with exponential backoff (1 = never retry)")
    ap.add_argument("--retry-base", type=float, default=0.5,
                    metavar="SECONDS",
                    help="retry backoff base (doubles per attempt, "
                         "jittered)")
    ap.add_argument("--job-timeout", type=float, default=0.0,
                    metavar="SECONDS",
                    help="per-attempt watchdog: a hung assessment is "
                         "expired and its worker freed (0 = off)")
    ap.add_argument("--breaker-threshold", type=int, default=5,
                    help="consecutive terminal failures that quarantine "
                         "a dataset (submits -> 503 + Retry-After until "
                         "a cool-down probe succeeds; 0 = off)")
    ap.add_argument("--breaker-cooldown", type=float, default=30.0,
                    metavar="SECONDS",
                    help="quarantine cool-down (doubles per re-trip)")
    ap.add_argument("--max-finished", type=int, default=512,
                    help="finished jobs retained in memory; older ones "
                         "are evicted (the journal stays durable)")
    ap.add_argument("--no-journal", action="store_true",
                    help="disable the write-ahead job journal (accepted "
                         "jobs will NOT survive a crash)")
    ap.add_argument("--poll-interval", type=float, default=2.0,
                    metavar="SECONDS",
                    help="watcher cadence for registered source paths")
    ap.add_argument("--no-watch", action="store_true",
                    help="disable the source-path watcher (uploads and "
                         "POST /assess still work)")
    args = ap.parse_args(argv)

    from ..serve import QAServer, ServerConfig

    cfg = ServerConfig(
        store_root=args.store_root, metrics=args.metrics,
        backend=args.backend, device=args.device, base=tuple(args.base),
        workers=args.workers, prefetch=args.prefetch,
        speculate=args.speculate, segment_bytes=args.segment_bytes,
        poll_interval=args.poll_interval, watch=not args.no_watch,
        max_queued=args.max_queued, journal=not args.no_journal,
        max_attempts=args.max_attempts, retry_base=args.retry_base,
        job_timeout=args.job_timeout,
        breaker_threshold=args.breaker_threshold,
        breaker_cooldown=args.breaker_cooldown,
        max_finished=args.max_finished)
    srv = QAServer(cfg, host=args.host, port=args.port).start()
    # graceful shutdown: install the handlers BEFORE the startup banner —
    # orchestrators (and tests) treat the banner as "ready" and may send
    # SIGTERM immediately; a signal landing before installation would hit
    # the default action and kill the process without draining
    got = []

    def _on_signal(signum, frame):
        got.append(signal.Signals(signum).name)
        srv.request_stop()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    print(f"# repro_torch.serve on http://{srv.host}:{srv.port} "
          f"(store root: {srv.registry.root}, {args.workers} workers, "
          f"backend {args.backend}, device {args.device})",
          file=sys.stderr)
    print("#   PUT  /datasets/<name>         register "
          "{source?, alerts?, webhook?}", file=sys.stderr)
    print("#   PUT  /datasets/<name>/data    upload N-Triples -> job",
          file=sys.stderr)
    print("#   GET  /datasets/<name>/report  latest DQV "
          "(?format=nt for N-Triples)", file=sys.stderr)
    print("#   GET  /datasets/<name>/history trend report | /metrics | "
          "/healthz", file=sys.stderr)
    print("#   GET  /catalog/ranking        cross-dataset quality "
          "ranking (?format=md)", file=sys.stderr)
    # the handler only unblocks wait() (signal-safe); the main thread
    # then drains jobs and flushes the journal in close()
    try:
        srv.wait()
    except KeyboardInterrupt:       # SIGINT before the handler was set
        got.append("SIGINT")
    finally:
        print(f"# repro_torch.serve: {got[0] if got else 'stop'} — "
              "draining running jobs, flushing journal", file=sys.stderr)
        srv.close()
        print("# repro_torch.serve: clean shutdown", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
