"""Catalog launcher of the port (fleet-scale assessment,
``repro_torch.catalog`` as CLI).  Crawls rescan through the scan kernels
on the card (``--device cuda``, the default, and ``--backend
fused_scan``); without a card every dataset's record fails rather than
being assessed on the CPU.  Catalog roots, stores and the download cache
are the JAX package's (``python -m repro.launch.qa_catalog``): either
launcher reuses what the other wrote.

  # assess every dataset in a catalog into per-dataset stores
  PYTHONPATH=src python -m repro_torch.launch.qa_catalog crawl \\
      --source datasets/ --root catroot/ --workers 4
  # the same with the kernels' plain torch versions, no card needed
  PYTHONPATH=src python -m repro_torch.launch.qa_catalog crawl \\
      --source datasets/ --root catroot/ --device cpu

  # cross-dataset quality ranking from the stores (no re-assessment)
  python -m repro_torch.launch.qa_catalog rank --root catroot/ --format md

  # latest-vs-previous regression report with alert rules
  python -m repro_torch.launch.qa_catalog report --root catroot/ \\
      --rule 'delta(no_bogus_uris) < -0.05'

  # store maintenance across the whole fleet
  python -m repro_torch.launch.qa_catalog compact --root catroot/ \\
      --max-history 30

  # integrity-check every store's frozen segments (exit 1 on damage)
  python -m repro_torch.launch.qa_catalog fsck --root catroot/

``--source`` accepts a directory tree of ``.nt`` files, a glob pattern,
a JSON manifest (plain ``{"name": "path"}`` mapping, a ``datasets``
list, or DCAT-style ``dataset`` entries), or an ``http(s)://`` manifest
URL.  Remote distributions are localized through the download cache
(``--cache-dir``, default ``<root>/.fetch-cache``) with retry,
ETag/Last-Modified revalidation, Range resume, checksum verification,
and stale-serve degradation; ``--offline`` serves only from cache,
``--refresh`` forces full re-downloads.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def _cmd_crawl(args) -> int:
    from .. import catalog

    summary = catalog.crawl_catalog(
        args.source, args.root, metrics=args.metrics,
        backend=args.backend, device=args.device, base=tuple(args.base),
        workers=args.workers, segment_bytes=args.segment_bytes,
        max_history=args.max_history, max_attempts=args.max_attempts,
        retry_base=args.retry_base, pattern=args.pattern,
        cache_dir=args.cache_dir, offline=args.offline,
        refresh=args.refresh, fetch_timeout=args.fetch_timeout,
        max_fetch_attempts=args.max_fetch_attempts,
        max_crawls=args.max_crawls)
    for rec in summary["datasets"]:
        fetch = rec.get("fetch")
        note = ""
        if fetch is not None:
            if fetch["stale"]:
                note = " [STALE: origin unreachable, cached copy]"
            elif fetch["not_modified"]:
                note = " [304 not modified]"
            elif fetch["status"] == "fetched":
                note = (f" [fetched {fetch['bytes_fetched']:,} bytes in "
                        f"{fetch['attempts']} attempt(s)"
                        + (", resumed]" if fetch["resumed"] else "]"))
        if rec["status"] == "ok":
            print(f"# {rec['name']}: {rec['n_triples']:,} triples, "
                  f"{rec.get('bytes_rescanned', 0):,}/"
                  f"{rec.get('bytes_total', 0):,} bytes rescanned "
                  f"({rec['wall_seconds']:.2f}s){note}", file=sys.stderr)
        else:
            print(f"# {rec['name']}: FAILED after {rec['attempts']} "
                  f"attempt(s) — {rec['error']}", file=sys.stderr)
    fetch = summary.get("fetch")
    if fetch:
        print(f"# fetch: {fetch['requests']} request(s), "
              f"{fetch['attempts']} attempt(s), "
              f"{fetch['bytes_fetched']:,} bytes, "
              f"{fetch['not_modified']} × 304, "
              f"{fetch['stale_served']} stale", file=sys.stderr)
    print(f"# crawl: {summary['n_ok']}/{summary['n_datasets']} ok, "
          f"{summary['bytes_rescanned']:,}/{summary['bytes_total']:,} "
          f"bytes rescanned, {summary['wall_seconds']:.2f}s wall "
          f"({args.backend} on {args.device})", file=sys.stderr)
    print(json.dumps({k: v for k, v in summary.items() if k != "results"},
                     indent=2, sort_keys=True))
    return 0 if summary["n_failed"] == 0 else 1


def _cmd_rank(args) -> int:
    from .. import catalog

    doc = catalog.rank_catalog(args.root)
    if args.format in ("md", "markdown"):
        print(catalog.ranking_markdown(doc), end="")
    else:
        print(json.dumps(doc, indent=2, sort_keys=True))
    return 0


def _cmd_report(args) -> int:
    from .. import catalog

    doc = catalog.report_catalog(args.root, rules=args.rule)
    if args.format in ("md", "markdown"):
        print(catalog.regression_markdown(doc), end="")
    else:
        print(json.dumps(doc, indent=2, sort_keys=True))
    # fired alerts make the exit code non-zero so a cron'd crawl+report
    # pipeline fails loudly
    return 1 if doc["fired"] else 0


def _cmd_compact(args) -> int:
    from ..catalog import store_dir
    from ..store import SegmentStore

    root = os.fspath(args.root)
    try:
        names = sorted(d for d in os.listdir(root)
                       if os.path.isdir(store_dir(root, d)))
    except OSError:
        names = []
    total = {"segments_removed": 0, "bytes_reclaimed": 0,
             "history_dropped": 0}
    for name in names:
        stats = SegmentStore.compact_dir(store_dir(root, name),
                                         max_history=args.max_history)
        print(f"# {name}: {stats['segments_removed']} segment(s) "
              f"removed, {stats['bytes_reclaimed']:,} bytes reclaimed, "
              f"{stats['history_dropped']} snapshot(s) dropped",
              file=sys.stderr)
        for k in total:
            total[k] += stats[k]
    print(f"# compacted {len(names)} store(s): "
          f"{total['segments_removed']} segment(s) removed, "
          f"{total['bytes_reclaimed']:,} bytes reclaimed, "
          f"{total['history_dropped']} snapshot(s) dropped",
          file=sys.stderr)
    return 0


def _cmd_fsck(args) -> int:
    from ..catalog import store_dir
    from ..store import SegmentStore

    root = os.fspath(args.root)
    try:
        names = sorted(d for d in os.listdir(root)
                       if os.path.isdir(store_dir(root, d)))
    except OSError:
        names = []
    damaged = 0
    reports = {}
    for name in names:
        rep = SegmentStore.verify_dir(store_dir(root, name))
        reports[name] = rep
        if rep["clean"]:
            print(f"# {name}: OK — {rep['segments_ok']}/"
                  f"{rep['segments_checked']} segment(s) verified"
                  + (f", {rep['orphans']} orphan(s)" if rep["orphans"]
                     else ""), file=sys.stderr)
        else:
            damaged += 1
            probs = ([f"missing {fp}" for fp in rep["missing"]]
                     + [f"corrupt {c['fp']} ({c['issue']})"
                        for c in rep["corrupt"]])
            print(f"# {name}: DAMAGED — " + "; ".join(probs),
                  file=sys.stderr)
    print(json.dumps({"n_datasets": len(names), "n_damaged": damaged,
                      "datasets": reports}, indent=2, sort_keys=True))
    if damaged:
        print(f"# fsck: {damaged}/{len(names)} store(s) damaged "
              "(they self-heal by rescanning on the next crawl)",
              file=sys.stderr)
        return 1
    print(f"# fsck: all {len(names)} store(s) clean", file=sys.stderr)
    return 0


def main(argv=None):
    from ..core.evaluator import BACKENDS

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.qa_catalog",
        description="fleet-scale RDF quality assessment over a dataset "
                    "catalog (one incremental store per dataset)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("crawl", help="assess every dataset in a catalog")
    c.add_argument("--source", required=True,
                   help="catalog source: directory tree, glob pattern, "
                        "or JSON manifest")
    c.add_argument("--root", required=True, metavar="DIR",
                   help="catalog root: one store per dataset under DIR")
    c.add_argument("--pattern", default="*.nt",
                   help="filename pattern for directory sources")
    c.add_argument("--metrics", default="all", help="'paper'|'all'|csv")
    c.add_argument("--backend", choices=BACKENDS, default="fused_scan",
                   help="fused_scan: counters and sketches in one kernel; "
                        "twopass: qap_count plus one hll_fold per sketch; "
                        "torch: the plain torch versions")
    c.add_argument("--device", default="cuda",
                   help="where the scans run: cuda (default; fails "
                        "without a card), cuda:N, or cpu")
    c.add_argument("--base", action="append", default=[],
                   help="internal base namespace (repeatable)")
    c.add_argument("--workers", type=int, default=4,
                   help="datasets assessed concurrently")
    c.add_argument("--segment-bytes", type=int, default=0,
                   help="target store segment size (0 = default)")
    c.add_argument("--max-history", type=int, default=0, metavar="N",
                   help="per-store history retention (0 = unbounded)")
    c.add_argument("--max-attempts", type=int, default=3,
                   help="attempts per dataset on transient failures")
    c.add_argument("--retry-base", type=float, default=0.2,
                   metavar="SECONDS", help="retry backoff base")
    c.add_argument("--max-crawls", type=int, default=0, metavar="N",
                   help="crawls.jsonl retention: keep newest N crawl "
                        "summaries (0 = unbounded)")
    c.add_argument("--cache-dir", default=None, metavar="DIR",
                   help="download cache for remote distributions "
                        "(default: <root>/.fetch-cache)")
    c.add_argument("--offline", action="store_true",
                   help="never touch the network: serve remote "
                        "distributions from cache only")
    c.add_argument("--refresh", action="store_true",
                   help="skip revalidation and force full re-downloads")
    c.add_argument("--fetch-timeout", type=float, default=10.0,
                   metavar="SECONDS", help="per-request HTTP timeout")
    c.add_argument("--max-fetch-attempts", type=int, default=3,
                   help="HTTP attempts per distribution on transient "
                        "failures")
    c.set_defaults(fn=_cmd_crawl)

    r = sub.add_parser("rank", help="cross-dataset quality ranking")
    r.add_argument("--root", required=True, metavar="DIR")
    r.add_argument("--format", choices=["json", "md", "markdown"],
                   default="json")
    r.set_defaults(fn=_cmd_rank)

    g = sub.add_parser("report", help="latest-vs-previous regression "
                                      "report with alert rules")
    g.add_argument("--root", required=True, metavar="DIR")
    g.add_argument("--rule", action="append", default=[],
                   help="alert rule, e.g. 'dereferenceability < 0.9' or "
                        "'delta(no_bogus_uris) < -0.05' (repeatable)")
    g.add_argument("--format", choices=["json", "md", "markdown"],
                   default="json")
    g.set_defaults(fn=_cmd_report)

    k = sub.add_parser("compact", help="compact every per-dataset store "
                                       "under the catalog root")
    k.add_argument("--root", required=True, metavar="DIR")
    k.add_argument("--max-history", type=int, default=0, metavar="N",
                   help="also truncate each history.jsonl to newest N")
    k.set_defaults(fn=_cmd_compact)

    f = sub.add_parser("fsck", help="verify frozen-segment integrity "
                                    "across every store (exit 1 on "
                                    "damage)")
    f.add_argument("--root", required=True, metavar="DIR")
    f.set_defaults(fn=_cmd_fsck)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
