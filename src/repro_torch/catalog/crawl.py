"""Fleet crawl: incremental assessment of every dataset in a catalog.

One crawl = one pass over the discovered refs.  Each dataset gets its
own segment store under the catalog root (``<root>/<name>/store/``), so
a warm re-crawl rescans only the bytes that actually changed in each
dataset — the same amortization ``repro_torch.store`` gives a single
dataset, multiplied across the fleet.  Every rescanned segment goes
through the port's incremental runner (``store/runner.py``) and so
through the scan kernels on the card (``device="cuda"``, the default,
with the ``fused_scan`` backend); without a card each dataset's record
fails with an error that names the device, and nothing is assessed on
the CPU unless ``device="cpu"`` is asked for.

Remote refs (``http(s)://`` distributions, or a manifest URL source) go
through a **fetch stage** first: a shared ``repro_torch.fetch.Fetcher``
localizes each distribution into the download cache (default
``<root>/.fetch-cache``) with retry/backoff, per-host breakers,
ETag/Last-Modified revalidation, Range resume, and checksum
verification.  The cache path is stable per URL, so a 304 revalidation
feeds the *same* local file back into the incremental store — zero
bytes fetched and zero bytes rescanned on an unchanged re-crawl.  An
unreachable origin with a cached copy degrades to a **stale** serve
(``stale: true`` on the dataset record and a summary counter); only a
never-fetched dataset fails, and the rest of the fleet completes.

Isolation rules mirror ``repro_torch.serve``'s job engine:

* datasets run on a bounded thread pool (``workers``) — kernel launches
  are asynchronous, and a worker waits for its segment's scan in the
  device-to-host copy of ``QualityEvaluator.materialize_chunk``, with
  the GIL released, while the others parse and launch; the per-dataset
  stores never contend.  The workers share one evaluator (one per
  metrics, backend and device) and launch on the card's default stream,
  so their scans run one after another on the card;
* a failure is classified with ``serve.jobs.default_transient``:
  transient ones (I/O hiccups) retry with exponential backoff up to
  ``max_attempts``; permanent ones (corrupt content, bad config) fail
  once.  Either way the failure is *recorded* in the summary and the
  crawl continues — one corrupt dataset never kills the fleet.  Fetch
  failures arrive pre-retried (the fetcher owns network backoff) and
  are recorded without a second retry loop;
* a ref whose path does not exist is a permanent failure up front (no
  retry: the classifier would call the ``FileNotFoundError`` transient,
  but a missing catalog entry is a configuration error, not a hiccup).

Every crawl appends one summary line to ``<root>/crawls.jsonl`` so the
regression report can compare "this crawl" against "the previous one"
even across processes; ``max_crawls`` bounds that journal by atomically
rewriting it to the newest N under a cross-process flock (the
``max_history`` retention rule, applied at the fleet level).
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from ..fetch import Fetcher, FetchError
from ..serve.jobs import default_transient
from .discovery import DatasetRef, discover, is_url

try:
    import fcntl
except ImportError:
    fcntl = None

CRAWLS_NAME = "crawls.jsonl"
CACHE_DIRNAME = ".fetch-cache"


def store_dir(root: str, name: str) -> str:
    """Per-dataset store location under the catalog root (mirrors the
    service registry layout: ``<root>/<name>/store/``)."""
    return os.path.join(root, name, "store")


def _assess_one(ref: DatasetRef, root: str, *, metrics, backend, device,
                base, segment_bytes: int, max_history: int,
                max_attempts: int, retry_base: float,
                fetcher: Optional[Fetcher]) -> dict:
    from .. import qa

    rec = {"name": ref.name, "path": ref.path, "status": "failed",
           "attempts": 0, "error": None}
    t0 = time.monotonic()

    path = ref.path
    if ref.remote:
        rec["url"] = ref.url
        try:
            fr = fetcher.fetch(ref.url, checksum=ref.checksum)
        except FetchError as exc:
            # the fetcher already retried/backed off network transients;
            # what escapes is terminal for this crawl
            rec["attempts"] = max(1, getattr(exc, "attempts", 1))
            rec["error"] = f"{type(exc).__name__}: {exc}"
            rec["wall_seconds"] = time.monotonic() - t0
            return rec
        rec["fetch"] = fr.to_dict()
        rec["stale"] = fr.stale
        rec["path"] = path = fr.path
    if not os.path.isfile(path):
        rec["attempts"] = 1
        rec["error"] = f"dataset file not found: {path}"
        rec["wall_seconds"] = time.monotonic() - t0
        return rec

    pipe = qa.pipeline().metrics(metrics).backend(backend).device(device)
    if base:
        pipe = pipe.base(*base)
    pipe = pipe.incremental(
        store_dir(root, ref.name), segment_bytes=segment_bytes,
        dataset_uri=f"urn:repro:dataset:{ref.name}",
        max_history=max_history)

    last_exc: BaseException | None = None
    for attempt in range(1, max(1, max_attempts) + 1):
        rec["attempts"] = attempt
        try:
            result = pipe.run(path)
        except Exception as exc:            # noqa: BLE001 — recorded
            last_exc = exc
            if attempt < max_attempts and default_transient(exc):
                time.sleep(retry_base * (2 ** (attempt - 1)))
                continue
            break
        rec["status"] = "ok"
        rec["error"] = None
        rec["values"] = {k: float(v)
                         for k, v in sorted(result.values.items())}
        rec["n_triples"] = int(result.n_triples)
        s = result.exec_stats
        if s is not None:
            rec["bytes_total"] = int(getattr(s, "bytes_total", 0))
            rec["bytes_rescanned"] = int(getattr(s, "bytes_rescanned", 0))
            rec["segments_reused"] = int(getattr(s, "segments_reused", 0))
            rec["segments_rescanned"] = int(
                getattr(s, "segments_rescanned", 0))
            rec["footprints_replayed"] = int(
                getattr(s, "footprints_replayed", 0))
        rec["wall_seconds"] = time.monotonic() - t0
        rec["_result"] = result             # popped before persistence
        return rec
    rec["error"] = f"{type(last_exc).__name__}: {last_exc}"
    rec["wall_seconds"] = time.monotonic() - t0
    return rec


def crawl_catalog(source, root, *, metrics="all", backend="fused_scan",
                  device="cuda", base=(), workers: int = 4,
                  segment_bytes: int = 0,
                  max_history: int = 0, max_attempts: int = 3,
                  retry_base: float = 0.2, keep_results: bool = False,
                  pattern: str = "*.nt", cache_dir=None,
                  offline: bool = False, refresh: bool = False,
                  fetch_timeout: float = 10.0,
                  max_fetch_attempts: int = 3, fetcher: Optional[Fetcher]
                  = None, fetch_metrics=None,
                  max_crawls: int = 0) -> dict:
    """Crawl every dataset in ``source`` into per-dataset stores under
    ``root``; returns (and journals) the crawl summary.

    The summary's ``datasets`` list is in discovery order regardless of
    completion order, so two crawls of the same catalog are directly
    comparable.  With ``keep_results=True`` the in-memory
    ``AssessmentResult`` objects ride along under ``"results"`` (never
    journaled) so callers can compare values *and HLL registers* against
    a standalone ``qa.assess`` — the benchmark's exactness gate.

    Remote sources/distributions go through a shared ``Fetcher`` over
    ``cache_dir`` (default ``<root>/.fetch-cache``); pass ``fetcher=``
    to share one cache/breaker/metrics plane across crawls (the daemon
    does), or ``fetch_metrics=`` to land the fetch counters in an
    ``obs.Metrics`` registry.  ``offline`` serves only from cache;
    ``refresh`` forces full re-downloads.  ``backend`` is one of
    ``torch|twopass|fused_scan`` and ``device`` where the scans run
    (``"cuda"``, ``"cuda:N"`` or ``"cpu"``).
    """
    root = os.fspath(root)
    os.makedirs(root, exist_ok=True)
    src = os.fspath(source)

    def make_fetcher() -> Fetcher:
        return Fetcher(cache_dir or os.path.join(root, CACHE_DIRNAME),
                       timeout=fetch_timeout,
                       max_attempts=max_fetch_attempts,
                       offline=offline, refresh=refresh,
                       metrics=fetch_metrics)

    if fetcher is None and is_url(src):
        fetcher = make_fetcher()
    refs = discover(src, pattern=pattern, fetcher=fetcher)
    if fetcher is None and any(r.remote for r in refs):
        fetcher = make_fetcher()
    t0 = time.monotonic()

    kw = dict(metrics=metrics, backend=backend, device=device,
              base=tuple(base),
              segment_bytes=segment_bytes, max_history=max_history,
              max_attempts=max_attempts, retry_base=retry_base,
              fetcher=fetcher)
    records: list[dict] = [None] * len(refs)
    if refs:
        with ThreadPoolExecutor(max_workers=max(1, workers)) as pool:
            futs = {pool.submit(_assess_one, ref, root, **kw): i
                    for i, ref in enumerate(refs)}
            for fut, i in futs.items():
                records[i] = fut.result()

    results = {}
    for rec in records:
        r = rec.pop("_result", None)
        if r is not None:
            results[rec["name"]] = r

    ok = [r for r in records if r["status"] == "ok"]
    summary = {
        "generatedAtTime": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                         time.gmtime()),
        "source": src,
        "root": root,
        "n_datasets": len(records),
        "n_ok": len(ok),
        "n_failed": len(records) - len(ok),
        "bytes_total": sum(r.get("bytes_total", 0) for r in ok),
        "bytes_rescanned": sum(r.get("bytes_rescanned", 0) for r in ok),
        "segments_reused": sum(r.get("segments_reused", 0) for r in ok),
        "segments_rescanned": sum(r.get("segments_rescanned", 0)
                                  for r in ok),
        "wall_seconds": time.monotonic() - t0,
        "datasets": records,
    }
    fetched = [r["fetch"] for r in records if "fetch" in r]
    if fetched or fetcher is not None:
        summary["fetch"] = {
            "requests": len(fetched),
            "attempts": sum(f["attempts"] for f in fetched),
            "bytes_fetched": sum(f["bytes_fetched"] for f in fetched),
            "not_modified": sum(1 for f in fetched if f["not_modified"]),
            "stale_served": sum(1 for f in fetched if f["stale"]),
            "offline": offline,
        }
    _append_crawl(root, summary, max_crawls=max_crawls)
    if keep_results:
        summary["results"] = results
    return summary


_crawl_lock = threading.Lock()


@contextlib.contextmanager
def _crawls_flock(root: str):
    """Cross-process lock for the crawls journal (same flock discipline
    as the segment store): append+rewrite is atomic fleet-wide."""
    if fcntl is None:
        yield
        return
    fd = os.open(os.path.join(root, ".crawls.lock"),
                 os.O_CREAT | os.O_RDWR, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)


def _append_crawl(root: str, summary: dict, max_crawls: int = 0) -> None:
    line = json.dumps({k: v for k, v in summary.items()
                       if k != "results"}, sort_keys=True)
    path = os.path.join(root, CRAWLS_NAME)
    with _crawl_lock, _crawls_flock(root):
        with open(path, "a") as f:
            f.write(line + "\n")
        if max_crawls > 0:
            with open(path) as f:
                lines = [ln for ln in f.read().splitlines() if ln.strip()]
            if len(lines) > max_crawls:
                tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
                try:
                    with open(tmp, "w") as f:
                        f.write("\n".join(lines[-max_crawls:]) + "\n")
                    os.replace(tmp, path)
                finally:
                    if os.path.exists(tmp):
                        try:
                            os.remove(tmp)
                        except OSError:
                            pass


def load_crawls(root) -> list[dict]:
    """Crawl summaries in append order; torn tail lines are skipped the
    same way ``core.report.load_history`` skips them."""
    out = []
    try:
        with open(os.path.join(os.fspath(root), CRAWLS_NAME)) as f:
            for ln in f:
                ln = ln.strip()
                if not ln:
                    continue
                try:
                    out.append(json.loads(ln))
                except ValueError:
                    continue
    except OSError:
        pass
    return out
