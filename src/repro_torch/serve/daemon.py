"""The quality-assessment service daemon (assessment as a service).

A stdlib-only HTTP front end (``http.server.ThreadingHTTPServer``) over
the existing machinery: multi-tenant dataset registry (one
``repro_torch.store`` segment store per dataset), a bounded job queue
driving ``qa.Pipeline.incremental`` per assessment, DQV report + history
serving, threshold/regression alerts, and Prometheus-text observability.

Every job assesses through the port's incremental runner
(``store/runner.py``): each rescanned segment launches the configured
backend's scan kernels on the card (``ServerConfig.device``, default
``"cuda"``; backend default ``"fused_scan"``).  Without a card a job
fails with an error that names the device; nothing falls back to the
CPU unless ``device="cpu"`` is configured.  The worker threads share one
evaluator and launch on the card's default stream, so the scans of
concurrent jobs run one after another on the card while their ingest
overlaps on the host.  The HTTP API, the journal, the metric names and
the on-disk layout are the JAX package's, so either daemon serves (and
replays) a store root the other wrote.

API (JSON unless noted)::

    GET  /healthz                      liveness + queue/dataset counts
    GET  /metrics                      Prometheus text format
    GET  /datasets                     registered datasets
    PUT  /datasets/<name>              register/update
                                       body: {"source"?: "/path/on/server",
                                              "alerts"?: ["L1 < 0.9", ...],
                                              "webhook"?: "http://..."}
    GET  /datasets/<name>              registration + store/job summary
    PUT  /datasets/<name>/data         upload N-Triples bytes; auto-
                                       registers unknown names; enqueues
                                       an incremental assessment -> job
    DELETE /datasets/<name>            unregister + reclaim the store
                                       (409 while jobs are in flight;
                                       tombstone journaled first)
    POST /datasets/<name>/assess       enqueue an assessment of the
                                       registered source (or last upload)
    GET  /datasets/<name>/jobs         job log, oldest first
    GET  /datasets/<name>/jobs/<id>    one job (state, exec_stats, values)
    GET  /datasets/<name>/report       latest DQV report; ?format=nt or
                                       Accept: application/n-triples for
                                       the N-Triples serialization
    GET  /datasets/<name>/history      history.jsonl folded into the DQV
                                       trend report (per-metric deltas)
    GET  /datasets/<name>/alerts       fired alert records

Safety properties:

* uploads land atomically (registry tmp+rename), so a job segmenting the
  previous payload never reads a torn file;
* per-dataset assessments are serialized by the job queue while distinct
  datasets run concurrently on the worker pool;
* the queue is bounded (``max_queued``): job-enqueuing endpoints answer
  429 with a ``Retry-After`` header once that many jobs are waiting, and
  each rejection is counted in ``repro_jobs_rejected_total`` — clients
  faster than the workers see backpressure, not unbounded memory growth;
* accepted work is durable: every job is journaled (``jobs.jsonl`` under
  the store root, fsync'd) *before* its 202 goes out, and a restarted
  daemon replays unfinished jobs under their original ids — ``kill -9``
  loses nothing a client was told was accepted;
* failures degrade gracefully: transient job errors retry with
  exponential backoff + jitter (``max_attempts``), a hung assessment is
  expired by the per-job watchdog (``job_timeout``) so it cannot wedge a
  worker, and ``breaker_threshold`` consecutive terminal failures
  quarantine a dataset — submits answer 503 + Retry-After (the dataset
  is poison) while healthy tenants keep running, until a cool-down probe
  succeeds;
* each dataset's store dir is an ordinary ``repro_torch.store``
  directory —
  external CLI monitors (``--store <root>/<name>/store``) may run
  concurrently with daemon jobs; commits are flock-serialized and the
  manifest version CAS'd by the store itself.
"""
from __future__ import annotations

import dataclasses
import datetime
import http.server
import json
import os
import re
import threading
import time
import traceback
import sys
from typing import Optional
from urllib.parse import parse_qs, urlsplit

from . import alerts as alerts_mod
from .jobs import DatasetQuarantined, Job, JobQueue, QueueFull
from .journal import JobJournal
from .obs import Metrics
from .registry import DatasetRegistry, RegistryError, UnknownDataset
from ..launch.assess import file_signature

JSON_CT = "application/json"
NT_CT = "application/n-triples"
PROM_CT = "text/plain; version=0.0.4"

MAX_UPLOAD_BYTES = 1 << 31          # refuse absurd Content-Length up front


class ApiError(Exception):
    """An HTTP-visible request failure.  ``headers`` are extra response
    headers (e.g. ``Retry-After`` on a 429)."""

    def __init__(self, status: int, message: str,
                 headers: Optional[dict] = None):
        super().__init__(message)
        self.status = status
        self.headers = headers or {}


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """How the daemon executes assessments (the server-side knobs that a
    one-shot CLI run would take on its command line)."""
    store_root: str                   # one dataset dir per tenant under it
    metrics: str = "all"              # metric spec (qa.Pipeline.metrics)
    backend: str = "fused_scan"       # torch | twopass | fused_scan
    device: str = "cuda"              # where the scans run (cuda | cuda:N
                                      #   | cpu: the plain torch versions)
    base: tuple = ()                  # internal base namespaces
    workers: int = 2                  # job worker pool size
    prefetch: int = 0                 # async pipelined executor depth
    speculate: bool = False           # straggler backup copies
    segment_bytes: int = 0            # store segment target (0 = default)
    poll_interval: float = 2.0        # source-file watcher cadence
    watch: bool = True                # poll registered source paths
    max_queued: int = 64              # waiting-job cap -> HTTP 429
                                      # (0 = unbounded, pre-cap behaviour)
    journal: bool = True              # write-ahead job journal + replay
    max_attempts: int = 3             # attempts per job (transient errors
                                      #   retry with backoff; 1 = never)
    retry_base: float = 0.5           # backoff base seconds (x2 per try)
    job_timeout: float = 0.0          # per-attempt watchdog (0 = off)
    breaker_threshold: int = 5        # consecutive terminal failures that
                                      #   quarantine a dataset (0 = off)
    breaker_cooldown: float = 30.0    # quarantine cool-down seconds
                                      #   (doubles per re-trip, capped 32x)
    max_finished: int = 512           # finished jobs retained in memory
                                      #   (older evicted; journal durable)
    webhook_retries: int = 3          # alert webhook POST attempts
    webhook_backoff: float = 0.5      # webhook backoff base seconds
    fetch_timeout: float = 10.0       # HTTP timeout for remote sources
    max_fetch_attempts: int = 3       # HTTP attempts per remote fetch


def _now_iso() -> str:
    return datetime.datetime.now(datetime.timezone.utc).isoformat()


def _json_bytes(doc) -> bytes:
    return (json.dumps(doc, indent=2, sort_keys=False) + "\n").encode()


def _err(message: str) -> bytes:
    return _json_bytes({"error": message})


class QAServer:
    """The daemon: HTTP server + registry + job queue + watcher."""

    def __init__(self, config: ServerConfig, host: str = "127.0.0.1",
                 port: int = 0, faults=None):
        from .. import qa                     # defer the torch import
        self.config = config
        self.registry = DatasetRegistry(config.store_root)
        self.obs = Metrics()
        self._faults = faults
        self.journal = (JobJournal(
            os.path.join(self.registry.root, "jobs.jsonl"), faults=faults)
            if config.journal else None)
        self.jobs = JobQueue(
            workers=config.workers, max_queued=config.max_queued,
            journal=self.journal, faults=faults, metrics=self.obs,
            max_attempts=config.max_attempts,
            retry_base=config.retry_base,
            job_timeout=config.job_timeout,
            breaker_threshold=config.breaker_threshold,
            breaker_cooldown=config.breaker_cooldown,
            max_finished=config.max_finished)
        pipe = (qa.pipeline().metrics(config.metrics)
                .backend(config.backend).device(config.device))
        if config.prefetch:
            pipe = pipe.pipelined(config.prefetch)
        if config.speculate:
            pipe = pipe.speculative()
        if config.base:
            pipe = pipe.base(*config.base)
        self._pipe = pipe
        self._started_at = time.time()
        self._stop = threading.Event()
        self._watch_sigs: dict[str, tuple] = {}
        self._fetcher = None              # built on first remote source
        self._fetcher_lock = threading.Lock()
        self.httpd = _HTTPServer((host, port), _Handler)
        self.httpd.qa = self
        self.host, self.port = self.httpd.server_address[:2]
        self._threads: list[threading.Thread] = []
        self.obs.gauge("repro_job_queue_depth", self.jobs.depth)
        self.obs.gauge("repro_datasets_registered",
                       lambda: len(self.registry.names()))
        self._closed = False
        if self.journal is not None:
            self._replay_journal()

    def _replay_journal(self) -> None:
        """Re-enqueue every journaled job that never reached a terminal
        state — ``kill -9`` loses no accepted work.  The journal is first
        compacted to exactly those jobs' enqueue records (atomic rewrite:
        a crash mid-compaction leaves the old journal governing), then
        each is re-submitted under its original id with the enqueue
        append skipped (the compacted record already covers it)."""
        unfinished, max_id = JobJournal.replay(self.journal.path)
        self.jobs.set_next_id(max_id + 1)
        keep = [rec for rec in unfinished
                if rec["dataset"] in self.registry
                and rec.get("path") and os.path.exists(rec["path"])]
        self.journal.reset([
            JobJournal.enqueue_record(rec["id"], rec["dataset"],
                                      rec["trigger"], rec["path"],
                                      requeued=True)
            for rec in keep])
        for rec in keep:
            try:
                self.jobs.submit(rec["dataset"], trigger=rec["trigger"],
                                 path=rec["path"], fn=self._execute,
                                 _id=rec["id"], _journal=False)
            except (QueueFull, DatasetQuarantined):
                continue      # enqueue record stays; next restart retries
            self.obs.inc("repro_jobs_replayed_total",
                         dataset=rec["dataset"])

    # -- lifecycle -------------------------------------------------------------
    def start(self) -> "QAServer":
        t = threading.Thread(target=self.httpd.serve_forever,
                             name="qa-serve-http", daemon=True)
        t.start()
        self._threads.append(t)
        if self.config.watch:
            w = threading.Thread(target=self._watch_loop,
                                 name="qa-serve-watch", daemon=True)
            w.start()
            self._threads.append(w)
        return self

    def wait(self) -> None:
        """Block until ``close()``/``request_stop()`` (or the process is
        interrupted)."""
        self._stop.wait()

    def request_stop(self) -> None:
        """Unblock ``wait()`` without tearing anything down yet — the
        SIGTERM/SIGINT handler's half of a graceful shutdown (signal
        handlers must not join threads; the main thread runs ``close``)."""
        self._stop.set()

    def close(self) -> None:
        """Graceful shutdown: stop accepting HTTP, drain running jobs,
        flush the journal.  Jobs still queued (or awaiting a retry) stay
        in the journal and replay on the next start.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        self.httpd.shutdown()
        self.httpd.server_close()
        self.jobs.shutdown(wait=True)
        if self.journal is not None:
            self.journal.close()
        for t in self._threads:
            t.join(timeout=10.0)

    # -- the source watcher ----------------------------------------------------
    @property
    def fetcher(self):
        """Shared fetch plane for ``http(s)://`` dataset sources, built
        lazily (a daemon with only local sources never creates the cache
        dir).  One cache + breaker set serves the watcher and every job,
        and its counters land in this server's /metrics."""
        with self._fetcher_lock:
            if self._fetcher is None:
                from ..fetch import Fetcher
                self._fetcher = Fetcher(
                    os.path.join(self.registry.root, ".fetch-cache"),
                    timeout=self.config.fetch_timeout,
                    max_attempts=self.config.max_fetch_attempts,
                    metrics=self.obs)
            return self._fetcher

    def _source_signature(self, source: str):
        """Change-detection signature for a registered source: the
        mtime_ns/size/inode triple for local paths, the cache content
        digest for remote URLs (a revalidated 304 keeps the digest — and
        therefore the signature — stable at zero transfer cost)."""
        from ..catalog import is_url
        if is_url(source):
            return ("url", self.fetcher.fetch(source).digest)
        return file_signature(source)

    def _watch_loop(self) -> None:
        """Poll every registered ``source``; enqueue an assessment when
        its signature changes.  Local paths use ``file_signature`` (the
        same mtime_ns/size/inode triple the CLI ``--watch`` loop uses, so
        same-size atomic replaces are caught here too); remote URLs
        revalidate through the fetch cache, so an unchanged origin costs
        one conditional request and zero body bytes per poll.  A fetch
        failure (origin down, breaker open with nothing cached) skips
        the dataset until the next poll — scheduled surfaces degrade,
        they don't crash."""
        from ..fetch import FetchError
        while not self._stop.wait(self.config.poll_interval):
            for name in self.registry.names():
                try:
                    ds = self.registry.get(name)
                except UnknownDataset:
                    continue
                if not ds.source:
                    continue
                try:
                    sig = self._source_signature(ds.source)
                except (OSError, FetchError):
                    continue              # absent/mid-replace: next poll
                if self._watch_sigs.get(name) == sig:
                    continue
                try:
                    self.submit_assessment(name, trigger="watch")
                except (ApiError, RegistryError, UnknownDataset):
                    continue      # incl. 429 queue-full: sig NOT recorded,
                                  # so the change is retried next poll
                self._watch_sigs[name] = sig

    # -- assessment jobs -------------------------------------------------------
    def _job_path(self, name: str, trigger: str) -> str:
        """The dataset bytes this job will assess: the upload for
        upload-triggered jobs, else the registered source, else the last
        upload."""
        from ..catalog import is_url
        from ..fetch import FetchError
        ds = self.registry.get(name)
        data = self.registry.data_path(name)
        if trigger == "upload":
            path = data
        else:
            path = ds.source or data
        if is_url(path):
            # localize through the shared cache: warm = one conditional
            # request; origin down = the cached copy, served stale
            try:
                return self.fetcher.fetch(path).path
            except FetchError as e:
                raise ApiError(
                    502, f"dataset {name!r}: remote source fetch failed "
                         f"({e})") from None
        if not os.path.exists(path):
            raise ApiError(409, f"dataset {name!r} has no data: upload to "
                                f"/datasets/{name}/data or register a "
                                f"server-side source path")
        return path

    def submit_assessment(self, name: str, trigger: str = "manual") -> Job:
        path = self._job_path(name, trigger)
        try:
            return self.jobs.submit(name, trigger=trigger, path=path,
                                    fn=self._execute)
        except QueueFull as e:
            self.obs.inc("repro_jobs_rejected_total", dataset=name)
            retry = max(1, int(round(e.retry_after)))
            raise ApiError(429, f"{e} — retry in ~{retry}s",
                           headers={"Retry-After": str(retry)}) from None
        except DatasetQuarantined as e:
            # 503, not 429: the *dataset* is poisoned (circuit breaker
            # open after consecutive failures), the service is healthy —
            # other tenants keep running
            self.obs.inc("repro_jobs_quarantined_total", dataset=name)
            retry = max(1, int(round(e.retry_after)))
            raise ApiError(503, str(e),
                           headers={"Retry-After": str(retry)}) from None

    def _execute(self, job: Job) -> None:
        """Job body (runs on a worker thread): one incremental assessment
        through the shared pipeline config, then report persistence,
        alert evaluation, and counter updates."""
        name = job.dataset
        reg = self.registry
        reg.get(name)       # deleted mid-flight -> fail (permanent), and
        #                     never recreate a tombstoned store dir
        uri = f"urn:repro:dataset:{name}"
        try:
            pipe = self._pipe.incremental(
                reg.store_dir(name),
                segment_bytes=self.config.segment_bytes, dataset_uri=uri)
            res = pipe.run(job.path)
        except Exception:
            self.obs.inc("repro_assessments_total", dataset=name,
                         state="failed")
            raise
        from ..core import report
        ts = _now_iso()
        reg.write_report(
            name,
            report.to_json(res, dataset_uri=uri, computed_on=ts).encode(),
            report.to_ntriples(res, dataset_uri=uri,
                               computed_on=ts).encode())
        s = res.exec_stats
        job.values = {k: float(v) for k, v in sorted(res.values.items())}
        job.n_triples = int(res.n_triples)
        job.passes = int(res.passes)
        job.exec_stats = {
            "mode": s.mode, "attempts": int(s.attempts),
            "passes_per_chunk": int(s.passes_per_chunk),
            "segments_reused": int(s.segments_reused),
            "segments_rescanned": int(s.segments_rescanned),
            "bytes_total": int(s.bytes_total),
            "bytes_rescanned": int(s.bytes_rescanned),
            "wall_seconds": float(s.wall_seconds),
        }
        self._fire_alerts(job, ts)
        self.obs.inc("repro_assessments_total", dataset=name, state="done")
        self.obs.inc("repro_triples_assessed_total", res.n_triples,
                     dataset=name)
        self.obs.inc("repro_bytes_rescanned_total", s.bytes_rescanned,
                     dataset=name)
        self.obs.inc("repro_segments_reused_total", s.segments_reused,
                     dataset=name)
        self.obs.inc("repro_segments_rescanned_total",
                     s.segments_rescanned, dataset=name)

    def _fire_alerts(self, job: Job, ts: str) -> None:
        """Evaluate the dataset's rules against this run's values, with
        the previous history snapshot as the regression baseline (the
        run just appended its own snapshot, so previous = entry[-2];
        an external CLI monitor's snapshot counts — the history is the
        shared ground truth for 'previous')."""
        from ..core import report
        ds = self.registry.get(job.dataset)
        if not ds.rules:
            return
        rules = alerts_mod.parse_rules(ds.rules)
        hist = report.load_history(self.registry.history_path(job.dataset))
        prev = hist[-2]["values"] if len(hist) >= 2 else None
        for rule in rules:
            rec = rule.evaluate(job.values, prev)
            if rec is None:
                continue
            rec.update(dataset=job.dataset, job=job.id, firedAt=ts)
            self.registry.append_alert(job.dataset, rec)
            job.alerts_fired += 1
            self.obs.inc("repro_alerts_fired_total", dataset=job.dataset)
            if ds.webhook:
                if not alerts_mod.post_webhook(
                        ds.webhook, rec,
                        retries=self.config.webhook_retries,
                        backoff=self.config.webhook_backoff,
                        fault=self._faults):
                    # final failure after bounded retries — the alert
                    # record is on disk regardless (alerts.jsonl)
                    self.obs.inc("repro_webhook_failures_total",
                                 dataset=job.dataset)

    # -- read-model helpers ----------------------------------------------------
    def dataset_info(self, name: str) -> dict:
        from ..core import report
        ds = self.registry.get(name)
        info = ds.to_dict()
        jobs = self.jobs.list(name)
        info["jobs"] = {
            "total": len(jobs),
            "by_state": {st: sum(1 for j in jobs if j["state"] == st)
                         for st in ("queued", "running", "done", "failed")},
        }
        info["breaker"] = self.jobs.breaker_state(name)
        info["has_report"] = os.path.exists(
            self.registry.report_path(name, "json"))
        info["snapshots"] = len(report.load_history(
            self.registry.history_path(name)))
        man = self._manifest_payload(name)
        if man:
            info["store"] = {"version": man.get("version"),
                             "n_segments": man.get("n_segments"),
                             "n_bytes": man.get("n_bytes"),
                             "n_triples": man.get("n_triples")}
        return info

    def _manifest_payload(self, name: str) -> dict:
        """Display-only peek at the dataset store's committed manifest
        (no signature check — this is for humans, not for reuse)."""
        try:
            with open(os.path.join(self.registry.store_dir(name),
                                   "manifest.json")) as f:
                return json.load(f).get("payload") or {}
        except (OSError, ValueError):
            return {}

    def health(self) -> dict:
        return {
            "status": "ok",
            "uptime_seconds": time.time() - self._started_at,
            "datasets": len(self.registry.names()),
            "jobs": self.jobs.counts(),
        }


# -- HTTP plumbing -------------------------------------------------------------

class _HTTPServer(http.server.ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    qa: QAServer = None


def _read_body(handler) -> bytes:
    try:
        n = int(handler.headers.get("Content-Length") or 0)
    except ValueError:
        raise ApiError(400, "bad Content-Length") from None
    if n < 0 or n > MAX_UPLOAD_BYTES:
        raise ApiError(413, f"payload too large ({n} bytes)")
    return handler.rfile.read(n) if n else b""


def _json_body(handler) -> dict:
    body = _read_body(handler)
    if not body:
        return {}
    try:
        doc = json.loads(body)
    except ValueError:
        raise ApiError(400, "request body is not valid JSON") from None
    if not isinstance(doc, dict):
        raise ApiError(400, "request body must be a JSON object")
    return doc


def _h_healthz(srv, handler, m, q):
    return 200, _json_bytes(srv.health()), JSON_CT


def _h_metrics(srv, handler, m, q):
    return 200, srv.obs.render().encode(), PROM_CT


def _h_catalog_ranking(srv, handler, m, q):
    """Cross-dataset quality ranking over every registered dataset's
    snapshot history — ``repro_torch.catalog``'s ranking applied to the
    service registry instead of a crawl root.  ``?format=md`` returns
    the markdown dashboard."""
    from ..catalog import rank_histories, ranking_markdown
    from ..core import report
    histories = {}
    for name in srv.registry.names():
        hist = report.load_history(srv.registry.history_path(name))
        if hist:
            histories[name] = hist
    doc = rank_histories(histories)
    fmt = (q.get("format") or [""])[0].lower()
    if fmt in ("md", "markdown"):
        return 200, ranking_markdown(doc).encode(), "text/markdown"
    return 200, _json_bytes(doc), JSON_CT


def _h_datasets(srv, handler, m, q):
    return 200, _json_bytes(
        {"datasets": [srv.registry.get(n).to_dict()
                      for n in srv.registry.names()]}), JSON_CT


def _h_register(srv, handler, m, q):
    doc = _json_body(handler)
    unknown = set(doc) - {"source", "alerts", "webhook"}
    if unknown:
        raise ApiError(400, f"unknown registration keys {sorted(unknown)}")
    rules = doc.get("alerts") or []
    if not isinstance(rules, list):
        raise ApiError(400, "alerts must be a list of rule strings")
    try:
        alerts_mod.parse_rules(rules)       # validate syntax up front
    except ValueError as e:
        raise ApiError(400, str(e)) from None
    ds, created = srv.registry.register(
        m.group(1), source=doc.get("source"), rules=rules,
        webhook=doc.get("webhook"))
    return (201 if created else 200), _json_bytes(ds.to_dict()), JSON_CT


def _h_dataset_info(srv, handler, m, q):
    return 200, _json_bytes(srv.dataset_info(m.group(1))), JSON_CT


def _h_delete(srv, handler, m, q):
    """Dataset lifecycle GC: unregister + reclaim the store.  Refused
    (409) while any job for the dataset is queued, running, or awaiting
    retry — drain first, then DELETE.  The tombstone is journaled before
    removal so a crash mid-delete never replays the dataset's jobs."""
    name = m.group(1)
    srv.registry.get(name)                  # 404 on unknown dataset
    if srv.jobs.has_unfinished(name):
        raise ApiError(409, f"dataset {name!r} has queued or running "
                            "jobs; wait for them to finish and retry",
                       headers={"Retry-After": "2"})
    if srv.journal is not None:
        srv.journal.append("tombstone", dataset=name)
    freed = srv.registry.delete(name)
    srv._watch_sigs.pop(name, None)
    srv.jobs.forget_dataset(name)
    srv.obs.inc("repro_datasets_deleted_total")
    return 200, _json_bytes({"deleted": name,
                             "bytes_reclaimed": freed}), JSON_CT


def _h_upload(srv, handler, m, q):
    name = m.group(1)
    data = _read_body(handler)
    if not data:
        raise ApiError(400, "empty upload: PUT the N-Triples bytes as "
                            "the request body")
    if name not in srv.registry:
        srv.registry.register(name)         # upload implies registration
    srv.registry.save_upload(name, data)
    srv.obs.inc("repro_upload_bytes_total", len(data), dataset=name)
    job = srv.submit_assessment(name, trigger="upload")
    return 202, _json_bytes({"dataset": name, "bytes": len(data),
                             "job": job.to_dict()}), JSON_CT


def _h_assess(srv, handler, m, q):
    job = srv.submit_assessment(m.group(1), trigger="manual")
    return 202, _json_bytes({"job": job.to_dict()}), JSON_CT


def _h_jobs(srv, handler, m, q):
    srv.registry.get(m.group(1))            # 404 on unknown dataset
    return 200, _json_bytes({"jobs": srv.jobs.list(m.group(1))}), JSON_CT


def _h_job(srv, handler, m, q):
    srv.registry.get(m.group(1))
    job = srv.jobs.get(int(m.group(2)))
    if job is None or job["dataset"] != m.group(1):
        raise ApiError(404, f"no job {m.group(2)} for dataset "
                            f"{m.group(1)!r}")
    return 200, _json_bytes(job), JSON_CT


def _h_report(srv, handler, m, q):
    name = m.group(1)
    srv.registry.get(name)
    fmt = (q.get("format") or [""])[0].lower()
    accept = handler.headers.get("Accept", "")
    want_nt = fmt in ("nt", "ntriples", "n-triples") or (
        not fmt and NT_CT in accept)
    if fmt and not want_nt and fmt != "json":
        raise ApiError(400, f"unknown format {fmt!r}: json | nt")
    path = srv.registry.report_path(name, "nt" if want_nt else "json")
    try:
        with open(path, "rb") as f:
            body = f.read()
    except OSError:
        raise ApiError(404, f"no report yet for dataset {name!r}: no "
                            "assessment has completed") from None
    return 200, body, (NT_CT if want_nt else JSON_CT)


def _h_history(srv, handler, m, q):
    from ..core import report
    name = m.group(1)
    srv.registry.get(name)
    trend = report.to_dqv_history(srv.registry.history_path(name),
                                  dataset_uri=f"urn:repro:dataset:{name}")
    return 200, _json_bytes(trend), JSON_CT


def _h_alerts(srv, handler, m, q):
    name = m.group(1)
    srv.registry.get(name)
    return 200, _json_bytes(
        {"alerts": srv.registry.load_alerts(name)}), JSON_CT


_NAME_PAT = r"([^/]+)"
_ROUTES = [
    ("GET", "healthz", re.compile(r"^/healthz$"), _h_healthz),
    ("GET", "metrics", re.compile(r"^/metrics$"), _h_metrics),
    ("GET", "catalog_ranking", re.compile(r"^/catalog/ranking$"),
     _h_catalog_ranking),
    ("GET", "datasets", re.compile(r"^/datasets/?$"), _h_datasets),
    ("PUT", "register", re.compile(rf"^/datasets/{_NAME_PAT}$"),
     _h_register),
    ("GET", "dataset", re.compile(rf"^/datasets/{_NAME_PAT}$"),
     _h_dataset_info),
    ("DELETE", "delete", re.compile(rf"^/datasets/{_NAME_PAT}$"),
     _h_delete),
    ("PUT", "data", re.compile(rf"^/datasets/{_NAME_PAT}/data$"),
     _h_upload),
    ("POST", "assess", re.compile(rf"^/datasets/{_NAME_PAT}/assess$"),
     _h_assess),
    ("GET", "jobs", re.compile(rf"^/datasets/{_NAME_PAT}/jobs/?$"),
     _h_jobs),
    ("GET", "job", re.compile(rf"^/datasets/{_NAME_PAT}/jobs/(\d+)$"),
     _h_job),
    ("GET", "report", re.compile(rf"^/datasets/{_NAME_PAT}/report$"),
     _h_report),
    ("GET", "history", re.compile(rf"^/datasets/{_NAME_PAT}/history$"),
     _h_history),
    ("GET", "alerts", re.compile(rf"^/datasets/{_NAME_PAT}/alerts$"),
     _h_alerts),
]


class _Handler(http.server.BaseHTTPRequestHandler):
    server_version = "repro-qa-serve/1.0"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):      # request logging lives in
        pass                                # /metrics, not on stderr

    def do_GET(self):
        self._route("GET")

    def do_PUT(self):
        self._route("PUT")

    def do_POST(self):
        self._route("POST")

    def do_DELETE(self):
        self._route("DELETE")

    def _route(self, method: str) -> None:
        srv: QAServer = self.server.qa
        t0 = time.perf_counter()
        split = urlsplit(self.path)
        route = "unknown"
        code, body, ctype = 404, _err("not found"), JSON_CT
        headers: dict = {}
        try:
            for m, name, pat, fn in _ROUTES:
                if m != method:
                    continue
                match = pat.match(split.path)
                if match:
                    route = name
                    code, body, ctype = fn(srv, self, match,
                                           parse_qs(split.query))
                    break
            else:
                if any(pat.match(split.path) for _, _, pat, _ in _ROUTES):
                    code, body = 405, _err(f"method {method} not allowed")
        except ApiError as e:
            code, body, ctype = e.status, _err(str(e)), JSON_CT
            headers = e.headers
        except RegistryError as e:
            code, body, ctype = 400, _err(str(e)), JSON_CT
        except UnknownDataset as e:
            code, body, ctype = 404, _err(str(e)), JSON_CT
        except Exception as e:              # noqa: BLE001 — a handler bug
            # must fail the request, not the daemon
            traceback.print_exc(file=sys.stderr)
            code, body, ctype = 500, _err(
                f"internal error: {type(e).__name__}: {e}"), JSON_CT
        self._send(code, body, ctype, headers)
        srv.obs.inc("repro_http_requests_total", method=method,
                    route=route, code=str(code))
        srv.obs.observe("repro_http_request_seconds",
                        time.perf_counter() - t0, route=route)

    def _send(self, code: int, body: bytes, ctype: str,
              headers: Optional[dict] = None) -> None:
        try:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass                            # client went away mid-reply
