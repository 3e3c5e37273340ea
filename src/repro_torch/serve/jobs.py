"""Bounded worker pool with per-dataset serialization and durability.

Two invariants the service needs from its executor:

* **distinct datasets run concurrently** — the pool has ``workers``
  threads, and jobs for different datasets are dispatched independently
  (the paper's multi-dataset workload: many tenants, one service);
* **one dataset never runs two assessments at once** — jobs for the same
  dataset queue FIFO behind each other.  The segment store would survive
  concurrent writers (flock + CAS'd manifest, built for *external*
  monitors racing the daemon), but serializing per tenant keeps each
  upload's job attributable to its payload and avoids burning workers on
  redundant rescans of the same bytes.

Job lifecycle: ``queued → running → done | failed``, with a transient
failure looping ``running → queued`` (a scheduled retry) until
``max_attempts`` is exhausted.

Durability: when the queue is built with a ``JobJournal``, every
transition is written through it — ``enqueue`` *before* ``submit``
returns (so an HTTP 202 means the job survives ``kill -9``), ``start``
per attempt, ``retry`` on transient failure, ``finish`` on a terminal
state.  A restarted daemon replays the journal and re-enqueues every
unfinished job with its original id.

Retry/backoff: errors are classified transient (``TransientJobError``,
``JobTimeout``, ``OSError``/``TimeoutError`` — a file mid-replace, store
lock contention, flaky I/O) or permanent (everything else — a parse
error retries into the same parse error).  Transient failures re-queue
with exponential backoff (``retry_base × 2^(attempt-1)``) scaled by a
deterministic per-job jitter in [0.5, 1.5) so a burst of failures does
not re-arrive as a burst.

Watchdog: with ``job_timeout > 0`` each attempt's body runs on its own
thread and the worker waits at most that long; a hung assessment is
marked failed-by-timeout (transient → retried) and the worker moves on.
The abandoned thread's late result is discarded for job state; its store
side effects are harmless (frozen segments are content-addressed and
bit-identical, so a late freeze is just an adoptable orphan).

Circuit breaker: with ``breaker_threshold = K > 0``, K consecutive
*terminal* failures quarantine the dataset — further submits raise
``DatasetQuarantined`` (the daemon maps it to HTTP 503 + Retry-After,
distinct from 429 backpressure: 429 = the *service* is saturated, 503 =
*this dataset* is poison) until a cool-down passes, after which exactly
one probe job is admitted; success closes the breaker, failure re-opens
it with a doubled cool-down (capped at 32×).

Memory: finished jobs beyond ``max_finished`` are evicted oldest-first
(the journal remains the durable record); all hot-path counters
(``depth``, ``counts``, the 429 waiting check, the Retry-After estimate)
are O(1) running aggregates, not scans over every job ever submitted.

Backpressure: the queue is bounded.  ``max_queued`` caps the number of
not-yet-running jobs; a submit beyond the cap raises ``QueueFull`` whose
``retry_after`` estimates when a slot frees up (observed mean job
duration × queue depth ÷ workers).  The daemon maps it to HTTP 429 with
a ``Retry-After`` header.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import itertools
import queue
import threading
import time
from typing import Callable, Optional

QUEUED, RUNNING, DONE, FAILED = "queued", "running", "done", "failed"
_SENTINEL = object()


class QueueFull(RuntimeError):
    """Submit rejected: ``max_queued`` jobs are already waiting.
    ``retry_after`` (seconds, >= 1) estimates when a slot frees up."""

    def __init__(self, message: str, retry_after: float):
        super().__init__(message)
        self.retry_after = retry_after


class TransientJobError(RuntimeError):
    """A job failure worth retrying (raise from a job body to opt in)."""


class JobTimeout(TransientJobError):
    """The watchdog expired an attempt; the worker was freed."""


class DatasetQuarantined(RuntimeError):
    """Submit rejected: the dataset's circuit breaker is open after
    consecutive failures.  ``retry_after`` is the remaining cool-down."""

    def __init__(self, message: str, retry_after: float):
        super().__init__(message)
        self.retry_after = retry_after


def default_transient(exc: BaseException) -> bool:
    """The default transient-vs-permanent classifier."""
    return isinstance(exc, (TransientJobError, OSError, TimeoutError))


@dataclasses.dataclass
class Job:
    """One assessment request; mutated by the worker that runs it."""
    id: int
    dataset: str
    trigger: str = "manual"          # "upload" | "watch" | "manual"
    path: Optional[str] = None       # dataset bytes assessed by this job
    state: str = QUEUED
    enqueued_at: float = 0.0         # unix seconds
    started_at: Optional[float] = None
    finished_at: Optional[float] = None
    error: Optional[str] = None
    attempts: int = 0                # attempts started (1 on first run)
    max_attempts: int = 1
    next_retry_at: Optional[float] = None   # set while awaiting a retry
    # filled on success by the job body:
    values: Optional[dict] = None
    n_triples: Optional[int] = None
    passes: Optional[int] = None
    exec_stats: Optional[dict] = None
    alerts_fired: int = 0

    def to_dict(self) -> dict:
        return {
            "id": self.id, "dataset": self.dataset, "state": self.state,
            "trigger": self.trigger, "path": self.path,
            "enqueued_at": self.enqueued_at,
            "started_at": self.started_at,
            "finished_at": self.finished_at, "error": self.error,
            "attempts": self.attempts, "max_attempts": self.max_attempts,
            "next_retry_at": self.next_retry_at,
            "values": self.values, "n_triples": self.n_triples,
            "passes": self.passes, "exec_stats": self.exec_stats,
            "alerts_fired": self.alerts_fired,
        }


@dataclasses.dataclass
class _Breaker:
    """Per-dataset circuit-breaker state (guarded by the queue lock)."""
    failures: int = 0        # consecutive terminal failures this cycle
    open_until: float = 0.0  # 0 = never opened
    probing: bool = False    # a cool-down probe job is in flight
    trips: int = 0           # times opened (escalates the cool-down)


class JobQueue:
    """FIFO job queue over a fixed worker pool, serialized per dataset."""

    def __init__(self, workers: int = 2, fn: Callable[[Job], None] = None,
                 max_queued: int = 0, *, journal=None, faults=None,
                 metrics=None, max_attempts: int = 3,
                 retry_base: float = 0.5, retry_cap: float = 60.0,
                 job_timeout: float = 0.0, breaker_threshold: int = 0,
                 breaker_cooldown: float = 30.0, max_finished: int = 512,
                 transient: Callable[[BaseException], bool] =
                 default_transient):
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        if max_queued < 0:
            raise ValueError(f"max_queued must be >= 0, got {max_queued}")
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got "
                             f"{max_attempts}")
        self._fn = fn
        self._workers = workers
        self._max_queued = max_queued      # 0 = unbounded
        self._journal = journal
        self._faults = faults
        self._metrics = metrics
        self._max_attempts = max_attempts
        self._retry_base = retry_base
        self._retry_cap = retry_cap
        self._job_timeout = job_timeout    # 0 = no watchdog
        self._breaker_threshold = breaker_threshold   # 0 = breaker off
        self._breaker_cooldown = breaker_cooldown
        self._max_finished = max_finished  # 0 = retain forever
        self._transient = transient
        self._lock = threading.Lock()
        self._retry_cv = threading.Condition(self._lock)
        self._jobs: dict[int, Job] = {}
        self._order: list[int] = []
        self._finished: collections.deque = collections.deque()  # ids
        self._pending: dict[str, collections.deque] = {}
        self._active: set[str] = set()         # datasets ready or running
        self._breakers: dict[str, _Breaker] = {}
        self._ready: queue.SimpleQueue = queue.SimpleQueue()
        self._retry_heap: list = []            # (due, seq, job)
        self._retry_seq = itertools.count()
        self._ids = itertools.count(1)
        self._n_state = {QUEUED: 0, RUNNING: 0, DONE: 0, FAILED: 0}
        self._dur_sum = 0.0                    # finished-job durations
        self._dur_n = 0
        self._closed = False
        self._threads = [
            threading.Thread(target=self._worker, name=f"qa-worker-{i}",
                             daemon=True)
            for i in range(workers)]
        for t in self._threads:
            t.start()
        self._retry_thread = threading.Thread(
            target=self._retry_loop, name="qa-retry-timer", daemon=True)
        self._retry_thread.start()

    # -- submission ------------------------------------------------------------
    def set_next_id(self, next_id: int) -> None:
        """Start numbering new jobs at ``next_id`` (journal replay: new
        ids must never collide with replayed ones)."""
        self._ids = itertools.count(max(1, next_id))

    def submit(self, dataset: str, *, trigger: str = "manual",
               path: Optional[str] = None,
               fn: Callable[[Job], None] = None,
               _id: Optional[int] = None, _journal: bool = True) -> Job:
        """Enqueue one assessment of ``dataset``; returns the live Job.
        ``fn`` overrides the queue-level job body (must be provided in
        one place or the other).  Raises ``QueueFull`` when ``max_queued``
        jobs are already waiting and ``DatasetQuarantined`` while the
        dataset's circuit breaker is open.  ``_id``/``_journal`` are the
        journal-replay internals: re-enqueue under the original id,
        optionally skipping the (already-compacted) enqueue record."""
        body = fn or self._fn
        if body is None:
            raise ValueError("no job body: pass fn= here or to JobQueue()")
        with self._lock:
            if self._closed:
                raise RuntimeError("job queue is shut down")
            self._breaker_check_locked(dataset)
            if self._max_queued:
                waiting = self._n_state[QUEUED]
                if waiting >= self._max_queued:
                    raise QueueFull(
                        f"job queue full: {waiting} jobs waiting "
                        f"(max_queued={self._max_queued})",
                        self._retry_after_locked(waiting))
            job = Job(id=_id if _id is not None else next(self._ids),
                      dataset=dataset, trigger=trigger, path=path,
                      enqueued_at=time.time(),
                      max_attempts=self._max_attempts)
            job._fn = body
            self._jobs[job.id] = job
            self._order.append(job.id)
            self._n_state[QUEUED] += 1
            if self._journal is not None and _journal:
                try:
                    self._journal.append("enqueue", job=job.id,
                                         dataset=dataset, trigger=trigger,
                                         path=path)
                except OSError:
                    # the accept must not outlive its durable record
                    del self._jobs[job.id]
                    self._order.remove(job.id)
                    self._n_state[QUEUED] -= 1
                    raise
            self._pending.setdefault(dataset, collections.deque()
                                     ).append(job)
            self._dispatch_locked(dataset)
        return job

    def _retry_after_locked(self, waiting: int) -> float:
        """Seconds until a queue slot plausibly frees: observed mean job
        duration × (waiting depth ÷ workers), floored at 1s.  With no
        finished jobs yet there is no duration signal — 1s tells the
        client 'soon' without inventing precision."""
        if not self._dur_n:
            return 1.0
        mean = self._dur_sum / self._dur_n
        return max(1.0, mean * max(1.0, waiting / self._workers))

    def _dispatch_locked(self, dataset: str) -> None:
        """Move the dataset's next pending job to the ready queue iff no
        job for that dataset is running (per-dataset serialization)."""
        pend = self._pending.get(dataset)
        if dataset not in self._active and pend:
            job = pend.popleft()
            self._active.add(dataset)
            self._ready.put(job)

    # -- circuit breaker -------------------------------------------------------
    def _breaker_check_locked(self, dataset: str) -> None:
        if not self._breaker_threshold:
            return
        b = self._breakers.get(dataset)
        if b is None or not b.open_until:
            return
        now = time.time()
        if b.open_until > now:
            raise DatasetQuarantined(
                f"dataset {dataset!r} is quarantined after consecutive "
                f"failures; cool-down ends in {b.open_until - now:.1f}s",
                b.open_until - now)
        if b.probing:
            raise DatasetQuarantined(
                f"dataset {dataset!r} is quarantined; a cool-down probe "
                "is already in flight", max(1.0, self._breaker_cooldown / 4))
        b.probing = True            # this submit is the probe

    def _breaker_record_locked(self, dataset: str, ok: bool) -> None:
        """Fold one *terminal* job outcome into the breaker."""
        if not self._breaker_threshold:
            return
        if ok:
            self._breakers.pop(dataset, None)        # closed, clean slate
            return
        b = self._breakers.setdefault(dataset, _Breaker())
        b.failures += 1
        if b.probing or b.failures >= self._breaker_threshold:
            cool = self._breaker_cooldown * (2 ** min(b.trips, 5))
            b.open_until = time.time() + cool
            b.trips += 1
            b.failures = 0
            b.probing = False
            if self._metrics is not None:
                self._metrics.inc("repro_breaker_open_total",
                                  dataset=dataset)

    def breaker_state(self, dataset: str) -> dict:
        """Display-only breaker snapshot for ``GET /datasets/<name>``."""
        with self._lock:
            b = self._breakers.get(dataset)
            if not self._breaker_threshold or b is None:
                return {"state": "closed", "consecutive_failures":
                        b.failures if b else 0}
            now = time.time()
            if b.open_until > now:
                state = "open"
            elif b.open_until:
                state = "half-open"
            else:
                state = "closed"
            return {"state": state,
                    "consecutive_failures": b.failures,
                    "open_until": b.open_until or None,
                    "trips": b.trips}

    # -- worker loop -----------------------------------------------------------
    def _worker(self) -> None:
        while True:
            job = self._ready.get()
            if job is _SENTINEL:
                return
            self._run_job(job)

    def _run_job(self, job: Job) -> None:
        with self._lock:
            job.state = RUNNING
            job.started_at = time.time()
            job.attempts += 1
            job.next_retry_at = None
            self._n_state[QUEUED] -= 1
            self._n_state[RUNNING] += 1
        self._journal_ev("start", job=job.id, attempt=job.attempts)
        outcome: dict = {}
        done_ev = threading.Event()

        def body():
            try:
                if self._faults is not None:
                    self._faults.on_job_start(job)
                job._fn(job)
                err = None
            except BaseException as e:       # noqa: BLE001 — job isolation
                err = e
            with self._lock:
                if outcome.get("decided"):   # watchdog already expired us;
                    return                   # late result is discarded
                outcome["decided"] = True
                outcome["error"] = err
            done_ev.set()

        if self._job_timeout:
            t = threading.Thread(target=body, daemon=True,
                                 name=f"qa-job-{job.id}")
            t.start()
            if not done_ev.wait(self._job_timeout):
                with self._lock:
                    if not outcome.get("decided"):
                        outcome["decided"] = True
                        outcome["error"] = JobTimeout(
                            f"job {job.id} exceeded the "
                            f"{self._job_timeout:.1f}s watchdog timeout "
                            "(attempt abandoned, worker freed)")
                        if self._metrics is not None:
                            self._metrics.inc("repro_job_timeouts_total",
                                              dataset=job.dataset)
        else:
            body()
        self._settle(job, outcome["error"])

    def _settle(self, job: Job, err: Optional[BaseException]) -> None:
        """Fold one attempt's outcome into job state: done, retry-later,
        or terminally failed — then free the dataset slot."""
        now = time.time()
        retry_delay = None
        try:
            with self._lock:
                self._n_state[RUNNING] -= 1
                if err is None:
                    job.state = DONE
                    job.finished_at = now
                    self._finish_locked(job)
                    self._breaker_record_locked(job.dataset, ok=True)
                elif (self._transient(err)
                        and job.attempts < job.max_attempts):
                    retry_delay = self._retry_delay(job)
                    job.state = QUEUED
                    job.error = (f"{type(err).__name__}: {err} "
                                 f"(transient; retry "
                                 f"{job.attempts + 1}/{job.max_attempts} "
                                 f"in {retry_delay:.2f}s)")
                    job.next_retry_at = now + retry_delay
                    self._n_state[QUEUED] += 1
                    heapq.heappush(self._retry_heap,
                                   (job.next_retry_at,
                                    next(self._retry_seq), job))
                    self._retry_cv.notify_all()
                    if self._metrics is not None:
                        self._metrics.inc("repro_job_retries_total",
                                          dataset=job.dataset)
                else:
                    job.state = FAILED
                    job.finished_at = now
                    job.error = f"{type(err).__name__}: {err}"
                    self._finish_locked(job)
                    self._breaker_record_locked(job.dataset, ok=False)
        finally:
            if retry_delay is not None:
                self._journal_ev("retry", job=job.id, attempt=job.attempts,
                                 error=job.error,
                                 next_at=job.next_retry_at)
            else:
                self._journal_ev("finish", job=job.id, state=job.state,
                                 error=job.error)
            with self._lock:
                self._active.discard(job.dataset)
                self._dispatch_locked(job.dataset)

    def _finish_locked(self, job: Job) -> None:
        """Terminal-state bookkeeping: counters, duration aggregate, and
        the finished-job retention cap (evict oldest beyond
        ``max_finished`` — the journal keeps the durable record)."""
        self._n_state[job.state] += 1
        if job.started_at is not None and job.finished_at is not None:
            self._dur_sum += job.finished_at - job.started_at
            self._dur_n += 1
        self._finished.append(job.id)
        if self._max_finished:
            while len(self._finished) > self._max_finished:
                old_id = self._finished.popleft()
                old = self._jobs.pop(old_id, None)
                if old is not None:
                    self._n_state[old.state] -= 1
                    try:
                        self._order.remove(old_id)
                    except ValueError:
                        pass
                    if self._metrics is not None:
                        self._metrics.inc("repro_jobs_evicted_total")

    def _retry_delay(self, job: Job) -> float:
        """Exponential backoff with deterministic per-job jitter: base ×
        2^(attempt-1), scaled by a hash of the job id into [0.5, 1.5)."""
        base = self._retry_base * (2 ** (job.attempts - 1))
        jitter = 0.5 + ((job.id * 2654435761) & 1023) / 1024.0
        return min(self._retry_cap, base * jitter)

    def _retry_loop(self) -> None:
        """Single timer thread: sleep until the earliest scheduled retry
        is due, then put the job back at the *front* of its dataset's
        pending deque (it is the oldest accepted work for that tenant)."""
        with self._retry_cv:
            while True:
                if self._closed:
                    return
                if not self._retry_heap:
                    self._retry_cv.wait(timeout=1.0)
                    continue
                due = self._retry_heap[0][0]
                now = time.time()
                if due > now:
                    self._retry_cv.wait(timeout=min(due - now, 1.0))
                    continue
                _, _, job = heapq.heappop(self._retry_heap)
                job.next_retry_at = None
                self._pending.setdefault(job.dataset, collections.deque()
                                         ).appendleft(job)
                self._dispatch_locked(job.dataset)

    def _journal_ev(self, ev: str, **fields) -> None:
        if self._journal is None:
            return
        try:
            self._journal.append(ev, **fields)
        except OSError:
            pass        # lifecycle events are best-effort; only the
            #             enqueue record gates acceptance

    # -- introspection ---------------------------------------------------------
    def get(self, job_id: int) -> Optional[dict]:
        with self._lock:
            job = self._jobs.get(job_id)
            return job.to_dict() if job else None

    def list(self, dataset: Optional[str] = None) -> list[dict]:
        """Retained job snapshots in submission order (oldest first);
        finished jobs beyond ``max_finished`` have been evicted (the
        journal holds their durable record)."""
        with self._lock:
            return [self._jobs[i].to_dict() for i in self._order
                    if dataset is None or self._jobs[i].dataset == dataset]

    def depth(self) -> int:
        """Jobs not yet finished (queued + running)."""
        with self._lock:
            return self._n_state[QUEUED] + self._n_state[RUNNING]

    def counts(self) -> dict:
        """Retained jobs by state (O(1): running aggregates, no scan)."""
        with self._lock:
            return dict(self._n_state)

    def has_unfinished(self, dataset: str) -> bool:
        """Any queued/running/awaiting-retry job for ``dataset``?  Gates
        DELETE: a dataset with work in flight cannot be reclaimed."""
        with self._lock:
            return (dataset in self._active
                    or bool(self._pending.get(dataset))
                    or any(j.dataset == dataset
                           for _, _, j in self._retry_heap))

    def forget_dataset(self, dataset: str) -> None:
        """Drop a deleted dataset's breaker state and retained finished
        jobs, so a re-created dataset of the same name starts clean."""
        with self._lock:
            self._breakers.pop(dataset, None)
            self._pending.pop(dataset, None)
            for jid in [i for i in self._order
                        if self._jobs[i].dataset == dataset
                        and self._jobs[i].state in (DONE, FAILED)]:
                self._n_state[self._jobs[jid].state] -= 1
                del self._jobs[jid]
                self._order.remove(jid)
                try:
                    self._finished.remove(jid)
                except ValueError:
                    pass

    # -- shutdown --------------------------------------------------------------
    def shutdown(self, wait: bool = True, timeout: float = 30.0) -> None:
        """Stop accepting jobs and stop the workers.  Running jobs finish;
        still-queued and awaiting-retry jobs stay ``queued`` — their
        journal records survive, so a restarted daemon replays them."""
        with self._lock:
            self._closed = True
            self._retry_cv.notify_all()
        for _ in self._threads:
            self._ready.put(_SENTINEL)
        if wait:
            deadline = time.time() + timeout
            for t in self._threads:
                t.join(max(0.0, deadline - time.time()))
            self._retry_thread.join(max(0.0, deadline - time.time()))
