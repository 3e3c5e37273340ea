"""Deterministic fault injection for the service layer.

``ServiceFaultInjector`` is the serve-plane sibling of
``repro_torch.dist.FaultInjector`` (which injects chunk-level worker faults
into the scheduler): it breaks the *daemon* in controlled, reproducible
ways so the durability machinery can be tested end to end —

* **journal crash points**: ``crash_before_journal`` / ``crash_after_journal``
  hold keys ``"<ev>#<n>"`` (the n-th append of that event type, 1-based);
  hitting one hard-kills the process via ``os._exit`` — no cleanup, no
  flush, the closest in-process stand-in for ``kill -9``.  "Before"
  crashes lose the record (the client never got its 202 — correctly
  never accepted); "after" crashes keep it (the job replays on restart
  even if the response was never delivered: at-least-once).
* **transient job failures**: ``fail_jobs`` maps dataset → number of
  attempts that raise ``TransientJobError`` before one succeeds (tests
  retry/backoff and the attempt counters).
* **permanent job failures**: datasets in ``permanent_fail`` always fail
  with a non-retryable error (tests ``max_attempts`` exhaustion and the
  circuit breaker).  The set is mutable — tests clear it to model a
  poison payload being fixed, letting the breaker's cool-down probe
  succeed.
* **slow jobs**: ``slow_jobs`` maps dataset → extra seconds per attempt
  (tests the per-job watchdog timeout, and holds workers busy so crash
  tests can kill the daemon genuinely mid-queue).
* **failing webhooks**: the first ``fail_webhooks`` webhook POST attempts
  raise (−1 = all of them) — tests the bounded webhook retry and the
  final-failure counter.

Hooks are called from the job queue (``on_job_start``), the journal
(``on_journal``), and ``alerts.post_webhook`` (``on_webhook``); a daemon
constructed with ``QAServer(cfg, faults=...)`` threads one injector
through all three.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import threading
import time
from typing import Collection, Mapping

from .jobs import TransientJobError


@dataclasses.dataclass
class ServiceFaultInjector:
    crash_before_journal: Collection[str] = ()
    crash_after_journal: Collection[str] = ()
    fail_jobs: Mapping[str, int] = dataclasses.field(default_factory=dict)
    permanent_fail: Collection[str] = ()
    slow_jobs: Mapping[str, float] = dataclasses.field(default_factory=dict)
    fail_webhooks: int = 0              # -1 = every attempt fails
    crash_exit_code: int = 17

    def __post_init__(self):
        self._lock = threading.Lock()
        self._fails_left = dict(self.fail_jobs)
        self._webhook_fails_left = int(self.fail_webhooks)
        self._before = frozenset(self.crash_before_journal)
        self._after = frozenset(self.crash_after_journal)
        self.permanent_fail = set(self.permanent_fail)

    # -- journal crash points --------------------------------------------------
    def on_journal(self, ev: str, n: int, phase: str) -> None:
        """Called by ``JobJournal.append`` around the durable write;
        ``phase`` is ``"before"`` or ``"after"``."""
        key = f"{ev}#{n}"
        keys = self._before if phase == "before" else self._after
        if key in keys:
            self._crash(f"{phase} journal append {key}")

    def _crash(self, where: str) -> None:
        print(f"# ServiceFaultInjector: crashing {where} "
              f"(exit {self.crash_exit_code})", file=sys.stderr, flush=True)
        os._exit(self.crash_exit_code)

    # -- job-body faults -------------------------------------------------------
    def on_job_start(self, job) -> None:
        """Called on the job's worker thread before the job body."""
        delay = self.slow_jobs.get(job.dataset, 0.0)
        if delay:
            time.sleep(delay)
        if job.dataset in self.permanent_fail:
            raise RuntimeError(
                f"injected permanent failure for dataset {job.dataset!r}")
        with self._lock:
            left = self._fails_left.get(job.dataset, 0)
            if left > 0:
                self._fails_left[job.dataset] = left - 1
                raise TransientJobError(
                    f"injected transient failure on {job.dataset!r} "
                    f"({left - 1} more to come)")

    # -- webhook faults --------------------------------------------------------
    def on_webhook(self, url: str) -> None:
        with self._lock:
            if self._webhook_fails_left != 0:
                if self._webhook_fails_left > 0:
                    self._webhook_fails_left -= 1
                raise OSError(f"injected webhook failure to {url}")
