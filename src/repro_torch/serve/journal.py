"""Write-ahead job journal: accepted work survives ``kill -9``.

One append-only ``jobs.jsonl`` per service store root.  The job queue
writes through it — a submission is journaled (flushed + fsync'd)
*before* the HTTP 202 goes out, so "accepted" means "durable".  Records
are one JSON object per line::

    {"ev": "enqueue",   "job": 7, "dataset": "ds", "trigger": "upload",
     "path": "...", "ts": ...}
    {"ev": "start",     "job": 7, "attempt": 1, "ts": ...}
    {"ev": "retry",     "job": 7, "attempt": 1, "error": "...",
     "next_at": ..., "ts": ...}
    {"ev": "finish",    "job": 7, "state": "done"|"failed",
     "error": null|"...", "ts": ...}
    {"ev": "tombstone", "dataset": "ds", "ts": ...}   # DELETE /datasets/<n>

``replay`` folds the journal into the set of jobs that were accepted but
never reached a terminal state (last event ``enqueue``/``start``/
``retry``): a restarted daemon re-enqueues exactly those, with their
original ids.  A ``tombstone`` voids every unfinished job of its dataset
up to that point.  Reading is torn-tail tolerant like ``history.jsonl``:
a crash mid-append leaves at most one undecodable final line, which is
skipped — every fully-written record before it still counts.

On startup the daemon *compacts* the journal: after replay it atomically
rewrites the file with only the re-enqueued jobs' records (temp file +
``os.replace``, so a crash during compaction leaves the old journal
intact).  Finished jobs' histories are dropped — the journal stays
bounded across restarts while remaining the durable record for jobs the
in-memory retention cap has evicted.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional


class JobJournal:
    """Append-only, fsync-per-record job event log."""

    def __init__(self, path: str, faults=None):
        self.path = os.fspath(path)
        self._faults = faults
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {}   # ev -> appends (fault keys)
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        try:
            size = os.path.getsize(self.path)
        except OSError:
            size = 0
        self._f = open(self.path, "a", encoding="utf-8")
        if size:
            # heal a torn tail left by a crash mid-append: a missing
            # final newline would otherwise concatenate (and corrupt)
            # the next record appended to it
            with open(self.path, "rb") as rf:
                rf.seek(size - 1)
                if rf.read(1) != b"\n":
                    self._f.write("\n")
                    self._f.flush()
                    os.fsync(self._f.fileno())

    # -- writing ---------------------------------------------------------------
    def append(self, ev: str, **fields) -> dict:
        """Durably append one record (write + flush + fsync).  The fault
        injector's crash points fire around the write: ``before`` means
        the record was never durable (the caller's 202 never went out),
        ``after`` means it was (the job replays even though the client
        may not have seen the response — at-least-once)."""
        rec = {"ev": ev, "ts": time.time(), **fields}
        line = json.dumps(rec, sort_keys=True) + "\n"
        with self._lock:
            n = self._counts[ev] = self._counts.get(ev, 0) + 1
            if self._faults is not None:
                self._faults.on_journal(ev, n, "before")
            self._f.write(line)
            self._f.flush()
            os.fsync(self._f.fileno())
            if self._faults is not None:
                self._faults.on_journal(ev, n, "after")
        return rec

    def reset(self, records) -> None:
        """Atomically replace the journal's contents (startup compaction).
        ``records`` are complete record dicts, written tmp + ``os.replace``
        — the rename is the commit point, so a crash mid-compaction
        leaves the previous journal governing."""
        with self._lock:
            tmp = f"{self.path}.{os.getpid()}.tmp"
            try:
                with open(tmp, "w", encoding="utf-8") as f:
                    for rec in records:
                        f.write(json.dumps(rec, sort_keys=True) + "\n")
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, self.path)
            finally:
                if os.path.exists(tmp):
                    try:
                        os.remove(tmp)
                    except OSError:
                        pass
            try:
                self._f.close()
            except (OSError, ValueError):
                pass
            self._counts = {}
            self._f = open(self.path, "a", encoding="utf-8")

    def close(self) -> None:
        with self._lock:
            try:
                self._f.flush()
                os.fsync(self._f.fileno())
            except (OSError, ValueError):
                pass
            try:
                self._f.close()
            except (OSError, ValueError):
                pass

    # -- reading ---------------------------------------------------------------
    @staticmethod
    def load(path: str) -> list[dict]:
        """All decodable records in append order; torn/garbage lines (the
        tail of a crashed append) are skipped, not fatal."""
        out = []
        try:
            with open(path, encoding="utf-8", errors="replace") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if isinstance(rec, dict) and "ev" in rec:
                        out.append(rec)
        except OSError:
            pass
        return out

    @staticmethod
    def replay(path: str) -> tuple[list[dict], int]:
        """``(unfinished, max_id)``: jobs accepted but not finished, in id
        order — each ``{"id", "dataset", "trigger", "path"}`` — plus the
        highest job id ever journaled (the restarted queue numbers new
        jobs past it so ids never collide with replayed ones)."""
        jobs: dict[int, dict] = {}
        max_id = 0
        for rec in JobJournal.load(path):
            ev = rec.get("ev")
            if ev == "tombstone":
                ds = rec.get("dataset")
                jobs = {i: r for i, r in jobs.items()
                        if r["dataset"] != ds}
                continue
            jid = rec.get("job")
            if not isinstance(jid, int):
                continue
            max_id = max(max_id, jid)
            if ev == "enqueue":
                jobs[jid] = {"id": jid,
                             "dataset": rec.get("dataset"),
                             "trigger": rec.get("trigger") or "manual",
                             "path": rec.get("path")}
            elif ev == "finish":
                jobs.pop(jid, None)
            # "start"/"retry": still unfinished — nothing to update
        return [jobs[i] for i in sorted(jobs)], max_id

    @staticmethod
    def enqueue_record(job_id: int, dataset: str, trigger: str,
                       path: Optional[str], *, requeued: bool = False,
                       ) -> dict:
        rec = {"ev": "enqueue", "ts": time.time(), "job": job_id,
               "dataset": dataset, "trigger": trigger, "path": path}
        if requeued:
            rec["requeued"] = True
        return rec
