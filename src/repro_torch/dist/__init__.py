"""repro_torch.dist — the execution subsystem beneath ``repro_torch.qa``.

The paper's Spark deployment gets three things for free from the RDD
runtime: over-decomposition into tasks, speculative/retried execution of
failed tasks, and lineage-based recovery. This package supplies the same
properties for the torch engine:

* ``ChunkScheduler`` — over-decomposes the main dataset into chunks, runs
  ``QualityEvaluator.eval_chunk`` per chunk with bounded retries, merges
  idempotently (duplicate deliveries are ignored), and checkpoints the
  merged state so a crashed coordinator resumes without re-scanning
  completed chunks.  With ``prefetch > 0`` the scan is PIPELINED: a
  producer thread ingests chunk ``i+1`` and starts its copy to the card
  (pinned buffers, a side stream: ``evaluator.PinnedStager``) while the
  card computes chunk ``i`` (CUDA launches are asynchronous), and the
  only per-chunk host synchronization is one deferred materialization —
  merge order, retry accounting, and checkpoint/resume state are
  bit-for-bit identical to the sequential loop.
* ``FaultInjector`` / ``WorkerFailure`` — deterministic failure injection
  (flaky workers, stragglers, coordinator crashes) for tests and drills.

Under a mesh (an evaluator built with ``mesh=``) every rank runs the same
scheduler over the same dataset: each chunk's rows shard over the ranks,
the evaluator reduces each chunk's counters and registers over the mesh,
and every rank merges the same reduced state. Rank 0 alone writes
checkpoints; every rank reads them on resume, after a barrier. The loop
must make the same decisions on every rank, or the ranks' collectives
stop matching and the run hangs: retries and injected faults are
deterministic per chunk id, but speculation decides from each process's
own timings, so ``speculate=True`` with a mesh raises ``ValueError``.

Only ``WorkerFailure`` is retried. A CUDA error in a kernel surfaces as
torch's ``RuntimeError`` when the chunk's results are copied to the host;
it is not a worker failure, so it propagates and fails the run.

Checkpoints are written through ``CheckpointManager.save_async``'s writer
thread, so periodic checkpoints never stall the scan loop; ``run`` joins
the writer before returning, so a completed run's state is durable. The
checkpoint format and its compatibility metadata are the JAX package's
(``repro.dist``), so either package resumes a run the other began.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import queue as queue_mod
import threading
import time
import warnings
from typing import Callable, Iterable, Mapping, Optional

import numpy as np
import torch

from ..checkpoint import CheckpointManager


class WorkerFailure(RuntimeError):
    """A worker task or coordinator failed (injected or real)."""


def _fingerprint(planes) -> str:
    """Cheap content digest of a plane tensor: shape + up to 64 evenly
    sampled rows. Distinguishes same-size datasets on resume without
    hashing the full data (the JAX package's digest, bit for bit)."""
    h = hashlib.blake2s(repr(planes.shape).encode())
    step = max(1, planes.shape[0] // 64)
    h.update(np.ascontiguousarray(planes[::step]).tobytes())
    return h.hexdigest()[:16]


def _device_scope(evaluator) -> Callable:
    """A context factory that makes ``evaluator``'s card the current device
    of a worker thread (a new thread starts on device 0). The device index
    is resolved here, on the calling thread."""
    dev = getattr(evaluator, "device", None)
    if dev is None or dev.type != "cuda":
        return contextlib.nullcontext
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return functools.partial(torch.cuda.device, index)


@dataclasses.dataclass
class FaultInjector:
    """Deterministic fault injection for the chunk scheduler.

    ``fail_chunks``: chunk id → number of attempts that fail before one
    succeeds (a flaky worker). ``slow_chunks``: chunk id → extra seconds
    (a straggler; every attempt pays it — a slow *partition*).
    ``slow_chunks_once``: chunk id → extra seconds on the FIRST attempt
    only (a slow *worker*: the speculative backup copy runs at full
    speed).  ``crash_after_merges``: coordinator dies once this many
    chunks have been merged (tests checkpoint/resume).
    """
    fail_chunks: Mapping[int, int] = dataclasses.field(default_factory=dict)
    slow_chunks: Mapping[int, float] = dataclasses.field(default_factory=dict)
    slow_chunks_once: Mapping[int, float] = dataclasses.field(
        default_factory=dict)
    crash_after_merges: Optional[int] = None

    def __post_init__(self):
        self._fails_left = dict(self.fail_chunks)
        self._slow_once_left = dict(self.slow_chunks_once)

    def on_eval(self, chunk_id: int) -> None:
        delay = self.slow_chunks.get(chunk_id, 0.0)
        delay += self._slow_once_left.pop(chunk_id, 0.0)
        if delay:
            time.sleep(delay)
        left = self._fails_left.get(chunk_id, 0)
        if left > 0:
            self._fails_left[chunk_id] = left - 1
            raise WorkerFailure(
                f"injected worker failure on chunk {chunk_id} "
                f"({left - 1} more to come)")

    def on_merge(self, merges_done: int) -> None:
        if (self.crash_after_merges is not None
                and merges_done >= self.crash_after_merges):
            raise WorkerFailure(
                f"injected coordinator crash after {merges_done} merges")


@dataclasses.dataclass
class ChunkStats:
    chunks_total: int
    attempts: int = 0            # eval attempts in THIS run (incl. retries)
    retries: int = 0
    devices: int = 1             # mesh row shards per chunk (1 = no mesh)
    resumed_from: Optional[int] = None  # merge count at the restored ckpt
    checkpoints_written: int = 0
    mode: str = "sync"           # "sync" | "pipelined"
    passes_per_chunk: int = 0    # actual data passes per chunk eval
    wall_seconds: float = 0.0    # end-to-end run() wall time
    # per merged chunk, host-observed seconds: full eval (sync mode) or
    # time blocked in the deferred materialization (pipelined mode — the
    # overlap headroom is exactly what's NOT in here)
    chunk_eval_seconds: list = dataclasses.field(default_factory=list)
    # chunk ids whose eval time exceeded straggler_factor × the running
    # median of chunk_eval_seconds (see ChunkScheduler.straggler_factor)
    stragglers: list = dataclasses.field(default_factory=list)
    # speculative re-execution (ChunkScheduler(speculate=True)): chunks
    # whose primary eval outlived the live straggler threshold and got a
    # backup copy dispatched; wins counts backups that finished first
    speculated: list = dataclasses.field(default_factory=list)
    speculation_wins: int = 0
    # incremental (segment-store) runs: reuse accounting, see
    # repro_torch.store
    segments_reused: int = 0
    segments_rescanned: int = 0
    bytes_total: int = 0
    bytes_rescanned: int = 0
    # dictionary footprints actually replayed (lazy replay: reused
    # segments after the last rescanned one never replay, and a fully
    # warm run replays none)
    footprints_replayed: int = 0


class _ProducerError:
    """Exception raised on the prefetch thread, relayed to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


_END_OF_STREAM = object()


class ChunkScheduler:
    """Fault-tolerant chunked execution of a quality assessment.

    Built on the evaluator's mergeable-chunk interface
    (``dispatch_chunk``/``materialize_chunk``/``merge_chunk``/
    ``finalize_state``): chunk results are commutative monoid elements
    (counter sums + HLL register max), so any arrival order, duplicate
    delivery, or restart yields bit-identical results to a single-shot
    pass.

    ``prefetch > 0`` enables the pipelined executor: up to ``prefetch``
    ingested chunks, their copies to the card under way, are buffered
    ahead of the device while the previous chunk's materialization is
    deferred until the next chunk has been dispatched (``prefetch=1`` is
    classic double buffering).
    """

    def __init__(self, evaluator, n_chunks: int = 16, *,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 8, max_attempts: int = 4,
                 prefetch: int = 0, straggler_factor: float = 4.0,
                 speculate: bool = False,
                 on_chunk: Optional[Callable] = None):
        self.evaluator = evaluator
        self.n_chunks = n_chunks
        self.checkpoint_every = checkpoint_every
        self.max_attempts = max_attempts
        self.prefetch = prefetch
        # flag chunks slower than straggler_factor × the running median of
        # per-chunk eval seconds (0/None disables detection)
        self.straggler_factor = straggler_factor
        # speculative re-execution: when a chunk's eval outlives the SAME
        # straggler threshold, dispatch a backup copy of the whole eval
        # and take whichever finishes first — merge is idempotent (HLL
        # max / counter add keyed by chunk id), so a late loser landing
        # twice is provably harmless, exactly the Spark speculative-task
        # story.  Applies to the sequential loop (the pipelined executor
        # already overlaps the next chunk's ingest against a straggler).
        self.speculate = speculate
        if speculate and evaluator.mesh is not None:
            raise ValueError(
                "speculate=True cannot run under a mesh: each rank would "
                "decide from its own timings whether to dispatch a backup "
                "copy, and ranks that decide differently issue "
                "mismatched collectives and hang; drop .speculative() or "
                ".shard()")
        if speculate and prefetch:
            warnings.warn(
                "speculate=True applies to the sequential chunk loop; the "
                "pipelined executor (prefetch>0) ignores it — drop one of "
                "the two flags", RuntimeWarning, stacklevel=2)
        # called as on_chunk(cid, counts, regs) exactly once per NEWLY
        # merged chunk (duplicate deliveries and resumed chunks are not
        # re-reported)
        self.on_chunk = on_chunk
        self._mgr = (CheckpointManager(checkpoint_dir, keep=2)
                     if checkpoint_dir else None)
        self._dataset_sig: Optional[tuple] = None  # set per run()
        self._chunk_sizes: dict[int, int] = {}   # cid -> n_valid when merged
        self._last_saved = 0                     # merge count at last save

    # -- checkpoint plumbing ---------------------------------------------------
    def _compat_meta(self) -> dict:
        from ..rdf.triple_tensor import PLANE_LAYOUT_VERSION
        ev = self.evaluator
        return {"n_chunks": self.n_chunks,
                "metrics": [m.name for m in ev.metrics],
                "n_plans": len(ev.plans),
                "hll_p": ev.hll_p,
                # register banks hash specific plane columns: a checkpoint
                # written under another plane layout must refuse to resume
                "plane_layout": PLANE_LAYOUT_VERSION,
                # dataset identity (size + content digest; None for
                # unsized streams) — a checkpoint from a different
                # dataset must not resume
                "dataset": (list(self._dataset_sig)
                            if self._dataset_sig else None)}

    def _restore(self, state: dict) -> tuple[dict, Optional[int]]:
        if self._mgr is None:
            return state, None
        # under a mesh, rank 0 may still be finishing the last run's
        # checkpoint: every rank reads once all ranks are here
        self.evaluator.barrier()
        step = self._mgr.latest_step()
        if step is None:
            return state, None
        meta = self._mgr.manifest(step)["metadata"]
        want = self._compat_meta()
        mismatched = {k: (meta.get(k), v) for k, v in want.items()
                      if meta.get(k) != v}
        if mismatched:
            # chunk ids from an incompatible run denote different data
            # slices — resuming would silently corrupt the result
            raise ValueError(
                f"checkpoint at step {step} is incompatible with this "
                f"scheduler (saved vs current): {mismatched}; use a fresh "
                f"checkpoint_dir or matching n_chunks/metrics")
        template = {"counts": state["counts"], "sketches": state["sketches"]}
        restored = self._mgr.restore(step, template)
        done = meta["chunks_done"]
        self._chunk_sizes = dict(zip(done, meta.get("chunk_sizes", [])))
        return ({"counts": restored["counts"],
                 "sketches": restored["sketches"],
                 "chunks_done": set(done)}, step)

    def _save(self, merges: int, state: dict) -> None:
        # async writer thread: the scan loop never blocks on disk (merges
        # REPLACE state arrays rather than mutating them, so the snapshot
        # the writer holds stays consistent). Under a mesh every rank holds
        # the same state, and rank 0 writes it.
        if not self.evaluator.is_writer():
            return
        done = sorted(state["chunks_done"])
        self._mgr.save_async(
            merges,
            {"counts": state["counts"], "sketches": state["sketches"]},
            metadata={"chunks_done": done,
                      "chunk_sizes": [self._chunk_sizes.get(c) for c in done],
                      **self._compat_meta()})

    # -- execution -------------------------------------------------------------
    def run(self, dataset, *, faults: Optional[FaultInjector] = None):
        """Assess ``dataset`` chunk by chunk; returns (result, ChunkStats).

        ``dataset``: a ``TripleTensor`` (split into ``n_chunks`` here) or an
        already-chunked sequence of ``TripleTensor``s (streaming ingest).
        """
        t0 = time.perf_counter()
        ev = self.evaluator
        if hasattr(dataset, "chunks"):
            chunks: Iterable = dataset.chunks(self.n_chunks)
            chunks_total = self.n_chunks
            self._dataset_sig = (len(dataset), _fingerprint(dataset.planes))
        else:
            chunks = dataset  # streaming: consumed lazily, one chunk resident
            chunks_total = 0  # counted as the stream drains
            self._dataset_sig = None

        state = ev.chunk_state_init()
        state, resumed = self._restore(state)
        stats = ChunkStats(chunks_total=chunks_total, resumed_from=resumed,
                           mode="pipelined" if self.prefetch else "sync",
                           passes_per_chunk=ev.passes_per_chunk,
                           devices=ev._shard_count())

        self._last_saved = len(state["chunks_done"])
        loop = self._run_pipelined if self.prefetch else self._run_sync
        try:
            n_triples = loop(chunks, state, stats, faults)
        finally:
            if self._mgr is not None:
                # join the async writer even when the coordinator crashes:
                # the last submitted snapshot must land for resume to work
                self._mgr.wait()

        merges = len(state["chunks_done"])
        if self._mgr is not None and merges > self._last_saved:
            # final checkpoint: a completed run always persists its state,
            # even when n_chunks never aligned with checkpoint_every
            self._save(merges, state)
            stats.checkpoints_written += 1
            self._mgr.wait()  # durable before run() returns

        if stats.stragglers:
            warnings.warn(
                f"straggler chunks {stats.stragglers}: eval exceeded "
                f"{self.straggler_factor}x the running median of "
                f"{len(stats.chunk_eval_seconds)} chunk eval times",
                RuntimeWarning, stacklevel=2)
        stats.wall_seconds = time.perf_counter() - t0
        return ev.finalize_state(state, n_triples), stats

    # -- shared loop pieces ----------------------------------------------------
    def _skip_done(self, state: dict, cid: int, n: int) -> bool:
        """True if ``cid`` was merged before a restart — but only if it is
        the SAME chunk; a differently-split stream must not resume."""
        if cid not in state["chunks_done"]:
            return False
        expected = self._chunk_sizes.get(cid)
        if expected is not None and expected != n:
            raise ValueError(
                f"chunk {cid} has {n} triples but the checkpoint recorded "
                f"{expected}; the dataset is chunked differently — use a "
                f"fresh checkpoint_dir")
        return True

    def _attempt(self, fn, cid: int, stats: ChunkStats,
                 faults: Optional[FaultInjector],
                 budget: Optional[int] = None):
        """Run ``fn`` with bounded retries and fault injection.  ``budget``
        caps the tries (default ``max_attempts``) so callers that already
        burned failures can keep the per-chunk total identical."""
        budget = self.max_attempts if budget is None else budget
        for attempt in range(budget):
            try:
                stats.attempts += 1
                if faults is not None:
                    faults.on_eval(cid)
                return fn()
            except WorkerFailure:
                stats.retries += 1
                if attempt == budget - 1:
                    raise

    # ignore sub-this "stragglers": with micro-chunks the median is so
    # small that scheduler jitter trips the ratio test constantly
    STRAGGLER_MIN_SECONDS = 0.05

    def _note_eval_time(self, cid: int, secs: float,
                        stats: ChunkStats) -> None:
        """Record one chunk's host-observed eval seconds and flag it as a
        straggler when it exceeds ``straggler_factor ×`` the running median
        (needs ≥ 3 samples so early chunks can't define the baseline)."""
        stats.chunk_eval_seconds.append(secs)
        if not self.straggler_factor or secs < self.STRAGGLER_MIN_SECONDS:
            return
        times = stats.chunk_eval_seconds
        if len(times) < 3:
            return
        med = float(np.median(times))
        if (med > 0.0 and secs > self.straggler_factor * med
                and cid not in stats.stragglers):   # may be live-flagged
            stats.stragglers.append(cid)

    def _speculation_threshold(self, stats: ChunkStats) -> Optional[float]:
        """Live straggler cutoff for speculative re-execution: the same
        formula the post-hoc detector uses (factor × running median, ≥ 3
        samples, 50 ms floor), applied as a timeout *while* a chunk runs.
        None disables speculation for this chunk (no baseline yet)."""
        times = stats.chunk_eval_seconds
        if (not self.speculate or not self.straggler_factor
                or len(times) < 3):
            return None
        med = float(np.median(times))
        return max(self.straggler_factor * med, self.STRAGGLER_MIN_SECONDS)

    def _eval_speculative(self, eval_once: Callable, cid: int,
                          stats: ChunkStats, faults,
                          threshold: float):
        """Race the primary eval against a backup copy dispatched once the
        primary outlives ``threshold``.  First completion wins; the loser
        is abandoned (its eventual merge attempt would be ignored anyway —
        the merge is idempotent per chunk id).  ``eval_once`` must be
        bound to its chunk (no late-binding closures: the abandoned copy
        may still be running after the loop advances).  Each copy counts
        attempts/retries on a private ChunkStats; only the *decided*
        copy's counts fold into the shared stats, so an abandoned loser
        never mutates caller-visible state after run() returns.  Both
        copies run on the evaluator's card."""
        results: queue_mod.Queue = queue_mod.Queue()
        on_card = _device_scope(self.evaluator)

        def runner(kind: str) -> None:
            local = ChunkStats(chunks_total=0)
            try:
                with on_card():
                    out = self._attempt(eval_once, cid, local, faults)
                results.put((kind, local, True, out))
            except BaseException as e:
                results.put((kind, local, False, e))

        threading.Thread(target=runner, args=("primary",), daemon=True,
                         name=f"chunk-{cid}-primary").start()
        try:
            kind, local, ok, payload = results.get(timeout=threshold)
        except queue_mod.Empty:
            # primary is a straggler: flag it live and dispatch the backup
            stats.stragglers.append(cid)
            stats.speculated.append(cid)
            threading.Thread(target=runner, args=("backup",), daemon=True,
                             name=f"chunk-{cid}-backup").start()
            kind, local, ok, payload = results.get()
            if not ok:
                # one copy failed — the race is still on for the other
                stats.attempts += local.attempts
                stats.retries += local.retries
                kind, local, ok, payload = results.get()
            if ok and kind == "backup":
                stats.speculation_wins += 1
        stats.attempts += local.attempts
        stats.retries += local.retries
        if not ok:
            raise payload
        return payload

    def _merge_and_checkpoint(self, state: dict, cid: int, counts, regs,
                              stats: ChunkStats,
                              faults: Optional[FaultInjector]) -> None:
        fresh = cid not in state["chunks_done"]
        self.evaluator.merge_chunk(state, cid, counts, regs)
        if fresh and self.on_chunk is not None:
            self.on_chunk(cid, counts, regs)
        merges = len(state["chunks_done"])
        if (self._mgr is not None and self.checkpoint_every
                and merges % self.checkpoint_every == 0):
            self._save(merges, state)
            stats.checkpoints_written += 1
            self._last_saved = merges
        if faults is not None:
            faults.on_merge(merges)

    def _run_sync(self, chunks, state, stats, faults) -> int:
        """The sequential loop: ingest → transfer → compute → sync, one
        chunk at a time."""
        ev = self.evaluator
        n_triples = 0
        for cid, chunk in enumerate(chunks):
            stats.chunks_total = max(stats.chunks_total, cid + 1)
            n_triples += len(chunk)
            if self._skip_done(state, cid, len(chunk)):
                continue
            self._chunk_sizes[cid] = len(chunk)
            t0 = time.perf_counter()
            eval_once = functools.partial(ev.eval_chunk, chunk)
            threshold = self._speculation_threshold(stats)
            if threshold is None:
                counts, regs = self._attempt(eval_once, cid, stats, faults)
            else:
                counts, regs = self._eval_speculative(
                    eval_once, cid, stats, faults, threshold)
            self._note_eval_time(cid, time.perf_counter() - t0, stats)
            self._merge_and_checkpoint(state, cid, counts, regs, stats,
                                       faults)
        return n_triples

    def _run_pipelined(self, chunks, state, stats, faults) -> int:
        """Double-buffered async executor.

        A producer thread drains the chunk source (host ingest — NumPy,
        which releases the GIL) and starts each chunk's copy to the card
        (``evaluator.plane_stager``: on a CUDA device a pinned buffer and a
        non-blocking copy on a side stream, with an event the consumer's
        stream waits on); the consumer dispatches compute on chunk *i*
        (async, non-blocking) and only THEN materializes chunk *i-1*'s
        results — so ingest/transfer of the next chunk, device compute of
        this chunk, and host merge of the previous one all overlap.  Merge
        order, retries, and checkpoint cadence are identical to
        ``_run_sync``.
        """
        ev = self.evaluator
        q: queue_mod.Queue = queue_mod.Queue(maxsize=max(1, self.prefetch))
        stop = threading.Event()
        done_at_start = frozenset(state["chunks_done"])
        on_card = _device_scope(ev)
        stage = ev.plane_stager(self.prefetch + 1)

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue_mod.Full:
                    continue
            return False

        def produce():
            try:
                with on_card():
                    for cid, chunk in enumerate(chunks):
                        arr = None if cid in done_at_start else stage(chunk)
                        if not _put((cid, len(chunk), arr)):
                            return
                _put(_END_OF_STREAM)
            except BaseException as e:  # relay ingest failures
                _put(_ProducerError(e))

        producer = threading.Thread(target=produce, daemon=True,
                                    name="chunk-prefetch")
        producer.start()
        n_triples = 0
        pending = None  # (cid, dispatched-but-unmaterialized outputs)
        try:
            while True:
                item = q.get()
                if isinstance(item, _ProducerError):
                    raise item.exc
                if item is _END_OF_STREAM:
                    break
                cid, n, arr = item
                stats.chunks_total = max(stats.chunks_total, cid + 1)
                n_triples += n
                if self._skip_done(state, cid, n):
                    continue
                self._chunk_sizes[cid] = n
                before = stats.attempts
                outs = self._attempt(
                    lambda: ev.dispatch_chunk(arr), cid, stats, faults)
                if pending is not None:
                    self._finish_pending(pending, state, stats, faults)
                # carry the attempts this chunk has already consumed, so a
                # later materialize failure draws from the SAME budget
                pending = (cid, outs, arr, stats.attempts - before)
            if pending is not None:
                self._finish_pending(pending, state, stats, faults)
        finally:
            stop.set()
            while True:  # unblock a producer stuck on a full queue
                try:
                    q.get_nowait()
                except queue_mod.Empty:
                    break
            producer.join(timeout=10.0)
        return n_triples

    def _finish_pending(self, pending, state, stats, faults) -> None:
        # CUDA launches are async, so a compute failure surfaces HERE (at
        # host sync), not at dispatch — retry by re-dispatching from the
        # still-device-resident planes, matching _run_sync's coverage where
        # the whole eval (dispatch + sync) sits inside the retry loop. Only
        # a WorkerFailure is retried: a CUDA error is torch's RuntimeError
        # and propagates.
        ev = self.evaluator
        cid, outs, arr, used = pending
        t0 = time.perf_counter()
        try:
            counts, regs = ev.materialize_chunk(outs)
        except WorkerFailure:
            # the dispatch that produced ``outs`` was attempt number
            # ``used``; its materialization failing fails THAT attempt, so
            # the recovery budget is what's left of max_attempts — a chunk
            # aborts after the same total failures as in _run_sync no
            # matter where in dispatch/materialize they strike
            stats.retries += 1
            if self.max_attempts - used <= 0:
                raise
            counts, regs = self._attempt(
                lambda: ev.materialize_chunk(ev.dispatch_chunk(arr)),
                cid, stats, faults, budget=self.max_attempts - used)
        self._note_eval_time(cid, time.perf_counter() - t0, stats)
        self._merge_and_checkpoint(state, cid, counts, regs, stats, faults)


__all__ = ["ChunkScheduler", "ChunkStats", "FaultInjector", "WorkerFailure"]
