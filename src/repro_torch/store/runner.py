"""The incremental planner: diff segments against the store, rescan only
segments whose *content* changed, merge frozen partial states for the rest.

Why results are *bit-identical* to a cold run (registers included)
------------------------------------------------------------------
Every plane a metric or sketch reads is **content-determined**: counter
predicates read flag / length / datatype planes or compare term ids for
equality (invariant to id *numbering*), and since plane layout v2 the HLL
sketches hash the content-hash planes — a 32-bit hash of each term's
``Term.key()`` bytes computed at ingest — instead of the id planes.  A
frozen segment state (counter vectors + register banks) is therefore a
pure function of the segment's bytes plus the engine signature, and is
valid whenever its fingerprint still matches, *regardless of how upstream
edits renumbered the id space*.  The rescan set is exactly the segments
with no verified frozen state: new or changed content, corrupt files.
Appends rescan only the tail segment(s), deletes and mutations only the
segments framing the edit, and a duplicate segment is reused from one
state file (counts merge per occurrence, registers idempotently).

The runner rebuilds the canonical ("cold") dictionary — without
re-reading unchanged bytes — by replaying each reused segment's persisted
**dictionary footprint** through ``TermDictionary.intern_keys_batch`` in
segment order, so rescanned segments encode with the cold run's ids.  The
replay is **lazy**: reused footprints are queued and interned just before
the next rescan encodes, so a fully warm run replays nothing and reused
segments after the last rescanned one are never replayed
(``exec_stats.footprints_replayed`` counts the ones that were).  Plans
that read raw id planes (user-registered metrics) keep the eager
replay-and-compare gate.

Rescans run through ``repro_torch.dist.ChunkScheduler`` and so through
``QualityEvaluator.dispatch_chunk``: every rescanned segment launches the
configured backend's kernels on the card (one ``fused_scan`` for a plan
with sketches, one ``qap_count`` for one without, ``qap_count`` plus one
``hll_fold`` per sketch under ``twopass``), with retries and optional
``prefetch`` pipelining; the ``on_chunk`` hook freezes each newly
evaluated segment's state into the store as it merges.

Mesh scale-out: segments are *independent* (each frozen state is a pure
function of its own bytes), so when the evaluator carries a mesh the
rescan set is embarrassingly parallel. Every rank walks the same
segments; rescanned ones are evaluated in batches of one segment a rank
through ``QualityEvaluator.eval_segment_batch`` (per-segment results come
back unreduced, so each state is frozen exactly as in the sequential
path). The batched executor replaces the chunk scheduler for those
rescans, so ``prefetch``/``speculate`` do not apply under a mesh. Rank 0
alone writes the store (states, manifest, history); a barrier after each
batch lets every rank read the store as rank 0 left it, and barriers
before and after the commit keep any rank from reading a half-written
store.

What this port leaves out of the JAX package's runner
-----------------------------------------------------
* Segments are not padded to power-of-two row buckets.  The JAX runner
  pads so that XLA sees O(log n) distinct shapes instead of recompiling
  per segment.  Here the scan kernel is compiled once per plan, not per
  row count, and it takes a ragged tail (``csrc/scan_spec.cuh`` stages the
  rows past the last full tile word by word), so padding would only add a
  host copy of up to twice each segment.  Zero rows are invisible to
  counters and sketches, so padded and unpadded segments give the same
  state either way.

The store's on-disk format (``store.py``) and the engine signature are
the JAX package's, byte for byte: a store written by either package is
reused by the other with no segment rescanned.
"""
from __future__ import annotations

import hashlib
import time
import warnings
from typing import Iterable, Sequence

import numpy as np
import torch

from ..core import report
from ..core.evaluator import AssessmentResult, QualityEvaluator
from ..dist import ChunkScheduler, ChunkStats
from ..rdf import TermDictionary
from ..rdf import ingest as rdf_ingest
from ..rdf.triple_tensor import (COL_O, COL_P, COL_S,
                                 PLANE_LAYOUT_VERSION)
from .segmenter import fingerprint
from .store import FORMAT_VERSION, SegmentState, SegmentStore


def engine_signature(evaluator: QualityEvaluator,
                     base_namespaces: Sequence[str] = ()) -> dict:
    """What a frozen segment state depends on: the JAX package's signature,
    key for key.  The backend, the device and the package are deliberately
    absent: every backend of either package gives the same counters and
    registers, so a store written by one is reusable by any other.  The
    plane-layout version IS present: frozen registers hash specific plane
    columns, so a store written under another layout must self-heal via
    the wholesale-discard path rather than be misread.
    """
    plans = [(tuple(m.name for m in p.metrics), p.n_counters, p.program,
              p.sketch_specs) for p in evaluator.plans]
    return {
        "format": FORMAT_VERSION,
        "plane_layout": PLANE_LAYOUT_VERSION,
        "metrics": [m.name for m in evaluator.metrics],
        "fused": bool(evaluator.fused),
        "hll_p": int(evaluator.hll_p),
        "base_namespaces": list(base_namespaces),
        "plans": hashlib.blake2b(repr(plans).encode(),
                                 digest_size=8).hexdigest(),
    }


_ID_PLANES = frozenset((COL_S, COL_P, COL_O))


def _expr_renumbering_invariant(e) -> bool:
    """True iff a counter expression's value is invariant under any
    injective renumbering of term ids.  Flag/length/datatype/hash planes
    are content-determined; id planes are numbering-dependent EXCEPT when
    two of them are compared for equality (same term ⇔ same id under any
    numbering)."""
    from ..core import expr as E
    if isinstance(e, (E.And, E.Or)):
        return (_expr_renumbering_invariant(e.a)
                and _expr_renumbering_invariant(e.b))
    if isinstance(e, E.Not):
        return _expr_renumbering_invariant(e.a)
    if isinstance(e, E.EqPlanes):
        return (e.plane_a in _ID_PLANES) == (e.plane_b in _ID_PLANES)
    return e.plane not in _ID_PLANES


def plans_renumbering_invariant(evaluator: QualityEvaluator) -> bool:
    """Whether every plan's counters AND sketches read only content-
    determined planes.  True for all built-ins since plane layout v2
    (sketches hash COL_*_HASH); user-registered metrics may still sketch
    or compare raw id planes, in which case frozen states are only valid
    under the exact cold id assignment and the incremental planner must
    keep the replayed-id equality gate."""
    for pln in evaluator.plans:
        for _, cols in pln.sketch_specs:
            if any(c in _ID_PLANES for c in cols):
                return False
        for e in pln.exprs:
            if not _expr_renumbering_invariant(e):
                return False
    return True


def _footprint_ids(planes: np.ndarray) -> np.ndarray:
    """Distinct term ids of a segment in first-appearance order over the
    flattened (s0, p0, o0, s1, ...) sequence — the exact order a fresh
    per-term intern loop would meet them."""
    if planes.shape[0] == 0:
        return np.zeros(0, np.int64)
    flat = planes[:, :3].reshape(-1)
    present, first = np.unique(flat, return_index=True)
    order = np.argsort(first, kind="stable")
    return present[order].astype(np.int64)


def assess_incremental(evaluator: QualityEvaluator,
                       segments: Iterable[bytes], store_dir: str, *,
                       base_namespaces: Sequence[str] = (),
                       prefetch: int = 0,
                       speculate: bool = False,
                       max_history: int = 0,
                       dataset_uri: str = "urn:repro:dataset",
                       ) -> AssessmentResult:
    """Assess ``segments`` (ordered raw byte segments of one dataset)
    against the segment store at ``store_dir``.

    Returns an ``AssessmentResult`` bit-identical to a cold assessment of
    the concatenated bytes; ``result.exec_stats`` carries
    ``segments_reused`` / ``segments_rescanned`` / ``bytes_rescanned`` /
    ``footprints_replayed``.  On success the store's manifest is committed
    for the new dataset version and a quality snapshot is appended to
    ``history.jsonl``.

    The evaluator's device is touched before the store is read, so a run
    on a card that is not there fails whether or not the store is warm.
    """
    t0 = time.perf_counter()
    ev = evaluator
    try:
        torch.empty(0, device=ev.device)
    except (RuntimeError, AssertionError) as e:
        # the service and the crawler record this text per job / dataset
        raise RuntimeError(f"device {ev.device} is not available: "
                           f"{e}") from e
    store = SegmentStore(store_dir,
                         engine_signature(ev, base_namespaces))
    d = TermDictionary(base_namespaces)
    # Built-in metrics are content-determined since plane layout v2, so
    # unchanged bytes ⇒ reusable.  A user-registered metric may still
    # sketch or threshold raw id planes — for those plans frozen state is
    # only valid under the cold id assignment, and the replayed-id
    # equality gate stays on (exactness over reuse).
    content_determined = plans_renumbering_invariant(ev)

    order: list[dict] = []        # segment descriptors, dataset order
    reused: list[SegmentState] = []
    rescan_meta: dict[int, dict] = {}   # cid -> frozen-state ingredients
    nbytes = {"total": 0, "rescanned": 0}
    replayed = [0]                # footprints actually interned
    deferred: list[SegmentState] = []   # reused, replay not yet needed

    def replay_deferred():
        """Intern the footprints of every reused segment queued so far —
        called just before a rescan encodes, so the rescanned segment's
        terms land at their cold ids."""
        for st in deferred:
            d.intern_keys_batch(st.keys, st.flags, st.lengths,
                                st.datatypes)
        replayed[0] += len(deferred)
        deferred.clear()

    def produce():
        """Sequential segment walk: replay-or-rescan.  Runs on the
        scheduler's producer thread when pipelined; all side effects are
        read only after the scheduler joins it, and each rescan's
        ``rescan_meta`` entry is written before its segment is yielded, so
        ``on_chunk`` (consumer thread) always finds it."""
        cid = 0
        for seg in segments:
            fp = fingerprint(seg)
            nbytes["total"] += len(seg)
            st = store.load_state(fp)
            if st is not None:
                if content_determined:
                    deferred.append(st)
                    reused.append(st)
                    order.append({"fp": fp, "n_bytes": len(seg),
                                  "n_triples": st.n_triples})
                    continue
                # id-plane-reading user metric: the replay stays eager and
                # gates reuse
                ids = d.intern_keys_batch(st.keys, st.flags, st.lengths,
                                          st.datatypes)
                replayed[0] += 1
                if np.array_equal(ids, st.ids):
                    reused.append(st)
                    order.append({"fp": fp, "n_bytes": len(seg),
                                  "n_triples": st.n_triples})
                    continue
                # shifted id environment: rescan below (the replay already
                # positioned this segment's terms at their cold ids)
            replay_deferred()
            nbytes["rescanned"] += len(seg)
            tt = rdf_ingest.parse_encode(seg, dictionary=d)
            ids = _footprint_ids(tt.planes)
            flags, lengths, dts, _hashes = d.plane_arrays()
            order.append({"fp": fp, "n_bytes": len(seg),
                          "n_triples": len(tt)})
            rescan_meta[cid] = {
                "fp": fp, "n_bytes": len(seg), "n_triples": len(tt),
                "keys": d.keys_for(ids), "flags": flags[ids],
                "lengths": lengths[ids].astype(np.int64),
                "datatypes": dts[ids], "ids": ids,
            }
            cid += 1
            yield tt

    # one merged state over ALL segments — the same commutative monoid the
    # chunk executor uses.  Rescanned chunks merge in as they land
    # (on_chunk), so no per-segment result is held beyond its freeze.
    state = ev.chunk_state_init()
    rescanned = [0]

    def on_chunk(cid: int, counts, regs) -> None:
        m = rescan_meta.pop(cid)
        if ev.is_writer():
            store.put_state(SegmentState(
                fingerprint=m["fp"], n_bytes=m["n_bytes"],
                n_triples=m["n_triples"],
                counts=[np.asarray(c, np.int64) for c in counts],
                regs={k: np.asarray(v, np.int32) for k, v in regs.items()},
                keys=m["keys"], flags=m["flags"], lengths=m["lengths"],
                datatypes=m["datatypes"], ids=m["ids"]))
        ev.merge_chunk(state, ("rescanned", cid), counts, regs)
        rescanned[0] += 1

    if ev.mesh is not None:
        if prefetch or speculate:
            warnings.warn(
                "prefetch/speculate are ignored for mesh rescans: the "
                "batched segment executor replaces the chunk scheduler",
                RuntimeWarning, stacklevel=2)
        stats = ChunkStats(chunks_total=0, mode="incremental+mesh",
                           passes_per_chunk=ev.passes_per_chunk,
                           devices=ev._shard_count())
        batch: list = []            # [(cid, tensor)]

        def flush() -> None:
            if not batch:
                return
            t_eval = time.perf_counter()
            outs = ev.eval_segment_batch([tt for _, tt in batch])
            stats.chunk_eval_seconds.append(time.perf_counter() - t_eval)
            stats.attempts += len(batch)
            for (cid, _), (counts, regs) in zip(batch, outs):
                on_chunk(cid, counts, regs)
            batch.clear()
            # rank 0 has frozen the batch: every rank walks on over the
            # store as it now stands, so a later duplicate of one of these
            # segments is reused on every rank alike
            ev.barrier()

        for cid, tt in enumerate(produce()):
            batch.append((cid, tt))
            if len(batch) >= ev._shard_count():
                flush()
        flush()
    else:
        sched = ChunkScheduler(ev, prefetch=prefetch, speculate=speculate,
                               on_chunk=on_chunk)
        _, stats = sched.run(produce())
        stats.mode = "incremental" + ("+pipelined" if prefetch else "")

    for i, st in enumerate(reused):
        ev.merge_chunk(state, ("reused", i), st.counts, st.regs)
    n_total = sum(s["n_triples"] for s in order)
    result = ev.finalize_state(state, n_total)
    # only rescanned segments actually streamed bytes through the kernels
    result.passes = rescanned[0] * ev.passes_per_chunk

    stats.chunks_total = len(order)
    stats.segments_reused = len(reused)
    stats.segments_rescanned = rescanned[0]
    stats.bytes_total = nbytes["total"]
    stats.bytes_rescanned = nbytes["rescanned"]
    stats.footprints_replayed = replayed[0]
    stats.wall_seconds = time.perf_counter() - t0
    result.exec_stats = stats

    ev.barrier()        # every rank is done reading the store
    if ev.is_writer():
        store.commit(order)
        store.append_history(report.history_entry(
            result, dataset_uri=dataset_uri), max_history=max_history)
    ev.barrier()        # no rank reads a half-written store after this
    return result
