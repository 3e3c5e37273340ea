"""QAP evaluator (paper §2.2 step 4 + Algorithm 1), single device.

Execution modes:

* ``fused=True`` (beyond-paper): ONE plan over the main dataset evaluates
  every requested metric — the planner's deduped bytecode.
* ``fused=False`` (paper-faithful Algorithm 1): ``foreach m ∈ metrics`` run a
  separate pass.
* ``backend='torch' | 'twopass' | 'fused_scan'``: the plain torch
  versions (the bytecode interpreter, plus one scatter-max scan per sketch
  — ``1 + S`` data passes), the two-kernel path (``kernels/qap_count`` for
  the counters plus one ``kernels/hll`` fold per sketch — also ``1 + S``
  passes; the JAX package's ``pallas``), or the one-pass kernels
  (``kernels/fused_scan``: counters AND every sketch register bank in one
  pass; a plan without sketches goes to ``kernels/qap_count`` — exactly 1
  data pass either way).
* ``device``: where the planes live and the passes run (default
  ``"cuda"``). On a CPU device the kernel wrappers run their plain
  versions; on a CUDA device they launch the kernels or raise.

``AssessmentResult.passes`` reports ACTUAL data passes: each op wrapper
that streams the planes once records a scan (``kernels.record_scan``),
before it dispatches on the device, and ``passes_per_chunk`` runs every
plan's pass function once on an 8-row zero tensor under that counter.

The mergeable chunk state (``chunk_state_init``/``merge_chunk``) holds
numpy arrays only — per-plan int64 counter vectors, int32 register banks
and ``chunks_done`` — in the same shape as the JAX evaluator's, so chunks
evaluated by either package merge here (``state_from_numpy``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Mapping, Sequence

import numpy as np
import torch

from ..kernels import count_scans, record_scan
from ..rdf.triple_tensor import TripleTensor, N_PLANES
from . import sketches as hll
from .expr import eval_program_torch
from .metrics import ALL_METRICS, get_metrics
from .planner import Plan, plan, plan_single

BACKENDS = ("torch", "twopass", "fused_scan")


@dataclasses.dataclass
class AssessmentResult:
    values: dict[str, float]            # metric name -> value
    counts: dict[str, dict[str, int]]   # metric -> counter -> raw count
    sketch_estimates: dict[str, float]
    n_triples: int
    passes: int                         # ACTUAL data passes performed
    exec_stats: object = None           # always None on the single-shot path
    # merged HLL register banks (sketch name -> int32 array); exposed so
    # exactness can be asserted at the register level, not just on the
    # derived estimates
    registers: dict = dataclasses.field(default_factory=dict)

    def __getitem__(self, k: str) -> float:
        return self.values[k]


class QualityEvaluator:
    def __init__(self, metric_names: Sequence[str] = ALL_METRICS, *,
                 fused: bool = True, backend: str = "fused_scan",
                 hll_p: int = hll.DEFAULT_P, device="cuda"):
        if backend not in BACKENDS:
            raise ValueError(
                f"backend must be one of {BACKENDS}, got {backend!r}")
        self.metrics = get_metrics(metric_names)
        self.fused = fused
        self.backend = backend
        self.hll_p = hll_p
        self.device = torch.device(device)
        self.plans: list[Plan] = (
            [plan(self.metrics)] if fused
            else [plan_single(m) for m in self.metrics])
        self._scans_compiled = False

    # -- single-pass core (one plan) ------------------------------------------
    def _local_pass_fn(self, pln: Plan):
        """The pass planes -> (counts, sketches) for one plan, as tensors
        on the planes' device.

        Each branch declares its data passes via ``record_scan`` (op
        wrappers do it for the kernel path), so running this function
        under ``kernels.count_scans`` measures passes per execution — the
        hook behind ``passes_per_chunk``.
        """
        program, n_counters = pln.program, pln.n_counters
        sketch_specs = pln.sketch_specs
        backend, hll_p = self.backend, self.hll_p

        def local_pass(planes):
            if backend == "fused_scan":
                from ..kernels.fused_scan import ops as fops
                return fops.fused_scan(planes, program, n_counters,
                                       sketch_specs, hll_p)
            if backend == "twopass":
                from ..kernels.hll import ops as hops
                from ..kernels.qap_count import ops as qops
                counts = qops.fused_count(planes, program, n_counters)
                return counts, {sname: hops.hll_fold(planes, cols, hll_p)
                                for sname, cols in sketch_specs}
            from ..kernels.hll.ref import hll_fold_torch
            record_scan(1)  # the counts scan
            counts = eval_program_torch(planes, program, n_counters)
            regs = {}
            for sname, cols in sketch_specs:
                record_scan(1)  # one more scan per sketch
                regs[sname] = hll_fold_torch(planes, cols, hll_p)
            return counts, regs

        return local_pass

    @functools.cached_property
    def _pass_fns(self):
        return [self._local_pass_fn(p) for p in self.plans]

    @functools.cached_property
    def passes_per_chunk(self) -> int:
        """ACTUAL data passes one chunk evaluation performs, measured by
        running every plan's pass function once under the scan counter —
        1 per plan for the fused_scan kernels, ``1 + S`` for the torch
        and twopass paths with S sketches.

        The probe runs on an 8-row zero tensor on the CPU: every wrapper
        records its scan before it dispatches on the device, so the count
        is the one a CUDA run records, and the probe launches nothing on
        the card.
        """
        zeros = torch.zeros((8, N_PLANES), dtype=torch.int32)
        with count_scans() as box:
            for pln in self.plans:
                self._local_pass_fn(pln)(zeros)
        return box[0]

    def device_planes(self, tensor: TripleTensor) -> torch.Tensor:
        """The planes on the evaluator's device, as they are: the kernels
        mask the ragged tail themselves, and zero rows the tensor already
        carries are invisible to counters and sketches alike."""
        return torch.from_numpy(np.ascontiguousarray(tensor.planes)).to(
            self.device)

    def plane_stager(self, slots: int):
        """The function the pipelined executor's producer thread puts each
        chunk through: ``device_planes`` on a CPU device; on a CUDA device
        ``PinnedStager.put`` over ``slots`` pinned buffers, so the copy of
        the next chunk overlaps the scan of this one."""
        if self.device.type == "cuda":
            return PinnedStager(self.device, slots).put
        return self.device_planes

    # -- mergeable chunk interface ---------------------------------------------
    def _all_sketch_specs(self) -> tuple:
        specs: dict[str, tuple[int, ...]] = {}
        for pln in self.plans:
            for s, cols in pln.sketch_specs:
                if specs.get(s, cols) != cols:
                    raise ValueError(
                        f"sketch {s!r} defined with conflicting columns "
                        f"{specs[s]} vs {cols}")
                specs[s] = cols
        return tuple(specs.items())

    def chunk_state_init(self) -> dict:
        """Empty mergeable state: one counter vector per plan + sketches."""
        return {
            "counts": [np.zeros((pln.n_counters,), np.int64)
                       for pln in self.plans],
            "sketches": {s: np.zeros((1 << self.hll_p,), np.int32)
                         for s, _ in self._all_sketch_specs()},
            "chunks_done": set(),
        }

    def dispatch_chunk(self, arr):
        """Launch every plan's pass over device-resident ``arr`` (a tensor,
        or ``StagedPlanes`` still being copied) WITHOUT blocking (CUDA
        launches are asynchronous) — the device-side half of
        ``eval_chunk``. Pair with ``materialize_chunk``."""
        if isinstance(arr, StagedPlanes):
            arr = arr.consume()
        if arr.device.type == "cuda" and not self._scans_compiled:
            self._compile_scans()
        return [fn(arr) for fn in self._pass_fns]

    def _compile_scans(self) -> None:
        """Compile every plan's scan kernel at once, in parallel, before
        the first launch on a card (per-metric mode has one plan a
        metric); the launches then find them in the process's cache."""
        if self.backend in ("fused_scan", "twopass"):
            from ..kernels import _build
            _build.compile_scans(
                _build.scan_source(
                    pln.program, pln.n_counters,
                    pln.sketch_specs if self.backend == "fused_scan"
                    else (), self.hll_p)
                for pln in self.plans)
        self._scans_compiled = True

    @staticmethod
    def materialize_chunk(outs):
        """Wait for the dispatched passes and gather host numpy results —
        the single per-chunk host synchronization point."""
        counts_out, regs_out = [], {}
        for counts, regs in outs:
            counts_out.append(counts.cpu().numpy())
            regs_out.update({k: v.cpu().numpy() for k, v in regs.items()})
        return counts_out, regs_out

    def eval_chunk(self, chunk: TripleTensor):
        arr = self.device_planes(chunk)
        return self.materialize_chunk(self.dispatch_chunk(arr))

    @staticmethod
    def merge_chunk(state: dict, chunk_id: int, counts, regs) -> dict:
        """Idempotent merge — re-delivered chunks are ignored."""
        if chunk_id in state["chunks_done"]:
            return state
        state["counts"] = [a + b for a, b in zip(state["counts"], counts)]
        for k, v in regs.items():
            state["sketches"][k] = np.maximum(state["sketches"][k], v)
        state["chunks_done"].add(chunk_id)
        return state

    def finalize_state(self, state: dict, n_triples: int) -> AssessmentResult:
        # estimates from the merged host registers, on the CPU: the same
        # registers give the same float32 sum whatever device scanned them
        est = {"sketch:" + k: float(hll.hll_estimate(torch.from_numpy(
                   np.ascontiguousarray(v))))
               for k, v in state["sketches"].items()}
        values: dict[str, float] = {}
        counts_out: dict[str, dict[str, int]] = {}
        for pln, counts in zip(self.plans, state["counts"]):
            values.update(pln.finalize(counts, est))
            for m in pln.metrics:
                counts_out[m.name] = {
                    c: int(counts[pln.slots[m.name][c]])
                    for c, _ in m.counters}
        return AssessmentResult(values=values, counts=counts_out,
                                sketch_estimates=est, n_triples=n_triples,
                                passes=len(state["chunks_done"])
                                * self.passes_per_chunk,
                                registers={k: np.asarray(v) for k, v
                                           in state["sketches"].items()})


@dataclasses.dataclass
class StagedPlanes:
    """Planes on their way to the card: the device tensor, and the event
    recorded on the copy stream after the copy into it."""
    planes: torch.Tensor
    ready: "torch.cuda.Event"

    def consume(self) -> torch.Tensor:
        """The planes, for work on the current stream: the stream waits for
        the copy, and the caching allocator is told the tensor is used
        there (it was allocated on the copy stream), so its memory is not
        handed out again while a kernel still reads it."""
        stream = torch.cuda.current_stream(self.planes.device)
        stream.wait_event(self.ready)
        self.planes.record_stream(stream)
        return self.planes


class PinnedStager:
    """Host→device copies of chunk planes for the pipelined executor.

    ``put`` copies a chunk into the next of ``slots`` pinned host buffers,
    issues a non-blocking copy from there into a fresh device tensor on a
    dedicated copy stream, records an event after it and returns at once.
    From pageable memory ``.to(device)`` would be synchronous, and the
    pipeline would run serially. A buffer is refilled only once the copy
    out of it has finished (its event), and every buffer is sized to the
    largest chunk seen, since streamed chunks differ in size.

    Called from one producer thread; ``slots`` = prefetch + 1 covers the
    chunks waiting in the queue plus the one being copied.
    """

    def __init__(self, device, slots: int):
        device = torch.device(device)
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self._bufs: list = [None] * max(1, slots)
        self._copied: list = [None] * len(self._bufs)
        self._next = 0
        self._capacity = 0

    def put(self, tensor: TripleTensor) -> StagedPlanes:
        i = self._next
        self._next = (i + 1) % len(self._bufs)
        if self._copied[i] is not None:
            self._copied[i].synchronize()   # the last copy out of buffer i
        host = torch.from_numpy(np.ascontiguousarray(tensor.planes))
        n = host.numel()
        if self._bufs[i] is None or self._bufs[i].numel() < n:
            self._capacity = max(self._capacity, n, 1)
            self._bufs[i] = torch.empty((self._capacity,), dtype=torch.int32,
                                        pin_memory=True)
        staged = self._bufs[i][:n].view(host.shape)
        staged.copy_(host)
        with torch.cuda.stream(self.stream):
            planes = torch.empty(host.shape, dtype=torch.int32,
                                 device=self.device)
            planes.copy_(staged, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self.stream)
        self._copied[i] = ready
        return StagedPlanes(planes, ready)


def state_from_numpy(state: Mapping, evaluator: QualityEvaluator) -> dict:
    """Carry a chunk state over from the JAX evaluator (or any holder of
    numpy arrays shaped like ``chunk_state_init``/``merge_chunk``'s state)
    into ``evaluator``'s, checking it against the evaluator's plans:
    one counter vector per plan of its length, the same sketch names, and
    ``2^hll_p`` registers each. Returns a fresh state; ``state`` is left
    as it was."""
    try:
        counts, sketches = state["counts"], state["sketches"]
        chunks_done = state["chunks_done"]
    except (KeyError, TypeError) as e:
        raise ValueError(f"not a chunk state: {e!r}") from None
    if len(counts) != len(evaluator.plans):
        raise ValueError(f"state has {len(counts)} counter vectors, the "
                         f"evaluator {len(evaluator.plans)} plans")
    out_counts = []
    for i, (c, pln) in enumerate(zip(counts, evaluator.plans)):
        c = np.asarray(c)
        if c.shape != (pln.n_counters,) or not np.issubdtype(
                c.dtype, np.integer):
            raise ValueError(f"plan {i}: counters {c.dtype}{c.shape}, "
                             f"expected int ({pln.n_counters},)")
        out_counts.append(c.astype(np.int64))
    want = {s for s, _ in evaluator._all_sketch_specs()}
    if set(sketches) != want:
        raise ValueError(f"state sketches {sorted(sketches)}, the evaluator "
                         f"has {sorted(want)}")
    m = 1 << evaluator.hll_p
    out_sketches = {}
    for s, v in sketches.items():
        v = np.asarray(v)
        if v.shape != (m,) or not np.issubdtype(v.dtype, np.integer):
            raise ValueError(f"sketch {s!r}: registers {v.dtype}{v.shape}, "
                             f"expected int ({m},) for hll_p="
                             f"{evaluator.hll_p}")
        out_sketches[s] = v.astype(np.int32)
    return {"counts": out_counts, "sketches": out_sketches,
            "chunks_done": {int(c) for c in chunks_done}}


def run_single_shot(evaluator: QualityEvaluator,
                    tensor: TripleTensor) -> AssessmentResult:
    """One full-dataset pass per plan (one total when fused), expressed as
    a 1-chunk run through the mergeable-chunk interface so single-shot and
    chunked execution share one finalize path."""
    state = evaluator.chunk_state_init()
    counts, regs = evaluator.eval_chunk(tensor)
    state = QualityEvaluator.merge_chunk(state, 0, counts, regs)
    return evaluator.finalize_state(state, len(tensor))
