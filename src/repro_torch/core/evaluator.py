"""QAP evaluator (paper §2.2 step 4 + Algorithm 1), on one device or over
a mesh of ranks.

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
* ``mesh``: a 1-D ``DeviceMesh`` (``launch.mesh.make_assessment_mesh``)
  over ranks that each run this same evaluator. A chunk's rows split into
  one contiguous shard per rank (``shard_bounds``); each rank copies only
  its shard to its device and launches the backend's kernels over it, and
  the counters are then all-reduced with SUM (int64) and the register
  banks with MAX (int32) over the mesh's group: sum and max are exact and
  order-free, so any split gives the single-device counters and
  registers bit for bit. ``eval_segment_batch`` instead hands whole
  segments to ranks and all-gathers each one's state unreduced.

``AssessmentResult.passes`` reports ACTUAL data passes: each op wrapper
that streams the planes once records a scan (``kernels.record_scan``),
before it dispatches on the device, and ``passes_per_chunk`` runs every
plan's pass function once on an 8-row zero tensor under that counter.
Under a mesh that is one rank's pass over its shard: every rank streams
its shard once, so the sharded chunk streams once collectively.

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
import torch.distributed as dist

from .. import tracing
from ..kernels import count_scans, record_scan
from ..rdf.triple_tensor import TripleTensor, N_PLANES
from . import sketches as hll
from .expr import eval_program_torch
from .metrics import ALL_METRICS, get_metrics
from .planner import Plan, plan, plan_single

BACKENDS = ("torch", "twopass", "fused_scan")

# Shard boundaries fall on multiples of this many rows: 4 rows of 52 B are
# 208 B, so every shard's base stays 16-byte aligned on the card (the scan
# kernel stages a tile at an unaligned base word by word,
# csrc/scan_spec.cuh). No row is padded: the kernels take ragged tails.
SHARD_ALIGN_ROWS = 4


@dataclasses.dataclass
class AssessmentResult:
    values: dict[str, float]            # metric name -> value
    counts: dict[str, dict[str, int]]   # metric -> counter -> raw count
    sketch_estimates: dict[str, float]
    n_triples: int
    passes: int                         # ACTUAL data passes performed
    exec_stats: object = None           # None on the single-shot path
    # merged HLL register banks (sketch name -> int32 array); exposed so
    # exactness can be asserted at the register level, not just on the
    # derived estimates
    registers: dict = dataclasses.field(default_factory=dict)

    def __getitem__(self, k: str) -> float:
        return self.values[k]


class QualityEvaluator:
    def __init__(self, metric_names: Sequence[str] = ALL_METRICS, *,
                 fused: bool = True, backend: str = "fused_scan",
                 hll_p: int = hll.DEFAULT_P, device="cuda", mesh=None):
        if backend not in BACKENDS:
            raise ValueError(
                f"backend must be one of {BACKENDS}, got {backend!r}")
        self.metrics = get_metrics(metric_names)
        self.fused = fused
        self.backend = backend
        self.hll_p = hll_p
        self.device = torch.device(device)
        self.mesh = mesh
        if mesh is not None:
            self._check_mesh(mesh)
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

    # -- the mesh --------------------------------------------------------------
    def _check_mesh(self, mesh) -> None:
        if mesh.ndim != 1:
            raise ValueError(f"the mesh must be 1-D (rows split over one "
                             f"axis), got shape {tuple(mesh.mesh.shape)}")
        if mesh.device_type != self.device.type:
            raise ValueError(f"the mesh is on {mesh.device_type}, the "
                             f"evaluator's device is {self.device}")
        if mesh.get_coordinate() is None:
            rank = dist.get_rank() if dist.is_initialized() else None
            raise ValueError(f"rank {rank} is not in the mesh "
                             f"{mesh.mesh.tolist()}")

    def _shard_count(self) -> int:
        """Row shards a mesh splits a chunk into (1 without a mesh)."""
        return 1 if self.mesh is None else self.mesh.size()

    def _row_multiple(self) -> int:
        """Rows every shard boundary is a multiple of (1 without a mesh)."""
        return 1 if self.mesh is None else SHARD_ALIGN_ROWS

    def shard_bounds(self, n_rows: int) -> list[int]:
        """The ``W + 1`` row boundaries of a chunk of ``n_rows`` rows over
        ``W`` shards: rank r takes ``[b[r], b[r+1])``. Each inner boundary
        is ``n_rows * r / W`` rounded down to a multiple of
        ``_row_multiple()``; a shard may be empty."""
        w, m = self._shard_count(), self._row_multiple()
        return [n_rows * r // w // m * m for r in range(w)] + [n_rows]

    def _local_rows(self, planes: np.ndarray) -> np.ndarray:
        """This rank's shard of ``planes`` (all of it without a mesh): a
        contiguous row range, a view."""
        if self.mesh is None:
            return planes
        b, r = self.shard_bounds(planes.shape[0]), self.mesh.get_local_rank()
        return planes[b[r]:b[r + 1]]

    def is_writer(self) -> bool:
        """Whether this process writes what a run persists (checkpoints,
        the segment store): always without a mesh, rank 0 alone under
        one, since every rank holds the same reduced state."""
        return self.mesh is None or self.mesh.get_local_rank() == 0

    def barrier(self) -> None:
        """Wait for every rank of the mesh (a no-op without one): one
        all-reduce of a one-element tensor on the mesh's collective
        device, the same call under ``nccl`` and ``gloo``, and its copy to
        the host, which waits for it under ``nccl`` too."""
        if self.mesh is None:
            return
        dev = self.device if self._on_card_collectives() else "cpu"
        token = torch.zeros(1, dtype=torch.int32, device=dev)
        dist.all_reduce(token, group=self.mesh.get_group())
        token.cpu()

    def _on_card_collectives(self) -> bool:
        """Whether the mesh's collectives take the card's tensors: under
        ``nccl``. ``gloo`` reduces host copies of the kernels' outputs,
        which are copied to the host for the merge anyway."""
        return dist.get_backend(self.mesh.get_group()) == "nccl"

    def device_planes(self, tensor: TripleTensor) -> torch.Tensor:
        """The planes on the evaluator's device, as they are, or under a
        mesh this rank's shard of them: the kernels mask the ragged tail
        themselves, and zero rows the tensor already carries are invisible
        to counters and sketches alike."""
        return self._to_device(self._local_rows(tensor.planes))

    def _to_device(self, planes: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(planes)).to(self.device)

    def plane_stager(self, slots: int):
        """The function the pipelined executor's producer thread puts each
        chunk through: ``device_planes`` on a CPU device; on a CUDA device
        ``PinnedStager.put`` over ``slots`` pinned buffers, so the copy of
        the next chunk overlaps the scan of this one. Under a mesh only the
        rank's shard is staged."""
        if self.device.type == "cuda":
            stager = PinnedStager(self.device, slots)
            return lambda chunk: stager.put(self._local_rows(chunk.planes))
        return self.device_planes

    # -- public API ------------------------------------------------------------
    def assess(self, tensor: TripleTensor) -> AssessmentResult:
        """Single-shot assessment (the JAX evaluator's method).

        A shim over the execution path the ``repro_torch.qa`` pipeline
        uses; prefer ``qa.pipeline()`` / ``qa.assess`` for new code (they
        add ingest, chunked execution and checkpoint/resume)."""
        return run_single_shot(self, tensor)

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
        with tracing.span("evaluator.dispatch"):
            if isinstance(arr, StagedPlanes):
                arr = arr.consume()
            if arr.device.type == "cuda" and not self._scans_compiled:
                with tracing.span("evaluator.compile"):
                    self._compile_scans()
            return [fn(arr) for fn in self._pass_fns]

    def _compile_scans(self) -> None:
        """Compile every plan's scan kernel (and ``twopass``'s
        ``hll_fold``) at once, in parallel, before the first launch on a
        card (per-metric mode has one plan a metric); the launches then
        find them in the process's cache."""
        if self.backend in ("fused_scan", "twopass"):
            from ..kernels import _build
            fused = self.backend == "fused_scan"
            srcs = [_build.scan_source(pln.program, pln.n_counters,
                                       pln.sketch_specs if fused else (),
                                       self.hll_p)
                    for pln in self.plans]
            if not fused and any(pln.sketch_specs for pln in self.plans):
                from ..kernels.hll import ops as hops
                srcs.append(hops.kernel_source())
            _build.compile_scans(srcs)
        self._scans_compiled = True

    def materialize_chunk(self, outs):
        """Wait for the dispatched passes and gather host numpy results —
        the single per-chunk host synchronization point. Under a mesh the
        passes' outputs are first reduced over the mesh
        (``reduce_over_mesh``), so every rank returns the whole chunk's
        counters and registers."""
        with tracing.span("evaluator.materialize"):
            counts, regs = _joined(outs)
            if self.mesh is not None:
                counts, regs = self.reduce_over_mesh(counts, regs)
            return ([c.cpu().numpy() for c in counts],
                    {k: v.cpu().numpy() for k, v in regs.items()})

    def reduce_over_mesh(self, counts: list, regs: dict):
        """Counters SUM (int64) and register banks MAX (int32) over the
        mesh's group, in two collectives that every rank issues in the same
        order: the plans' counters concatenated in plan order, the banks
        stacked in sorted sketch-name order. On the card's tensors under
        ``nccl``; on host copies under ``gloo``."""
        group = self.mesh.get_group()
        move = ((lambda t: t) if self._on_card_collectives()
                else (lambda t: t.cpu()))
        sizes = [c.numel() for c in counts]
        flat = move(torch.cat([c.reshape(-1).to(torch.int64)
                               for c in counts]))
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        counts = list(torch.split(flat, sizes))
        names = sorted(regs)
        if names:
            bank = move(torch.stack([regs[k] for k in names]))
            dist.all_reduce(bank, op=dist.ReduceOp.MAX, group=group)
            regs = {k: bank[names.index(k)] for k in regs}  # plans' order
        return counts, regs

    def eval_chunk(self, chunk: TripleTensor):
        arr = self.device_planes(chunk)
        return self.materialize_chunk(self.dispatch_chunk(arr))

    # -- batched independent segments (mesh scale-out of incremental runs) -----
    def eval_segment_batch(self, tensors: Sequence[TripleTensor]) -> list:
        """Evaluate ``B`` independent tensors; returns a list of
        per-tensor ``(counts, regs)`` in input order — the same pair
        ``eval_chunk`` yields, kept separate per tensor.

        Under a mesh of ``W`` ranks, rank r scans tensors
        ``i ≡ r (mod W)``, each whole and unreduced, and one
        ``all_gather`` per dtype hands every rank every tensor's state. A
        rank with no tensor left in the last round still takes part with
        zero counters and zero registers, the identity of sum and of max.
        Every rank must call this with the same ``B``.
        """
        if not tensors:
            return []
        if self.mesh is None:
            return [self.eval_chunk(t) for t in tensors]
        w, r = self._shard_count(), self.mesh.get_local_rank()
        rounds = -(-len(tensors) // w)
        plan_sizes = [pln.n_counters for pln in self.plans]
        specs = [s for s, _ in self._all_sketch_specs()]
        names = sorted(specs)
        regs_shape = (len(names), 1 << self.hll_p)
        on_card = self._on_card_collectives()
        dev = self.device if on_card else torch.device("cpu")
        counts = torch.zeros((rounds, sum(plan_sizes)), dtype=torch.int64,
                             device=dev)
        banks = torch.zeros((rounds,) + regs_shape, dtype=torch.int32,
                            device=dev)
        for j in range(rounds):
            i = j * w + r
            if i >= len(tensors):
                break
            c, regs = _joined(self.dispatch_chunk(
                self._to_device(tensors[i].planes)))
            counts[j] = torch.cat([x.to(torch.int64) for x in c]).to(dev)
            for k, name in enumerate(names):
                banks[j, k] = regs[name].to(dev)
        group = self.mesh.get_group()
        all_counts = [torch.empty_like(counts) for _ in range(w)]
        all_banks = [torch.empty_like(banks) for _ in range(w)]
        dist.all_gather(all_counts, counts, group=group)
        dist.all_gather(all_banks, banks, group=group)
        results = []
        for i in range(len(tensors)):
            j, src = divmod(i, w)
            c = all_counts[src][j].cpu().numpy()
            b = all_banks[src][j].cpu().numpy()
            results.append((list(np.split(c, np.cumsum(plan_sizes)[:-1])),
                            {name: b[names.index(name)] for name in specs}))
        return results

    @staticmethod
    def merge_chunk(state: dict, chunk_id: int, counts, regs) -> dict:
        """Idempotent merge — re-delivered chunks are ignored."""
        with tracing.span("evaluator.merge"):
            if chunk_id in state["chunks_done"]:
                return state
            state["counts"] = [a + b for a, b in zip(state["counts"],
                                                     counts)]
            for k, v in regs.items():
                state["sketches"][k] = np.maximum(state["sketches"][k], v)
            state["chunks_done"].add(chunk_id)
            return state

    def finalize_state(self, state: dict, n_triples: int) -> AssessmentResult:
        with tracing.span("evaluator.finalize"):
            # estimates from the merged host registers: the same registers
            # give the same float32 value whatever device scanned them
            est = {"sketch:" + k: hll.estimate_bank(v)
                   for k, v in state["sketches"].items()}
            values: dict[str, float] = {}
            counts_out: dict[str, dict[str, int]] = {}
            for pln, counts in zip(self.plans, state["counts"]):
                with tracing.span("plan.finalize"):
                    values.update(pln.finalize(counts, est))
                for m in pln.metrics:
                    counts_out[m.name] = {
                        c: int(counts[pln.slots[m.name][c]])
                        for c, _ in m.counters}
            return AssessmentResult(
                values=values, counts=counts_out, sketch_estimates=est,
                n_triples=n_triples,
                passes=len(state["chunks_done"]) * self.passes_per_chunk,
                registers={k: np.asarray(v)
                           for k, v in state["sketches"].items()})


def _joined(outs) -> tuple[list, dict]:
    """The plans' pass outputs as (counter vectors in plan order, one dict
    of every register bank)."""
    regs = {}
    for _, r in outs:
        regs.update(r)
    return [c for c, _ in outs], regs


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

    ``put`` copies a chunk's planes (or a rank's shard of them) into the
    next of ``slots`` pinned host buffers, issues a non-blocking copy from
    there into a fresh device tensor on a dedicated copy stream, records
    an event after it and returns at once.
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

    def put(self, host_planes: np.ndarray) -> StagedPlanes:
        i = self._next
        self._next = (i + 1) % len(self._bufs)
        if self._copied[i] is not None:
            self._copied[i].synchronize()   # the last copy out of buffer i
        host = torch.from_numpy(np.ascontiguousarray(host_planes))
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
    chunked execution share one finalize path. Under a mesh every rank
    scans its shard and returns the whole result."""
    state = evaluator.chunk_state_init()
    counts, regs = evaluator.eval_chunk(tensor)
    state = QualityEvaluator.merge_chunk(state, 0, counts, regs)
    return evaluator.finalize_state(state, len(tensor))
