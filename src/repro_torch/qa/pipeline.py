"""The ``repro_torch.qa`` pipeline — one front door for quality assessment.

A ``Pipeline`` is an immutable description of *what* to measure (metric
names) and *how* to execute (backend, fusion, HLL precision, device,
mesh);
every fluent method returns a new pipeline, so partial configurations can
be shared and specialized freely::

    base = qa.pipeline().metrics("paper").device("cuda")
    res = base.chunked(32, checkpoint_dir="ckpt/").run("data.nt")

Datasets are ingested polymorphically: a ``TripleTensor``, an N-Triples
file path, raw N-Triples text, bytes (gzip is sniffed and decompressed),
or an iterable of chunks (each itself a ``TripleTensor`` or N-Triples
text) for streaming ingest. Single-shot execution puts the whole dataset
on the device as one chunk; chunked, streamed and pipelined execution go
through ``repro_torch.dist.ChunkScheduler``; incremental execution
(``.incremental(store_dir)``) diffs the dataset's segments against a
``repro_torch.store`` segment store and rescans only the changed ones.
"""
from __future__ import annotations

import dataclasses
import functools
import os
from typing import Iterable, Optional, Sequence, Union

from ..core.evaluator import (BACKENDS, AssessmentResult, QualityEvaluator,
                              run_single_shot)
from ..core.metrics import (ALL_METRICS, EXTENDED_METRICS, PAPER_METRICS,
                            SKETCH_METRICS, REGISTRY, Metric, register)
from ..core import sketches as hll
from ..dist import ChunkScheduler
from ..rdf import TripleTensor
from ..rdf import ingest as rdf_ingest

METRIC_ALIASES = {
    "paper": PAPER_METRICS,
    "extended": EXTENDED_METRICS,
    "sketch": SKETCH_METRICS,
}

Dataset = Union[TripleTensor, str, bytes, os.PathLike, Iterable]


@dataclasses.dataclass(frozen=True)
class ExecutionConfig:
    """How an assessment executes; owned by the pipeline, consumed by the
    evaluator engine and the ``repro_torch.dist`` scheduler."""
    backend: str = "fused_scan"        # the CUDA kernels
    fused: bool = True
    chunks: int = 0                    # 0 = single shot
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 8
    hll_p: int = hll.DEFAULT_P
    stream_triples: int = 0            # >0: streaming ingest chunk size
    prefetch: int = 0                  # >0: async pipelined chunk executor
    speculate: bool = False            # straggler backup copies (sync loop)
    device: str = "cuda"
    mesh: object = None                # DeviceMesh: rows split over ranks
    store_dir: Optional[str] = None    # segment store: incremental mode
    segment_bytes: int = 0             # target segment size (0 = default)
    max_history: int = 0               # >0: keep only the newest N
                                       # history.jsonl snapshots
    dataset_uri: Optional[str] = None  # provenance URI for reports/history
                                       # (None = the default urn)

    def __post_init__(self):
        # validate here so every construction path (fluent, qa.assess
        # overrides, direct ExecutionConfig) rejects typos loudly
        if self.backend not in BACKENDS:
            raise ValueError(
                f"backend must be one of {BACKENDS}, got {self.backend!r}")
        if self.chunks < 0:
            raise ValueError(f"chunks must be >= 0, got {self.chunks}")
        if self.stream_triples < 0:
            raise ValueError(
                f"stream_triples must be >= 0, got {self.stream_triples}")
        if self.prefetch < 0:
            raise ValueError(f"prefetch must be >= 0, got {self.prefetch}")
        if self.segment_bytes < 0:
            raise ValueError(
                f"segment_bytes must be >= 0, got {self.segment_bytes}")
        if self.max_history < 0:
            raise ValueError(
                f"max_history must be >= 0, got {self.max_history}")


def _resolve_metrics(spec) -> tuple[str, ...]:
    if isinstance(spec, str):
        names: list[str] = []
        for tok in (s.strip() for s in spec.split(",")):
            if tok == "all":
                # resolved against the live registry so user-registered
                # metrics are included
                names.extend(REGISTRY)
            elif tok in METRIC_ALIASES:
                names.extend(METRIC_ALIASES[tok])
            elif tok:
                names.append(tok)
    else:
        names = []
        for m in spec:
            if isinstance(m, Metric):
                if REGISTRY.get(m.name) is not m:
                    register(m)  # raises on collision, never clobbers
                names.append(m.name)
            else:
                names.append(m)
    names = list(dict.fromkeys(names))  # dedupe, keep order
    if not names:
        raise ValueError("no metrics selected")
    unknown = [n for n in names if n not in REGISTRY]
    if unknown:
        raise ValueError(
            f"unknown metrics {unknown}; registered: {sorted(REGISTRY)}")
    return tuple(names)


def mesh_structural_key(mesh) -> tuple | None:
    """``(device type, mesh shape, dim names, ranks)`` — equal iff two
    meshes run the same SPMD program on the same ranks. None for None
    (the single-device case)."""
    if mesh is None:
        return None
    return (mesh.device_type, tuple(mesh.mesh.shape),
            tuple(mesh.mesh_dim_names or ()),
            tuple(mesh.mesh.flatten().tolist()))


class _MeshKey:
    """Hashable cache identity for a mesh: STRUCTURAL, not object
    identity. Callers rebuild a structurally identical mesh per call (a
    service per job, a benchmark per rung); keying the engine cache on the
    ``DeviceMesh`` object would miss on every rebuild and build a new
    engine, whose plans compile anew. The first mesh seen for a structure
    is the one the cached engine keeps using."""

    __slots__ = ("mesh", "key")

    def __init__(self, mesh):
        self.mesh = mesh
        self.key = mesh_structural_key(mesh)

    def __hash__(self):
        return hash(self.key)

    def __eq__(self, other):
        return isinstance(other, _MeshKey) and self.key == other.key


@functools.lru_cache(maxsize=16)
def _evaluator_for(metrics_key: tuple, backend: str, fused: bool,
                   hll_p: int, device: str,
                   mesh_key: _MeshKey) -> QualityEvaluator:
    # keyed on the Metric OBJECTS (not names), so re-registering a name
    # yields a fresh engine rather than a stale cached plan
    return QualityEvaluator([m.name for m in metrics_key], fused=fused,
                            backend=backend, hll_p=hll_p, device=device,
                            mesh=mesh_key.mesh)


@dataclasses.dataclass(frozen=True)
class Pipeline:
    """Immutable, fluent assessment pipeline. Build with ``qa.pipeline()``."""
    metric_names: tuple[str, ...] = ALL_METRICS
    exec: ExecutionConfig = ExecutionConfig()
    base_ns: tuple[str, ...] = ()

    # -- what to measure -------------------------------------------------------
    def metrics(self, spec) -> "Pipeline":
        """Select metrics: ``"paper"``/``"all"``/``"extended"``/``"sketch"``,
        a csv string, or a sequence of names/``Metric``s."""
        return dataclasses.replace(self, metric_names=_resolve_metrics(spec))

    def base(self, *namespaces: str) -> "Pipeline":
        """Internal base namespaces used when ingesting N-Triples text."""
        return dataclasses.replace(self, base_ns=tuple(namespaces))

    # -- how to execute --------------------------------------------------------
    def _exec(self, **kw) -> "Pipeline":
        return dataclasses.replace(
            self, exec=dataclasses.replace(self.exec, **kw))

    def backend(self, name: str) -> "Pipeline":
        return self._exec(backend=name)  # validated by ExecutionConfig

    def fused(self, flag: bool = True) -> "Pipeline":
        return self._exec(fused=flag)

    def per_metric(self) -> "Pipeline":
        """Paper-faithful Algorithm 1: one pass per metric."""
        return self._exec(fused=False)

    def hll(self, p: int) -> "Pipeline":
        return self._exec(hll_p=p)

    def device(self, device) -> "Pipeline":
        """Where the planes live and the scan runs (``"cuda"``,
        ``"cuda:1"``, ``"cpu"``)."""
        return self._exec(device=str(device))

    def shard(self, mesh) -> "Pipeline":
        """Shard rows over ``mesh`` (pure data parallelism): a 1-D
        ``DeviceMesh`` from ``launch.mesh.make_assessment_mesh``, whose
        device type is the pipeline's device's. Every rank of the mesh
        runs the same pipeline on the same dataset; ``None`` drops the
        mesh."""
        return self._exec(mesh=mesh)

    def chunked(self, n_chunks: int, *, checkpoint_dir: Optional[str] = None,
                checkpoint_every: int = 8) -> "Pipeline":
        """Fault-tolerant over-decomposed scan via ``dist.ChunkScheduler``."""
        return self._exec(chunks=int(n_chunks), checkpoint_dir=checkpoint_dir,
                          checkpoint_every=checkpoint_every)

    def streamed(self, chunk_triples: int = 65_536, *,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: Optional[int] = None) -> "Pipeline":
        """Bounded-memory ingest: N-Triples paths/text are read in blocks
        and fed to the scheduler as ready ``TripleTensor`` chunks of
        ``chunk_triples`` rows (``rdf.ingest.stream_chunks``) — the full
        dataset is never resident. Term ids stay global across chunks, so
        results (sketches included) match the single-shot pass exactly.
        ``checkpoint_dir`` enables scheduler checkpoint/resume for the
        stream without needing a separate ``chunked()`` call (when omitted,
        any checkpointing configured via ``chunked()`` is left untouched)."""
        kw: dict = dict(stream_triples=int(chunk_triples))
        if checkpoint_dir is not None:
            kw["checkpoint_dir"] = checkpoint_dir
        if checkpoint_every is not None:
            kw["checkpoint_every"] = checkpoint_every
        return self._exec(**kw)

    def pipelined(self, prefetch: int = 1) -> "Pipeline":
        """Async double-buffered chunk executor: ingest and the host→device
        copy of chunk *i+1* (pinned buffers, a side stream) overlap with
        the scan of chunk *i* on the card; host sync is one deferred
        per-chunk materialization. ``prefetch`` bounds how many ready
        chunks may wait ahead of the device (1 = classic double
        buffering). Results are bit-identical to the sequential loop;
        applies to chunked/streamed runs (single-shot runs have nothing to
        overlap). ``prefetch=0`` restores the sequential executor."""
        return self._exec(prefetch=int(prefetch))

    def speculative(self, flag: bool = True) -> "Pipeline":
        """Speculatively re-execute straggler chunks: when a chunk's eval
        outlives the straggler threshold (``straggler_factor ×`` the
        running median), a backup copy is dispatched and the first
        completion wins — safe for free because the merge is idempotent
        per chunk id.  Applies to the sequential chunk loop."""
        return self._exec(speculate=bool(flag))

    def incremental(self, store_dir: str, *, segment_bytes: int = 0,
                    dataset_uri: Optional[str] = None,
                    max_history: int = 0) -> "Pipeline":
        """Incremental assessment against the persistent segment store at
        ``store_dir`` (``repro_torch.store``): the dataset is split into
        content-defined segments, unchanged segments are served from their
        frozen partial states, and only new/changed segments are rescanned
        (through the configured backend's kernels; ``.pipelined()``
        applies). Results are bit-identical — HLL registers included — to
        a cold assessment of the same bytes, and every run appends a
        timestamped snapshot to the store's quality history.
        ``segment_bytes`` tunes the target segment size (0 =
        ``repro_torch.store.DEFAULT_TARGET_BYTES``); ``dataset_uri``
        labels history snapshots and DQV reports (None = default urn);
        ``max_history > 0`` bounds the store's ``history.jsonl`` to the
        newest that many snapshots (oldest dropped atomically). The store
        is the JAX package's format: either package reuses the other's."""
        return self._exec(store_dir=os.fspath(store_dir),
                          segment_bytes=int(segment_bytes),
                          dataset_uri=dataset_uri,
                          max_history=int(max_history))

    def single_shot(self) -> "Pipeline":
        """The whole dataset as one chunk: drops chunking, streaming,
        checkpointing and the segment store."""
        return self._exec(chunks=0, checkpoint_dir=None, stream_triples=0,
                          store_dir=None)

    def with_exec(self, cfg: ExecutionConfig) -> "Pipeline":
        return dataclasses.replace(self, exec=cfg)

    # -- execution -------------------------------------------------------------
    def evaluator(self) -> QualityEvaluator:
        """The configured engine beneath this pipeline, memoized on the
        resolved Metric objects + execution config."""
        metrics_key = tuple(REGISTRY[n] for n in self.metric_names)
        e = self.exec
        return _evaluator_for(metrics_key, e.backend, e.fused, e.hll_p,
                              e.device, _MeshKey(e.mesh))

    def run(self, dataset: Dataset) -> AssessmentResult:
        """Ingest ``dataset`` and execute; chunked/streaming runs attach a
        ``dist.ChunkStats`` on ``result.exec_stats``; so do incremental
        runs, with the store's reuse accounting."""
        if self.exec.store_dir:
            return self._run_incremental(dataset)
        data = self.ingest(dataset)
        if isinstance(data, TripleTensor) and not self.exec.chunks:
            return run_single_shot(self.evaluator(), data)
        result, stats = self.scheduler().run(data)
        result.exec_stats = stats
        return result

    def scheduler(self) -> ChunkScheduler:
        """The configured ``dist.ChunkScheduler`` (advanced: fault
        injection, custom chunk streams)."""
        return ChunkScheduler(self.evaluator(),
                              n_chunks=self.exec.chunks or 16,
                              checkpoint_dir=self.exec.checkpoint_dir,
                              checkpoint_every=self.exec.checkpoint_every,
                              prefetch=self.exec.prefetch,
                              speculate=self.exec.speculate)

    # -- incremental (segment store) -------------------------------------------
    def _segments(self, dataset: Dataset):
        """Ordered raw byte segments of ``dataset`` for the incremental
        planner: paths/text/bytes are CDC-segmented
        (``repro_torch.store.segmenter``) after gzip is sniffed and
        decompressed; an iterable of N-Triples text/bytes chunks is an
        *explicit* segmentation — each line-aligned chunk is one
        segment."""
        from .. import store as seg_store
        tb = self.exec.segment_bytes or seg_store.DEFAULT_TARGET_BYTES
        if isinstance(dataset, TripleTensor):
            raise TypeError(
                "incremental assessment diffs raw bytes against the "
                "segment store; pass an N-Triples path, text, or an "
                "iterable of text chunks, not an encoded TripleTensor")
        if self._is_path(dataset):
            def from_file():
                # segmentation runs over the *decompressed* stream, so a
                # dataset re-published as .nt.gz reuses every frozen
                # segment of its raw twin
                with rdf_ingest.open_nt(dataset) as f:
                    yield from seg_store.iter_segments(f, tb)
            return from_file()
        if isinstance(dataset, (str, bytes)):
            if isinstance(dataset, str):
                if not self._looks_like_ntriples(dataset):
                    raise FileNotFoundError(
                        f"no such N-Triples file: {dataset!r}")
                dataset = dataset.encode("utf-8")
            else:
                dataset = rdf_ingest.maybe_decompress(dataset)
            return seg_store.iter_segments_bytes(dataset, tb)
        if hasattr(dataset, "__iter__"):
            def from_chunks():
                for item in dataset:
                    if isinstance(item, str):
                        item = item.encode("utf-8")
                    if not isinstance(item, bytes):
                        raise TypeError(
                            "incremental chunk streams must yield "
                            "N-Triples text/bytes, got "
                            f"{type(item).__name__}")
                    yield item
            return from_chunks()
        raise TypeError(
            f"cannot ingest {type(dataset).__name__} as a dataset")

    def _run_incremental(self, dataset: Dataset) -> AssessmentResult:
        from ..store import assess_incremental
        kw = {}
        if self.exec.dataset_uri:
            kw["dataset_uri"] = self.exec.dataset_uri
        return assess_incremental(
            self.evaluator(), self._segments(dataset), self.exec.store_dir,
            base_namespaces=self.base_ns, prefetch=self.exec.prefetch,
            speculate=self.exec.speculate,
            max_history=self.exec.max_history, **kw)

    # -- ingest ----------------------------------------------------------------
    def _encode(self, text) -> TripleTensor:   # str | bytes (gzip ok)
        return rdf_ingest.parse_encode(text, base_namespaces=self.base_ns)

    @staticmethod
    def _looks_like_ntriples(text: str) -> bool:
        """N-Triples content, as opposed to a (possibly mistyped) path:
        multi-line, or a single statement-shaped line. A bare missing path
        never matches, so it raises instead of parsing to 0 triples."""
        if "\n" in text:
            return True
        t = text.strip()
        return t.startswith(("<", "_:", "#")) and t.endswith(".")

    @staticmethod
    def _is_path(item) -> bool:
        return isinstance(item, os.PathLike) or (
            isinstance(item, str) and "\n" not in item and len(item) < 4096
            and os.path.exists(item))

    def _ingest_one(self, item) -> TripleTensor:
        if isinstance(item, TripleTensor):
            return item
        if isinstance(item, bytes):
            return self._encode(item)       # parse_encode sniffs gzip
        if self._is_path(item):
            with open(os.fspath(item), "rb") as f:
                return self._encode(f.read())
        if isinstance(item, str):
            if self._looks_like_ntriples(item):
                return self._encode(item)
            raise FileNotFoundError(f"no such N-Triples file: {item!r}")
        raise TypeError(f"cannot ingest {type(item).__name__} as a dataset")

    def ingest(self, dataset: Dataset):
        """Encode without assessing: → a ``TripleTensor``, or a lazy
        stream of chunk tensors. Useful to time or reuse ingestion
        separately from evaluation."""
        st = self.exec.stream_triples
        if st and not isinstance(dataset, TripleTensor):
            if self._is_path(dataset):
                return rdf_ingest.stream_chunks(
                    dataset, st, base_namespaces=self.base_ns)
            if isinstance(dataset, bytes):
                return rdf_ingest.stream_chunks_text(
                    dataset, st, base_namespaces=self.base_ns)
            if isinstance(dataset, str):
                if self._looks_like_ntriples(dataset):
                    return rdf_ingest.stream_chunks_text(
                        dataset, st, base_namespaces=self.base_ns)
                raise FileNotFoundError(
                    f"no such N-Triples file: {dataset!r}")
            # pre-chunked iterables fall through to the generic path
        if isinstance(dataset, (TripleTensor, str, bytes, os.PathLike)):
            return self._ingest_one(dataset)
        if hasattr(dataset, "__iter__"):
            # generator: one encoded chunk resident at a time
            return (self._ingest_one(c) for c in dataset)
        raise TypeError(f"cannot ingest {type(dataset).__name__} as a dataset")

    # -- introspection ---------------------------------------------------------
    def describe(self) -> str:
        e = self.exec
        if e.store_dir:
            mode = f"incremental@{e.store_dir}"
            if e.segment_bytes:
                mode += f" seg={e.segment_bytes}B"
        else:
            mode = f"chunked×{e.chunks}" if e.chunks else "single-shot"
            if e.stream_triples:
                mode += f" streamed@{e.stream_triples}"
        if e.prefetch:
            mode += f" async×{e.prefetch}"
        elif e.speculate:
            # speculation applies to the sequential loop only; with
            # prefetch the pipelined executor runs and ignores it, so the
            # repr must not claim it (repr determines execution)
            mode += " speculative"
        if e.checkpoint_dir and not e.store_dir:
            mode += f" ckpt={e.checkpoint_dir}"
        mesh = (f" mesh={tuple(e.mesh.mesh_dim_names)}x{e.mesh.size()}"
                if e.mesh is not None else "")
        return (f"qa.Pipeline[{len(self.metric_names)} metrics | "
                f"{'fused' if e.fused else 'per-metric'} | {e.backend} | "
                f"hll_p={e.hll_p} | {mode}{mesh} | {e.device}]")

    __repr__ = describe


def pipeline() -> Pipeline:
    """A fresh default pipeline (all registered metrics, fused, the
    fused_scan kernels on the card, single shot)."""
    return Pipeline(metric_names=tuple(REGISTRY))


def assess(dataset: Dataset, *, metrics="all",
           exec: Optional[ExecutionConfig] = None,
           base: Sequence[str] = (), store: Optional[str] = None,
           **exec_overrides) -> AssessmentResult:
    """One-call assessment: ``qa.assess(ds, metrics="paper",
    device="cpu", chunks=8)``. Keyword overrides patch ``exec``;
    ``store=`` is shorthand for ``store_dir=`` (incremental mode against a
    ``repro_torch.store`` segment store)."""
    cfg = exec if exec is not None else ExecutionConfig()
    if store is not None:
        exec_overrides.setdefault("store_dir", os.fspath(store))
    if exec_overrides:
        cfg = dataclasses.replace(cfg, **exec_overrides)
    p = pipeline().metrics(metrics).with_exec(cfg)
    if base:
        p = p.base(*base)
    return p.run(dataset)
