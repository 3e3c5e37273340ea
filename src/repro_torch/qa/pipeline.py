"""The ``repro_torch.qa`` pipeline — one front door for quality assessment.

A ``Pipeline`` is an immutable description of *what* to measure (metric
names) and *how* to execute (backend, fusion, HLL precision, device);
every fluent method returns a new pipeline, so partial configurations can
be shared and specialized freely::

    base = qa.pipeline().metrics("paper")
    res = base.device("cuda").run("data.nt")

Datasets are ingested polymorphically: a ``TripleTensor``, an N-Triples
file path, raw N-Triples text, or bytes (gzip is sniffed and
decompressed). Execution is single-shot: the whole dataset is one chunk
on the device.
"""
from __future__ import annotations

import dataclasses
import functools
import os
from typing import Optional, Sequence, Union

from ..core.evaluator import (BACKENDS, AssessmentResult, QualityEvaluator,
                              run_single_shot)
from ..core.metrics import (ALL_METRICS, EXTENDED_METRICS, PAPER_METRICS,
                            SKETCH_METRICS, REGISTRY, Metric, register)
from ..core import sketches as hll
from ..rdf import TripleTensor
from ..rdf import ingest as rdf_ingest

METRIC_ALIASES = {
    "paper": PAPER_METRICS,
    "extended": EXTENDED_METRICS,
    "sketch": SKETCH_METRICS,
}

Dataset = Union[TripleTensor, str, bytes, os.PathLike]


@dataclasses.dataclass(frozen=True)
class ExecutionConfig:
    """How an assessment executes; owned by the pipeline, consumed by the
    evaluator engine."""
    backend: str = "fused_scan"        # the CUDA kernels
    fused: bool = True
    hll_p: int = hll.DEFAULT_P
    device: str = "cuda"

    def __post_init__(self):
        # validate here so every construction path (fluent, qa.assess
        # overrides, direct ExecutionConfig) rejects typos loudly
        if self.backend not in BACKENDS:
            raise ValueError(
                f"backend must be one of {BACKENDS}, got {self.backend!r}")


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


@functools.lru_cache(maxsize=16)
def _evaluator_for(metrics_key: tuple, backend: str, fused: bool,
                   hll_p: int, device: str) -> QualityEvaluator:
    # keyed on the Metric OBJECTS (not names), so re-registering a name
    # yields a fresh engine rather than a stale cached plan
    return QualityEvaluator([m.name for m in metrics_key], fused=fused,
                            backend=backend, hll_p=hll_p, device=device)


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

    def single_shot(self) -> "Pipeline":
        """The whole dataset as one chunk — the only execution mode here,
        so this returns the pipeline as it is; it keeps pipelines written
        against ``repro.qa`` unchanged."""
        return self

    def with_exec(self, cfg: ExecutionConfig) -> "Pipeline":
        return dataclasses.replace(self, exec=cfg)

    # -- execution -------------------------------------------------------------
    def evaluator(self) -> QualityEvaluator:
        """The configured engine beneath this pipeline, memoized on the
        resolved Metric objects + execution config."""
        metrics_key = tuple(REGISTRY[n] for n in self.metric_names)
        e = self.exec
        return _evaluator_for(metrics_key, e.backend, e.fused, e.hll_p,
                              e.device)

    def run(self, dataset: Dataset) -> AssessmentResult:
        """Ingest ``dataset`` and assess it in one pass per plan."""
        return run_single_shot(self.evaluator(), self.ingest(dataset))

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

    def ingest(self, dataset: Dataset) -> TripleTensor:
        """Encode without assessing → a ``TripleTensor``. Useful to time or
        reuse ingestion separately from evaluation."""
        if isinstance(dataset, TripleTensor):
            return dataset
        if isinstance(dataset, bytes):
            return self._encode(dataset)       # parse_encode sniffs gzip
        if self._is_path(dataset):
            with open(os.fspath(dataset), "rb") as f:
                return self._encode(f.read())
        if isinstance(dataset, str):
            if self._looks_like_ntriples(dataset):
                return self._encode(dataset)
            raise FileNotFoundError(f"no such N-Triples file: {dataset!r}")
        raise TypeError(f"cannot ingest {type(dataset).__name__} as a dataset")

    # -- introspection ---------------------------------------------------------
    def describe(self) -> str:
        e = self.exec
        return (f"qa.Pipeline[{len(self.metric_names)} metrics | "
                f"{'fused' if e.fused else 'per-metric'} | {e.backend} | "
                f"hll_p={e.hll_p} | single-shot | {e.device}]")

    __repr__ = describe


def pipeline() -> Pipeline:
    """A fresh default pipeline (all registered metrics, fused, the
    fused_scan kernels on the card, single shot)."""
    return Pipeline(metric_names=tuple(REGISTRY))


def assess(dataset: Dataset, *, metrics="all",
           exec: Optional[ExecutionConfig] = None,
           base: Sequence[str] = (), **exec_overrides) -> AssessmentResult:
    """One-call assessment: ``qa.assess(ds, metrics="paper",
    device="cpu")``. Keyword overrides patch ``exec``."""
    cfg = exec if exec is not None else ExecutionConfig()
    if exec_overrides:
        cfg = dataclasses.replace(cfg, **exec_overrides)
    p = pipeline().metrics(metrics).with_exec(cfg)
    if base:
        p = p.base(*base)
    return p.run(dataset)
