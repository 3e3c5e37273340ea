"""repro_torch.qa — the public quality-assessment API (one front door).

Fluent form::

    from repro_torch import qa
    res = qa.pipeline().metrics("paper").device("cuda").run("data.nt")
    res = (qa.pipeline().metrics("all").chunked(16, checkpoint_dir="ckpt/")
             .pipelined(2).run(tensor))

One-call form::

    res = qa.assess(dataset, metrics="all")            # on the card
    res = qa.assess(dataset, metrics="all", device="cpu")
    res = qa.assess(dataset, metrics="all", backend="twopass", chunks=8)

Custom metrics (LQML-style declarative builders, fused with built-ins)::

    from repro_torch.qa import ratio_metric, is_literal
    ratio_metric("LIT", num=is_literal("o"))
    qa.assess(dataset, metrics="paper,LIT")
"""
from ..core.evaluator import (AssessmentResult, QualityEvaluator,
                              state_from_numpy)
from ..core.metrics import (Metric, register, unregister, ratio_metric,
                            exists_metric, count_metric, qap_metric,
                            is_uri, is_literal, is_blank, is_internal,
                            is_external, has_flag, res_too_long,
                            valid_triple)
from .pipeline import (BACKENDS, Dataset, ExecutionConfig, Pipeline, assess,
                       pipeline, run_single_shot)

__all__ = [
    "AssessmentResult", "QualityEvaluator", "state_from_numpy",
    "Metric", "register", "unregister",
    "ratio_metric", "exists_metric", "count_metric", "qap_metric",
    "is_uri", "is_literal", "is_blank", "is_internal", "is_external",
    "has_flag", "res_too_long", "valid_triple",
    "BACKENDS", "Dataset", "ExecutionConfig", "Pipeline",
    "assess", "pipeline", "run_single_shot",
]
