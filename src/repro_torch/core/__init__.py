"""Core QAP engine — the paper's contribution as a composable torch module.

Quality Assessment Pattern (paper §2.1): Filters/Rules = vectorized predicate
``Expr`` trees, Transformations = their ∩/∪ algebra, Actions = counts (+HLL
distinct sketches), Metrics = counters + arithmetic finalize. The planner
fuses all metrics into one data pass, which the CUDA kernels execute.
"""
from .expr import (AnyBits, Cmp, EqPlanes, Expr, HasBits, And, Or, Not,
                   compile_program, eval_program_torch, program_stack_depth)
from .metrics import (ALL_METRICS, EXTENDED_METRICS, PAPER_METRICS,
                      SKETCH_METRICS, REGISTRY, Metric, get_metrics,
                      URI_TOO_LONG, register, unregister, ratio_metric,
                      exists_metric, count_metric, qap_metric)
from .planner import Plan, plan, plan_single
from .evaluator import AssessmentResult, QualityEvaluator, state_from_numpy
from . import sketches, report

__all__ = [
    "AnyBits", "Cmp", "EqPlanes", "Expr", "HasBits", "And", "Or", "Not",
    "compile_program", "eval_program_torch", "program_stack_depth",
    "ALL_METRICS", "EXTENDED_METRICS", "PAPER_METRICS", "SKETCH_METRICS",
    "REGISTRY", "Metric", "get_metrics", "URI_TOO_LONG",
    "register", "unregister", "ratio_metric", "exists_metric",
    "count_metric", "qap_metric",
    "Plan", "plan", "plan_single",
    "AssessmentResult", "QualityEvaluator", "state_from_numpy",
    "sketches", "report",
]
