"""Fused multi-metric planner.

The paper's Algorithm 1 evaluates metrics one-by-one over the persisted RDD;
its §6 future work asks for "dependency analysis in order to evaluate multiple
metrics simultaneously". On TPU the scan is HBM-bound, so this is the single
biggest optimization: the planner deduplicates structurally-identical counters
across metrics (e.g. ``count(triples)`` is shared by I2/U1/RC1/CN2/…) and
compiles ALL counters into ONE bytecode program → one pass over the data.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

from .expr import Expr, compile_program, program_stack_depth
from .metrics import Metric


@dataclasses.dataclass(frozen=True)
class Plan:
    metrics: tuple[Metric, ...]
    exprs: tuple[Expr, ...]                 # unique counters, evaluation order
    program: tuple[tuple[int, int, int], ...]
    stack_depth: int
    # metric name -> counter name -> index into exprs
    slots: Mapping[str, Mapping[str, int]]
    # unique sketch requirements: name -> columns
    sketch_specs: tuple[tuple[str, tuple[int, ...]], ...]

    @property
    def n_counters(self) -> int:
        return len(self.exprs)

    def finalize(self, counts: Sequence[int],
                 sketch_estimates: Mapping[str, float] | None = None
                 ) -> dict[str, float]:
        """Combine raw counter values into final metric values."""
        out = {}
        for m in self.metrics:
            c = {name: int(counts[self.slots[m.name][name]])
                 for name, _ in m.counters}
            if sketch_estimates:
                for sname, _ in m.sketches:
                    key = "sketch:" + sname
                    if key in sketch_estimates:
                        c[key] = sketch_estimates[key]
            out[m.name] = m.finalize(c)
        return out


def plan(metrics: Sequence[Metric]) -> Plan:
    """Deduplicate counters across metrics and compile one fused program."""
    expr_index: dict[Expr, int] = {}
    exprs: list[Expr] = []
    slots: dict[str, dict[str, int]] = {}
    sketch_specs: dict[str, tuple[int, ...]] = {}
    for m in metrics:
        mslots = {}
        for cname, e in m.counters:
            idx = expr_index.get(e)
            if idx is None:
                idx = len(exprs)
                expr_index[e] = idx
                exprs.append(e)
            mslots[cname] = idx
        slots[m.name] = mslots
        for sname, cols in m.sketches:
            prev = sketch_specs.get(sname)
            assert prev is None or prev == cols, f"sketch {sname} conflict"
            sketch_specs[sname] = cols
    program = compile_program(exprs)
    return Plan(metrics=tuple(metrics), exprs=tuple(exprs), program=program,
                stack_depth=program_stack_depth(program), slots=slots,
                sketch_specs=tuple(sketch_specs.items()))


def plan_single(metric: Metric) -> Plan:
    """Paper-faithful: one plan (one pass) per metric (Algorithm 1 loop)."""
    return plan([metric])
