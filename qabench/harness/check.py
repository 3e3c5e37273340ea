"""The comparison that decides ``correct``.

Every request of the window is judged: the counters and register banks
the planner's program and the scan kernel produced (``result.counts``,
``result.registers``), the metric values ``finalize_state`` made of them
(``result.values``), and the values, ``nTriples`` and ``passes`` of the
DQV report text the request returned. Requests for one metric set over
the same planes must all say the same, so equal answers are compared once
and counted as many times as they came.

The numbers, each against its limit (``limits/default.json``):

* ``counters_off``: counters, over all requests, that differ from the
  reference's exact count (limit 0);
* ``registers_off``: HLL registers that differ from the reference's bank,
  every register of a bank of another size (limit 0);
* ``value_gap``: the largest relative gap between a value of
  ``finalize_state`` and the reference's (float32 rounding of the
  estimator where a metric reads a sketch; 0 elsewhere);
* ``report_gap``: the same for the values the report carries;
* ``report_off``: reports whose metric names, ``nTriples`` or ``passes``
  (1: one scan a plan) are not the reference's (limit 0).
"""
from __future__ import annotations

import json
import math

import numpy as np

DQV = "http://www.w3.org/ns/dqv#"
METRIC_URN = "urn:repro:metric:"
NUMBERS = ("counters_off", "registers_off", "value_gap", "report_gap",
           "report_off")


def rel_gap(a, r) -> float:
    if a is None:
        return math.inf
    a, r = float(a), float(r)
    if a == r:
        return 0.0
    return abs(a - r) / abs(r) if r else math.inf


def report_fields(text: str) -> tuple[dict, int, int]:
    """The metric values, ``nTriples`` and ``passes`` of a DQV report."""
    rep = json.loads(text)
    values = {}
    for m in rep["measurements"]:
        name = m[DQV + "isMeasurementOf"]["@id"]
        values[name[len(METRIC_URN):] if name.startswith(METRIC_URN)
               else name] = m[DQV + "value"]
    return values, rep["nTriples"], rep["passes"]


def _key(k, counts, registers, values, text) -> tuple:
    rv, nt, passes = report_fields(text)
    return (k, json.dumps(counts, sort_keys=True),
            tuple(sorted((s, np.asarray(r).tobytes())
                         for s, r in registers.items())),
            json.dumps({m: repr(v) for m, v in sorted(values.items())}),
            json.dumps({m: repr(v) for m, v in sorted(rv.items())}),
            nt, passes)


def judge_one(counts, registers, values, text, ref, n_triples: int) -> dict:
    """One answer against the reference's ``Answer`` for its set."""
    off = 0
    for m, cs in ref.counts.items():
        got = counts.get(m, {})
        off += sum(got.get(c) != v for c, v in cs.items())
    reg_off = 0
    for s, want in ref.registers.items():
        got = registers.get(s)
        if got is None or np.shape(got) != want.shape:
            reg_off += max(want.size, np.size(got) if got is not None else 0)
        else:
            reg_off += int(np.sum(np.asarray(got) != want))
    vgap = max((rel_gap(values.get(m), v) for m, v in ref.values.items()),
               default=0.0)
    rv, nt, passes = report_fields(text)
    rgap = max((rel_gap(rv.get(m), v) for m, v in ref.values.items()),
               default=0.0)
    rep_off = int(set(rv) != set(ref.values) or nt != n_triples
                  or passes != 1)
    return {"counters_off": off, "registers_off": reg_off,
            "value_gap": vgap, "report_gap": rgap, "report_off": rep_off}


def judge(answers, refs, n_triples: int, limits: dict) -> dict:
    """``answers``: ``(set index, counts, registers, values, report text)``
    of each request; ``refs``: the reference's ``Answer`` of each set.
    Returns the numbers, the requests that failed, and ``correct``."""
    groups: dict = {}
    for a in answers:
        key = _key(*a)
        if key in groups:
            groups[key][1] += 1
        else:
            groups[key] = [a, 1]
    total = {n: 0 for n in NUMBERS}
    failed = 0
    for (k, counts, registers, values, text), times in groups.values():
        one = judge_one(counts, registers, values, text, refs[k], n_triples)
        for n in NUMBERS:
            if n.endswith("_gap"):
                total[n] = max(total[n], one[n])
            else:
                total[n] += one[n] * times
        if any(one[n] > limits[n] for n in NUMBERS):
            failed += times
    correct = bool(answers) and failed == 0 and all(
        total[n] <= limits[n] for n in NUMBERS)
    return {"numbers": total, "failed": failed, "correct": correct}


def checks_line(numbers: dict, limits: dict) -> dict:
    """Each number beside its limit, for the result line (JSON-safe)."""
    def num(x):
        return "inf" if isinstance(x, float) and math.isinf(x) else x
    return {n: {"value": num(numbers[n]), "limit": limits[n]}
            for n in NUMBERS}
