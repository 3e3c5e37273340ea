"""One run of one cell: set-up, the measured window, the check, the line.

Set-up, in this order: the planes made on the device from the seed
(``planes.py``); one evaluator per distinct metric set of the mix, built
through the port's public fluent API; each evaluator's kernels got (the
first ``dispatch_chunk`` compiles them with NVRTC or loads their cubins
from ``build/kernels/``) and each plan's request run once; in a traced
run, one short session of the profiler (``trace.warm_profiler``). Nothing
else is warmed.

A request, timed by the host clock from the call to the report text:
``dispatch_chunk`` on the resident planes, ``materialize_chunk`` (which
waits for the scan), ``merge_chunk`` into a fresh state,
``finalize_state`` and ``report.to_json``: ``run_single_shot`` without the
host copy, ending in the DQV report a user receives. One client, closed
loop, for ``seconds``: the last request is the one that starts before the
window's end, and the window ends with its report. The client's thread is
held to one core for the window (the highest the process may use; the
rest of the process, set-up included, runs where the system puts it): the
host half of a request is Python, whose speed moves with the core it is
moved to.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import sys
import time

import numpy as np

from . import check, spec, traffic
from .planes import make_planes

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


@dataclasses.dataclass
class Request:
    k: int                  # index of its metric set
    rows: int
    ns: int                 # host nanoseconds, call to report text
    spans: dict             # benchmark span -> host (start, end) in ns


@dataclasses.dataclass
class Run:
    """What a run measured, as the metric readers see it."""
    sets: list
    requests: list
    window_s: float
    setup_s: float
    setup: dict
    trace: object = None
    plane_table: dict = None
    peaks: dict = None
    device_kind: str = ""

    def bytes_needed(self, k: int) -> int:
        planes = set()
        for m in self.sets[k]:
            planes.update(self.plane_table["planes"][m])
        return self.plane_table["bytes_per_plane"] * len(planes)

    def peak(self, key: str):
        return self.peaks.get(self.device_kind, {}).get(key)


def end_to_end(run: Run) -> dict:
    lat_ms = [r.ns / 1e6 for r in run.requests]
    return {
        "assessed_triples_per_s":
            sum(r.rows for r in run.requests) / run.window_s,
        "assess_ms_p95": float(np.percentile(lat_ms, 95)),
        "setup_s": run.setup_s,
    }


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & FORBIDDEN)


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _evaluators(cell, sets, device):
    from repro_torch import qa
    cfg = cell.config
    return [qa.pipeline().metrics(list(s)).backend(cfg["backend"])
            .fused(cfg["fused"]).hll(cfg["hll_p"]).device(device)
            .evaluator() for s in sets]


def _request(ev, planes, n, spans):
    """One request; ``spans`` collects each call's host clock, ``(start,
    end)`` in nanoseconds."""
    from repro_torch.core import report
    from repro_torch.core.evaluator import QualityEvaluator
    clock = time.perf_counter_ns

    def span(name, fn, *a):
        t = clock()
        out = fn(*a)
        spans[name] = (t, clock())
        return out

    outs = span("dispatch", ev.dispatch_chunk, planes)
    counts, regs = span("materialize", ev.materialize_chunk, outs)
    state = span("merge", lambda: QualityEvaluator.merge_chunk(
        ev.chunk_state_init(), 0, counts, regs))
    result = span("finalize", ev.finalize_state, state, n)
    text = span("report", report.to_json, result)
    return result, text


def set_up(cell: spec.Cell, seed: int, device: str, evs=None):
    """The planes from the seed, then (unless given) the evaluators, their
    kernels and one warm request each: ``(planes, evaluators, parts)``,
    ``parts`` the seconds of the steps. The peak memory counts from the
    planes on, so the generator's temporaries are not the program's."""
    import torch
    n = int(cell.config["triples"])
    parts = {}
    t = time.perf_counter()

    def part(name):
        nonlocal t
        _sync(device)
        now = time.perf_counter()
        parts[name] = parts.get(name, 0.0) + now - t
        t = now

    planes = make_planes(cell.config, seed, device)
    part("planes_s")
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    if evs is None:
        evs = _evaluators(cell, traffic.metric_sets(cell.mix), device)
        part("evaluators_s")
        for ev in evs:
            # no rows: gets the plan's kernel (printed, then compiled with
            # NVRTC or loaded from build/kernels/) and launches nothing
            ev.dispatch_chunk(planes[:0])
            part("kernel_s")
            _request(ev, planes, n, {})         # the one warm request
            part("warm_s")
    return planes, evs, parts


def window(cell: spec.Cell, evs, planes, seed: int, seconds: float,
           profiled: bool = False):
    """The closed loop for ``seconds``, its thread on one core: ``(requests,
    answers, window, marks, profiler, core)``, ``window`` the host clock's
    ``(start, end)`` in nanoseconds. With ``profiled``, under
    ``torch.profiler`` with the CUDA activity, between two marker kernels
    whose launches' host clock is ``marks`` (``trace.py``)."""
    from . import trace
    n = int(cell.config["triples"])
    order = traffic.order(cell.mix, seed)
    requests, answers, marks = [], [], []
    clock = time.perf_counter_ns
    prof = None
    if profiled:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
        trace.settle()
        marks.append(trace.marker(clock, after=False))
    was = os.sched_getaffinity(0)
    core = max(was)
    os.sched_setaffinity(0, {core})
    try:
        t0 = clock()
        deadline = t0 + int(seconds * 1e9)
        while clock() < deadline:
            k = next(order)
            spans: dict = {}
            result, text = _request(evs[k], planes, n, spans)
            requests.append(Request(
                k, n, spans["report"][1] - spans["dispatch"][0], spans))
            answers.append((k, result.counts, result.registers,
                            result.values, text))
        t1 = clock()
    finally:
        os.sched_setaffinity(0, was)
    if prof is not None:
        marks.append(trace.marker(clock, after=True))
        trace.settle()
        prof.__exit__(None, None, None)
    return requests, answers, (t0, t1), marks, prof, core


def reference_answers(cell: spec.Cell, planes, control: bool = False):
    """The reference's ``Answer`` of each metric set of the mix."""
    from .. import reference
    sets = traffic.metric_sets(cell.mix)
    per_metric = reference.assess(planes, [m for s in sets for m in s],
                                  cell.config["hll_p"], control=control)
    return [reference.for_set(per_metric, s) for s in sets]


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, *,
        device: str, t_start: float, root=spec.ROOT,
        parts: dict | None = None) -> dict:
    """Run ``cell`` once; returns the result line's object, with the
    checks' numbers under ``checks``. ``parts``: seconds of set-up already
    spent since ``t_start``, by step, for the set-up line on stderr."""
    import torch

    torch.set_num_threads(1)
    sets = traffic.metric_sets(cell.mix)
    n = int(cell.config["triples"])
    on_card = torch.device(device).type == "cuda"
    parts = dict(parts or {})
    t = time.perf_counter()
    torch.zeros(1, device=device)               # the card's context
    _sync(device)
    parts["context_s"] = time.perf_counter() - t
    planes, evs, more = set_up(cell, seed, device)
    parts.update(more)
    if trace and on_card:
        from .trace import warm_profiler
        t = time.perf_counter()
        warm_profiler()
        parts["profiler_s"] = time.perf_counter() - t
    t = time.perf_counter()
    gc.collect()
    gc.freeze()
    parts["gc_s"] = time.perf_counter() - t
    from repro_torch.kernels import _build
    print("set-up: " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
          + f"; all {time.perf_counter() - t_start:.3f} s; kernels "
          f"{_build.spec_stats}", file=sys.stderr)

    requests, answers, (t0, t1), marks, prof, core = window(
        cell, evs, planes, seed, seconds, profiled=trace and on_card)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"loaded after the window: {found}")

    peak = int(torch.cuda.max_memory_allocated(device)) if on_card else 0
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    del evs
    gc.unfreeze()
    if on_card:
        torch.cuda.empty_cache()
    verdict = check.judge(answers, reference_answers(cell, planes), n,
                          cell.limits)

    meas = Run(sets=sets, requests=requests, window_s=(t1 - t0) / 1e9,
               setup_s=t0 / 1e9 - t_start, setup=parts,
               plane_table=json.loads(
                   (root / "qabench" / "plane_table.json").read_text()),
               peaks=json.loads((root / "qabench" / "peaks.json")
                                .read_text()),
               device_kind=kind)
    per_span = {name: sum(b - a for a, b in (r.spans[name]
                                             for r in requests))
                / 1e6 / max(1, len(requests))
                for name in (requests[0].spans if requests else ())}
    print(f"window: {len(requests)} requests on core {core}; host ms a "
          "request: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                  per_span.items()), file=sys.stderr)
    device_line = {"platform": "gpu" if on_card else "cpu", "kind": kind,
                   "count": cell.chips, "memory_peak_bytes": peak,
                   "window_core": core}
    out = {"correct": verdict["correct"], "attempted": len(requests),
           "failed": verdict["failed"]}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if trace:
        from .trace import reduce
        meas.trace = reduce(prof, [(name, a, b) for r in requests
                                   for name, (a, b) in r.spans.items()],
                            (t0, t1), marks)
        served = meas.trace.scans_by_request(
            [r.spans["dispatch"][0] for r in requests],
            [r.spans["report"][1] for r in requests])
        print(f"trace: {meas.trace.scan_launches} scan kernels, "
              f"{len(served)} of {len(requests)} requests found theirs; "
              f"clock {meas.trace.clock}", file=sys.stderr)
        values = {}
        for m in cell.per_layer:
            v = spec.layer_reader(m["name"], root)(meas)
            if v is not None:
                values[m["name"]] = v
        device_line["busy_s"] = meas.trace.busy_s
        device_line["window_s"] = meas.trace.window_s
    else:
        computed = end_to_end(meas)
        values = {m["name"]: computed[m["name"]] for m in cell.end_to_end}
    out["metrics"] = {k: {"value": v, "unit": units[k]}
                      for k, v in values.items()}
    out["device"] = device_line
    if trace:
        out["breakdown"] = meas.trace.breakdown()
    out["checks"] = check.checks_line(verdict["numbers"], cell.limits)
    return out


def parse(argv):
    ap = argparse.ArgumentParser(prog="qabench/run.py", description=(
        "Run one cell of BENCHMARK.json once and print its result line."))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_start: float) -> int:
    parts = {"imports_s": time.perf_counter() - t_start}
    args = parse(argv)
    cell = spec.load_cell(args.workload)
    t = time.perf_counter()
    # the system under test, from src/
    from repro_torch import qa  # noqa: F401
    from repro_torch.core import evaluator, report  # noqa: F401
    import torch
    parts["port_import_s"] = time.perf_counter() - t
    t = time.perf_counter()
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    parts["cuda_init_s"] = time.perf_counter() - t     # the driver's init
    if have < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); this machine "
              f"has {have}", file=sys.stderr)
        return 2
    out = run(cell, args.seed, args.seconds, bool(args.trace),
              device="cuda", t_start=t_start, parts=parts)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {found}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0

