"""One traced run of a cell, broken down by the program's own spans.

    python qabench/span_breakdown.py --workload <config>.<mix> --seed <n> \
        --seconds <s> [--profile-compile]

Run from the root of a checkout, on a machine with the card. It runs
``harness/cell.py``'s ``run`` with ``--trace 1``, under ``run.py``'s
caches and bytecode folder, with the program's recorder on from the start
(so set-up's spans are kept too), and keeps what ``run`` hands
``trace.reduce``. It prints one JSON object: ``run``'s result line
(``result``); the idle gaps by the innermost program span over each gap
(``idle_gaps_by_span``, summing to the result line's ``idle_gaps``); the
share of scan launch calls that fall inside a ``kernel.launch`` span; the
mean host milliseconds a request spends in each program span; the
program's counters; the milliseconds of set-up in each program span and
in each outside its children in the same thread (``setup_self_ms``); the
milliseconds of the garbage collector's passes in set-up, in all and
inside each program span (``setup_gc_ms``); and what one span costs this
host, recording off and on, against an empty ``with`` (``span_cost_ns``).
With ``--profile-compile`` each evaluator's first ``_compile_scans`` runs
under ``cProfile`` (which slows it, and set-up's spans with it), and the
functions with the most own time there are printed (``compile_profile``).
The result line of a cell is ``run.py``'s; this is a diagnosis of where
its time goes. It goes once ``cell.py``'s traced line carries the
breakdown by program span.
"""
import argparse
import gc
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def span_cost_ns(n: int = 200_000) -> dict:
    """Nanoseconds a ``with tracing.span(...)`` takes, off and on, and an
    empty ``with`` on a shared object (the least a span can cost)."""
    import contextlib
    from repro_torch import tracing
    empty = contextlib.nullcontext()

    def loop(open_):
        t = time.perf_counter_ns()
        for _ in range(n):
            with open_("kernel.check"):
                pass
        return (time.perf_counter_ns() - t) / n

    out = {"empty": loop(lambda name: empty), "off": loop(tracing.span)}
    tracing.enable()
    try:
        out["on"] = loop(tracing.span)
    finally:
        tracing.disable()
        tracing.drain()
    return out


def _profiling_compile():
    """Wrap ``QualityEvaluator._compile_scans`` in one ``cProfile``:
    ``(profile, undo)``."""
    import cProfile
    from repro_torch.core.evaluator import QualityEvaluator
    prof, compile_scans = cProfile.Profile(), QualityEvaluator._compile_scans

    def profiled(self):
        prof.enable()
        try:
            return compile_scans(self)
        finally:
            prof.disable()

    QualityEvaluator._compile_scans = profiled

    def undo():
        QualityEvaluator._compile_scans = compile_scans
    return prof, undo


def _top(prof, n: int = 15) -> list:
    """The ``n`` functions with the most own time in ``prof``: name,
    calls, own ms, cumulative ms."""
    import pstats
    prof.create_stats()
    if not prof.stats:              # no compile ran
        return []
    stats = pstats.Stats(prof).stats
    top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:n]
    return [[f"{f}:{line}({name})", nc, tt * 1e3, ct * 1e3]
            for (f, line, name), (_, nc, tt, ct, _) in top]


def breakdown(cell, seed: int, seconds: float,
              profile_compile: bool = False) -> dict:
    """Run ``cell`` once, traced, on the card and return the object
    ``main`` prints."""
    import torch
    from repro_torch import tracing
    from qabench.harness import cell as cell_mod
    from qabench.harness import program, trace

    seen = {}
    reduce = trace.reduce

    def keep(prof, spans, window, marks):
        seen.update(prof=prof, spans=spans, window=window, marks=marks)
        return reduce(prof, spans, window, marks)

    passes = []                 # the collector's (start, end) in ns

    def collected(phase, info):
        if phase == "start":
            passes.append([time.perf_counter_ns(), None])
        elif passes:
            passes[-1][1] = time.perf_counter_ns()

    cost = span_cost_ns()
    prof, undo = _profiling_compile() if profile_compile else (None, None)
    t_start = time.perf_counter()
    tracing.drain()
    tracing.enable()
    trace.reduce = keep
    gc.callbacks.append(collected)
    try:
        out = cell_mod.run(cell, seed, seconds, True, device="cuda",
                           t_start=t_start)
    finally:
        gc.callbacks.remove(collected)
        trace.reduce = reduce
        tracing.disable()
        if undo:
            undo()
    rec = tracing.drain()
    w0, w1 = seen["window"]
    harness = seen["spans"]
    first = min(a for name, a, _ in harness if name == "dispatch")
    last = max(b for name, _, b in harness if name == "report")
    spans = [s for s in rec.spans if s.start >= first and s.end <= last]
    setup = [s for s in rec.spans if s.end <= w0]
    by_span = program.idle_gaps_by_span(seen["prof"], harness, (w0, w1),
                                        seen["marks"], spans)
    reduced = reduce(seen["prof"], harness, (w0, w1), seen["marks"])
    inside, total = program.launch_coverage(reduced.scans, spans)
    n = sum(name == "dispatch" for name, _, _ in harness)
    means: dict = {}
    for s in spans:
        means[s.name] = means.get(s.name, 0) + s.end - s.start
    setup_ms: dict = {}
    self_ms: dict = {}
    child_ns: dict = {}
    for s in setup:
        if s.parent:
            child_ns[s.parent] = child_ns.get(s.parent, 0) + s.end - s.start
    for s in setup:
        d = s.end - s.start
        setup_ms[s.name] = setup_ms.get(s.name, 0) + d / 1e6
        self_ms[s.name] = (self_ms.get(s.name, 0)
                           + (d - child_ns.get(s.id, 0)) / 1e6)
    gc_setup = [(a, b) for a, b in passes if b is not None and b <= w0]
    gc_ms = {"all": sum(b - a for a, b in gc_setup) / 1e6}
    for s in setup:
        ns = sum(max(0, min(b, s.end) - max(a, s.start))
                 for a, b in gc_setup)
        if ns:
            gc_ms[s.name] = gc_ms.get(s.name, 0) + ns / 1e6
    return {
        "workload": cell.name, "seed": seed, "requests": n,
        "kind": torch.cuda.get_device_name(0), "result": out,
        "idle_gaps_by_span": by_span,
        "idle_total_s": [sum(reduced.idle_gaps.values()),
                         sum(by_span.values())],
        "launch_calls_inside_kernel_launch": [inside, total],
        "kernel_launch_spans": sum(s.name == "kernel.launch"
                                   for s in spans),
        "program_ms_a_request": {k: v / 1e6 / n for k, v in
                                 sorted(means.items())},
        "counters": rec.counters,
        "setup_ms_by_span": setup_ms, "setup_self_ms": self_ms,
        "setup_gc_ms": gc_ms, "span_cost_ns": cost,
        "compile_profile": _top(prof) if prof else None,
    }


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="qabench/span_breakdown.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--profile-compile", action="store_true")
    args = ap.parse_args(argv)
    import torch
    from qabench.harness import spec
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    out = breakdown(spec.load_cell(args.workload), args.seed, args.seconds,
                    args.profile_compile)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import qabench.run  # noqa: E402,F401  run.py's caches and bytecode
    sys.exit(main(sys.argv[1:]))
