"""The program's own spans and counters (``repro_torch.tracing``) in a
traced run, for the per-layer metrics that read them.

The port records its spans while a ``torch.profiler`` session runs, so a
traced window holds them with no call from the harness; its counters
(the kernel build's ``kernel.build_ns``) are kept always. The readers
read the recorder without clearing it (``drain(clear=False)``), each for
itself, so no reader depends on another having run. A program without
the recorder (a checkout before it) has nothing to read: every function
here then returns ``None``, and the metrics that read them are left out
of the line. A program with the recorder that recorded no span in a
profiled window with scans raises: its switch has failed, and the
metrics would be left out in silence.
"""
from __future__ import annotations

import bisect

try:
    from repro_torch import tracing
except ImportError:         # a program without the recorder
    tracing = None

LAUNCH_PATH = ("kernel.check", "kernel.outputs", "kernel.source",
               "kernel.get", "kernel.launch")
BUILD_BUSY = "kernel.build_ns"


def record(run):
    """The recorder's ``Record`` (spans and counters so far, left in
    place), or None where the program has no recorder."""
    if tracing is None:
        return None
    rec = tracing.drain(clear=False)
    if not rec.spans and run.requests and run.trace and run.trace.scans:
        raise RuntimeError(
            "the program has repro_torch.tracing but recorded no span in a "
            "profiled window: its torch.profiler switch has failed")
    return rec


def window_spans(run):
    """The program's spans between the window's first request's call and
    its last report, or None where there are none."""
    rec = record(run)
    if rec is None or not run.requests:
        return None
    w0 = run.requests[0].spans["dispatch"][0]
    w1 = run.requests[-1].spans["report"][1]
    spans = [s for s in rec.spans if s.start >= w0 and s.end <= w1]
    return spans or None


def total_ns(spans, names) -> int:
    names = frozenset(names)
    return sum(s.end - s.start for s in spans if s.name in names)


def per_request_ms(run, name: str):
    """Mean milliseconds a request of the window spends in the spans
    ``name``; None without program spans."""
    spans = window_spans(run)
    if spans is None:
        return None
    return total_ns(spans, (name,)) / 1e6 / len(run.requests)


def by_request(run, spans) -> dict:
    """``spans`` grouped by the request whose host span (its call to its
    report) holds their start, by the request's index."""
    starts = [r.spans["dispatch"][0] for r in run.requests]
    out: dict = {}
    for s in spans:
        i = bisect.bisect_right(starts, s.start) - 1
        if i >= 0 and s.end <= run.requests[i].spans["report"][1]:
            out.setdefault(i, []).append(s)
    return out


def scans_end(run) -> dict:
    """Each request's last scan kernel's end on the host's clock, by the
    request's index: the kernels in the order of their launch calls, each
    starting at its call (the card idle) or at the end of the one before,
    and running its device time. A scan whose launch call the profiler
    lost is left out, and a request with no other has no entry."""
    starts = [r.spans["dispatch"][0] for r in run.requests]
    ends = [r.spans["report"][1] for r in run.requests]
    out: dict = {}
    for h, s in sorted((h, s) for h, s in run.trace.scans if h is not None):
        i = bisect.bisect_right(starts, h) - 1
        if i >= 0 and h <= ends[i]:
            out[i] = max(out.get(i, h), h) + s * 1e9
    return out


def launch_coverage(scans, spans) -> tuple[int, int]:
    """``(inside, total)``: of the scan kernels ``scans`` (``Trace.scans``)
    with a launch call, those whose call falls inside one of the program's
    ``kernel.launch`` spans among ``spans``."""
    launches = sorted((s.start, s.end) for s in spans
                      if s.name == "kernel.launch")
    starts = [a for a, _ in launches]
    inside = total = 0
    for h, _ in scans:
        if h is None:
            continue
        total += 1
        i = bisect.bisect_right(starts, h) - 1
        inside += i >= 0 and h <= launches[i][1]
    return inside, total


def flatten(spans) -> list[tuple[str, int, int]]:
    """Nested spans ``(name, start, end)`` as disjoint pieces, each named
    by the innermost span over it: a span that starts later inside
    another is its child (one that outlasts its parent is cut at the
    parent's end)."""
    out, stack, t = [], [], 0
    for name, a, b in sorted(spans, key=lambda s: (s[1], -s[2])):
        while stack and stack[-1][1] <= a:
            top, end = stack.pop()
            out.append((top, t, end))
            t = end
        if stack:
            out.append((stack[-1][0], t, a))
            b = min(b, stack[-1][1])
        stack.append((name, b))
        t = a
    while stack:
        top, end = stack.pop()
        out.append((top, t, end))
        t = end
    return [(n, a, b) for n, a, b in out if b > a]


def idle_gaps_by_span(prof, harness_spans, window, marks, program_spans):
    """The idle gaps of a traced window (``trace.reduce``'s, each placed by
    the launch call of the op that ends it) by the innermost program span
    over them, else the benchmark's host span, else ``loop``: seconds by
    span name, summing to the same total as ``Trace.idle_gaps``."""
    from .trace import reduce
    pieces = flatten(list(harness_spans) + [(s.name, s.start, s.end)
                                            for s in program_spans])
    return reduce(prof, pieces, window, marks).idle_gaps
