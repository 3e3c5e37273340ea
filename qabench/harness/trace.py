"""What the profiler's trace of a window says: the device's busy time, each
device operation's time, the scan kernels with the requests they served,
and the idle gaps by what the host was doing.

The window is ``torch.profiler`` over the closed loop with the CUDA
activity alone: the device's kernels, copies and fills and the runtime's
calls, and none of the host's operators, whose recording would slow the
host half of a request. A marker kernel (``torch.cuda._sleep``) is
launched on the idle card just before the window and a longer one just
after it, each between two reads of the host clock. Set-up runs one short
session of the profiler before the window's (``warm_profiler``).

The trace has two clocks. The runtime's calls are stamped on the host's
side, on a clock that runs straight against the host's once the profiler
has had a session in the process; the device's records on the device's,
which CUPTI converts to the host's side and which bends against it by
milliseconds within a window (on the H100, a window's first scan kernel
has read 3.3 ms before the call that launched it, and the two markers'
fit has put the device's rate 7e-4 off the host's). So each device
quantity is taken on the device's clock alone: the window there runs from
the end of the marker before it to the start of the marker after it,
which holds the window's device work and nothing else. The host's side
comes in through the calls, mapped onto the host's clock by the markers'
launch calls: a scan kernel's launch call finds the request that made it,
and each idle gap is put on the host's clock by the launch call of the op
that ends it (on an idle card an op starts as its launch returns), where
the benchmark's host spans (``perf_counter_ns`` around its calls into the
port, as an untraced run takes them) say what the host was doing.

The profiler can lose a record (on the H100, a marker kernel and one or
two scan kernels in 3 of 25 traced windows before the profiler was given
``SETTLE_S`` around the markers, none in 33 since). A lost marker's
launch call is still the first or the last kernel launch of the trace,
as nothing else is launched within ``SETTLE_S`` of the window; a map
with one point takes its rate from the Unix clock against the host's,
and one with none takes the trace's clock to be the Unix clock (as the
profiler's is). A lost scan kernel leaves its request out of
``scan_bw_share``'s bytes and time alike; a gap whose op has no launch
call goes onto the host's clock by the markers' device records.
"""
from __future__ import annotations

import bisect
import dataclasses

MARKER = "spin_kernel"         # torch.cuda._sleep's kernel
MARKER_CYCLES = (1_000, 200_000)    # before the window, after it
LONG_NS = 20_000               # the marker after the window runs longer
SETTLE_S = 0.05                # host time around the markers, launch-free
SCAN_KERNEL = "scan_spec"      # the plan-specialized scan kernel's entry
LAUNCH = "LaunchKernel"        # in the name of a kernel launch call
TOP = 10


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    ops: dict                  # device op name -> seconds
    scan_s: float              # the scan kernels' device seconds
    scan_launches: int
    idle_gaps: dict            # host span name -> idle device seconds
    scans: list = dataclasses.field(default_factory=list)
    # ^ each scan kernel: (host ns of its launch call or None, seconds)
    clock: str = "host"        # how the host's spans were put on the trace

    def breakdown(self) -> dict:
        def top(d):
            return [[n, s] for n, s in sorted(d.items(),
                                              key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(self.ops), "idle_gaps": top(self.idle_gaps)}

    def scans_by_request(self, starts, ends) -> dict:
        """The seconds of scan kernels whose launch call lies in request
        ``i``'s span ``(starts[i], ends[i])`` on the host clock, by ``i``
        (``starts`` sorted); a scan with no launch call, or one outside
        every span, is in none."""
        out: dict = {}
        for h, s in self.scans:
            if h is None:
                continue
            i = bisect.bisect_right(starts, h) - 1
            if i >= 0 and h <= ends[i]:
                out[i] = out.get(i, 0.0) + s
        return out


def marker(clock, after: bool) -> tuple[int, int, int]:
    """Launch one marker kernel on an idle card (the longer one ``after``
    the window): the host clock just before and just after the launch,
    and the Unix clock beside it."""
    import time
    import torch
    torch.cuda.synchronize()
    a = clock()
    torch.cuda._sleep(MARKER_CYCLES[after])
    b = clock()
    unix = time.time_ns()
    torch.cuda.synchronize()
    return a, b, unix - (b + clock()) // 2


def warm_profiler() -> None:
    """One short session of the profiler, in set-up: the first session in
    a process stamps the runtime's calls on a clock that does not run
    straight against the host's (on the H100, with the two markers' fit,
    4-8% of a window's scan launches fell outside their request), where
    later sessions' clocks do (none did)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(MARKER_CYCLES[0])
        torch.cuda.synchronize()
    prof.profiler.kineto_results.events()


def settle() -> None:
    """Host time with no launch, between the profiler's start or stop and
    the nearest marker, so that a marker's launch call is the first or
    the last of the trace."""
    import time
    time.sleep(SETTLE_S)


def _union(spans) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _covered(gaps, spans) -> int:
    """Nanoseconds of ``gaps`` that the sorted, disjoint ``spans`` cover."""
    tot, j = 0, 0
    for ga, gb in gaps:
        while j < len(spans) and spans[j][1] <= ga:
            j += 1
        k = j
        while k < len(spans) and spans[k][0] < gb:
            tot += min(gb, spans[k][1]) - max(ga, spans[k][0])
            k += 1
    return tot


def _overlaps(gaps, spans) -> dict:
    """Seconds of the idle ``gaps`` that each named host span covers; what
    no benchmark span covers is the loop's own."""
    by_name: dict = {}
    for name, a, b in spans:
        by_name.setdefault(name, []).append((a, b))
    out = {name: _covered(gaps, _union(ss)) / 1e9
           for name, ss in by_name.items()}
    rest = sum(b - a for a, b in gaps) - _covered(gaps, _union(
        (a, b) for _, a, b in spans))
    out["loop"] = rest / 1e9
    return {k: v for k, v in out.items() if v > 0}


def _line(marks, points, what: str):
    """The map from the host clock to a trace clock and its inverse, from
    ``points`` (side, trace time) of the markers found: ``marks`` the
    host's (before, after, Unix - host) of the two launches."""
    (h0, _, u0), (h1, _, u1) = marks
    unix_rate = 1 + (u1 - u0) / (h1 - h0)
    pts = [((marks[s][0] + marks[s][1]) / 2, k) for s, k in sorted(points)]
    if len(pts) == 2:
        (h0, k0), (h1, k1) = pts
        slope, how = (k1 - k0) / (h1 - h0), "two markers"
    elif pts:
        (h0, k0), = pts
        slope, how = unix_rate, "one marker, the Unix clock's rate"
    else:
        k0, slope, how = h0 + u0, unix_rate, "no marker: the Unix clock"
    return (lambda h: k0 + (h - h0) * slope,
            lambda k: h0 + (k - k0) / slope,
            f"{what} {how}: trace - host {(k0 - h0) / 1e3:.1f} us, drift "
            f"{slope - 1:.2e}")


def _sides(marked) -> dict:
    """The device's marker records ``(start, end, corr)`` by side: 0 the
    short one before the window, 1 the long one after it."""
    sides = [int(b - a >= LONG_NS) for a, b, _ in marked]
    if len(set(sides)) < len(sides):
        raise RuntimeError("two marker kernels of one kind in the trace")
    return dict(zip(sides, marked))


def reduce(prof, spans, window, marks) -> Trace:
    """The ``Trace`` of a window: ``prof`` a finished ``torch.profiler``
    profile with the CUDA activity (None where there is no card, and then
    no device op), ``spans`` the benchmark's host spans ``(name, start,
    end)``, ``window`` its ``(start, end)`` and ``marks`` the ``(before,
    after, Unix - host)`` of each marker's launch (``marker``), all on
    the host's nanosecond clock."""
    dev, calls = [], []
    if prof is not None:
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        for e in prof.profiler.kineto_results.events():
            a = e.start_ns()
            rec = (e.name(), e.correlation_id(), a, a + e.duration_ns())
            if e.device_type() == cuda:
                dev.append(rec)
            elif e.correlation_id():
                calls.append(rec)
    if prof is None:
        def to_dev(h):
            return h
        from_dev = from_call = to_dev
        clock, w0, w1, after = "host", window[0], window[1], None
    else:
        if len(marks) != 2:
            raise RuntimeError(f"{len(marks)} markers launched, not 2")
        found = _sides(sorted((a, b, c) for n, c, a, b in dev
                              if MARKER in n))
        by_corr = {c: (a, b) for _, c, a, b in calls}
        launches = sorted((a, b) for n, _, a, b in calls if LAUNCH in n)
        call_points = []
        for side in (0, 1):
            if side in found and found[side][2] in by_corr:
                a, b = by_corr[found[side][2]]
            elif launches:
                a, b = launches[-side]      # first before, last after
            else:
                continue
            call_points.append((side, (a + b) / 2))
        _, from_call, c_how = _line(marks, call_points, "calls")
        dev_points = [(side, a) for side, (a, _, _) in found.items()]
        if dev_points:
            to_dev, from_dev, d_how = _line(marks, dev_points, "device")
        else:
            to_dev, from_dev, d_how = _line(marks, call_points,
                                            "device by calls")
        clock = f"{d_how}; {c_how}"
        w0 = found[0][1] if 0 in found else to_dev(window[0])
        w1 = found[1][0] if 1 in found else to_dev(window[1])
        after = marks[1][1] if 1 in found else None
    dev = sorted((a, b, n, c) for n, c, a, b in dev
                 if MARKER not in n and b > w0 and a < w1)
    dev = [(max(a, w0), min(b, w1), n, c) for a, b, n, c in dev]
    ops: dict = {}
    for a, b, n, _ in dev:
        ops[n] = ops.get(n, 0.0) + (b - a) / 1e9
    # each idle gap on the host's clock, anchored at the launch call of the
    # op that ends it (the marker after the window for the last): on an
    # idle card an op starts as its launch returns
    call_end = {c: from_call(b) for _, c, a, b in calls}
    gaps, t, busy_ns = [], w0, 0
    for a, b, _, c in dev + [(w1, w1, None, None)]:
        if a > t:
            end = call_end.get(c) if c is not None else after
            gaps.append((end - (a - t), end) if end is not None
                        else (from_dev(t), from_dev(a)))
        busy_ns += max(0, b - max(a, t))
        t = max(t, b)
    mid = {c: (from_call(a) + from_call(b)) / 2 for _, c, a, b in calls}
    scans = [(mid.get(c), (b - a) / 1e9) for a, b, n, c in dev
             if n == SCAN_KERNEL]
    return Trace(window_s=(w1 - w0) / 1e9, busy_s=busy_ns / 1e9, ops=ops,
                 scan_s=sum(s for _, s in scans), scan_launches=len(scans),
                 idle_gaps=_overlaps(gaps, spans), scans=scans, clock=clock)
