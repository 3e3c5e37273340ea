"""The trace's reduction: the device's quantities on the device's clock
between the two marker kernels, the host's spans put on it by the
markers (or, where the profiler lost them, by the launch calls or the
Unix clock), the scan kernels found by their launch calls, and a scan
whose record was lost left out of the roofline share."""
import json
import types

import pytest
import torch

from qabench.harness import cell as cell_mod
from qabench.harness import spec, trace

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU
US = 1_000
OFFSET = 5_000_000_000         # the calls' clock, ahead of the host's
UNIX = OFFSET + 30 * US        # the Unix clock reads 30 us off the calls'


def _event(name, device, start, dur, corr):
    return types.SimpleNamespace(
        name=lambda: name, device_type=lambda: device,
        start_ns=lambda: start, duration_ns=lambda: dur,
        correlation_id=lambda: corr)


def _prof(events):
    return types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))


# host clock, us: the marker before launched at 990-1000 and run at
# 1000-1001; the window 1010-9000; one request: dispatch 1010-1200 (its
# scan launched at 1195-1200), the scan 1200-6200, its copy 6200-6300, the
# report 6300-9000; the marker after launched at 9005-9010, run at
# 9010-9110. The device's records stand ``skew`` off the calls' clock.
MARKS = [(990 * US, 1_000 * US, UNIX), (9_005 * US, 9_010 * US, UNIX)]
WINDOW = (1_010 * US, 9_000 * US)
SPANS = [("dispatch", 1_010 * US, 1_200 * US),
         ("materialize", 1_200 * US, 6_300 * US),
         ("report", 6_300 * US, 9_000 * US)]


def _markers(skew):
    return [_event(trace.MARKER + "(short)", CUDA,
                   OFFSET + skew + 1_000 * US, US, 7),
            _event(trace.MARKER + "(long)", CUDA,
                   OFFSET + skew + 9_010 * US, 100 * US, 9)]


def _work(skew):
    return [_event(trace.SCAN_KERNEL, CUDA, OFFSET + skew + 1_200 * US,
                   5_000 * US, 8),
            _event("Memcpy DtoH", CUDA, OFFSET + skew + 6_200 * US,
                   100 * US, 10)]


CALLS = [_event("cudaLaunchKernel", CPU, OFFSET + 992 * US, 6 * US, 7),
         _event("cuLaunchKernel", CPU, OFFSET + 1_195 * US, 5 * US, 8),
         _event("cudaMemcpyAsync", CPU, OFFSET + 1_205 * US, 5 * US, 10),
         _event("cudaLaunchKernel", CPU, OFFSET + 9_006 * US, 3 * US, 9)]


ONE = "one marker, the Unix clock's rate"


@pytest.mark.parametrize("kept,calls,skew,device,calls_how", [
    ((0, 1), True, 0, "device two markers", "two markers"),
    ((0,), True, 0, "device " + ONE, "two markers"),
    ((1,), True, 0, "device " + ONE, "two markers"),
    ((), True, 0, "device by calls two markers", "two markers"),
    ((0, 1), False, 0, "device two markers", "no marker: the Unix clock"),
    ((0, 1), True, 3_000 * US, "device two markers", "two markers"),
    ((0, 1), True, -3_000 * US, "device two markers", "two markers"),
])
def test_reduce_on_the_trace_clock(kept, calls, skew, device, calls_how):
    events = ([_markers(skew)[i] for i in kept] + _work(skew)
              + (CALLS if calls else []))
    t = trace.reduce(_prof(events), SPANS, WINDOW, MARKS)
    assert t.clock.startswith(device + ":")
    assert "; calls " + calls_how + ":" in t.clock
    assert t.window_s == pytest.approx(8e-3, rel=3e-3)
    assert t.busy_s == pytest.approx(5.1e-3, rel=1e-2)
    assert t.scan_s == pytest.approx(5e-3) and t.scan_launches == 1
    assert trace.MARKER not in " ".join(t.ops)
    assert t.idle_gaps["report"] == pytest.approx(2.7e-3, rel=2e-2)
    assert t.idle_gaps["dispatch"] == pytest.approx(0.19e-3, rel=0.2)
    found = t.scans_by_request([WINDOW[0]], [WINDOW[1]])
    assert found == ({0: pytest.approx(5e-3)} if calls else {})


def test_reduce_refuses_two_markers_of_a_kind():
    events = [_markers(0)[0], _markers(0)[0]] + _work(0)
    with pytest.raises(RuntimeError, match="marker"):
        trace.reduce(_prof(events), SPANS, WINDOW, MARKS)


def _two_requests(lose_first_scan: bool):
    """Two requests of 8 ms each; the first asks for L1, the second for
    RC1; each scan 5 ms, launched 0.2 ms into its request."""
    events, spans, reqs = list(_markers(0)), [], []
    marks = [MARKS[0], (17_005 * US, 17_010 * US, UNIX)]
    events[1] = _event(trace.MARKER + "(long)", CUDA,
                       OFFSET + 17_010 * US, 100 * US, 9)
    events += [_event("cudaLaunchKernel", CPU, OFFSET + 992 * US, 6 * US, 7),
               _event("cudaLaunchKernel", CPU, OFFSET + 17_006 * US, 3 * US,
                      9)]
    for i in range(2):
        t0 = (1_010 + 8_000 * i) * US
        corr = 20 + i
        events.append(_event("cuLaunchKernel", CPU, OFFSET + t0 + 195 * US,
                             5 * US, corr))
        if not (i == 0 and lose_first_scan):
            events.append(_event(trace.SCAN_KERNEL, CUDA,
                                 OFFSET + t0 + 200 * US, 5_000 * US, corr))
        s = {"dispatch": (t0, t0 + 200 * US),
             "materialize": (t0 + 200 * US, t0 + 5_300 * US),
             "report": (t0 + 5_300 * US, t0 + 7_990 * US)}
        spans += [(n, a, b) for n, (a, b) in s.items()]
        reqs.append(cell_mod.Request(i, 1_000_000, 7_990 * US, s))
    t = trace.reduce(_prof(events), spans, (1_010 * US, 17_000 * US), marks)
    return t, reqs


@pytest.mark.parametrize("lose", [False, True])
def test_a_lost_scan_leaves_its_request_out(lose):
    t, reqs = _two_requests(lose)
    assert t.scan_launches == (1 if lose else 2)
    run = cell_mod.Run(
        sets=[("L1",), ("RC1",)], requests=reqs, window_s=16e-3,
        setup_s=1.0, setup={}, trace=t,
        plane_table=json.loads((spec.HERE / "plane_table.json").read_text()),
        peaks={"card": {"hbm_bytes_per_s": 1e12}}, device_kind="card")
    share = spec.layer_reader("scan_bw_share")(run)
    served = [1] if lose else [0, 1]
    need = sum(1_000_000 * run.bytes_needed(i) for i in served)
    assert share == pytest.approx(100 * need / 1e12 / (5e-3 * len(served)))
