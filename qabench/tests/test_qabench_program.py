"""The readers of the program's own spans and counters
(``harness/program.py``, ``repro_torch.tracing``): nothing to read
without them, their values on a synthetic run, the idle gaps by program
span on the synthetic trace of ``test_qabench_trace.py``, and on the card
the scan kernels' launch calls inside the program's ``kernel.launch``
spans."""
import dataclasses
import json
import time
import types

import pytest

import test_qabench_trace as synth
from qabench.harness import cell as cell_mod
from qabench.harness import program, spec, trace
from repro_torch import tracing

NEW = ("launch_host_ms", "copy_host_ms", "hll_estimate_ms", "kernel_get_s",
       "scan_read_bw_share")
US = synth.US


def _span(name, a, b, value=0, parent=0):
    return tracing.Span(name, a * US, b * US, 1, 0, parent, 0, value)


def _two_request_run(lose_first_scan=False):
    """``test_qabench_trace``'s two requests of 8 ms, 5 ms of scan each,
    with the program's spans of each request and the set-up's counters."""
    t, reqs = synth._two_requests(lose_first_scan)
    spans = []
    for i in range(2):
        t0 = 1_010 + 8_000 * i
        spans += [_span("kernel.check", t0 + 10, t0 + 30),
                  _span("kernel.outputs", t0 + 30, t0 + 50),
                  _span("kernel.source", t0 + 50, t0 + 60),
                  _span("kernel.get", t0 + 60, t0 + 70),
                  _span("kernel.launch", t0 + 170, t0 + 200,
                        1_000_000 * 52),
                  _span("evaluator.materialize", t0 + 200, t0 + 5_300),
                  _span("sketches.estimate", t0 + 5_400, t0 + 5_700)]
    spans.append(_span("evaluator.materialize", 20_000, 21_000))  # after
    rec = tracing.Record(spans, {"kernel.build_ns": 51_000_000})
    run = cell_mod.Run(
        sets=[("L1",), ("RC1",)], requests=reqs, window_s=16e-3,
        setup_s=1.0, setup={}, trace=t,
        plane_table=json.loads((spec.HERE / "plane_table.json").read_text()),
        peaks={"card": {"hbm_bytes_per_s": 1e12}}, device_kind="card")
    return run, rec


@pytest.fixture
def recorded(monkeypatch):
    """``recorded(rec)``: the recorder holds ``rec``."""
    def use(rec):
        monkeypatch.setattr(program, "tracing", types.SimpleNamespace(
            drain=lambda clear=True: rec))
    return use


@pytest.mark.parametrize("name", NEW)
@pytest.mark.parametrize("how", ["no recorder", "nothing recorded"])
def test_nothing_to_read(monkeypatch, recorded, name, how):
    run, _ = _two_request_run()
    if how == "no recorder":
        monkeypatch.setattr(program, "tracing", None)
    else:                       # as on the CPU: no scan in the trace
        run.trace = dataclasses.replace(run.trace, scans=[])
        recorded(tracing.Record([], {}))
    assert spec.layer_reader(name)(run) is None


@pytest.mark.parametrize("name", NEW)
def test_a_profiled_window_without_spans_fails_loudly(recorded, name):
    """A program with the recorder whose profiled window with scans holds
    no span has lost its switch: the reader raises, not returns None."""
    run, _ = _two_request_run()
    recorded(tracing.Record([], {"kernel.build_ns": 1}))
    with pytest.raises(RuntimeError, match="recorded no span"):
        spec.layer_reader(name)(run)


@pytest.mark.parametrize("name,want", [
    ("launch_host_ms", (20 + 20 + 10 + 10 + 30) / 1e3),
    ("copy_host_ms", 0.1025),   # materialize after the scan's end
    ("hll_estimate_ms", 0.3),
    ("kernel_get_s", 0.051),
    ("scan_read_bw_share", 100 * 52e6 / 1e12 / 5e-3),
])
def test_reads_the_program(recorded, name, want):
    run, rec = _two_request_run()
    recorded(rec)
    assert spec.layer_reader(name)(run) == pytest.approx(want)


def test_read_share_is_the_need_share_scaled(recorded):
    """Where each launch reads 52 B a row, the read share is
    ``scan_bw_share`` × 52 / the bytes a row the request needs, and a
    request whose scan record was lost counts in neither."""
    for lose in (False, True):
        run, rec = _two_request_run(lose)
        recorded(rec)
        need = spec.layer_reader("scan_bw_share")(run)
        read = spec.layer_reader("scan_read_bw_share")(run)
        if lose:
            assert need * 52 / run.bytes_needed(1) == pytest.approx(read)
        else:
            assert need < read <= 100 * 52e6 / 1e12 / 5e-3 + 1e-9


def test_readers_leave_the_record_in_place(recorded, capsys):
    """Every reader reads the recorder without clearing it, so none
    depends on the order they run in; the read share alone prints the
    launch calls' share inside ``kernel.launch``."""
    run, rec = _two_request_run()
    calls = []
    recorded(rec)
    drain = program.tracing.drain
    program.tracing.drain = lambda clear=True: calls.append(clear) or drain()
    first = {name: spec.layer_reader(name)(run) for name in NEW}
    assert calls and not any(calls)
    assert first == {name: spec.layer_reader(name)(run)
                     for name in reversed(NEW)}
    err = capsys.readouterr().err
    assert err.count("program spans:") == 2
    assert ("14 in the window, 0 dropped; scan launch calls inside "
            "kernel.launch: 2 of 2 (100.00%)") in err


@pytest.mark.parametrize("scans,want", [
    ([(1_200, 5_000)], {0: 6_200}),
    ([(1_200, 5_000), (1_300, 1_000)], {0: 7_200}),  # queued behind
    ([(1_200, 50), (1_300, 100)], {0: 1_400}),       # the card idle
    ([(None, 5_000), (9_100, 10)], {1: 9_110}),      # a lost call
])
def test_scans_end_runs_each_scan_from_its_call(scans, want):
    run, _ = _two_request_run()
    run.trace = dataclasses.replace(
        run.trace, scans=[(h if h is None else h * US, s * US / 1e9)
                          for h, s in scans])
    assert {i: e / US for i, e in program.scans_end(run).items()} == (
        pytest.approx(want))


@pytest.mark.parametrize("spans,want", [
    ([("p", 0, 10), ("c", 2, 5), ("d", 6, 8)],
     [("p", 0, 2), ("c", 2, 5), ("p", 5, 6), ("d", 6, 8), ("p", 8, 10)]),
    ([("a", 0, 3), ("b", 5, 7)], [("a", 0, 3), ("b", 5, 7)]),
    ([("p", 0, 10), ("c", 0, 4), ("g", 1, 2)],
     [("c", 0, 1), ("g", 1, 2), ("c", 2, 4), ("p", 4, 10)]),
    ([("p", 0, 5), ("c", 3, 9)], [("p", 0, 3), ("c", 3, 5)]),
])
def test_flatten_names_each_piece_by_its_innermost_span(spans, want):
    assert program.flatten(spans) == want


@pytest.mark.parametrize("skew", [0, 3_000 * US])
def test_idle_gaps_by_span_sum_to_idle_gaps(skew):
    events = synth._markers(skew) + synth._work(skew) + synth.CALLS
    prof = synth._prof(events)
    t = trace.reduce(prof, synth.SPANS, synth.WINDOW, synth.MARKS)
    mine = [_span("evaluator.dispatch", 1_020, 1_199),
            _span("kernel.launch", 1_190, 1_199),
            _span("report.to_json", 6_310, 8_990),
            _span("report.encode", 7_000, 8_990)]
    by = program.idle_gaps_by_span(prof, synth.SPANS, synth.WINDOW,
                                   synth.MARKS, mine)
    assert sum(by.values()) == pytest.approx(sum(t.idle_gaps.values()),
                                             abs=1e-9)
    assert by["report.encode"] == pytest.approx(1.99e-3, rel=2e-2)
    assert by["report.to_json"] == pytest.approx(0.69e-3, rel=5e-2)
    assert by["kernel.launch"] == pytest.approx(9e-6, rel=0.5)
    assert "materialize" not in by


def test_cpu_run_with_the_recorder_on(small_cell):
    """On the CPU the recorder on reads the host-side metrics; with no
    card there is no scan launch and no module load to read."""
    tracing.enable()
    try:
        out = cell_mod.run(small_cell("bsbm_20gb.report_all"), 2**31 + 9,
                           0.3, True, device="cpu",
                           t_start=time.perf_counter())
    finally:
        tracing.disable()
        tracing.drain()
    got = set(out["metrics"]) & set(NEW)
    assert got == {"hll_estimate_ms"}     # copies: no scan to end first
    assert out["metrics"]["hll_estimate_ms"]["value"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["bsbm_20gb.report_all",
                                  "bsbm_20gb.per_metric"])
def test_gpu_launch_calls_inside_kernel_launch(cuda, small_cell, name):
    """At least 99% of the scan kernels' launch calls, put on the host's
    clock by the markers, fall inside the program's ``kernel.launch``
    spans; the idle gaps by program span sum to the gaps by host span."""
    from qabench import span_breakdown
    out = span_breakdown.breakdown(small_cell(name, 4_000_000), 2**31 + 11,
                                   1.0)
    inside, total = out["launch_calls_inside_kernel_launch"]
    assert total >= 0.99 * out["requests"] and inside >= 0.99 * total
    a, b = out["idle_total_s"]
    assert b == pytest.approx(a, abs=1e-3)
