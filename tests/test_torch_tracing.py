"""``repro_torch.tracing``: the recorder off and on, nesting and request
ids, worker threads, the cap, the busy counters, the spans of a CPU
assessment, and the kernel build's counter. The card's launch path is
checked by the ``gpu`` test at the end."""
import sys
import threading
import time
import types
import warnings

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.core import report
from repro_torch.core import sketches
from repro_torch.core.evaluator import QualityEvaluator, run_single_shot
from repro_torch.core.metrics import ALL_METRICS, PAPER_METRICS
from repro_torch.dist import ChunkScheduler
from repro_torch.kernels import scan_codegen
from repro_torch.rdf import synth_encoded


@pytest.fixture
def rec():
    """The recorder emptied before the test, off and emptied after it."""
    tracing.disable()
    tracing.drain()
    yield tracing
    tracing.disable()
    tracing.drain()


def _names(spans):
    return [s.name for s in spans]


@pytest.mark.parametrize("name,value", [("evaluator.dispatch", 0),
                                        ("kernel.launch", 52 * 1000)])
def test_off_records_nothing(rec, name, value):
    got = rec.span(name, value)
    assert got is rec.NOOP
    with got:
        with rec.span("inner"):
            pass
    out = rec.drain()
    assert out.spans == [] and out.counters == {}


def test_on_spans_nest_and_share_the_root_id(rec):
    rec.enable()
    with rec.span("request"):
        with rec.span("a"):
            with rec.span("a.1", 7):
                pass
        with rec.span("b"):
            pass
    with rec.span("next"):
        pass
    spans = {s.name: s for s in rec.drain().spans}
    root = spans["request"]
    assert root.parent == 0 and root.root == root.id
    assert spans["a"].parent == root.id and spans["b"].parent == root.id
    assert spans["a.1"].parent == spans["a"].id
    assert spans["a.1"].value == 7
    assert {spans[n].root for n in ("a", "a.1", "b")} == {root.id}
    assert spans["next"].root == spans["next"].id != root.id
    assert root.start <= spans["a"].start <= spans["a.1"].start
    assert spans["a.1"].end <= spans["a"].end <= spans["b"].start
    assert spans["b"].end <= root.end
    assert {s.thread for s in spans.values()} == {threading.get_ident()}


def test_follows_the_torch_profiler(rec):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        with rec.span("profiled") as got:
            assert got is not rec.NOOP
    with rec.span("after") as got:
        assert got is rec.NOOP
    assert _names(rec.drain().spans) == ["profiled"]


def test_a_torch_without_the_profiler_flag_warns(rec, monkeypatch):
    """Where torch's private flag is gone, the first span says so, and
    recording still follows ``enable()``."""
    monkeypatch.setitem(sys.modules, "torch.autograd.profiler",
                        types.ModuleType("torch.autograd.profiler"))
    monkeypatch.setattr(tracing, "_profiler", None)
    with pytest.warns(RuntimeWarning, match="_is_profiler_enabled"):
        assert rec.span("x") is rec.NOOP
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert rec.span("y") is rec.NOOP
        rec.enable()
        with rec.span("z"):
            pass
    assert _names(rec.drain().spans) == ["z"]


def test_worker_threads_keep_their_spans(rec):
    """Speculative execution runs each chunk's eval in a worker thread of
    its own: every chunk's spans are kept, each with its thread, its
    children under it in that thread."""
    tensor = synth_encoded(6_000, seed=5)
    ev = QualityEvaluator(PAPER_METRICS, backend="torch", device="cpu")
    rec.enable()
    ChunkScheduler(ev, n_chunks=6, straggler_factor=1e6,
                   speculate=True).run(tensor)
    spans = rec.drain().spans
    assert _names(spans).count("evaluator.dispatch") == 6
    assert _names(spans).count("evaluator.materialize") == 6
    main = threading.get_ident()
    threads = [s.thread for s in sorted(spans, key=lambda s: s.start)
               if s.name == "evaluator.dispatch"]
    # the first three set the straggler threshold in the calling thread
    assert threads[:3] == [main] * 3 and main not in threads[3:]
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.parent:
            assert by_id[s.parent].thread == s.thread
            assert by_id[s.parent].root == s.root


def test_threads_lose_no_span(rec):
    """More threads than cores, switching often: every span of every
    thread is kept, with distinct ids."""
    n_threads, per = 16, 300
    rec.enable()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(per):
                with rec.span("outer"):
                    with rec.span("inner"):
                        pass
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    spans = rec.drain().spans
    assert len(spans) == 2 * n_threads * per
    assert len({s.id for s in spans}) == len(spans)
    outer = {s.id: s for s in spans if s.name == "outer"}
    for s in spans:
        if s.name == "inner":
            assert outer[s.parent].thread == s.thread


def test_cap_drops_and_counts(rec, monkeypatch):
    monkeypatch.setattr(tracing, "CAP", 5)
    rec.enable()
    for _ in range(8):
        with rec.span("x"):
            pass
    out = rec.drain()
    assert len(out.spans) == 5 and out.counters == {"spans.dropped": 3}
    assert rec.drain() == ([], {})


def test_drain_can_leave_the_record(rec):
    rec.enable()
    with rec.span("x"):
        pass
    with rec.busy("n"):
        pass
    kept = rec.drain(clear=False)
    assert _names(kept.spans) == ["x"] and list(kept.counters) == ["n"]
    assert rec.drain() == kept
    assert rec.drain() == ([], {})


def test_add_accumulates_and_is_kept(rec):
    """``add`` counts with recording off, and ``drain(clear=False)``
    leaves the count to grow on."""
    rec.add("n")
    rec.add("n", 4)
    assert rec.drain(clear=False).counters == {"n": 5}
    rec.add("n", 2)
    assert rec.drain().counters == {"n": 7}
    assert rec.drain() == ([], {})


def _bank(p, rows):
    keys = torch.arange(rows, dtype=torch.int32)[:, None] * 7 + 1
    return sketches.hll_update(sketches.hll_init(p), keys, (0,)).numpy()


def _rounded_bank():
    """The raw branch with ``sum(2^-reg)`` = 511.875 + 2^-20, which needs
    more than float32's 24 bits."""
    regs = np.full(4096, 3, np.int32)
    regs[7] = 20
    return regs


@pytest.mark.parametrize("banks,raw,rounded", [
    # a full report's two banks: ``spo`` on the raw branch with an exact
    # float32 sum, ``p`` (64 keys) on the linear-counting branch
    (lambda: [_bank(12, 2_000_000), _bank(12, 64)], [True, False], 0),
    (lambda: [_rounded_bank()], [True], 1),
], ids=["full_report", "rounded"])
def test_sum_rounded_counts_the_rounded_raw_sums(rec, banks, raw, rounded):
    ests = [sketches.estimate_bank(regs) for regs in banks()]
    assert [e > 2.5 * 4096 for e in ests] == raw
    assert rec.drain().counters.get(sketches.SUM_ROUNDED, 0) == rounded


def _step_bank(high):
    """``high`` registers at 16, the rest at 15: the raw estimate crosses
    2^32/30 between 2,650 and 2,660 of them."""
    regs = np.full(4096, 15, np.int32)
    regs[:high] = 16
    return regs


@pytest.mark.parametrize("bank,estimate,past", [
    # the estimates as estimate_bank gave them before the counter, in hex
    (lambda: np.full(4096, 15, np.int32), "0x1.7135560000000p+26", 0),
    (lambda: _step_bank(2650), "0x1.10e0300000000p+27", 0),
    (lambda: _step_bank(2660), "0x1.115e780000000p+27", 1),
    (lambda: np.full(4096, 18, np.int32), "0x1.7135560000000p+29", 1),
    (lambda: np.random.default_rng(7).integers(15, 21, 4096)
     .astype(np.int32), "0x1.1ff3320000000p+28", 1),
    (lambda: _bank(12, 64), None, 0),
], ids=["uniform15", "step2650", "step2660", "uniform18", "mixed",
        "linear"])
def test_past_range_counts_estimates_past_the_large_range(rec, bank,
                                                          estimate, past):
    """``sketches.past_range`` counts each estimate past 2^32/30, whose
    value stays the uncorrected raw one."""
    est = sketches.estimate_bank(bank())
    if estimate is not None:
        assert est.hex() == estimate
    assert (est > 2 ** 32 / 30) == bool(past)
    assert rec.drain().counters.get(sketches.PAST_RANGE, 0) == past


def _union_ns(spans):
    tot, end = 0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            tot, end = tot + b - a, b
        elif b > end:
            tot, end = tot + b - end, b
    return tot


@pytest.mark.parametrize("layout", [
    # (thread, start ms, end ms) of each block
    [(0, 0, 40)],
    [(0, 0, 40), (1, 10, 30)],              # nested in time: once
    [(0, 0, 20), (1, 10, 40)],              # overlapping: the union
    [(0, 0, 10), (0, 30, 40)],              # apart: the sum
])
def test_busy_counts_the_union_over_threads(rec, layout):
    """A ``busy`` counter adds the wall time in which any of its blocks
    is open, whatever thread opened it; it is kept with recording off.
    Each block's clock readings just outside and just inside it bound
    what the counter may hold."""
    t0 = time.perf_counter_ns()
    outer, inner = [], []

    def block(a, b):
        time.sleep(max(0, t0 + a * 1_000_000 - time.perf_counter_ns()) / 1e9)
        before = time.perf_counter_ns()
        with rec.busy("build_ns"):
            first = time.perf_counter_ns()
            time.sleep(max(0, t0 + b * 1_000_000
                           - time.perf_counter_ns()) / 1e9)
            last = time.perf_counter_ns()
        outer.append((before, time.perf_counter_ns()))
        inner.append((first, last))

    by_thread = {}
    for th, a, b in layout:
        by_thread.setdefault(th, []).append((a, b))
    threads = [threading.Thread(target=lambda bs=bs: [block(a, b)
                                                      for a, b in bs])
               for bs in by_thread.values()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    got = rec.drain().counters["build_ns"]
    assert _union_ns(inner) <= got <= _union_ns(outer)


@pytest.mark.parametrize("metrics,estimates", [(ALL_METRICS, 2),
                                               (PAPER_METRICS, 0)])
def test_single_shot_emits_its_spans_in_order(rec, metrics, estimates):
    tensor = synth_encoded(4_000, seed=6)
    ev = QualityEvaluator(metrics, device="cpu")
    ev.passes_per_chunk     # its probe runs the kernels' checks once
    rec.enable()
    report.to_json(run_single_shot(ev, tensor))
    spans = rec.drain().spans
    roots = [s.name for s in spans if s.parent == 0]
    assert roots == ["evaluator.dispatch", "evaluator.materialize",
                     "evaluator.merge", "evaluator.finalize",
                     "report.to_json"]
    by_id = {s.id: s for s in spans}
    under = {}
    for s in spans:
        if s.parent:
            under.setdefault(by_id[s.parent].name, []).append(s.name)
    assert "evaluator.materialize" not in under     # the copies, unsplit
    assert under["evaluator.finalize"] == (["sketches.estimate"] * estimates
                                           + ["plan.finalize"])
    assert under["report.to_json"] == ["report.dqv", "report.encode"]
    assert under["evaluator.dispatch"] == ["kernel.check"]
    starts = [by_id[s.id].start for s in spans if s.parent == 0]
    assert starts == sorted(starts)


@pytest.mark.parametrize("metrics", [ALL_METRICS, ("L1",), ("SCH1",)])
def test_kernel_source_row_bytes_is_its_staged_row(metrics):
    """A launch counts rows × ``row_bytes``: the bytes of the row the
    kernel stages in its shared-memory ring, all 13 planes today, whatever
    the plan reads of them."""
    ev = QualityEvaluator(metrics, device="cpu")
    (pln,) = ev.plans
    from repro_torch.kernels import _build
    src = _build.scan_source(pln.program, pln.n_counters, pln.sketch_specs,
                             ev.hll_p)
    assert src.row_bytes == scan_codegen.ROW_BYTES == 4 * scan_codegen.N_PLANES
    ring = scan_codegen.STAGES * scan_codegen.TILE_ROWS * src.row_bytes
    assert src.smem_bytes - ring in (0, 4 * (src.n_sketches << src.p))
    assert len(src.dag.planes) * 4 <= src.row_bytes


def test_kernel_source_time_is_counted_once(rec):
    scan_codegen.generate_cached.cache_clear()
    ev = QualityEvaluator(("L1",), device="cpu")
    (pln,) = ev.plans
    from repro_torch.kernels import _build
    rec.enable()
    for _ in range(3):
        _build.scan_source(pln.program, pln.n_counters, (), None)
    out = rec.drain()
    assert _names(out.spans) == ["kernel.source"] * 3
    assert set(out.counters) == {scan_codegen.BUILD_BUSY}
    assert 0 < out.counters[scan_codegen.BUILD_BUSY] <= max(
        s.end - s.start for s in out.spans)


@pytest.mark.gpu
def test_gpu_launch_path_spans_and_bytes(rec):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.fused_scan.ops import fused_scan
    tensor = synth_encoded(100_003, seed=7)
    planes = torch.from_numpy(np.ascontiguousarray(tensor.planes)).cuda()
    ev = QualityEvaluator(ALL_METRICS, device="cuda")
    (pln,) = ev.plans
    rec.enable()
    fused_scan(planes, pln.program, pln.n_counters, pln.sketch_specs,
               ev.hll_p)
    torch.cuda.synchronize()
    out = rec.drain()
    names = [n for n in _names(out.spans) if n != "kernel.module"]
    assert names == ["kernel.check", "kernel.outputs", "kernel.source",
                     "kernel.get", "kernel.launch"]
    n = planes.shape[0]
    (launch,) = [s for s in out.spans if s.name == "kernel.launch"]
    assert launch.value == n * 52
