#!/usr/bin/env python3
"""Smoke test of the ``repro_torch`` port on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` and no network, and it exits nonzero without printing a
result when any of that, or the checkout, is missing.

Phases (one JSON line each, plus the last lines described below):

1. device — the card's name, count and power limit; the build of every
   kernel in ``src/repro_torch/csrc`` with ``nvcc`` for ``sm_90a`` (one
   ``nvcc`` per source, all at once) and what ``ptxas`` reports.
2. kernels — ``qap_count``, ``fused_scan`` and ``hll_fold`` on the card
   against their plain torch versions on the same inputs: N in
   {1, 8193, 1,000,003}, p in {8, 12, 14}, the ``paper`` and ``all``
   programs plus hand-built programs covering all 13 opcodes, and the
   sketch columns (10, 11, 12) and (11,). Tolerance: exact
   (``torch.equal``); counters are integer sums and registers integer
   maxima. At 1,000,003 rows the counters are also held to the numpy
   interpreter (``qap_count/ref.py::counts_ref_np``), and on every input
   each ``fused_scan`` sketch bank must equal ``hll_fold``'s.
3. main path — ``repro_torch.qa.assess`` at the triple count of the
   paper's BSBM 20 GB dataset (81,980,472 rows, 4.26 GB of planes on the
   card) with ``metrics="all"`` (the fused_scan kernel), ``metrics="paper"``
   (the qap_count kernel) and ``backend="twopass"`` (qap_count plus one
   hll_fold per sketch), and ``.per_metric()`` at the BSBM 2 GB count
   (8,289,484 rows; both scan kernels). Every run must be bit-identical,
   counters and registers, to the plain ``"torch"`` backend on the same
   card, with equal values. Then the chunked and the pipelined executor
   (16 chunks, the second with pinned side-stream copies) at full size,
   and a crash-and-resume drill (24 chunks, injected worker failures and
   a coordinator crash, a second scheduler resuming from the checkpoint)
   at the BSBM 2 GB count, each bit-identical to single shot. Launch
   counts are set to 0 just before each run and read just after; each
   run must launch its kernels the expected number of times. Then each
   kernel is timed at full size (CUDA events) beside its plain version
   and its least possible time on the card.
4. ingest — BSBM N-Triples text (``bsbm_ntriples(200_000, seed=7)``)
   through ``qa.assess`` and the DQV report, against the plain backend,
   and the same text streamed in chunks of 131,072 triples, against the
   single-shot result.

Then one ``{"kernels": [...]}`` line, the ``nvidia-smi`` name and power
limit line, and as the last line ``{"ok": true, "device": {...}}``. Any
mismatch or exception exits nonzero before that line.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import kernels as K, qa  # noqa: E402
from repro_torch.core import report  # noqa: E402
from repro_torch.core.expr import (  # noqa: E402
    OP_ANYBITS, OP_EMIT, OP_HASBITS, AnyBits, Cmp, EqPlanes, HasBits,
    compile_program)
from repro_torch.core.metrics import (  # noqa: E402
    ALL_METRICS, PAPER_METRICS, get_metrics)
from repro_torch.core.planner import plan  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.dist import ChunkScheduler, FaultInjector, WorkerFailure  # noqa
from repro_torch.kernels.fused_scan import ops as fops, ref as fref  # noqa
from repro_torch.kernels.hll import ops as hops, ref as href  # noqa
from repro_torch.kernels.qap_count import ops as qops, ref as qref  # noqa
from repro_torch.rdf import bsbm_ntriples, synth_encoded  # noqa: E402

FULL_ROWS = 81_980_472         # triples of the paper's BSBM 20 GB dataset
PER_METRIC_ROWS = 8_289_484    # triples of its BSBM 2 GB dataset
CHECK_ROWS = (1, 8193, 1_000_003)
CHECK_P = (8, 12, 14)
CHECK_COLS = ((10, 11, 12), (11,))   # the default sketches: spo and p
CHUNKS = 16                    # chunked and pipelined phases
DRILL_CHUNKS = 24              # resume drill, as examples/assess_restart.py
STREAM_TRIPLES = 131_072
MAIN_P = 12                    # hll precision of the main path (default)
BSBM_PRODUCTS = 200_000
BASE = ("http://bsbm.example.org/",)
BUILD = os.path.join(ROOT, "build")   # listed in .gitignore
# H100 SXM published peaks (NVIDIA data sheet): device memory rate, and
# the non-tensor float32 rate, taken as the ceiling for the scalar integer
# operations these kernels do (the data sheet lists no int32 rate).
MEM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
REPLACES = {
    "qap_count": "src/repro/kernels/qap_count/kernel.py:105",
    "fused_scan": "src/repro/kernels/fused_scan/kernel.py:114",
    "hll_fold": "src/repro/kernels/hll/kernel.py:76",
}
KERNELS = tuple(REPLACES)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after one warm-up,
    from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def int_ops_per_row(program, sketch_specs) -> int:
    """Integer operations a row needs: 2 per bit test and per EMIT (mask
    and compare, mask and add), 1 per compare and per AND/OR/NOT; per
    sketch column 11 (xor, fmix32's 8, multiply, add), and per sketch 14
    (final fmix32, bucket and rank, the max)."""
    ops = sum(2 if op in (OP_HASBITS, OP_ANYBITS, OP_EMIT) else 1
              for op, _, _ in program)
    return ops + sum(11 * len(cols) + 14 for _, cols in sketch_specs)


def bound(rows: int, program, n_counters: int, sketch_specs, p: int):
    """Least time on the card: the larger of bytes over the memory rate
    and integer operations over the scalar rate."""
    out_bytes = 8 * n_counters + 4 * len(sketch_specs) * (1 << p)
    bytes_ms = (rows * 52 + 12 * len(program) + out_bytes) \
        / MEM_BYTES_PER_S * 1e3
    ops_ms = rows * int_ops_per_row(program, sketch_specs) \
        / SCALAR_OPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms
            else "operations")


def opcode_cover_exprs():
    """Hand-built counters whose program uses all 13 opcodes."""
    exprs = [HasBits(3, 8) & AnyBits(5, 3),
             Cmp(6, "lt", 40) | Cmp(7, "le", 38),
             ~Cmp(8, "gt", 80) & Cmp(9, "ge", 1),
             Cmp(5, "eq", 0) | Cmp(9, "ne", 0),
             EqPlanes(0, 2) | ~EqPlanes(10, 12),
             ~(HasBits(4, 1 << 14) | (AnyBits(5, 6) & ~Cmp(12, "lt", 0)))]
    check({op for op, _, _ in compile_program(exprs)} == set(range(13)),
          "hand-built programs cover all 13 opcodes")
    return exprs


def same_result(res, plain) -> None:
    """Hold an assessment to the plain backend's: counters, registers and
    values equal."""
    check(res.counts == plain.counts, "counters equal the plain backend's")
    check(set(res.registers) == set(plain.registers), "same sketches")
    for k in plain.registers:
        check(np.array_equal(res.registers[k], plain.registers[k]),
              f"register bank {k} equals the plain backend's")
    check(res.values == plain.values, "values equal the plain backend's")
    check(res.n_triples == plain.n_triples, "n_triples equal")
    check(all(math.isfinite(v) for v in res.values.values()),
          "values finite")


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    print(smi, flush=True)
    t = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t
    ptxas = {k: [ln.strip() for ln in v.splitlines() if "Used" in ln
                 or "spill" in ln] for k, v in _build.build_logs.items()}
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_seconds": build_s, "arch": "sm_90a",
          "built": sorted(ptxas), "ptxas": ptxas})
    check(sorted(ptxas) == sorted(_build.SOURCES),
          "every kernel source built in this run")
    return smi


def phase_kernels(all_plan, paper_plan, cover_plan):
    err = {k: 0.0 for k in KERNELS}
    checks = {k: 0 for k in KERNELS}
    programs = (("paper", paper_plan), ("all", all_plan),
                ("opcode-cover", cover_plan))
    t = time.perf_counter()
    for n in CHECK_ROWS:
        host = synth_encoded(n, seed=n).planes
        planes = torch.from_numpy(host).cuda()
        for label, pln in programs:
            got = qops.fused_count(planes, pln.program, pln.n_counters)
            want = qref.counts_ref(planes, pln.program, pln.n_counters)
            err["qap_count"] = max(err["qap_count"],
                                   float((got - want).abs().max()))
            check(torch.equal(got, want),
                  f"qap_count {label} n={n}: {got.tolist()} vs plain "
                  f"{want.tolist()}")
            checks["qap_count"] += 1
            if n == CHECK_ROWS[-1]:
                check(got.cpu().numpy().tolist() == qref.counts_ref_np(
                    host, pln.program, pln.n_counters).tolist(),
                    f"qap_count {label} n={n} equals the numpy interpreter")
        for p in CHECK_P:
            for label, pln in programs[1:]:
                specs = all_plan.sketch_specs
                got_c, got_r = fops.fused_scan(planes, pln.program,
                                               pln.n_counters, specs, p)
                want_c, want_r = fref.fused_scan_torch(
                    planes, pln.program, pln.n_counters, specs, p)
                check(torch.equal(got_c, want_c),
                      f"fused_scan {label} counters n={n} p={p}: "
                      f"{got_c.tolist()} vs plain {want_c.tolist()}")
                err["fused_scan"] = max(err["fused_scan"],
                                        float((got_c - want_c).abs().max()))
                for k in want_r:
                    check(torch.equal(got_r[k], want_r[k]),
                          f"fused_scan {label} registers {k} n={n} p={p}")
                    err["fused_scan"] = max(
                        err["fused_scan"],
                        float((got_r[k] - want_r[k]).abs().max()))
                checks["fused_scan"] += 1
            banks = dict(zip((c for _, c in specs),
                             (got_r[k] for k, _ in specs)))
            for cols in CHECK_COLS:
                got = hops.hll_fold(planes, cols, p)
                want = href.hll_fold_torch(planes, cols, p)
                err["hll_fold"] = max(err["hll_fold"],
                                      float((got - want).abs().max()))
                check(torch.equal(got, want),
                      f"hll_fold cols={cols} n={n} p={p}")
                check(torch.equal(got, banks[cols]),
                      f"fused_scan bank equals hll_fold cols={cols} n={n} "
                      f"p={p}")
                checks["hll_fold"] += 1
    emit({"phase": "kernels", "rows": list(CHECK_ROWS), "p": list(CHECK_P),
          "sketch_cols": [list(c) for c in CHECK_COLS],
          "programs": ["paper", "all", "opcode-cover"], "checks": checks,
          "max_abs_err": err, "tolerance": "exact (torch.equal)",
          "seconds": time.perf_counter() - t})
    return err


def run_main_path(label, run, plain, expect, **extra):
    """Drive one main-path run with launch counts zeroed just before and
    read just after; hold it to ``plain``: the plain backend's run, or a
    result already computed for the same input. Returns the launch counts
    and the result."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for name, n in expect.items():
        check(launches[name] == n,
              f"{label}: {name} launched {launches[name]} times, "
              f"expected {n}")
    plain_wall = None
    if callable(plain):
        t = time.perf_counter()
        plain = plain()
        plain_wall = time.perf_counter() - t
    same_result(res, plain)
    stats = res.exec_stats
    if stats is not None:
        extra.update(chunks_total=stats.chunks_total, mode=stats.mode,
                     exec_wall_seconds=stats.wall_seconds,
                     chunk_eval_seconds_sum=sum(stats.chunk_eval_seconds),
                     attempts=stats.attempts, retries=stats.retries,
                     resumed_from=stats.resumed_from)
    emit({"phase": label, "n_triples": res.n_triples, "passes": res.passes,
          "launches": launches, "wall_s": wall, "plain_wall_s": plain_wall,
          "max_memory_allocated": peak, "values": res.values,
          "matches_plain": True, **extra})
    return launches, res, wall


def time_kernel(name, planes, pln, p):
    """Kernel and plain version, timed on the card at the main path's
    shape. For ``hll_fold`` ``pln`` is one sketch's ``(name, cols)``."""
    rows = planes.shape[0]
    if name == "hll_fold":
        sketch, cols = pln
        bound_ms, bound_by = bound(rows, (), 0, (pln,), p)
        return {"ms": cuda_ms(lambda: hops.hll_fold(planes, cols, p), 10),
                "plain_ms": cuda_ms(
                    lambda: href.hll_fold_torch(planes, cols, p), 2),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None, "rows": rows, "sketch": sketch,
                "cols": list(cols)}
    if name == "qap_count":
        kernel = lambda: qops.fused_count(planes, pln.program,
                                          pln.n_counters)
        plain = lambda: qref.counts_ref(planes, pln.program, pln.n_counters)
        specs = ()
    else:
        specs = pln.sketch_specs
        kernel = lambda: fops.fused_scan(planes, pln.program,
                                         pln.n_counters, specs, p)
        plain = lambda: fref.fused_scan_torch(planes, pln.program,
                                              pln.n_counters, specs, p)
    bound_ms, bound_by = bound(rows, pln.program, pln.n_counters, specs, p)
    return {"ms": cuda_ms(kernel, 10), "plain_ms": cuda_ms(plain, 2),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "rows": rows,
            "instructions": len(pln.program), "sketches": len(specs)}


def resume_drill(tt):
    """A 24-chunk run with two failures of chunk 3 (retried) and a
    coordinator crash after 12 merges, then a second scheduler resuming
    from the checkpoint: the result of the resumed run, its ChunkStats on
    ``exec_stats``."""
    ev = qa.pipeline().metrics("all").evaluator()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_drill_",
                                     dir=BUILD) as d:
        kw = dict(n_chunks=DRILL_CHUNKS, checkpoint_dir=d, checkpoint_every=6)
        try:
            ChunkScheduler(ev, **kw).run(tt, faults=FaultInjector(
                fail_chunks={3: 2}, crash_after_merges=12))
        except WorkerFailure as e:
            check("coordinator crash" in str(e), f"crashed as injected: {e}")
        else:
            check(False, "the drill's coordinator crashed")
        res, stats = ChunkScheduler(ev, **kw).run(tt)
    res.exec_stats = stats
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    smi = phase_device()
    all_plan = plan(get_metrics(ALL_METRICS))
    paper_plan = plan(get_metrics(PAPER_METRICS))
    cover_plan = plan([qa.count_metric(f"COVER{i}", e, auto_register=False)
                       for i, e in enumerate(opcode_cover_exprs())])
    err = phase_kernels(all_plan, paper_plan, cover_plan)

    # -- 3. the main path at full size ---------------------------------------
    t = time.perf_counter()
    tt = synth_encoded(FULL_ROWS, seed=3)
    emit({"phase": "data", "rows": tt.n_rows,
          "planes_bytes": tt.planes.nbytes,
          "synth_seconds": time.perf_counter() - t})
    launches = {k: 0 for k in KERNELS}

    def add(out):
        counts, res, wall = out
        for k in launches:
            launches[k] += counts[k]
        return res, wall

    def expect(**n):
        return {k: n.get(k, 0) for k in KERNELS}

    plain = {}

    def plain_all():
        plain["all"] = qa.assess(tt, metrics="all", backend="torch")
        return plain["all"]

    single, single_wall = add(run_main_path(
        "assess-all", lambda: qa.assess(tt, metrics="all"), plain_all,
        expect(fused_scan=1)))
    twopass, _ = add(run_main_path(
        "assess-twopass",
        lambda: qa.assess(tt, metrics="all", backend="twopass"),
        plain.pop("all"), expect(qap_count=1, hll_fold=2)))
    check(twopass.passes == 3, f"twopass made {twopass.passes} passes, "
          f"expected 3")
    add(run_main_path(
        "assess-paper",
        lambda: qa.assess(tt, metrics="paper"),
        lambda: qa.assess(tt, metrics="paper", backend="torch"),
        expect(qap_count=1)))

    # chunked and pipelined execution, held to the single-shot result; the
    # host-side split into chunks, which both runs include, timed alone
    t = time.perf_counter()
    tt.chunks(CHUNKS)
    emit({"phase": "chunk-split", "chunks": CHUNKS,
          "seconds": time.perf_counter() - t})
    os.makedirs(BUILD, exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=BUILD)
    try:
        chunked_pipe = qa.pipeline().metrics("all").chunked(CHUNKS)
        for label, pipe in (
                ("assess-chunked", chunked_pipe.chunked(
                    CHUNKS, checkpoint_dir=ckpt)),
                ("assess-pipelined", chunked_pipe.pipelined(2))):
            res, _ = add(run_main_path(
                label, lambda: pipe.run(tt), single,
                expect(fused_scan=CHUNKS), single_shot_wall_s=single_wall))
            check(res.exec_stats.chunks_total == CHUNKS,
                  f"{label}: {res.exec_stats.chunks_total} chunks")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)

    small = tt.take(PER_METRIC_ROWS)
    per_metric = qa.pipeline().metrics("all").per_metric()
    add(run_main_path(
        "assess-per-metric",
        lambda: per_metric.run(small),
        lambda: per_metric.backend("torch").run(small),
        expect(qap_count=len(ALL_METRICS) - 2, fused_scan=2)))
    res, _ = add(run_main_path(
        "resume-drill", lambda: resume_drill(small),
        lambda: qa.assess(small, metrics="all", backend="torch"),
        expect(fused_scan=DRILL_CHUNKS)))
    check(res.exec_stats.resumed_from is not None,
          "the drill resumed from a checkpoint")

    planes = torch.from_numpy(tt.planes).cuda()
    del tt, small
    timing = {"qap_count": time_kernel("qap_count", planes, paper_plan,
                                       MAIN_P),
              "fused_scan": time_kernel("fused_scan", planes, all_plan,
                                        MAIN_P),
              "hll_fold": {name: time_kernel("hll_fold", planes,
                                             (name, cols), MAIN_P)
                           for name, cols in all_plan.sketch_specs}}
    emit({"phase": "timing", **timing})
    del planes
    torch.cuda.empty_cache()

    # -- 4. ingest: N-Triples text through assess and the DQV report ---------
    t = time.perf_counter()
    text = bsbm_ntriples(BSBM_PRODUCTS, seed=7)
    gen_s = time.perf_counter() - t
    pipe = qa.pipeline().metrics("all").base(*BASE)
    res, _ = add(run_main_path(
        "assess-ingest",
        lambda: qa.assess(text, metrics="all", base=BASE),
        lambda: pipe.backend("torch").run(text),
        expect(fused_scan=1)))
    dqv = json.loads(report.to_json(res))
    check(len(dqv["measurements"]) == len(ALL_METRICS),
          "DQV report has one measurement per metric")
    emit({"phase": "report", "bsbm_products": BSBM_PRODUCTS,
          "text_bytes": len(text), "generate_seconds": gen_s,
          "n_triples": dqv["nTriples"],
          "measurements": len(dqv["measurements"])})
    n_stream = -(-res.n_triples // STREAM_TRIPLES)
    streamed, _ = add(run_main_path(
        "assess-streamed", lambda: pipe.streamed(STREAM_TRIPLES).run(text),
        res, expect(fused_scan=n_stream)))
    check(streamed.exec_stats.chunks_total == n_stream,
          f"streamed in {streamed.exec_stats.chunks_total} chunks")

    kernels = []
    for name in KERNELS:
        check(launches[name] > 0, f"{name} launched on the main path")
        # hll_fold: the widest default sketch, spo over three columns
        tm = timing[name]["spo"] if name == "hll_fold" else timing[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": err[name], "matches_plain": True,
            "ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
            "library_ms": None})
    emit({"kernels": kernels})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
