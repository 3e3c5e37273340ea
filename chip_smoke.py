#!/usr/bin/env python3
"""Smoke test of the ``repro_torch`` port on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` and no network, and it exits nonzero without printing a
result when any of that, or the checkout, is missing.

Phases (one JSON line each, plus the last lines described below):

1. device — the card's name, count and power limit; the build of the
   fixed-source kernel ``hll_fold`` (``src/repro_torch/csrc/hll_fold.cu``)
   with ``nvcc`` for ``sm_90a`` and what ``ptxas`` reports. Then
   first-call — ``qa.assess`` on 100,000 rows, whole-plan and per-metric,
   each run twice: the first call of a plan prints its scan kernel
   (``kernels/scan_codegen.py`` around ``csrc/scan_spec.cuh``) and
   compiles it with NVRTC; the difference of the two walls is the cost
   that adds to ``assess``.
2. kernels — ``qap_count``, ``fused_scan`` and ``hll_fold`` on the card
   against their plain torch versions on the same inputs: N in
   {1, 8193, 1,000,003}, p in {8, 12, 14}, the ``paper`` and ``all``
   programs plus hand-built programs covering all 13 opcodes, and the
   sketch columns (10, 11, 12) and (11,); and two programs at the
   wrappers' limits (128 counters with a 16-deep stack, and 4,095
   instructions), as ``qap_count`` and as ``fused_scan`` at p = 12. The
   phase first compiles all its plans at once (``compile_scans``, one
   NVRTC thread each). Tolerance: exact
   (``torch.equal``); counters are integer sums and registers integer
   maxima. At 1,000,003 rows the counters are also held to the numpy
   interpreter (``qap_count/ref.py::counts_ref_np``), and on every input
   each ``fused_scan`` sketch bank must equal ``hll_fold``'s.
   ``qap_count`` and ``fused_scan`` are the plan-specialized scan kernel,
   one compiled source per plan, program and p.
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
   and its least possible time on the card, and one library reduction
   over the same planes (``planes.amax()``) gives the read rate a library
   kernel reaches on the card.
4. ingest — BSBM N-Triples text (``bsbm_ntriples(200_000, seed=7)``)
   through ``qa.assess`` and the DQV report, against the plain backend,
   and the same text streamed in chunks of 131,072 triples, against the
   single-shot result.

Then one ``scan-kernels`` line: per compiled plan, the NVRTC compile
time, ptxas' report (registers, shared memory, spills), the resident
blocks per SM, and the process's and disk cache's hits; for the ``all``
and ``paper`` kernels and those at the limits, the count of their SASS
instructions (``cuobjdump -sass``). Then one
``{"kernels": [...]}`` line, the ``nvidia-smi`` name and power limit
line, and as the last line ``{"ok": true, "device": {...}}``. Any
mismatch or exception exits nonzero before that line.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import kernels as K, qa  # noqa: E402
from repro_torch.core import report  # noqa: E402
from repro_torch.core.expr import (  # noqa: E402
    OP_ANYBITS, OP_EMIT, OP_HASBITS, And, AnyBits, Cmp, EqPlanes, HasBits,
    Not, Or, compile_program)
from repro_torch.core.metrics import (  # noqa: E402
    ALL_METRICS, PAPER_METRICS, get_metrics)
from repro_torch.core.planner import plan, plan_single  # noqa: E402
from repro_torch.kernels import _build, scan_codegen  # noqa: E402
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
# H100 SXM peaks: the device memory rate (NVIDIA data sheet), and the
# scalar integer rate the kernels' operations run at: 64 INT32 lanes an SM
# (Hopper architecture white paper) x 132 SMs x 1,980 MHz, the card's
# maximum SM clock (nvidia-smi clocks.max.sm).
MEM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
FIRST_CALL_ROWS = 100_000
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
    and integer operations over the INT32 rate."""
    out_bytes = 8 * n_counters + 4 * len(sketch_specs) * (1 << p)
    bytes_ms = (rows * 52 + 12 * len(program) + out_bytes) \
        / MEM_BYTES_PER_S * 1e3
    ops_ms = rows * int_ops_per_row(program, sketch_specs) \
        / INT32_OPS_PER_S * 1e3
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


def _rand_expr(rng, depth):
    """A random counter expression over every opcode."""
    if depth == 0 or rng.random() < 0.3:
        kind, plane = int(rng.integers(4)), int(rng.integers(13))
        if kind == 0:
            return HasBits(plane, 1 << int(rng.integers(15)))
        if kind == 1:
            return AnyBits(plane, 1 << int(rng.integers(15)))
        if kind == 2:
            return Cmp(plane, ("lt", "le", "gt", "ge", "eq", "ne")[
                int(rng.integers(6))], int(rng.integers(-4, 120)))
        return EqPlanes(plane, int(rng.integers(13)))
    kind = int(rng.integers(3))
    if kind == 2:
        return Not(_rand_expr(rng, depth - 1))
    a, b = _rand_expr(rng, depth - 1), _rand_expr(rng, depth - 1)
    return And(a, b) if kind == 0 else Or(a, b)


def limit_plans():
    """Programs at the wrappers' limits, as ``tests/test_torch_kernels.py``
    builds them: ``wide`` has 128 counters, the last needing a 16-deep
    stack; ``long`` has 4,095 instructions. Plans without sketches."""
    out = {}
    for which in ("wide", "long"):
        rng = np.random.default_rng(4096)
        if which == "wide":
            exprs = [_rand_expr(rng, 3)
                     for _ in range(qops.COUNTS_WIDTH - 1)]
            e = Cmp(6, "gt", 20)
            for i in range(qops.MAX_STACK - 1):
                e = (And if i % 2 else Or)(HasBits(3 + i % 6, 1 << i), e)
            exprs.append(e)
        else:
            exprs, n = [], 0
            while n < qops.MAX_INSTR - 1 and len(exprs) < qops.COUNTS_WIDTH:
                e = _rand_expr(rng, 8)
                m, left = len(compile_program([e])), qops.MAX_INSTR - n
                if min(48, left) <= m <= left:
                    exprs.append(e)
                    n += m
        program = compile_program(exprs)
        depth = qops.check_program(program, len(exprs))
        check(len(exprs) == qops.COUNTS_WIDTH and depth == qops.MAX_STACK
              if which == "wide" else len(program) >= qops.MAX_INSTR - 1,
              f"the {which} program is at the limits")
        out[which] = types.SimpleNamespace(
            program=program, n_counters=len(exprs), sketch_specs=())
    return out


def with_sketches(pln, sketch_specs):
    """A limit plan's program and counters with ``sketch_specs``."""
    return types.SimpleNamespace(program=pln.program,
                                 n_counters=pln.n_counters,
                                 sketch_specs=sketch_specs)


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


def phase_first_call():
    """``qa.assess`` on FIRST_CALL_ROWS rows twice, for the whole ``all``
    plan, the ``paper`` plan and per-metric mode (16 plans): the first
    run of each generates and compiles its plans' scan kernels, the
    second finds them in the process's cache."""
    tt = synth_encoded(FIRST_CALL_ROWS, seed=11)
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    per_metric = qa.pipeline().metrics("all").per_metric()
    out = {}
    for label, run in (
            ("all", lambda: qa.assess(tt, metrics="all")),
            ("paper", lambda: qa.assess(tt, metrics="paper")),
            ("per-metric", lambda: per_metric.run(tt))):
        before = dict(_build.spec_stats)
        specs_before = set(_build._specs)
        walls = []
        for _ in range(2):
            t = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        new = [k for k in _build._specs if k not in specs_before]
        out[label] = {
            "first_s": walls[0], "second_s": walls[1],
            "first_call_cost_s": walls[0] - walls[1],
            "nvrtc_seconds": sum(_build._specs[k].compile_seconds
                                 for k in new),
            **{k: _build.spec_stats[k] - before[k] for k in before}}
    emit({"phase": "first-call", "rows": FIRST_CALL_ROWS, **out})


def scan_kernel_labels(all_plan, paper_plan, cover_plan, limits):
    """Digest of each scan-kernel source this run compiles -> a label."""
    labels = {}

    def add(label, pln, p):
        src = _build.scan_source(pln.program, pln.n_counters,
                                 pln.sketch_specs, p)
        labels.setdefault(src.digest, label)

    for which, pln in limits.items():
        add(f"qap_count limit {which}", pln, None)
        add(f"fused_scan limit {which} p={MAIN_P}",
            with_sketches(pln, all_plan.sketch_specs), MAIN_P)

    for name, pln in (("all", all_plan), ("opcode-cover", cover_plan)):
        for p in CHECK_P:
            add(f"fused_scan {name} p={p}", dataclasses.replace(
                pln, sketch_specs=all_plan.sketch_specs), p)
        add(f"qap_count {name}",
            dataclasses.replace(pln, sketch_specs=()), None)
    add("qap_count paper", paper_plan, None)
    for m in get_metrics(ALL_METRICS):
        pln = plan_single(m)
        add(f"fused_scan per-metric {m.name} p={MAIN_P}"
            if pln.sketch_specs else f"qap_count per-metric {m.name}",
            pln, MAIN_P)
    return labels


def sass_counts(kern, label: str) -> dict:
    """A compiled kernel disassembled with ``cuobjdump -sass``: its
    instructions, and those of the ring's loop (from the barrier that
    frees a stage, past the wait for the next tile, to the next barrier),
    which evaluates TILE_ROWS / THREADS rows a thread."""
    from torch.utils.cpp_extension import CUDA_HOME
    out_dir = os.path.join(BUILD, "sass")
    os.makedirs(out_dir, exist_ok=True)
    cubin = os.path.join(out_dir, re.sub(r"\W+", "_", label) + ".cubin")
    with open(cubin, "wb") as f:
        f.write(kern.cubin)
    sass = subprocess.run(
        [os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass", cubin],
        capture_output=True, text=True, check=True).stdout
    # "        /*0120*/                   LDS R4, [R2+0x8] ;   /* 0x... */"
    code = [m.group(1) for m in re.finditer(
        r"^\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", sass, re.M)]
    wait = next((i for i, c in enumerate(code) if "TRYWAIT" in c), None)
    bars = [i for i, c in enumerate(code) if "BAR.SYNC" in c]
    before = [i for i in bars if wait is not None and i < wait]
    after = [i for i in bars if wait is not None and i > wait]
    return {"instructions": len(code),
            "ring_loop_instructions": (min(after) - max(before)
                                       if before and after else None),
            "rows_a_thread_per_tile":
                scan_codegen.TILE_ROWS // scan_codegen.THREADS}


def phase_scan_kernels(labels):
    """Every scan kernel compiled in this run: compile time, ptxas'
    report, the driver's resources and resident blocks per SM; the SASS
    of the main path's and the limit plans' kernels."""
    kernels = []
    for kern in _build._specs.values():
        src = kern.src
        label = labels.get(src.digest, "other")
        sass = (sass_counts(kern, label) if "limit" in label or label in (
            f"fused_scan all p={MAIN_P}", "qap_count paper") else None)
        kernels.append({
            "label": label, "sass": sass,
            "kernel": "fused_scan" if src.n_sketches else "qap_count",
            "how": kern.how, "compile_seconds": kern.compile_seconds,
            "counters": src.dag.n_counters,
            "leaves": len(src.dag.leaves), "nodes": len(src.dag.nodes),
            "sketches": src.n_sketches, "p": src.p,
            "shared_banks": src.shared_banks,
            "ptxas": [ln.strip() for ln in kern.log.splitlines()
                      if "Used" in ln or "spill" in ln],
            "resources": kern.resources.get(0)})
    emit({"phase": "scan-kernels", "compiled": len(kernels),
          "cache": dict(_build.spec_stats), "flags": list(_build.NVRTC_FLAGS),
          "kernels": kernels})


def phase_kernels(all_plan, paper_plan, cover_plan, limits):
    err = {k: 0.0 for k in KERNELS}
    checks = {k: 0 for k in KERNELS}
    programs = (("paper", paper_plan), ("all", all_plan),
                ("opcode-cover", cover_plan),
                *((f"limit {k}", v) for k, v in limits.items()))
    t = time.perf_counter()
    # every plan of the phase, compiled at once
    srcs = [_build.scan_source(pln.program, pln.n_counters, (), None)
            for _, pln in programs]
    srcs += [_build.scan_source(pln.program, pln.n_counters,
                                all_plan.sketch_specs, p)
             for _, pln in programs[1:3] for p in CHECK_P]
    srcs += [_build.scan_source(pln.program, pln.n_counters,
                                all_plan.sketch_specs, MAIN_P)
             for _, pln in programs[3:]]
    _build.compile_scans(srcs)
    compile_s = time.perf_counter() - t
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
            for label, pln in (programs[1:3] if p != MAIN_P
                               else programs[1:]):
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
          "programs": [label for label, _ in programs],
          "limit_programs": {k: {"instructions": len(v.program),
                                 "counters": v.n_counters}
                             for k, v in limits.items()},
          "checks": checks, "max_abs_err": err,
          "tolerance": "exact (torch.equal)", "compiled": len(srcs),
          "compile_seconds": compile_s,
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
    src = scan_codegen.generate_cached(tuple(pln.program), pln.n_counters,
                                       tuple(specs), p if specs else None)
    kern = _build.spec_kernel(src)
    counts = torch.zeros((pln.n_counters,), dtype=torch.int64,
                         device=planes.device)
    regs = torch.zeros((len(specs), 1 << p), dtype=torch.int32,
                       device=planes.device) if specs else None

    def launch():   # the launch alone, without the wrapper's checks
        counts.zero_()
        if regs is not None:
            regs.zero_()
        kern.launch(planes, counts, regs)

    return {"ms": cuda_ms(kernel, 10), "plain_ms": cuda_ms(plain, 2),
            "launch_ms": cuda_ms(launch, 10),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "rows": rows,
            "instructions": len(pln.program),
            "distinct_leaves": len(src.dag.leaves), "sketches": len(specs),
            "threads": scan_codegen.THREADS,
            "tile_rows": scan_codegen.TILE_ROWS,
            "stages": scan_codegen.STAGES,
            "blocks_per_sm": kern.resources[0]["blocks_per_sm"]}


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
    phase_first_call()
    all_plan = plan(get_metrics(ALL_METRICS))
    paper_plan = plan(get_metrics(PAPER_METRICS))
    cover_plan = plan([qa.count_metric(f"COVER{i}", e, auto_register=False)
                       for i, e in enumerate(opcode_cover_exprs())])
    limits = limit_plans()
    err = phase_kernels(all_plan, paper_plan, cover_plan, limits)

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
    read_ms = cuda_ms(lambda: planes.amax(), 10)
    emit({"phase": "timing", **timing,
          "read_yardstick": {"call": "planes.amax()", "ms": read_ms,
                             "read_TB_per_s": planes.numel() * 4
                             / read_ms / 1e9}})
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

    phase_scan_kernels(scan_kernel_labels(all_plan, paper_plan, cover_plan,
                                          limits))
    kernels = []
    for name in KERNELS:
        check(launches[name] > 0, f"{name} launched on the main path")
        # hll_fold: the widest default sketch, spo over three columns
        tm = timing[name]["spo"] if name == "hll_fold" else timing[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": ("src/repro_torch/csrc/hll_fold.cu"
                       if name == "hll_fold" else
                       "src/repro_torch/csrc/scan_spec.cuh"),
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
