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
3b. mesh — the main path over a mesh of ranks (``launch.mesh``,
   ``Pipeline.shard``): each rank copies its row shard to the card and
   launches the kernels over it, counters and registers are all-reduced
   over ``torch.distributed``. (1) A one-rank ``nccl`` group in this
   process at 81,980,472 rows, ``metrics="all"`` (one ``fused_scan``)
   and ``"paper"`` (one ``qap_count``), held to the single-shot runs
   above; the group is destroyed after it. (2) Four ``gloo`` ranks
   sharing the card, child processes started by ``launch_ranks``, at the
   BSBM 2 GB count (8,289,484 rows: a cut for the script's time limit),
   single shot (``all`` and ``paper``), ``.chunked(6).pipelined(2)``
   (``exec_stats.devices == 4``) and ``twopass``: every rank's result
   bit-identical to the plain backend on the card, and each kernel
   launched once per rank per chunk. (3) The phase-4 text through the
   segment store under a 2-rank mesh, cold and after a ~1% mutation,
   equal to the single-device store runs with the same rescanned
   segments, each rescanned segment scanned by one rank; the single-device
   runner then reuses the mesh's store with 0 segments rescanned. (4)
   ``python -m repro_torch.launch.assess --mesh 2 --synthetic 1000000``
   in a process of its own prints the values of the run without
   ``--mesh``. Per run: the group's backend, each rank's kernel
   milliseconds (CUDA events, one rank at a time), the all-reduce (or,
   for the store, all-gather) milliseconds, beside those of its
   collectives alone, and the wall time, beside the card's name and power
   limit.
4. ingest — BSBM N-Triples text (``bsbm_ntriples(200_000, seed=7)``)
   through ``qa.assess`` and the DQV report, against the plain backend,
   and the same text streamed in chunks of 131,072 triples, against the
   single-shot result.
5. incremental — the same text written to a file under ``build/`` and
   assessed against one segment store (``repro_torch.store``, the default
   1 MiB segments) in the six phases of ``benchmarks/fig_incremental.py``:
   cold, warm, ~1% appended, ~1% mutated at 25%, ~10% mutated at 50%,
   ~10% deleted at 20%. Each phase is held to the plain backend on the
   card on the edited bytes, launches ``fused_scan`` once per rescanned
   segment (none warm) and stays within the JAX benchmark's scan targets
   (append ≤ 5% of bytes, 10% mutation and delete ≤ 15%). Then a warm
   run of the same store through ``backend="twopass"`` rescans nothing,
   and ``python -m repro_torch.launch.assess --store`` in a process of its
   own prints ``0 rescanned`` and the last phase's values. Last, a cold
   and a warm run on a fresh store under cProfile give the host seconds of
   each step of the incremental runner (not part of the main path).
6. serve — an in-process ``repro_torch.serve`` daemon with its defaults
   (``fused_scan`` on ``cuda``), ``metrics="all"`` and two workers, over a
   store root under ``build/``: the phase-4 text registered as a watched
   server-side source; while its cold job runs, three tenants
   (``bsbm_ntriples(2,000, seed=i)``) uploaded over HTTP, so that both
   workers launch on the card at once; then ~1% appended to the source
   (the watcher's job must rescan at most 5% of the bytes) and one tenant
   re-uploaded unchanged (0 segments rescanned, no launch). Every job is
   held to the plain backend on the card; the DQV report, ``/metrics``
   and ``/catalog/ranking`` are read back; ``fused_scan`` launches equal
   the sum of the jobs' rescanned segments. Per job: the queue wait, the
   incremental runner's wall time and, of it, the chunk evals.
6b. serve-cli — ``python -m repro_torch.launch.assess --serve 0`` in a
   process of its own: one upload held to the plain backend, then SIGTERM
   and exit 0 after "clean shutdown". serve-chaos — the crash drill of
   ``scripts/serve_smoke.py --chaos`` with port daemons on the card: three
   uploads accepted, the daemon killed by the crash point after
   journaling the second job's start, a restarted daemon completing every
   accepted job (one after a transient failure), each held to the plain
   backend; alerts, a dead webhook counted, DELETE, SIGTERM exit 0.
7. catalog — the fleet of ``benchmarks/fig_catalog.py`` in full mode
   (8 × ``bsbm_ntriples(2,000, seed=100 + i)``, 8,413,937 bytes, 65,536-byte
   segments, 4 workers, ``metrics="all"``) served as a remote DCAT catalog
   by ``repro_torch.fetch.FlakyOriginServer`` on this machine and crawled
   by ``repro_torch.catalog``: cold (``fused_scan`` once per segment),
   warm (nothing rescanned, replayed, launched or fetched: every fetch a
   304) and after a ~2% rewrite of one dataset through ``twopass`` (only
   it rescans: ``qap_count`` once and ``hll_fold`` twice per segment).
   Every dataset of every crawl is held to the plain backend on the card,
   values and registers; the cold crawl's busy share is its chunk evals
   over its wall time. Then ``python -m repro_torch.launch.qa_catalog
   rank`` in a process of its own prints the in-process ranking.

8. models-lm-<arch> — the model-serving path of ``repro_torch.models``
   (no scan kernel: plain torch) for each of the five LM configs at its
   published widths, with seeded random weights (``torch.Generator``,
   the JAX package's init, the q/k/v projections rescaled to fan-in
   scale: ``fan_in_qkv`` says why, and ``--lm-init-witness`` below
   measures it):
   (a) the config in float32 at a depth cut (``LM_CUT``: 2 layers; gemma
   one 5:1 super-block of 6; deepseek its dense layer and one MoE layer),
   ``prefill`` (logits and caches) and three ``decode_step``s on the card
   held to the same code on the CPU with the same weights (``F32_TOL`` of
   each tensor's largest magnitude), then served on the card, each step's
   logits held to a ``prefill(..., logits_last_only=False)`` of the
   served sequence (relative L2 ``F32_TOL``); (b) ``launch.serve.serve_lm``
   in the config's own dtype (bf16), Qwen2.5-14B at all 48 layers (31.55
   GB of weights) and granite at all 24, the others at the cut: three
   greedy requests of a 16-token prompt and 32 tokens, each step held to
   a prefill of the served sequence (relative L2 ``BF16_REL_L2``). A MoE
   config is held at a capacity of E/top_k slots an expert, which drops
   nothing in either pass (its agreement at its own capacity, whose
   drops differ between a 1-token and a whole-sequence pass, is
   reported), with its routes recorded in both: the steps before the
   first token routed to other experts one by one, and the median step. Per
   config: resident bytes, init seconds, prefill ms, decode ms per token
   (p50, p99 over the requests after the first) beside the byte bound
   (weight bytes over 3.35 TB/s), and three decode steps under
   ``torch.profiler``: the card's busy share and kernels a step.
9. models-din — DIN at its full 10M-item table (180,232,842 parameters)
   through ``serve_din``: ``serve_p99`` (512 × 1) and ``serve_bulk``
   (262,144 × 1) batches, and ``retrieval_cand`` cut to 250,000
   candidates (the attention unit holds (B, C, T, 144) float32, 57.6 GB
   at 1,000,000); p50 and p99 per shape beside the float32 operation
   bound. The ``serve_p99`` scores are held to the CPU with the same
   weights (float32, ``atol=1e-5, rtol=1e-4``), and four candidates of a
   retrieval batch to scoring each alone.
   Both phases run after the card's memory from earlier phases is freed,
   and launch no scan kernel.

Then one ``scan-kernels`` line: per compiled plan, the NVRTC compile
time, ptxas' report (registers, shared memory, spills), the resident
blocks per SM, and the process's and disk cache's hits; for the ``all``
and ``paper`` kernels and those at the limits, the count of their SASS
instructions (``cuobjdump -sass``). Then one
``{"kernels": [...]}`` line, the ``nvidia-smi`` name and power limit
line, and as the last line ``{"ok": true, "device": {...}}``. Any
mismatch or exception exits nonzero before that line.

``python3 chip_smoke.py --lm-init-witness`` runs none of that: it serves
Qwen2.5-14B at all 48 layers in float32 and in bf16, with the JAX init's
weights as drawn and at fan-in scale, and prints for each the first
layer's attention score statistics and the decode steps' agreement with
a prefill of the served sequence (the measurement behind ``fan_in_qkv``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import torch
import torch.distributed as dist

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
from repro_torch.configs import LM_ARCHS, DIN_SHAPES, din_cfg  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.models import din as din_mod  # noqa: E402
from repro_torch.models import transformer as tf_mod  # noqa: E402
from repro_torch.models.common import (ParamTree, apply_rope,  # noqa: E402
                                       rmsnorm, rope_freqs)
from repro_torch.models.convert import tree_leaves  # noqa: E402
from repro_torch.rdf import bsbm_ntriples, synth_encoded  # noqa: E402
from repro_torch.rdf import ingest as rdf_ingest  # noqa: E402
from repro_torch.rdf.triple_tensor import TripleTensor  # noqa: E402
from repro_torch.store import (DEFAULT_TARGET_BYTES,  # noqa: E402
                               iter_segments_bytes)

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
SRC_ENV = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
# scan-fraction targets of benchmarks/fig_incremental.py
SCAN_TARGETS = {"append_1pct": 0.05, "mutate_10pct": 0.15,
                "delete_10pct": 0.15}
# H100 SXM peaks: the device memory rate (NVIDIA data sheet), and the
# scalar integer rate the kernels' operations run at: 64 INT32 lanes an SM
# (Hopper architecture white paper) x 132 SMs x 1,980 MHz, the card's
# maximum SM clock (nvidia-smi clocks.max.sm).
MEM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
FIRST_CALL_ROWS = 100_000
MESH_RANKS = 4                 # gloo ranks sharing the card
MESH_STORE_RANKS = 2
MESH_CHUNKS = 6
MESH_CLI_ROWS = 1_000_000
MESH_TIMEOUT = 600.0           # seconds the ranks of one launch may take
# phases 8-9, the model-serving path. Depth cut of the float32 check (and
# of the bf16 serve but for LM_SERVE_ALL_LAYERS): one whole period of each
# layer pattern (gemma: one 5:1 super-block; deepseek: its dense layer and
# one MoE layer)
LM_CUT = {"qwen2.5-14b": 2, "internlm2-20b": 2, "gemma3-12b": 6,
          "deepseek-v2-236b": 2, "granite-moe-1b-a400m": 2}
LM_SERVE_ALL_LAYERS = ("qwen2.5-14b", "granite-moe-1b-a400m")
LM_PROMPT = 16                 # serve_lm's prompt length
LM_TOKENS = 32
LM_REQUESTS = 3                # greedy requests a config; the first warms up
LM_CHECK_STEPS = 3
MODEL_SEED = 0
# float32, the card against the CPU with the same weights: their matmuls
# add up to 16,384 products a dot in other orders (about 1e-6 of the
# magnitude each) through 2-6 layers; bf16's 2^-9 would fail it
# (F32_TOL of the compared tensor's largest magnitude); float32 decode
# against a prefill of the same sequence on the card: relative L2 F32_TOL
F32_TOL = 1e-4
# bf16 decode against a bf16 prefill of the same sequence: other matmul
# shapes round differently, 8 mantissa bits through up to 48 layers
# (relative L2 error of a step's logits); a MoE config is held at a
# capacity that drops nothing (see lm_serve)
BF16_REL_L2 = 5e-2
LM_PROFILE_STEPS = 3           # decode steps under torch.profiler
DIN_REQUESTS = {"serve_p99": 20, "serve_bulk": 5, "retrieval_cand": 3}
# retrieval_cand cut from 1,000,000 candidates: the attention unit holds
# (B, C, T, 144) float32, 57.6 GB at 10^6, and as much again in its parts
DIN_RETRIEVAL_CANDS = 250_000
F32_FLOPS_PER_S = 67e12        # float32 outside the tensor cores (SXM)
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
    result already computed for the same input. ``expect`` gives each
    kernel's launches, or computes them from the result. Returns the
    launch counts and the result."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if callable(expect):
        expect = expect(res)
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
        if stats.bytes_total:        # an incremental run: the store's part
            extra.update(segments_reused=stats.segments_reused,
                         segments_rescanned=stats.segments_rescanned,
                         bytes_rescanned=stats.bytes_rescanned,
                         bytes_total=stats.bytes_total,
                         scan_fraction=stats.bytes_rescanned
                         / stats.bytes_total,
                         footprints_replayed=stats.footprints_replayed)
    emit({"phase": label, "n_triples": res.n_triples, "passes": res.passes,
          "launches": launches, "wall_s": wall, "plain_wall_s": plain_wall,
          "max_memory_allocated": peak, "values": res.values,
          "matches_plain": True, **extra})
    return launches, res, wall


def scan_launch(planes, pln, specs, p):
    """The scan kernel of ``pln`` with ``specs``: its printed source, the
    compiled kernel, and a function that launches it alone on ``planes``
    (zeroing the outputs), without the wrapper's checks."""
    src = scan_codegen.generate_cached(tuple(pln.program), pln.n_counters,
                                       tuple(specs), p if specs else None)
    kern = _build.spec_kernel(src)
    counts = torch.zeros((pln.n_counters,), dtype=torch.int64,
                         device=planes.device)
    regs = torch.zeros((len(specs), 1 << p), dtype=torch.int32,
                       device=planes.device) if specs else None

    def launch():
        counts.zero_()
        if regs is not None:
            regs.zero_()
        kern.launch(planes, counts, regs)

    return src, kern, launch


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
    src, kern, launch = scan_launch(planes, pln, specs, p)
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


def _region(data: bytes, start_frac: float, size_frac: float):
    """Line-aligned [a, b) spanning ~``size_frac`` of ``data`` (the helper
    of ``benchmarks/fig_incremental.py``)."""
    a = data.find(b"\n", int(len(data) * start_frac)) + 1
    b = data.find(b"\n", a + int(len(data) * size_frac)) + 1
    return a, b


def incremental_phases(data: bytes):
    """The edits of ``benchmarks/fig_incremental.py``, one after another:
    (label, the dataset's bytes after it)."""
    n = BSBM_PRODUCTS
    yield "cold", data
    yield "warm", data
    data += bsbm_ntriples(max(1, n // 100), seed=4242).encode()
    yield "append_1pct", data
    a, b = _region(data, 0.25, 0.01)
    data = data[:a] + bsbm_ntriples(max(1, n // 100),
                                    seed=777).encode() + data[b:]
    yield "mutate_1pct", data
    a, b = _region(data, 0.5, 0.10)
    data = data[:a] + bsbm_ntriples(n // 10, seed=778).encode() + data[b:]
    yield "mutate_10pct", data
    a, b = _region(data, 0.2, 0.10)
    yield "delete_10pct", data[:a] + data[b:]


def phase_incremental(text: str, add, expect):
    """Phase 5: the BSBM text through one segment store, edit after edit,
    each phase held to the plain backend; then a warm ``twopass`` run and
    the CLI on the warm store."""
    work = tempfile.mkdtemp(prefix="chip_smoke_incremental_", dir=BUILD)
    path = os.path.join(work, "data.nt")
    store = os.path.join(work, "store")
    cold = None
    try:
        pipe = qa.pipeline().metrics("all").base(*BASE).incremental(store)
        for label, data in incremental_phases(text.encode()):
            with open(path, "wb") as f:
                f.write(data)
            res, _ = add(run_main_path(
                f"incremental-{label}", lambda: pipe.run(path),
                lambda: qa.assess(data, metrics="all", backend="torch",
                                  base=BASE),
                lambda r: expect(
                    fused_scan=r.exec_stats.segments_rescanned)))
            s = res.exec_stats
            fraction = s.bytes_rescanned / s.bytes_total
            check(s.bytes_total == len(data), f"{label}: bytes counted")
            check(res.passes == s.segments_rescanned * s.passes_per_chunk,
                  f"{label}: passes {res.passes}")
            if label == "cold":
                check(s.segments_reused == 0 and s.segments_rescanned
                      == s.chunks_total, "cold: every segment scanned")
                cold = res
            if label == "warm":
                check(s.segments_rescanned == 0 and s.bytes_rescanned == 0
                      and s.footprints_replayed == 0,
                      "warm: nothing rescanned or replayed")
            if label in SCAN_TARGETS:
                check(fraction <= SCAN_TARGETS[label],
                      f"{label}: rescanned {fraction:.1%} of the bytes, "
                      f"target {SCAN_TARGETS[label]:.0%}")
        last = res
        res, _ = add(run_main_path(
            "incremental-warm-twopass",
            lambda: pipe.backend("twopass").run(path), last, expect()))
        check(res.exec_stats.segments_rescanned == 0,
              "a warm twopass run rescans nothing")
        t = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.assess", "--nt", path,
             "--store", store, "--base", BASE[0]],
            env=SRC_ENV,
            capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t
        check(cli.returncode == 0, f"the CLI exited {cli.returncode}: "
              f"{cli.stderr[-2000:]}")
        check(" 0 rescanned" in cli.stderr, "the CLI rescanned nothing")
        want = "".join(f"{k:10s} {v:.6f}\n"
                       for k, v in sorted(last.values.items()))
        check(cli.stdout == want, "the CLI prints the last phase's values")
        emit({"phase": "incremental-cli", "seconds": cli_s,
              "stderr": cli.stderr.strip().splitlines()})
        profile_incremental(path, os.path.join(work, "profiled"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return cold


# where an incremental run's host time goes: (label, module path suffix,
# function name) of the calls whose cumulative time the profile reports
PROFILED = (
    ("segmentation", "store/segmenter.py", "iter_segments"),
    ("state loads", "store/store.py", "load_state"),
    ("footprint replay", "store/runner.py", "replay_deferred"),
    ("parse and encode", "rdf/ingest.py", "parse_encode"),
    ("footprint capture", "store/runner.py", "_footprint_ids"),
    ("footprint keys", "rdf/encoder.py", "keys_for"),
    ("dictionary planes", "rdf/encoder.py", "plane_arrays"),
    ("chunk evals (copy, launch, sync)", "core/evaluator.py", "eval_chunk"),
    ("state writes", "store/store.py", "put_state"),
    ("manifest commit", "store/store.py", "commit"),
    ("history", "store/store.py", "append_history"),
)


def profile_incremental(path: str, store: str) -> None:
    """A cold and a warm run of ``path`` on a fresh store under cProfile
    (not part of the main path: its launches are not counted): the
    cumulative seconds of each step of the incremental runner, against
    the run's wall time under the profiler."""
    import cProfile
    import pstats
    pipe = qa.pipeline().metrics("all").base(*BASE).incremental(store)
    out = {}
    calls = {name: 0 for name, _, _ in PROFILED}
    for label in ("cold", "warm"):
        prof = cProfile.Profile()
        t = time.perf_counter()
        prof.enable()
        res = pipe.run(path)
        torch.cuda.synchronize()
        prof.disable()
        wall = time.perf_counter() - t
        stats = pstats.Stats(prof).stats
        steps = {}
        for name, suffix, fn in PROFILED:
            hits = [v for (file, _, func), v in stats.items()
                    if func == fn and file.endswith(suffix)]
            steps[name] = sum(v[3] for v in hits)
            calls[name] += sum(v[1] for v in hits)
        out[label] = {"wall_s": wall,
                      "segments_rescanned":
                          res.exec_stats.segments_rescanned,
                      "cumulative_s": steps}
    # a renamed or inlined step would read 0 s: each must have been called
    for name, suffix, fn in PROFILED:
        check(calls[name] > 0, f"incremental-profile: {suffix}::{fn} "
              f"({name}) was never called")
    emit({"phase": "incremental-profile", "profiler": "cProfile", **out})


# -- 6. the service and 7. the catalog crawler -------------------------------

SERVE_TENANTS = 3           # uploaded while the registered source's cold job
#                             runs, so that both workers use the card at once
FLEET = 8                   # benchmarks/fig_catalog.py, full mode
FLEET_PRODUCTS = 2_000
FLEET_SEGMENT_BYTES = 65_536
FLEET_WORKERS = 4
SERVE_BANNER = "# repro_torch.serve on http://"


def http(port: int, method: str, path: str, body=None):
    """(status, JSON or raw bytes) of one request to a daemon on this
    machine; 4xx and 5xx return instead of raising."""
    r = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                               method=method)
    try:
        with urllib.request.urlopen(r, timeout=120) as resp:
            raw, status = resp.read(), resp.status
            ctype = resp.headers.get("Content-Type", "")
    except urllib.error.HTTPError as e:
        raw, status = e.read(), e.code
        ctype = e.headers.get("Content-Type", "")
    return status, json.loads(raw) if ctype.startswith(
        "application/json") else raw


def wait_job(port: int, name: str, job_id: int, timeout: float = 600.0,
             ok: bool = True) -> dict:
    """Poll one job to its end; with ``ok`` it must have succeeded."""
    deadline = time.time() + timeout
    while True:
        st, job = http(port, "GET", f"/datasets/{name}/jobs/{job_id}")
        check(st == 200, f"job {name}/{job_id}: HTTP {st}")
        if job["state"] in ("done", "failed"):
            check(not ok or job["state"] == "done",
                  f"job {name}/{job_id} failed: {job['error']}")
            return job
        check(time.time() < deadline,
              f"job {name}/{job_id} still {job['state']} after {timeout}s")
        time.sleep(0.05)


def upload(port: int, name: str, data: bytes) -> int:
    st, doc = http(port, "PUT", f"/datasets/{name}/data", body=data)
    check(st == 202, f"upload to {name}: HTTP {st} {doc}")
    return doc["job"]["id"]


def same_job_values(job: dict, plain, label: str) -> None:
    check(job["values"] == {k: float(v) for k, v in
                            sorted(plain.values.items())},
          f"{label}: values equal the plain backend's")
    check(job["n_triples"] == plain.n_triples, f"{label}: n_triples equal")


class RunnerStats:
    """The ``ChunkStats`` of every incremental run while active, by store
    directory: wraps ``repro_torch.store.assess_incremental``, which the
    pipeline looks up at each run. The service keeps only a summary of a
    job's stats; this keeps the seconds of its chunk evals too."""

    def __enter__(self):
        from repro_torch import store
        self._store, self._orig = store, store.assess_incremental
        self.runs: dict[str, list] = {}
        lock = threading.Lock()

        def wrapped(evaluator, segments, store_dir, **kw):
            res = self._orig(evaluator, segments, store_dir, **kw)
            with lock:
                self.runs.setdefault(store_dir, []).append(res.exec_stats)
            return res

        store.assess_incremental = wrapped
        return self

    def __exit__(self, *exc):
        self._store.assess_incremental = self._orig


def job_breakdown(job: dict, stats) -> dict:
    """Where a served job's time went: waiting in the queue, then the
    incremental runner (its chunk evals: copy, launch, sync on the card;
    the rest: segmentation, parse and encode, state loads and writes on
    the host), then reports, history and alerts."""
    evals = sum(stats.chunk_eval_seconds)
    return {"dataset": job["dataset"], "trigger": job["trigger"],
            "queue_wait_s": job["started_at"] - job["enqueued_at"],
            "run_s": job["finished_at"] - job["started_at"],
            "runner_wall_s": stats.wall_seconds, "chunk_eval_s": evals,
            "host_runner_s": stats.wall_seconds - evals,
            **{k: job["exec_stats"][k] for k in (
                "segments_rescanned", "segments_reused", "bytes_rescanned",
                "bytes_total")}}


def dataset_jobs(port: int, name: str) -> list:
    st, doc = http(port, "GET", f"/datasets/{name}/jobs")
    check(st == 200, f"jobs of {name}: HTTP {st}")
    return doc["jobs"]


def phase_serve(text: str, cold, launches) -> None:
    """Phase 6: an in-process daemon with the defaults (``fused_scan`` on
    ``cuda``) and two workers: the BSBM text as a watched server-side
    source, three tenants uploaded while its cold job runs, a ~1% append
    to the source, an unchanged re-upload; every job held to the plain
    backend on the card, ``fused_scan`` launched once per rescanned
    segment over all jobs."""
    from repro_torch.serve import QAServer, ServerConfig
    work = tempfile.mkdtemp(prefix="chip_smoke_serve_", dir=BUILD)
    source = os.path.join(work, "bsbm.nt")
    data = text.encode()
    with open(source, "wb") as f:
        f.write(data)
    tenants = {f"t{i}": bsbm_ntriples(FLEET_PRODUCTS, seed=i).encode()
               for i in range(SERVE_TENANTS)}
    plain = {n: qa.assess(d, metrics="all", backend="torch", base=BASE)
             for n, d in tenants.items()}
    srv = QAServer(ServerConfig(store_root=os.path.join(work, "root"),
                                metrics="all", base=BASE, workers=2,
                                poll_interval=0.2), port=0)
    check((srv.config.backend, srv.config.device) == ("fused_scan", "cuda"),
          "the service's defaults are the fused_scan kernel on the card")
    try:
        with RunnerStats() as runner:
            srv.start()
            torch.cuda.synchronize()
            K.reset_launches()
            t0 = time.perf_counter()
            st, doc = http(srv.port, "PUT", "/datasets/bsbm", body=json.dumps(
                {"source": source}).encode())
            check(st == 201, f"register bsbm: HTTP {st} {doc}")
            deadline = time.time() + 60
            while not any(j["state"] == "running"
                          for j in dataset_jobs(srv.port, "bsbm")):
                check(time.time() < deadline, "the watcher never started "
                      "the source's cold job")
                time.sleep(0.02)
            ids = {n: upload(srv.port, n, d) for n, d in tenants.items()}
            check(dataset_jobs(srv.port, "bsbm")[0]["state"] == "running",
                  "the tenants were uploaded while the cold job ran")
            jobs = [wait_job(srv.port, n, i) for n, i in ids.items()]
            cold_job = wait_job(srv.port, "bsbm",
                                dataset_jobs(srv.port, "bsbm")[0]["id"])
            cold_wall = time.perf_counter() - t0
            same_job_values(cold_job, cold, "serve bsbm cold")
            for job in jobs:
                same_job_values(job, plain[job["dataset"]],
                                f"serve {job['dataset']}")
            overlap = [j["dataset"] for j in jobs
                       if j["started_at"] < cold_job["finished_at"]]
            check(overlap, "a tenant's job ran beside the cold job")
            jobs.insert(0, cold_job)

            # ~1% appended, as phase 5, by an atomic replace of the source
            edited = data + bsbm_ntriples(max(1, BSBM_PRODUCTS // 100),
                                          seed=4242).encode()
            with open(source + ".tmp", "wb") as f:
                f.write(edited)
            t = time.perf_counter()
            os.replace(source + ".tmp", source)
            deadline = time.time() + 600
            while len(dataset_jobs(srv.port, "bsbm")) < 2:
                check(time.time() < deadline, "the watcher missed the edit")
                time.sleep(0.02)
            edit_job = wait_job(srv.port, "bsbm",
                                dataset_jobs(srv.port, "bsbm")[1]["id"])
            edit_wall = time.perf_counter() - t
            same_job_values(edit_job, qa.assess(
                edited, metrics="all", backend="torch", base=BASE),
                "serve bsbm append")
            es = edit_job["exec_stats"]
            fraction = es["bytes_rescanned"] / es["bytes_total"]
            check(es["bytes_total"] == len(edited), "append: bytes counted")
            check(fraction <= SCAN_TARGETS["append_1pct"],
                  f"serve append: rescanned {fraction:.1%} of the bytes")
            jobs.append(edit_job)

            # an unchanged re-upload: nothing rescanned, nothing launched
            torch.cuda.synchronize()
            before = dict(K.LAUNCHES)
            again = wait_job(srv.port, "t0", upload(srv.port, "t0",
                                                    tenants["t0"]))
            torch.cuda.synchronize()
            check(again["exec_stats"]["segments_rescanned"] == 0
                  and dict(K.LAUNCHES) == before,
                  "an unchanged re-upload rescans and launches nothing")
            same_job_values(again, plain["t0"], "serve t0 re-upload")
            jobs.append(again)
            counts = dict(K.LAUNCHES)
            wall = time.perf_counter() - t0

        st, rep = http(srv.port, "GET", "/datasets/t1/report")
        check(st == 200 and len(rep["measurements"]) == len(ALL_METRICS)
              and rep["nTriples"] == plain["t1"].n_triples,
              "the served DQV report has one measurement per metric")
        st, prom = http(srv.port, "GET", "/metrics")
        check(st == 200 and b'repro_assessments_total{dataset="bsbm",'
              b'state="done"} 2' in prom, "/metrics counts the assessments")
        st, ranking = http(srv.port, "GET", "/catalog/ranking")
        check(st == 200 and [r["rank"] for r in ranking["ranking"]]
              == [1, 2, 3, 4], "/catalog/ranking ranks the 4 tenants")
    finally:
        srv.close()
        shutil.rmtree(work, ignore_errors=True)
    segs = sum(j["exec_stats"]["segments_rescanned"] for j in jobs)
    check(counts == {"qap_count": 0, "fused_scan": segs, "hll_fold": 0},
          f"serve: launches {counts}, expected fused_scan {segs}")
    for k in launches:
        launches[k] += counts[k]
    seen: dict[str, int] = {}
    breakdown = []
    for job in jobs:
        stores = runner.runs[srv.registry.store_dir(job["dataset"])]
        breakdown.append(job_breakdown(job, stores[seen.get(
            job["dataset"], 0)]))
        seen[job["dataset"]] = seen.get(job["dataset"], 0) + 1
    emit({"phase": "serve", "workers": 2, "backend": "fused_scan",
          "source_bytes": len(data), "tenant_bytes": [
              len(d) for d in tenants.values()],
          "launches": counts, "segments_rescanned": segs,
          "wall_s": wall, "cold_phase_wall_s": cold_wall,
          "append_wall_s": edit_wall, "append_scan_fraction": fraction,
          "beside_cold_job": overlap, "jobs": breakdown,
          "matches_plain": True})


def start_daemon(argv: list, timeout: float = 300.0):
    """A daemon in a process of its own: the process, its port from the
    startup banner, and the list its standard error lines go to."""
    proc = subprocess.Popen([sys.executable, *argv], env=SRC_ENV,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    lines: list[str] = []
    ready = threading.Event()

    def read():
        for line in proc.stderr:
            lines.append(line)
            if line.startswith(SERVE_BANNER):
                ready.set()

    threading.Thread(target=read, daemon=True).start()
    if not ready.wait(timeout):
        proc.kill()
        check(False, f"no startup banner from {argv}: {''.join(lines)}")
    head = next(ln for ln in lines if ln.startswith(SERVE_BANNER))
    port = int(head[len(SERVE_BANNER):].split(" ", 1)[0].rsplit(":", 1)[1])
    return proc, port, lines


def phase_serve_cli() -> None:
    """Phase 6b, part 1: ``python -m repro_torch.launch.assess --serve 0``
    in a process of its own: one upload held to the plain backend, then
    SIGTERM and a clean shutdown with exit code 0."""
    work = tempfile.mkdtemp(prefix="chip_smoke_serve_cli_", dir=BUILD)
    data = bsbm_ntriples(FLEET_PRODUCTS, seed=SERVE_TENANTS).encode()
    t = time.perf_counter()
    proc, port, lines = start_daemon(
        ["-m", "repro_torch.launch.assess", "--serve", "0", "--store-root",
         os.path.join(work, "root"), "--base", BASE[0]])
    try:
        startup = time.perf_counter() - t
        t = time.perf_counter()
        job = wait_job(port, "cli", upload(port, "cli", data))
        job_s = time.perf_counter() - t
        same_job_values(job, qa.assess(data, metrics="all",
                                       backend="torch", base=BASE),
                        "serve-cli")
        t = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        stop_s = time.perf_counter() - t
        err = "".join(lines)
        check(rc == 0 and "clean shutdown" in err,
              f"serve-cli: exit {rc} after SIGTERM: {err[-2000:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "serve-cli", "startup_s": startup, "job_s": job_s,
          "shutdown_s": stop_s, "banner": lines[0].strip(),
          "segments_rescanned": job["exec_stats"]["segments_rescanned"],
          "matches_plain": True})


# the chaos drill's daemon (scripts/serve_smoke.py --chaos, on the card):
# phase "crash" exits 17 right after journaling the second job's start,
# phase "clean" replays the journal with dataset c2's first attempt failing
CHAOS_DAEMON = """\
import os, signal, sys
root, portfile, phase = sys.argv[1:4]
from repro_torch.serve import QAServer, ServerConfig, ServiceFaultInjector
if phase == "crash":
    faults = ServiceFaultInjector(slow_jobs={"c1": 1.0},
                                  crash_after_journal={"start#2"},
                                  fail_webhooks=-1)
else:
    faults = ServiceFaultInjector(fail_jobs={"c2": 1})
srv = QAServer(ServerConfig(store_root=root, metrics="all",
                            base=("http://bsbm.example.org/",), workers=1,
                            watch=False, retry_base=0.05, webhook_retries=2,
                            webhook_backoff=0.05),
               port=0, faults=faults).start()
signal.signal(signal.SIGTERM, lambda s, f: srv.request_stop())
with open(portfile + ".tmp", "w") as f:
    f.write(str(srv.port))
os.replace(portfile + ".tmp", portfile)
srv.wait()
srv.close()
print("# chaos daemon: clean shutdown", flush=True)
"""


def phase_serve_chaos() -> None:
    """Phase 6b, part 2: the crash drill of ``scripts/serve_smoke.py
    --chaos`` with port daemons on the card: three uploads accepted, the
    daemon killed by the crash point after journaling the second job's
    start, and a restarted daemon that completes every accepted job (one
    of them after a transient failure), each held to the plain backend."""
    work = tempfile.mkdtemp(prefix="chip_smoke_chaos_", dir=BUILD)
    root = os.path.join(work, "root")
    portfile = os.path.join(work, "port")
    data = {f"c{i}": bsbm_ntriples(120, seed=i).encode() for i in (1, 2, 3)}
    procs = []

    def spawn(phase):
        if os.path.exists(portfile):
            os.remove(portfile)
        log = os.path.join(work, f"{phase}.log")
        with open(log, "w") as f:
            p = subprocess.Popen([sys.executable, "-c", CHAOS_DAEMON, root,
                                  portfile, phase], env=SRC_ENV, stdout=f,
                                 stderr=subprocess.STDOUT)
        procs.append(p)
        deadline = time.time() + 300
        while not os.path.exists(portfile):
            if p.poll() is not None:
                with open(log) as f:
                    check(False, f"chaos daemon ({phase}) died at "
                          f"start-up: {f.read()[-2000:]}")
            check(time.time() < deadline, "chaos daemon never came up")
            time.sleep(0.05)
        with open(portfile) as f:
            return p, int(f.read())

    t0 = time.perf_counter()
    try:
        p1, port = spawn("crash")
        st, _ = http(port, "PUT", "/datasets/c1", body=json.dumps(
            {"alerts": ["L1 >= 0"],
             "webhook": "http://127.0.0.1:9/hook"}).encode())
        check(st == 201, f"register c1: HTTP {st}")
        ids = {n: upload(port, n, d) for n, d in data.items()}
        rc = p1.wait(timeout=300)
        check(rc == 17, f"the crash point exits 17, got {rc}")
        crash_s = time.perf_counter() - t0

        t = time.perf_counter()
        p2, port = spawn("clean")
        lost = []
        for name in ("c2", "c3"):       # c1 finished before the crash
            job = wait_job(port, name, ids[name], ok=False)
            if job["state"] != "done":
                lost.append((name, job["error"]))
                continue
            same_job_values(job, qa.assess(data[name], metrics="all",
                                           backend="torch", base=BASE),
                            f"chaos {name}")
            if name == "c2":
                check(job["attempts"] == 2, "c2 retried once")
        check(not lost, f"jobs lost across the crash: {lost}")
        st, rep = http(port, "GET", "/datasets/c1/report")
        check(st == 200 and rep["measurements"], "c1's report survived")
        st, doc = http(port, "POST", "/datasets/c1/assess")
        check(st == 202, f"re-assess c1: HTTP {st}")
        j1 = wait_job(port, "c1", doc["job"]["id"])
        check(j1["alerts_fired"] >= 1, "c1's alert fired again")
        same_job_values(j1, qa.assess(data["c1"], metrics="all",
                                      backend="torch", base=BASE),
                        "chaos c1")
        st, prom = http(port, "GET", "/metrics")
        for want in (b'repro_jobs_replayed_total{dataset="c2"} 1',
                     b'repro_jobs_replayed_total{dataset="c3"} 1',
                     b'repro_job_retries_total{dataset="c2"} 1',
                     b'repro_webhook_failures_total{dataset="c1"} 1'):
            check(want in prom, f"/metrics has {want!r}")
        st, doc = http(port, "DELETE", "/datasets/c3")
        check(st == 200 and doc["bytes_reclaimed"] > 0,
              "DELETE reclaimed c3's store")
        p2.send_signal(signal.SIGTERM)
        rc = p2.wait(timeout=120)
        check(rc == 0, f"the restarted daemon exits {rc} on SIGTERM")
        replay_s = time.perf_counter() - t
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "serve-chaos", "accepted": len(ids), "lost": 0,
          "replayed": 2, "crash_exit": 17, "crash_s": crash_s,
          "replay_s": replay_s, "matches_plain": True})


def phase_catalog(launches) -> None:
    """Phase 7: the fleet of ``benchmarks/fig_catalog.py`` (full mode)
    served as a remote DCAT catalog by the fetch plane's flaky origin on
    this machine, crawled cold, warm and after a ~2% edit of one dataset
    (that crawl through ``twopass``); every dataset in every crawl held
    to the plain backend on the card, values and registers. Then the
    ``qa_catalog rank`` CLI in a process of its own."""
    from repro_torch import catalog
    from repro_torch.fetch import FlakyOriginServer
    work = tempfile.mkdtemp(prefix="chip_smoke_catalog_", dir=BUILD)
    origin_dir = os.path.join(work, "origin")
    root = os.path.join(work, "root")
    os.makedirs(origin_dir)
    entries = []
    for i in range(FLEET):
        name = f"ds{i:02d}"
        with open(os.path.join(origin_dir, f"{name}.nt"), "wb") as f:
            f.write(bsbm_ntriples(FLEET_PRODUCTS, seed=100 + i).encode())
        entries.append({"title": name,
                        "distribution": [{"downloadURL": f"{name}.nt"}]})
    with open(os.path.join(origin_dir, "catalog.json"), "w") as f:
        json.dump({"dataset": entries}, f)
    fleet_bytes = sum(os.path.getsize(os.path.join(origin_dir, f"{e}.nt"))
                      for e in (x["title"] for x in entries))

    def crawl(label, url, backend):
        torch.cuda.synchronize()
        K.reset_launches()
        t = time.perf_counter()
        summary = catalog.crawl_catalog(
            url, root, metrics="all", backend=backend, base=BASE,
            workers=FLEET_WORKERS, segment_bytes=FLEET_SEGMENT_BYTES,
            keep_results=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = dict(K.LAUNCHES)
        check(summary["n_failed"] == 0, f"catalog-{label}: "
              f"{[d['error'] for d in summary['datasets']]}")
        results = summary.pop("results")
        for rec in summary["datasets"]:
            same_result(results[rec["name"]], qa.assess(
                rec["path"], metrics="all", backend="torch", base=BASE))
        evals = sum(sum(r.exec_stats.chunk_eval_seconds)
                    for r in results.values())
        segs = summary["segments_rescanned"]
        for k in launches:
            launches[k] += counts[k]
        emit({"phase": f"catalog-{label}", "backend": backend,
              "datasets": FLEET, "fleet_bytes": fleet_bytes,
              "workers": FLEET_WORKERS, "wall_s": wall,
              "crawl_wall_s": summary["wall_seconds"],
              "bytes_rescanned": summary["bytes_rescanned"],
              "segments_rescanned": segs,
              "segments_reused": summary["segments_reused"],
              "footprints_replayed": sum(d["footprints_replayed"]
                                         for d in summary["datasets"]),
              "fetch": summary["fetch"], "launches": counts,
              "chunk_eval_s": evals, "busy_share": evals / wall,
              "dataset_wall_s": {d["name"]: d["wall_seconds"]
                                 for d in summary["datasets"]},
              "matches_plain": True})
        return summary, counts

    try:
        with FlakyOriginServer(origin_dir) as origin:
            url = origin.url_for("catalog.json")
            cold, counts = crawl("cold", url, "fused_scan")
            check(cold["bytes_total"] == fleet_bytes == cold[
                "bytes_rescanned"] and cold["segments_reused"] == 0,
                "cold: every dataset scanned")
            check(counts == {"qap_count": 0, "hll_fold": 0,
                             "fused_scan": cold["segments_rescanned"]},
                  f"cold: launches {counts}")
            warm, counts = crawl("warm", url, "fused_scan")
            check(warm["bytes_rescanned"] == 0 and sum(
                d["footprints_replayed"] for d in warm["datasets"]) == 0
                and sum(counts.values()) == 0,
                "warm: nothing rescanned, replayed or launched")
            check(warm["fetch"]["not_modified"] == FLEET
                  and warm["fetch"]["bytes_fetched"] == 0,
                  "warm: every fetch a 304 with no bytes")

            # a contiguous ~2% in-place rewrite of one dataset
            edited = os.path.join(origin_dir, "ds01.nt")
            with open(edited, "rb") as f:
                data = f.read()
            a = data.find(b"\n", int(len(data) * 0.4)) + 1
            b = data.find(b"\n", a + int(len(data) * 0.02)) + 1
            with open(edited, "wb") as f:
                f.write(data[:a] + bsbm_ntriples(
                    max(1, FLEET_PRODUCTS // 50), seed=999).encode()
                    + data[b:])
            edit, counts = crawl("edit_one", url, "twopass")
            per = {d["name"]: d for d in edit["datasets"]}
            segs = per["ds01"]["segments_rescanned"]
            check(segs > 0 and all(d["bytes_rescanned"] == 0 for n, d in
                                   per.items() if n != "ds01"),
                  "edit_one: only the edited dataset rescans")
            check(counts == {"qap_count": segs, "hll_fold": 2 * segs,
                             "fused_scan": 0},
                  f"edit_one: launches {counts}, {segs} segments")
            check(edit["fetch"]["not_modified"] == FLEET - 1,
                  "edit_one: the other datasets revalidate")
        t = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.qa_catalog", "rank",
             "--root", root], env=SRC_ENV, capture_output=True, text=True,
            timeout=300)
        cli_s = time.perf_counter() - t
        check(cli.returncode == 0, f"qa_catalog rank exited "
              f"{cli.returncode}: {cli.stderr[-2000:]}")
        ranking = catalog.rank_catalog(root)
        check(json.loads(cli.stdout) == ranking,
              "qa_catalog rank prints the in-process ranking")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "catalog-rank-cli", "seconds": cli_s,
          "ranked": [r["name"] for r in ranking["ranking"]],
          "scan_fraction_edit_one": edit["bytes_rescanned"]
          / edit["bytes_total"]})


# -- 3b. the mesh -------------------------------------------------------------

def pack(res, launches=None, wall=None) -> dict:
    """An assessment as a rank reports it, on one JSON line."""
    s = res.exec_stats
    out = {"counts": res.counts, "values": res.values,
           "n_triples": res.n_triples, "passes": res.passes,
           "registers": {k: v.tolist() for k, v in res.registers.items()},
           "launches": launches, "wall_s": wall}
    if s is not None:
        out["stats"] = {k: getattr(s, k) for k in (
            "devices", "mode", "chunks_total", "segments_reused",
            "segments_rescanned", "bytes_rescanned", "bytes_total",
            "footprints_replayed")}
        out["stats"]["chunk_eval_seconds_sum"] = sum(s.chunk_eval_seconds)
    return out


def same_packed(got: dict, ref, label: str) -> None:
    """Hold a rank's packed result to ``ref``: counters, registers, values
    and ``n_triples`` equal."""
    check(got["counts"] == ref.counts, f"{label}: counters equal")
    check(set(got["registers"]) == set(ref.registers),
          f"{label}: same sketches")
    for k, v in ref.registers.items():
        check(np.array_equal(np.asarray(got["registers"][k], np.int32), v),
              f"{label}: register bank {k} equal")
    check(got["values"] == ref.values, f"{label}: values equal")
    check(got["n_triples"] == ref.n_triples, f"{label}: n_triples equal")


def mesh_kernel_ms(label: str, planes) -> dict:
    """Each kernel a run of ``label`` launches, timed (CUDA events, mean of
    10 calls) on ``planes``, the rank's shard at the run's shape: through
    its wrapper, and for the scan kernel also the launch alone."""
    all_plan = plan(get_metrics(ALL_METRICS))
    if label in ("paper", "nccl-paper"):
        pln = plan(get_metrics(PAPER_METRICS))
        return {"qap_count": cuda_ms(lambda: qops.fused_count(
                    planes, pln.program, pln.n_counters), 10),
                "qap_count_launch": cuda_ms(
                    scan_launch(planes, pln, (), MAIN_P)[2], 10)}
    if label == "twopass":
        out = {"qap_count": cuda_ms(lambda: qops.fused_count(
            planes, all_plan.program, all_plan.n_counters), 10)}
        for name, cols in all_plan.sketch_specs:
            out[f"hll_fold_{name}"] = cuda_ms(
                lambda: hops.hll_fold(planes, cols, MAIN_P), 10)
        return out
    return {"fused_scan": cuda_ms(lambda: fops.fused_scan(
                planes, all_plan.program, all_plan.n_counters,
                all_plan.sketch_specs, MAIN_P), 10),
            "fused_scan_launch": cuda_ms(scan_launch(
                planes, all_plan, all_plan.sketch_specs, MAIN_P)[2], 10)}


def mesh_reduce_ms(ev, planes, reps: int = 20) -> dict:
    """Host milliseconds of one ``reduce_over_mesh`` of a pass's outputs
    over ``planes`` (under ``gloo`` the copies of the outputs to the host
    are part of it), and of its collectives alone on tensors of the same
    sizes already where the backend takes them; each after a barrier."""
    outs = ev.dispatch_chunk(planes)
    counts, regs = [c for c, _ in outs], {}
    for _, r in outs:
        regs.update(r)
    torch.cuda.synchronize()

    def per_call(fn) -> float:
        ev.barrier()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / reps * 1e3

    group = ev.mesh.get_group()
    dev = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
    flat = torch.zeros(sum(c.numel() for c in counts), dtype=torch.int64,
                       device=dev)
    bank = torch.zeros((len(regs), 1 << MAIN_P), dtype=torch.int32,
                       device=dev)

    def collectives():
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        if regs:
            dist.all_reduce(bank, op=dist.ReduceOp.MAX, group=group)

    return {"reduce_ms": per_call(lambda: ev.reduce_over_mesh(counts, regs)),
            "collectives_ms": per_call(collectives)}


def mesh_row_pipes(mesh) -> dict:
    """The runs of the four-rank part: label -> pipeline."""
    pipe = qa.pipeline().metrics("all").shard(mesh)
    return {"single": pipe,
            "paper": qa.pipeline().metrics("paper").shard(mesh),
            "pipelined": pipe.chunked(MESH_CHUNKS).pipelined(2),
            "twopass": pipe.backend("twopass")}


def mesh_rank_run(run, ev) -> dict:
    """One main-path run on this rank, launch counts zeroed just before
    and read just after, after a barrier so the ranks start together."""
    ev.barrier()
    torch.cuda.synchronize()
    K.reset_launches()
    t = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    return pack(res, dict(K.LAUNCHES), wall)


def mesh_rank(spec: dict) -> int:
    """One rank of a launch of ``phase_mesh`` (``chip_smoke.py --mesh-rank
    SPEC``): the spec's runs, then this rank's kernel times (one rank at a
    time) and collective times; prints one JSON line."""
    mesh = mesh_mod.make_assessment_mesh(device="cuda")
    try:
        group = mesh.get_group()
        rank, world = dist.get_rank(), dist.get_world_size()
        out = {"rank": rank, "backend": dist.get_backend(group), "runs": {},
               "kernel_ms": {}, "collective_ms": {}}
        if spec["case"] == "rows":
            tt = TripleTensor(np.load(spec["planes"], mmap_mode="c"),
                              spec["n_valid"], spec["n_terms"])
            pipes = mesh_row_pipes(mesh)
            for label, pipe in pipes.items():
                out["runs"][label] = mesh_rank_run(lambda: pipe.run(tt),
                                                   pipe.evaluator())
            shapes = {label: pipes[label].evaluator().device_planes(
                tt.chunks(MESH_CHUNKS)[0] if label == "pipelined" else tt)
                for label in pipes}
            for r in range(world):          # one rank at a time on the card
                dist.barrier(group)
                if r == rank:
                    out["kernel_ms"] = {label: mesh_kernel_ms(label, planes)
                                        for label, planes in shapes.items()}
            for label, planes in shapes.items():
                out["collective_ms"][label] = mesh_reduce_ms(
                    pipes[label].evaluator(), planes)
            out["shard_rows"] = {k: v.shape[0] for k, v in shapes.items()}
        else:
            pipe = qa.pipeline().metrics("all").base(*BASE).shard(
                mesh).incremental(spec["store"])
            ev = pipe.evaluator()
            for label in ("cold", "mutated"):
                out["runs"][label] = mesh_rank_run(
                    lambda: pipe.run(spec[label]), ev)
            with open(spec["cold"], "rb") as f:
                seg = next(iter_segments_bytes(f.read(),
                                               DEFAULT_TARGET_BYTES))
            # a whole segment, as eval_segment_batch hands it to a rank
            planes = torch.from_numpy(rdf_ingest.parse_encode(
                seg, base_namespaces=BASE).planes).cuda()
            for r in range(world):
                dist.barrier(group)
                if r == rank:
                    out["kernel_ms"]["segment"] = mesh_kernel_ms(
                        "single", planes)
            empty = [TripleTensor(np.zeros((0, planes.shape[1]), np.int32),
                                  0)] * world
            ev.barrier()
            t = time.perf_counter()
            for _ in range(20):
                ev.eval_segment_batch(empty)
            out["collective_ms"]["segment_batch"] = \
                (time.perf_counter() - t) / 20 * 1e3
            out["segment_rows"] = planes.shape[0]
        print(json.dumps(out), flush=True)
    finally:
        mesh_mod.close_ranks()
    return 0


def launch_mesh(n: int, spec: dict) -> tuple[list, float]:
    """``n`` ranks of ``mesh_rank`` on ``spec``; their JSON lines, and the
    launch's wall seconds (process start-up included)."""
    t = time.perf_counter()
    results = mesh_mod.launch_ranks(
        n, [os.path.abspath(__file__), "--mesh-rank", json.dumps(spec)],
        timeout=MESH_TIMEOUT)
    wall = time.perf_counter() - t
    return [json.loads(r.stdout.strip().splitlines()[-1])
            for r in results], wall


def phase_mesh(tt, small, single, paper, launches, smi) -> None:
    """Phase 3b: the main path over a mesh of ranks (module docstring)."""
    t_phase = time.perf_counter()

    def count(per_kernel: dict) -> None:
        for k in launches:
            launches[k] += per_kernel.get(k, 0)

    # (1) one nccl rank in this process, at full size
    mesh = mesh_mod.make_assessment_mesh(1, device="cuda")
    try:
        backend = dist.get_backend(mesh.get_group())
        check(backend == "nccl", f"a one-rank group is {backend}")
        for label, metrics, ref, kernel in (
                ("nccl-all", "all", single, "fused_scan"),
                ("nccl-paper", "paper", paper, "qap_count")):
            pipe = qa.pipeline().metrics(metrics).shard(mesh)
            got, res, wall = run_main_path(
                f"mesh-{label}", lambda: pipe.run(tt), ref,
                {k: int(k == kernel) for k in KERNELS},
                backend=backend, ranks=1, card=smi)
            count(got)
            check(res.passes == ref.passes == 1, f"{label}: one pass")
            ev = pipe.evaluator()
            planes = ev.device_planes(tt)
            emit({"phase": f"mesh-{label}-timing", "backend": backend,
                  "ranks": 1, "rows": tt.n_rows, "card": smi,
                  "rank_kernel_ms": [mesh_kernel_ms(label, planes)],
                  "allreduce": [mesh_reduce_ms(ev, planes)],
                  "wall_s": wall})
            del planes
            torch.cuda.empty_cache()
    finally:
        mesh_mod.close_ranks()
    check(not dist.is_initialized(), "the one-rank group is destroyed")

    work = tempfile.mkdtemp(prefix="chip_smoke_mesh_", dir=BUILD)
    try:
        # (2) four gloo ranks sharing the card, at the BSBM 2 GB count
        path = os.path.join(work, "planes.npy")
        np.save(path, small.planes)
        ref = {"single": qa.assess(small, metrics="all", backend="torch")}
        ref["paper"] = qa.assess(small, metrics="paper", backend="torch")
        ref["pipelined"] = ref["twopass"] = ref["single"]
        expect = {"single": {"fused_scan": 1}, "paper": {"qap_count": 1},
                  "pipelined": {"fused_scan": MESH_CHUNKS},
                  "twopass": {"qap_count": 1, "hll_fold": 2}}
        passes = {"single": 1, "paper": 1, "pipelined": MESH_CHUNKS,
                  "twopass": 3}
        outs, launch_wall = launch_mesh(MESH_RANKS, {
            "case": "rows", "planes": path, "n_valid": small.n_valid,
            "n_terms": small.n_terms})
        for label in expect:
            for o in outs:
                got = o["runs"][label]
                name = f"mesh-gloo{MESH_RANKS}-{label} rank {o['rank']}"
                check(o["backend"] == "gloo", f"{name}: {o['backend']}")
                same_packed(got, ref[label], name)
                check(got["passes"] == passes[label],
                      f"{name}: {got['passes']} passes")
                want = {k: expect[label].get(k, 0) for k in KERNELS}
                check(got["launches"] == want,
                      f"{name}: launched {got['launches']}, expected {want}")
                if label == "pipelined":
                    check(got["stats"]["devices"] == MESH_RANKS
                          and got["stats"]["chunks_total"] == MESH_CHUNKS,
                          f"{name}: {got['stats']}")
                count(got["launches"])
            emit({"phase": f"mesh-gloo{MESH_RANKS}-{label}",
                  "backend": "gloo", "ranks": MESH_RANKS,
                  "rows": small.n_rows, "card": smi,
                  "shard_rows": [o["shard_rows"][label] for o in outs],
                  "launches_per_rank": outs[0]["runs"][label]["launches"],
                  "passes": outs[0]["runs"][label]["passes"],
                  "rank_kernel_ms": [o["kernel_ms"][label] for o in outs],
                  "allreduce": [o["collective_ms"][label] for o in outs],
                  "wall_s": [o["runs"][label]["wall_s"] for o in outs],
                  "stats": outs[0]["runs"][label].get("stats"),
                  "values": outs[0]["runs"][label]["values"],
                  "matches_plain": True})
        emit({"phase": f"mesh-gloo{MESH_RANKS}-launch",
              "seconds": launch_wall, "card": smi})
        os.remove(path)

        # (3) the segment store under a 2-rank mesh: cold, ~1% mutated
        text = bsbm_ntriples(BSBM_PRODUCTS, seed=7).encode()
        a, b = _region(text, 0.25, 0.01)
        mutated = (text[:a] + bsbm_ntriples(max(1, BSBM_PRODUCTS // 100),
                                            seed=777).encode() + text[b:])
        paths = {}
        for label, data in (("cold", text), ("mutated", mutated)):
            paths[label] = os.path.join(work, f"{label}.nt")
            with open(paths[label], "wb") as f:
                f.write(data)
        one = qa.pipeline().metrics("all").base(*BASE).incremental(
            os.path.join(work, "single"))
        ref = {label: one.run(paths[label]) for label in paths}
        mesh_store = os.path.join(work, "mesh")
        outs, launch_wall = launch_mesh(MESH_STORE_RANKS, {
            "case": "store", "store": mesh_store, **paths})
        for label in paths:
            s_ref = ref[label].exec_stats
            scanned = 0
            for o in outs:
                got = o["runs"][label]
                name = f"mesh-store-{label} rank {o['rank']}"
                same_packed(got, ref[label], name)
                st = got["stats"]
                check(st["mode"] == "incremental+mesh"
                      and st["devices"] == MESH_STORE_RANKS, f"{name}: {st}")
                for k in ("segments_reused", "segments_rescanned",
                          "bytes_rescanned", "footprints_replayed"):
                    check(st[k] == getattr(s_ref, k),
                          f"{name}: {k} {st[k]}, one device "
                          f"{getattr(s_ref, k)}")
                check(got["passes"] == ref[label].passes, f"{name}: passes")
                scanned += got["launches"]["fused_scan"]
                count(got["launches"])
            check(scanned == s_ref.segments_rescanned,
                  f"mesh-store-{label}: {scanned} launches over the ranks "
                  f"for {s_ref.segments_rescanned} rescanned segments")
            emit({"phase": f"mesh-store-{label}", "backend": "gloo",
                  "ranks": MESH_STORE_RANKS, "card": smi,
                  "segments_rescanned": s_ref.segments_rescanned,
                  "segments_total": s_ref.chunks_total,
                  "launches_per_rank": [o["runs"][label]["launches"]
                                        ["fused_scan"] for o in outs],
                  "wall_s": [o["runs"][label]["wall_s"] for o in outs],
                  "one_device_wall_s": s_ref.wall_seconds,
                  "chunk_eval_seconds_sum": [
                      o["runs"][label]["stats"]["chunk_eval_seconds_sum"]
                      for o in outs],
                  "rank_kernel_ms": [o["kernel_ms"]["segment"]
                                     for o in outs],
                  "segment_rows": outs[0]["segment_rows"],
                  "allgather_ms": [o["collective_ms"]["segment_batch"]
                                   for o in outs],
                  "matches_one_device": True})
        emit({"phase": "mesh-store-launch", "seconds": launch_wall,
              "card": smi})
        got, res, _ = run_main_path(
            "mesh-store-reused", lambda: one.incremental(mesh_store).run(
                paths["mutated"]), ref["mutated"], {k: 0 for k in KERNELS})
        count(got)
        check(res.exec_stats.segments_rescanned == 0,
              "one device reuses the mesh's store: 0 segments rescanned")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # (4) the CLI's --mesh, in a process of its own
    from repro_torch.launch.assess import main as assess_main
    t = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.assess", "--mesh",
         str(MESH_STORE_RANKS), "--synthetic", str(MESH_CLI_ROWS)],
        env=SRC_ENV, capture_output=True, text=True, timeout=MESH_TIMEOUT)
    cli_s = time.perf_counter() - t
    check(cli.returncode == 0,
          f"the mesh CLI exited {cli.returncode}: {cli.stderr[-2000:]}")
    want = io.StringIO()
    with contextlib.redirect_stdout(want), \
            contextlib.redirect_stderr(io.StringIO()):
        assess_main(["--synthetic", str(MESH_CLI_ROWS)])
    check(cli.stdout == want.getvalue(),
          "the mesh CLI prints the values of the run without --mesh")
    emit({"phase": "mesh-cli", "ranks": MESH_STORE_RANKS,
          "rows": MESH_CLI_ROWS, "seconds": cli_s, "card": smi,
          "stderr": cli.stderr.strip().splitlines()})
    emit({"phase": "mesh", "seconds": time.perf_counter() - t_phase})


# -- 8-9. the model-serving path ------------------------------------------

def _free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    want = want.float().cpu()
    got = got.float().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def rel_l2(got, want) -> float:
    want = want.float().cpu()
    return float((got.float().cpu() - want).norm()
                 / want.norm().clamp_min(1e-30))


def weight_bytes(model) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


def fan_in_qkv(model) -> None:
    """Rescale the q/k/v projections of JAX-init weights to fan-in scale,
    in place. The JAX init scales them by 1/sqrt(heads) (``_dense_init``
    reads ``shape[-2]``, the head count), so at Qwen2.5-14B's widths q and
    k entries are about sqrt(d/H) and sqrt(d/Hkv) and the attention scores
    have a standard deviation of d/sqrt(H·Hkv) = 185: every softmax is one
    key, rounding flips which key, and the network amplifies it layer by
    layer (``--lm-init-witness`` measures it). Scaled by
    sqrt(heads/fan_in), the scores are O(1), as in a trained model, and
    two computation orders of the same sequence can be compared."""
    for name, p in model.named_parameters():
        if name.rsplit(".", 1)[-1] in ("wq", "wk", "wv", "wq_b", "wkv_b"):
            p.mul_(float(np.sqrt(p.shape[1] / p.shape[0])))


def lm_weights(cfg, device):
    """Seeded random weights for ``cfg`` on ``device``: the JAX package's
    init (``init_transformer``) with q/k/v at fan-in scale."""
    model, _ = tf_mod.init_transformer(
        cfg, torch.Generator(device).manual_seed(MODEL_SEED))
    fan_in_qkv(model)
    return model


def no_drop(cfg):
    """``cfg`` with a capacity of E/top_k slots an expert, which holds
    every token in any pass (a dense config as it is)."""
    if not cfg.moe:
        return cfg
    return dataclasses.replace(cfg,
                               capacity_factor=cfg.n_experts / cfg.top_k)


@contextlib.contextmanager
def recorded_routes(into: list):
    """Append each MoE dispatch's expert sets, (T, top_k) sorted, to
    ``into`` while the block runs (the router as ``_moe_dispatch_local``
    computes it)."""
    dispatch = tf_mod._moe_dispatch_local

    def recording(cfg, x, router_w, *experts):
        logits = torch.einsum("td,de->te", x.float(), router_w.float())
        top = torch.topk(torch.softmax(logits, dim=-1), cfg.top_k, dim=-1)
        into.append(top.indices.sort(dim=-1).values)
        return dispatch(cfg, x, router_w, *experts)
    tf_mod._moe_dispatch_local = recording
    try:
        yield
    finally:
        tf_mod._moe_dispatch_local = dispatch


def route_differences(served: list, ref: list) -> tuple[int, int | None]:
    """The (token, MoE layer) pairs routed to other experts in a served
    run (its prefill, then one token a decode step) than in the prefill
    of the served sequence, and the first position among them."""
    n_moe = len(ref)
    count, first = 0, None
    for layer in range(n_moe):
        got = torch.cat(served[layer::n_moe])
        diff = (got != ref[layer][:got.shape[0]]).any(dim=-1)
        count += int(diff.sum())
        if diff.any():
            pos = int(diff.nonzero()[0, 0])
            first = pos if first is None else min(first, pos)
    return count, first


def lm_f32_check(cfg, device) -> dict:
    """``prefill`` (logits and caches) and ``LM_CHECK_STEPS`` decode steps
    of ``cfg`` in float32 on ``device``, held to the same code on the CPU
    with the same weights (seeded on the device, copied to the host); then
    ``serve_lm`` on the card, each step held to a prefill of the served
    sequence (a MoE config at ``no_drop`` capacity)."""
    t = time.perf_counter()
    model = lm_weights(cfg, device)
    host = ParamTree(model.tree()).to("cpu")
    init_s = time.perf_counter() - t
    rng = np.random.default_rng(MODEL_SEED)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, LM_PROMPT)))
    s_max = LM_PROMPT + LM_CHECK_STEPS
    errs = {}

    def hold(label, got, want):
        logits_g, cache_g = got
        logits_c, cache_c = want
        errs[label] = rel_err(logits_g, logits_c)
        errs[label + "_cache"] = max(
            rel_err(g, c) for g, c in zip(tree_leaves(cache_g),
                                          tree_leaves(cache_c)))

    t = time.perf_counter()
    got = tf_mod.prefill(cfg, model, toks.to(device), s_max,
                         logits_last_only=False)
    serve_mod._sync(device)
    card_s = time.perf_counter() - t
    t = time.perf_counter()
    want = tf_mod.prefill(cfg, host, toks, s_max, logits_last_only=False)
    host_s = time.perf_counter() - t
    hold("prefill", got, want)
    for i in range(LM_CHECK_STEPS):
        nt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 1)))
        got = tf_mod.decode_step(cfg, model, got[1], nt.to(device),
                                 LM_PROMPT + i)
        want = tf_mod.decode_step(cfg, host, want[1], nt, LM_PROMPT + i)
        hold(f"decode{i}", got, want)
    worst = max(errs.values())
    check(worst <= F32_TOL, f"{cfg.name} float32 on the card within "
          f"{F32_TOL} of the CPU (worst {worst})")
    held_cfg = no_drop(cfg)
    served = serve_mod.serve_lm(LM_TOKENS, cfg=held_cfg, params=model,
                                device=device)
    step_err, same_argmax = decode_against_prefill(held_cfg, model, served)
    check(max(step_err) <= F32_TOL, f"{cfg.name} float32 decode within "
          f"{F32_TOL} (relative L2) of the prefill (worst {max(step_err)})")
    out = {"layers": cfg.n_layers, "params": cfg.num_params(),
           "init_s": init_s, "prefill_card_s": card_s,
           "prefill_host_s": host_s, "tol": F32_TOL, "max_rel_err": errs,
           "decode_vs_prefill": {
               "capacity_factor": held_cfg.capacity_factor,
               "logits_rel_l2_max": max(step_err),
               "argmax_equal": f"{same_argmax}/{LM_TOKENS}"}}
    del model, host, got, want, served
    _free()
    return out


def decode_against_prefill(cfg, model, served) -> tuple[list, int]:
    """Each served step's logits against a ``prefill`` of the served
    sequence: (relative L2 errors, steps whose argmax agrees)."""
    n = len(served["ids"])
    seq = torch.cat([served["prompt"], torch.tensor(
        [served["ids"][:-1]], dtype=torch.int32,
        device=served["prompt"].device)], dim=1)
    ref, _ = tf_mod.prefill(cfg, model, seq, seq.shape[1],
                            logits_last_only=False)
    ref = ref[:, LM_PROMPT - 1:]
    errs = [rel_l2(served["logits"][:, i], ref[:, i]) for i in range(n)]
    return errs, int((served["logits"].argmax(-1) == ref.argmax(-1)).sum())


def decode_busy_share(cfg, model, device) -> dict:
    """``LM_PROFILE_STEPS`` decode steps under ``torch.profiler``: the
    union of the card's kernel intervals over the wall time (the busy
    share; the profiler's own host cost is in the wall), and the kernels a
    step launches."""
    steps = LM_PROFILE_STEPS
    prompt = torch.zeros((1, LM_PROMPT), dtype=torch.int32, device=device)
    _, cache = tf_mod.prefill(cfg, model, prompt, LM_PROMPT + steps)
    tok = prompt[:, :1]
    serve_mod._sync(device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        for i in range(steps):
            logits, cache = tf_mod.decode_step(cfg, model, cache, tok,
                                               LM_PROMPT + i)
            tok = logits.argmax(-1)
            int(tok[0, 0])
        wall_us = (time.perf_counter() - t) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"steps": steps, "wall_ms": wall_us / 1e3,
            "device_busy_ms": busy / 1e3, "busy_share": busy / wall_us,
            "kernels_per_step": len(spans) / steps}


def lm_serve(cfg, device) -> dict:
    """``LM_REQUESTS`` greedy requests through ``serve_lm`` in the
    config's dtype, timed; each step's logits of the last held to a
    prefill of the served sequence. A MoE config is served once more at
    ``no_drop`` capacity for that (its timed requests keep the config's
    own, whose drops differ between a 1-token and a whole-sequence pass;
    that agreement is reported), and its routes are recorded in both: a
    token whose hidden state rounds otherwise can pick other experts,
    which moves its step's logits by up to about 0.12 and, through
    attention, later steps. So the steps before the first position routed
    otherwise are held one by one, and the median step (which a fault of
    the decode path would move, and a few rerouted tokens do not)."""
    _free()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model = lm_weights(cfg, device)
    serve_mod._sync(device)
    init_s = time.perf_counter() - t
    wbytes = weight_bytes(model)
    runs = [serve_mod.serve_lm(LM_TOKENS, cfg=cfg, params=model,
                               device=device)
            for _ in range(LM_REQUESTS)]
    last = runs[-1]
    own_err = own_argmax = n_rerouted = first_rerouted = None
    held_cfg = no_drop(cfg)
    held = LM_TOKENS
    if cfg.moe:
        own_err, own_argmax = decode_against_prefill(cfg, model, last)
        served_routes, ref_routes = [], []
        with recorded_routes(served_routes):
            last = serve_mod.serve_lm(LM_TOKENS, cfg=held_cfg, params=model,
                                      device=device)
        with recorded_routes(ref_routes):
            step_err, same_argmax = decode_against_prefill(held_cfg, model,
                                                           last)
        n_rerouted, first_rerouted = route_differences(served_routes,
                                                       ref_routes)
        if first_rerouted is not None:
            # step j's logits are taken at position LM_PROMPT - 1 + j
            held = max(0, first_rerouted - (LM_PROMPT - 1))
    else:
        step_err, same_argmax = decode_against_prefill(cfg, model, last)
    if held:
        check(max(step_err[:held]) <= BF16_REL_L2,
              f"{cfg.name} bf16 decode within {BF16_REL_L2} of the prefill "
              f"(worst {max(step_err[:held])} over {held} steps)")
    median = float(np.median(step_err))
    check(median <= BF16_REL_L2, f"{cfg.name} bf16 decode's median step "
          f"within {BF16_REL_L2} of the prefill ({median})")
    dec = [s for r in runs[1:] for s in r["decode_s"]]
    p50, p99 = serve_mod.p50_p99(dec)
    profiled = decode_busy_share(cfg, model, device)
    out = {"layers": cfg.n_layers, "dtype": str(cfg.dtype),
           "params": sum(p.numel() for p in model.parameters()),
           "weight_bytes": wbytes,
           "resident_bytes": torch.cuda.max_memory_allocated(),
           "init_s": init_s,
           "prefill_ms": [r["prefill_s"] * 1e3 for r in runs],
           "decode_ms_p50": p50 * 1e3, "decode_ms_p99": p99 * 1e3,
           "decode_steps_timed": len(dec),
           "bound_ms": wbytes / MEM_BYTES_PER_S * 1e3, "bound_by": "bytes",
           "ids": runs[-1]["ids"][:8],
           "held_capacity_factor": held_cfg.capacity_factor,
           "logits_rel_l2": step_err, "steps_held": held,
           "logits_rel_l2_median": median,
           "logits_rel_l2_tol": BF16_REL_L2,
           "routes_differing": n_rerouted,
           "first_position_routed_otherwise": first_rerouted,
           "argmax_equal": f"{same_argmax}/{LM_TOKENS}",
           "own_capacity_rel_l2_max": None if own_err is None
           else max(own_err),
           "own_capacity_argmax_equal": None if own_argmax is None
           else f"{own_argmax}/{LM_TOKENS}",
           "decode_profile": profiled}
    del model, runs, last
    _free()
    return out


def phase_models_lm(smi: str, device="cuda") -> None:
    """Phase 8: every LM config at its published widths. (a) float32 at
    the depth cut, the card held to the CPU; (b) ``serve_lm`` in the
    config's own dtype, at all layers for ``LM_SERVE_ALL_LAYERS``."""
    for name, module in LM_ARCHS.items():
        t = time.perf_counter()
        _free()
        start_bytes = torch.cuda.memory_allocated()
        cut = dataclasses.replace(module.FULL, n_layers=LM_CUT[name])
        f32 = lm_f32_check(dataclasses.replace(
            cut, dtype=torch.float32, param_dtype=torch.float32), device)
        served = lm_serve(module.FULL if name in LM_SERVE_ALL_LAYERS
                          else cut, device)
        emit({"phase": f"models-lm-{name}", "card": smi,
              "allocated_at_start": start_bytes, "float32_check": f32,
              "serve": served,
              "seconds": time.perf_counter() - t})


def layer0_scores(cfg, model, prompt) -> dict:
    """The first layer's attention scores over ``prompt`` (real heads,
    causal pairs): their standard deviation, and the mean over queries
    with two or more keys of the softmax's largest probability."""
    p = model["blocks"][0]
    h = rmsnorm(model["embed"][prompt.long()], p["ln1"], cfg.norm_eps)
    q = torch.einsum("bsd,dhk->bshk", h, p["attn"]["wq"])
    k = torch.einsum("bsd,dhk->bshk", h, p["attn"]["wk"])
    if cfg.qkv_bias:
        q, k = q + p["attn"]["bq"], k + p["attn"]["bk"]
    pos = torch.arange(prompt.shape[1], device=prompt.device)
    cos, sin = rope_freqs(cfg.head_dim, cfg.rope_theta, pos)
    cos, sin = cos[None, :, None], sin[None, :, None]
    q = apply_rope(q, cos, sin)[:, :, :cfg.n_heads].float()
    kv = torch.as_tensor(cfg.kv_map()[:cfg.n_heads], device=prompt.device)
    k = apply_rope(k, cos, sin)[:, :, kv.long()].float()
    scores = torch.einsum("bshd,bthd->bhst", q, k) / np.sqrt(cfg.head_dim)
    causal = pos[None, :] <= pos[:, None]
    probs = torch.softmax(scores.masked_fill(~causal, -math.inf), dim=-1)
    return {"score_std": float(scores[..., causal].std()),
            "max_prob_mean": float(probs.amax(-1)[..., 1:].mean())}


def lm_init_witness(device="cuda") -> int:
    """``python3 chip_smoke.py --lm-init-witness``: why ``lm_weights``
    rescales q/k/v. Qwen2.5-14B at all 48 layers, in float32 (63.1 GB)
    and in bf16, with the JAX init's weights as drawn and then at fan-in
    scale: per run, the first layer's attention scores on the served
    prompt, and ``serve_lm``'s ``LM_TOKENS`` steps against a prefill of
    the served sequence. Reported, not held; one line each."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    for dt in (torch.float32, torch.bfloat16):
        cfg = dataclasses.replace(LM_ARCHS["qwen2.5-14b"].FULL, dtype=dt,
                                  param_dtype=dt)
        _free()
        model, _ = tf_mod.init_transformer(
            cfg, torch.Generator(device).manual_seed(MODEL_SEED))
        for init in ("jax", "fan_in"):
            if init == "fan_in":
                fan_in_qkv(model)
            served = serve_mod.serve_lm(LM_TOKENS, cfg=cfg, params=model,
                                        device=device)
            errs, agree = decode_against_prefill(cfg, model, served)
            emit({"phase": "lm-init-witness", "card": smi,
                  "config": cfg.name, "layers": cfg.n_layers,
                  "dtype": str(dt), "init": init,
                  "weight_bytes": weight_bytes(model),
                  "layer0": layer0_scores(cfg, model, served["prompt"]),
                  "logits_rel_l2": errs,
                  "argmax_equal": f"{agree}/{LM_TOKENS}"})
            del served
        del model
    print(smi, flush=True)
    return 0


def din_flops(cfg, b: int, c: int) -> int:
    d = cfg.d_item
    attn = b * c * cfg.seq_len * (4 * d * 80 + 80 * 40 + 40) * 2
    final = b * c * (3 * d * 200 + 200 * 80 + 80) * 2
    return attn + final


def phase_models_din(smi: str, device="cuda", cfg=din_cfg.FULL,
                     cands: int = DIN_RETRIEVAL_CANDS) -> None:
    """Phase 9: DIN at its full 10M-item table scoring ``serve_p99``,
    ``serve_bulk`` and ``retrieval_cand`` (cut to ``cands``) batches
    through ``serve_din``; the ``serve_p99`` scores held to the CPU with
    the same weights, a retrieval batch to per-candidate scoring."""
    t_phase = time.perf_counter()
    _free()
    start_bytes = torch.cuda.memory_allocated()
    t = time.perf_counter()
    model, _ = din_mod.init_din(
        cfg, torch.Generator(device).manual_seed(MODEL_SEED))
    host = ParamTree(model.tree()).to("cpu")
    init_s = time.perf_counter() - t
    out = {}
    for shape in ("serve_p99", "serve_bulk", "retrieval_cand"):
        b = DIN_SHAPES[shape]["batch"]
        c = cands if shape == "retrieval_cand" else \
            DIN_SHAPES[shape]["n_cands"]
        torch.cuda.reset_peak_memory_stats()
        r = serve_mod.serve_din(b, c, DIN_REQUESTS[shape], cfg=cfg,
                                params=model, device=device)
        p50, p99 = serve_mod.p50_p99(r["latencies_s"])
        flops = din_flops(cfg, b, c)
        in_bytes = sum(v.nbytes for v in r["batch"].values())
        row_bytes = (b * cfg.seq_len + b * c) * cfg.d_item * 4
        bound_s = max(flops / F32_FLOPS_PER_S,
                      (in_bytes + row_bytes + 4 * b * c) / MEM_BYTES_PER_S)
        out[shape] = {"batch": b, "cands": c, "requests": len(r[
            "latencies_s"]), "p50_ms": p50 * 1e3, "p99_ms": p99 * 1e3,
            "scores_per_s": b * c / p50, "peak_bytes":
            torch.cuda.max_memory_allocated(), "flops": flops,
            "bound_ms": bound_s * 1e3, "bound_by": "operations"
            if flops / F32_FLOPS_PER_S >= (in_bytes + row_bytes)
            / MEM_BYTES_PER_S else "bytes"}
        check(bool(torch.isfinite(r["scores"]).all())
              and tuple(r["scores"].shape) == (b, c),
              f"din {shape}: finite scores of shape ({b}, {c})")
        if shape == "serve_p99":
            want = din_mod.forward(cfg, host,
                                   din_mod.to_device(r["batch"], "cpu"))
            err = float((r["scores"].cpu() - want).abs().max())
            check(torch.allclose(r["scores"].cpu(), want, atol=1e-5,
                                 rtol=1e-4),
                  f"din serve_p99 on the card equals the CPU ({err})")
            out[shape]["max_abs_err_vs_cpu"] = err
        if shape == "retrieval_cand":
            errs = []
            for j in (0, 1, c // 2, c - 1):
                one = {**r["batch"],
                       "cand_item": r["batch"]["cand_item"][:, j:j + 1],
                       "cand_cat": r["batch"]["cand_cat"][:, j:j + 1],
                       "labels": r["batch"]["labels"][:, j:j + 1]}
                single = din_mod.forward(cfg, model,
                                         din_mod.to_device(one, device))
                errs.append(abs(float(single[0, 0])
                                - float(r["scores"][0, j])))
            check(max(errs) <= 1e-5, f"din retrieval equals per-candidate "
                  f"scoring ({max(errs)})")
            out[shape]["max_abs_err_vs_single"] = max(errs)
        del r
        _free()
    emit({"phase": "models-din", "card": smi, "params": cfg.num_params(),
          "weight_bytes": weight_bytes(model),
          "allocated_at_start": start_bytes, "init_s": init_s,
          "retrieval_cut": {"cands": cands, "from": DIN_SHAPES[
              "retrieval_cand"]["n_cands"]}, **out,
          "seconds": time.perf_counter() - t_phase})
    del model, host
    _free()


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
    paper, _ = add(run_main_path(
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

    # -- 3b. the mesh: one nccl rank, four gloo ranks, the store, the CLI ---
    phase_mesh(tt, small, single, paper, launches, smi)

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

    # -- 5. incremental: the text through the segment store, edit by edit ---
    cold = phase_incremental(text, add, expect)

    # -- 6. the service, its CLI and a crash drill; 7. the catalog crawler --
    phase_serve(text, cold, launches)
    phase_serve_cli()
    phase_serve_chaos()
    phase_catalog(launches)

    # -- 8. the LM configs at full width; 9. DIN at its full table ---------
    before = dict(K.LAUNCHES)
    phase_models_lm(smi)
    phase_models_din(smi)
    check(K.LAUNCHES == before, "the model phases launch no scan kernel")

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
    if len(sys.argv) == 3 and sys.argv[1] == "--mesh-rank":
        sys.exit(mesh_rank(json.loads(sys.argv[2])))
    if sys.argv[1:] == ["--lm-init-witness"]:
        sys.exit(lm_init_witness())
    sys.exit(main())
