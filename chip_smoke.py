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
10. train-lm — the training path (``models.transformer.make_train_step``,
   ``optim.AdamW``, ``launch.train``; plain torch, no scan kernel): (a)
   ``train-lm-f32-<arch>``: each LM config at its published widths and
   the depth cut of phase 8, in float32 with its remat and chunked loss,
   one microbatch of 1 × 32 tokens; each gradient leaf on the card within
   ``F32_TOL`` of its largest magnitude of the same step on the CPU with
   the same weights, and the loss. (b) ``train-lm-granite-full``:
   granite-moe-1b-a400m's FULL config unchanged (24 layers, 1,410,128,896
   parameters, float32 masters and moments, bf16 compute, remat full,
   grad_accum 2, loss_chunk 512) through ``launch.train.train`` for
   ``TRAIN_STEPS`` steps at train_4k's sequence of 4,096 with the batch
   cut from 256 to 8: every loss finite; step ms (p50 after the first),
   tokens/s, model TFLOP/s (6 · 504,159,232 active parameters · tokens)
   and its share of 989 TFLOP/s, peak bytes; then one step under
   ``torch.profiler`` (busy share, device time by kind of kernel, the
   kernels with the most), and one layer's attention and MoE FFN and the
   loss head timed apart (CUDA events), the step rebuilt from them.
   (c) ``train-lm-remat``: at a 2-layer cut, one step's gradients with
   remat full against none on the same weights, each beside a second
   none run (the card's own spread): float32 each leaf within
   ``F32_TOL``, bf16 all leaves within ``BF16_REL_L2`` relative L2. (d)
   ``train-lm-resume``: at the 2-layer cut, ``launch.train`` for 2 steps
   with a checkpoint at step 2, restored bit for bit, and a run resumed
   from it against the state in memory stepped on the same batch (loss
   within ``RESUME_LOSS_RTOL``).

11. train-gnn — the GNN family (``models.gnn``, ``configs.*_cfg``,
   ``data.sampler``; plain torch, no scan kernel): each architecture's
   ``_smoke`` on the card; (a) ``train-gnn-f32-<arch>``: BASE widths at 2
   layers or blocks in float32 on molecule cut to 8 graphs, every gradient
   leaf on the card within ``F32_TOL`` of its largest magnitude of the same
   model on the CPU, and the loss; (b) ``train-gnn-equivariance``:
   EquiformerV2 at BASE width and depth, its output under a random
   rotation and a translation of the positions, float32 within 2e-3 (the
   JAX smoke's bound), bf16 reported; (c) ``train-gnn-remat-<arch>``:
   gatedgcn and graphcast, remat full against none beside none against
   none, all with torch's deterministic algorithms on (``in_fixed_order``:
   ``index_add_`` sums in index order), float32 each leaf within
   ``F32_TOL``; (d)
   ``train-gnn-<arch>-<shape>``: gatedgcn, dimenet, equiformer-v2 and
   graphcast at BASE width and depth through their configs' train steps
   (AdamW lr 1e-3, no weight decay) for 3 steps on full_graph_sm,
   minibatch_lg (the sampler's 1,024 seeds × fanout (15, 10) over a
   232,965-node graph of 114,615,892 uniform edges; ``train-gnn-sampler``
   times the CSR and the sampling) and molecule; ogb_products is cut
   (partition-parallel over a mesh only). Per run: every loss finite, step
   ms (first; p50 after it), model TFLOP/s from the config's ``_flops`` and
   its share of 989 (bf16) or 67 (float32) TFLOP/s, peak bytes, host input
   seconds; the minibatch_lg run of each architecture also one step under
   ``torch.profiler``.

12. mesh-models (run right after phase 2: this process only waits on its
   ranks, so a thread synthesizes phase 3's rows on the host meanwhile;
   the ``data`` line gives the synthesis its own seconds) — the models
   sharded over four ``gloo`` ranks sharing
   the card (child processes of ``chip_smoke.py --mesh-models-rank``), on
   a (data 2, model 2) ``make_host_mesh`` with ``ShardingPolicy(fsdp=True)``
   (``dist.sharding``, ``dist.collectives``; plain torch, no scan kernel):
   (a) ``mesh-models-granite``: granite-moe-1b-a400m at its published
   width and depth (24 layers, d_model 1024, 32 experts top-8, 16 a model
   rank) in float32 at a capacity of E/top_k (no drops): a forward of 2 ×
   4,096 tokens, a prefill of 4,096 positions (the cache's sequence
   sharded over "model") and 8 decode steps, each held to the same on one
   rank with the mesh's MoE routes replayed (``replayed_routes``; a route
   the one rank would pick otherwise must be a near-tie,
   ``MM_ROUTE_GAP``), relative L2 ``MM_REL_L2``; 3 float32 AdamW steps at
   batch 4 × 4,096 (train_4k's 256 cut) against one rank's with
   ``grad_accum`` doubled: every step, each with its own routes
   replayed, in loss and aux within ``MM_LOSS_RTOL`` and in the moments
   after it within tests/test_torch_train.py's tolerances, every leaf
   (each rank's shards kept in memory, ``MomentShards``, and compared on
   the card with the same slices of the one rank's); one bf16 step at the config's
   capacity 1.25 for its time. Per rank: each call's ms beside the ms in
   the model's collectives, peak bytes. (b) ``mesh-models-psum``:
   ``compressed_psum`` on card tensors over the four ranks (one call
   within 5%, twenty closer). (c) ``mesh-models-checkpoint``: part of the
   trained state saved from (2, 2), restored onto (1, 4) and onto one
   rank, bit for bit. (d) ``mesh-models-<arch>-<config>-<shape>``: the
   partition-parallel (cd-0) step of DimeNet and GraphCast on
   full_graph_sm and EquiformerV2 on minibatch_lg's shape (169,984
   nodes, 168,960 uniform edges), each graph in four contiguous blocks,
   cut edges dropped: float32 at BASE for DimeNet and GraphCast, 3 AdamW
   steps, the first held to each block's loss run on one rank and
   averaged (loss and first moment), the checked steps on both sides
   ``in_fixed_order``; EquiformerV2 in float32 at
   ``EQ_CHECK_LAYERS`` layers for that check, then 3 steps at BASE (bf16).
   ``ogb_products`` stays cut: one card holds every partition.

13. dryrun — the dry-run registry (``repro_torch.configs``,
   ``launch/dryrun.py``): (a) ``python -m repro_torch.launch.dryrun
   --no-subprocess`` in a process of its own (CPU only, torch's fake
   process group) over all 88 (arch × shape × mesh) cells: 80 ``OK``, 8
   ``SKIP``, no ``FAIL``; one ``dryrun-cell`` line each with the
   arguments' bytes a rank, and the largest beside the card's memory. (b)
   each of the 11 archs' ``smoke(device="cuda")``: finite losses, the
   paper's 16 metrics in one pass. (c) each ``dist-quality-assessment``
   shape on both production meshes: one rank's share of its rows
   (``synth_encoded(rows, seed=3)``, 16,191 to 5,050,523 rows) through
   the bundle's ``fn`` (``fused_scan`` on the card, then the reduce over
   the fake mesh), counters and registers bit-identical to the plain
   backend on the card; the kernel timed (CUDA events) through its
   wrapper and launched alone, beside rows × 52 B over 3.35 TB/s. The
   launch counts are set to 0 before (b) and read after (c): one
   ``fused_scan`` a scan (the smoke's and 8 cells').

Then one ``scan-kernels`` line: per compiled plan, the NVRTC compile
time, ptxas' report (registers, shared memory, spills), the resident
blocks per SM, and the process's and disk cache's hits; for the ``all``
and ``paper`` kernels and those at the limits, the count of their SASS
instructions (``cuobjdump -sass``). Then one
``{"kernels": [...]}`` line, the ``nvidia-smi`` name and power limit
line, and as the last line ``{"ok": true, "device": {...}}``. Any
mismatch or exception exits nonzero before that line.

``python3 chip_smoke.py --train-lm`` runs phase 10 alone,
``--train-gnn`` phase 11 alone, ``--mesh-models`` phase 12 alone and
``--dryrun`` phase 13 alone, then the card's line.
``python3 chip_smoke.py --lm-init-witness`` runs none of that: it serves
Qwen2.5-14B at all 48 layers in float32 and in bf16, with the JAX init's
weights as drawn and at fan-in scale, and prints for each the first
layer's attention score statistics and the decode steps' agreement with
a prefill of the served sequence (the measurement behind ``fan_in_qkv``).
"""
from __future__ import annotations

import concurrent.futures
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
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core import report  # noqa: E402
from repro_torch.core.expr import (  # noqa: E402
    OP_ANYBITS, OP_EMIT, OP_HASBITS, And, AnyBits, Cmp, EqPlanes, HasBits,
    Not, Or, compile_program)
from repro_torch.core.metrics import (  # noqa: E402
    ALL_METRICS, PAPER_METRICS, get_metrics)
from repro_torch.core.planner import plan, plan_single  # noqa: E402
from repro_torch.kernels import _build, scan_codegen  # noqa: E402
from repro_torch.dist import ChunkScheduler, FaultInjector, WorkerFailure  # noqa
from repro_torch.dist import collectives as mm_coll  # noqa: E402
from repro_torch.dist import compressed_psum  # noqa: E402
from repro_torch.dist.sharding import (ShardingPolicy,  # noqa: E402
                                       distribute_tree)
from repro_torch.kernels.fused_scan import ops as fops, ref as fref  # noqa
from repro_torch.kernels.hll import ops as hops, ref as href  # noqa
from repro_torch.kernels.qap_count import ops as qops, ref as qref  # noqa
from repro_torch.configs import (LM_ARCHS, LM_SHAPES,  # noqa: E402
                                 DIN_SHAPES, GNN_ARCHS, GNN_SHAPES, din_cfg,
                                 dimenet_cfg, equiformer_v2_cfg,
                                 granite_moe_1b)
from repro_torch import configs  # noqa: E402
from repro_torch.configs import gnn_common, paper_qa  # noqa: E402
from repro_torch.data import sampler  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import din as din_mod  # noqa: E402
from repro_torch.models.gnn import (dimenet, equiformer_v2,  # noqa: E402
                                    gatedgcn, graphcast)
from repro_torch.models.gnn.common import (  # noqa: E402
    GraphBatch, block_diagonal_batch, random_graph, to_device)
from repro_torch.models import transformer as tf_mod  # noqa: E402
from repro_torch.models.common import (ParamTree, apply_rope,  # noqa: E402
                                       rmsnorm, rope_freqs)
from repro_torch.optim import AdamW, cosine_schedule  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
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
# phase 10, the training path: granite FULL at train_4k's sequence, the
# batch cut from 256 to 8 to fit one card (LM_SHAPES["train_4k"]); five
# steps keep the script within its time limit beside phase 12
TRAIN_STEPS = 5
TRAIN_BATCH = 8
TRAIN_SEQ = 4096
TRAIN_CHECK_TOKENS = 32        # batch 1: the float32 card-vs-CPU gradients
TRAIN_CUT = 2                  # depth cut of the remat check and the drill
REMAT_BATCH = 4                # remat none keeps every layer's activations
# a resumed step against the same state stepped in memory: bit-identical
# states, so only MoE's index_add_ order differs (bf16, 2 layers)
RESUME_LOSS_RTOL = 1e-3
PROFILE_TOP = 12               # kernels listed from the profiled step
SPLIT_REPS = 3                 # timed calls of each part of a layer
# the profiled step's kernels by kind, from words in their lowercased
# names (the first that matches; "elementwise" otherwise)
KERNEL_KINDS = (("matmul", ("gemm", "xmma", "cutlass", "wgmma", "nvjet")),
                ("indexing", ("index", "scatter", "gather")),
                ("sort", ("sort", "radix")),
                ("copy or cast", ("copy",)),
                ("reduction", ("reduce",)))
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
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.rsplit(".", 1)[-1] in ("wq", "wk", "wv", "wq_b",
                                           "wkv_b"):
                p.mul_(float(np.sqrt(p.shape[1] / p.shape[0])))


def lm_weights(cfg, device, trainable=False):
    """Seeded random weights for ``cfg`` on ``device``: the JAX package's
    init (``init_transformer``) with q/k/v at fan-in scale; ``trainable``
    master weights that require gradients."""
    model, _ = tf_mod.init_transformer(
        cfg, torch.Generator(device).manual_seed(MODEL_SEED),
        trainable=trainable)
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
def recorded_routes(into: list, sort: bool = True):
    """Append each MoE routing's experts, (T, top_k), to ``into`` while
    the block runs (sorted: the expert sets; else in the router's order,
    as uint8 on the host, for ``replayed_routes``)."""
    route = tf_mod._route

    def recording(cfg, x, router_w):
        gates, idx, aux = route(cfg, x, router_w)
        into.append(idx.sort(dim=-1).values if sort
                    else idx.to(torch.uint8).cpu())
        return gates, idx, aux
    tf_mod._route = recording
    try:
        yield
    finally:
        tf_mod._route = route


@contextlib.contextmanager
def replayed_routes(calls, stats: dict):
    """Route each MoE call as ``calls`` give it, in turn (experts in the
    router's order; ``stats["calls"]`` counts them against
    ``stats["recorded"]``); the gates and aux from this run's own router
    at those experts. Where this run's own top-k picks other experts,
    ``stats``
    counts the (token, call) pairs (``flips``) and keeps the largest
    share of the probability its own experts hold beyond the replayed
    ones (``gap_max``: a near-tie is 0 up to rounding)."""
    route = tf_mod._route
    it = iter(calls)
    stats.update(flips=0, gap_max=0.0, calls=0, recorded=len(calls))

    def replaying(cfg, x, router_w):
        _, own, _ = route(cfg, x, router_w)
        idx = next(it).to(device=own.device, dtype=torch.long)
        probs = torch.softmax(torch.einsum(
            "td,de->te", x.float(), router_w.float()), dim=-1)
        mine = probs.gather(1, own).sum(-1)
        theirs = probs.gather(1, idx).sum(-1)
        flip = (own.sort(-1).values != idx.sort(-1).values).any(-1)
        stats["calls"] += 1
        if flip.any():
            stats["flips"] += int(flip.sum())
            stats["gap_max"] = max(stats["gap_max"], float(
                ((mine - theirs) / mine)[flip].max()))
        gates = probs.gather(1, idx)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        T, E = x.shape[0], cfg.n_experts
        density = torch.zeros(E, device=x.device).index_add_(
            0, idx.reshape(-1), torch.ones(idx.numel(), device=x.device)
        ) / (T * cfg.top_k)
        return gates, idx, E * torch.sum(density * probs.mean(0))
    tf_mod._route = replaying
    try:
        yield
    finally:
        tf_mod._route = route


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


# -- 10. the training path ----------------------------------------------------

def grads_of(cfg, model, toks) -> tuple[dict, float, float]:
    """One step's gradients of ``model`` on ``toks`` (``accumulate_grads``,
    the train step's backward), as {name: tensor}, with the loss and aux;
    the model's ``.grad`` is cleared after."""
    loss, aux = tf_mod.accumulate_grads(cfg, model, toks)
    grads = {n: p.grad for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return grads, float(loss), float(aux)


def card_rel_err(got, want) -> float:
    """``rel_err`` computed on ``got``'s device (a card): max |got - want|
    over max |want|."""
    want = want.to(got.device)
    return float((got - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


def grad_rel_l2(got: dict, want: dict) -> float:
    """Relative L2 error of all gradient leaves together."""
    num = sum(float((got[n].float() - w.float()).norm()) ** 2
              for n, w in want.items())
    den = sum(float(w.float().norm()) ** 2 for w in want.values())
    return math.sqrt(num / max(den, 1e-30))


def train_f32_check(cfg, device) -> dict:
    """The gradients of one step of ``cfg`` in float32 on ``device`` (its
    remat and chunked loss; one microbatch) held to the same code on the
    CPU with the same weights: each leaf within ``F32_TOL`` of its largest
    magnitude, and the loss."""
    t = time.perf_counter()
    model = lm_weights(cfg, device, trainable=True)
    host = ParamTree(model.tree(), requires_grad=True).to("cpu")
    init_s = time.perf_counter() - t
    toks = torch.from_numpy(np.random.default_rng(MODEL_SEED).integers(
        0, cfg.vocab_size, (1, TRAIN_CHECK_TOKENS)))
    t = time.perf_counter()
    got, loss_g, aux_g = grads_of(cfg, model, toks.to(device))
    serve_mod._sync(device)
    card_s = time.perf_counter() - t
    t = time.perf_counter()
    want, loss_c, aux_c = grads_of(cfg, host, toks)
    host_s = time.perf_counter() - t
    errs = {n: card_rel_err(got[n], w) for n, w in want.items()}
    worst = max(errs, key=errs.get)
    check(errs[worst] <= F32_TOL, f"{cfg.name} float32 gradients on the "
          f"card within {F32_TOL} of the CPU (worst {worst}: "
          f"{errs[worst]})")
    loss_err = abs(loss_g - loss_c) / abs(loss_c)
    check(loss_err <= F32_TOL, f"{cfg.name} float32 loss on the card "
          f"({loss_g}) equals the CPU's ({loss_c})")
    out = {"layers": cfg.n_layers, "params": cfg.num_params(),
           "tokens": TRAIN_CHECK_TOKENS, "remat": cfg.remat,
           "loss_chunk": cfg.loss_chunk, "init_s": init_s,
           "card_s": card_s, "host_s": host_s, "loss": loss_g,
           "aux": aux_g, "loss_rel_err": loss_err, "tol": F32_TOL,
           "grad_leaves": len(errs), "grad_max_rel_err": errs[worst],
           "worst_leaf": worst}
    del model, host, got, want
    _free()
    return out


def profile_train_step(cfg, state, toks) -> dict:
    """One LM train step under ``torch.profiler`` (``profile_step``)."""
    step = tf_mod.make_train_step(cfg, AdamW(lr=3e-4))
    return profile_step(
        lambda: float(step(state, {"tokens": toks})[1]["loss"]))


def profile_step(run) -> dict:
    """``run()``, one train step ending in its loss on the host, under
    ``torch.profiler``: the card's busy share (the union of kernel
    intervals over the wall), its time by kind of kernel and the kernels
    with the most device time."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        wall_us = (time.perf_counter() - t) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    check(len(kernels) > 0, "the profiled train step ran on the card")
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name: dict = {}
    for e in kernels:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:PROFILE_TOP]
    total_us = sum(us for _, us in by_name.values())
    kinds: dict = {}
    for n, (c, us) in by_name.items():
        kind = next((k for k, keys in KERNEL_KINDS
                     if any(key in n.lower() for key in keys)),
                    "elementwise")
        kc, kus = kinds.get(kind, (0, 0.0))
        kinds[kind] = (kc + c, kus + us)
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "busy_share": busy / wall_us, "kernels": len(kernels),
            "kernel_ms_total": total_us / 1e3,
            "by_kind": {k: {"launches": c, "ms": us / 1e3,
                            "share": us / total_us}
                        for k, (c, us) in sorted(kinds.items(),
                                                 key=lambda kv: -kv[1][1])},
            "top": [{"name": n[:120], "launches": c, "ms": us / 1e3,
                     "share": us / total_us} for n, (c, us) in top]}


def layer_split(cfg, device) -> dict:
    """Where a train step's time goes, by part: one layer of ``cfg`` at the
    step's microbatch, its attention (the norm before it, ``_gqa_attention``)
    and its MoE FFN (the norm, ``_moe_ffn``), and the embedding, final norm
    and chunked loss (``loss_fn`` of a 0-layer model), each timed with
    CUDA events forward only and forward plus backward. Under remat
    ``full`` a step runs each layer's forward, its recompute and its
    backward, so the step rebuilt from the parts is ``grad_accum`` ×
    (layers × (fb + f) of attention and MoE + fb of the head)."""
    torch.manual_seed(MODEL_SEED)
    mb, s = TRAIN_BATCH // cfg.grad_accum, TRAIN_SEQ
    one = dataclasses.replace(cfg, n_layers=1)
    lp = tf_mod.compute_dtypes(one, lm_weights(one, device, True).tree(
        lambda p: p))["blocks"][0]
    x = torch.randn(mb, s, cfg.d_model, device=device, dtype=cfg.dtype,
                    requires_grad=True)
    positions = torch.arange(s, device=device)
    head_cfg = dataclasses.replace(cfg, n_layers=0)
    head = tf_mod.compute_dtypes(head_cfg, lm_weights(
        head_cfg, device, True).tree(lambda p: p))
    toks = torch.from_numpy(next(train_mod.token_batches(cfg, mb, s))).to(
        device)
    parts = {
        "attention": lambda: tf_mod._gqa_attention(
            one, lp["attn"], rmsnorm(x, lp["ln1"], cfg.norm_eps),
            positions)[0],
        "moe": lambda: tf_mod._moe_ffn(
            one, lp["mlp"], rmsnorm(x, lp["ln2"], cfg.norm_eps))[0],
        "head": lambda: tf_mod.loss_fn(head_cfg, head, toks)[0]}
    out = {}
    for name, fn in parts.items():
        out[name] = {"fwd_ms": cuda_ms(fn, SPLIT_REPS),
                     "fwd_bwd_ms": cuda_ms(
                         lambda fn=fn: fn().float().sum().backward(),
                         SPLIT_REPS)}
    layer_ms = sum(out[k]["fwd_ms"] + out[k]["fwd_bwd_ms"]
                   for k in ("attention", "moe"))
    step_ms = cfg.grad_accum * (cfg.n_layers * layer_ms
                                + out["head"]["fwd_bwd_ms"])
    attn_ms = cfg.grad_accum * cfg.n_layers * (
        out["attention"]["fwd_ms"] + out["attention"]["fwd_bwd_ms"])
    return {"microbatch": mb, "parts": out, "rebuilt_step_ms": step_ms,
            "attention_share_of_rebuilt": attn_ms / step_ms}


def train_full(cfg, smi: str, device) -> dict:
    """``cfg`` as it is (granite FULL) through ``launch.train``'s loop:
    ``TRAIN_STEPS`` steps at ``TRAIN_BATCH`` × ``TRAIN_SEQ``, every loss
    finite; step p50 over the steps after the first, tokens/s, model
    TFLOP/s (6 · active params · tokens) and its share of the bf16 peak,
    peak bytes; then one more step under the profiler."""
    _free()
    out = train_mod.train(cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                          seq=TRAIN_SEQ, device=device)
    losses = out["losses"]
    check(all(math.isfinite(x) for x in losses + out["aux"]),
          f"{cfg.name}: every loss finite ({losses})")
    p50 = float(np.median(out["step_ms"][1:]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = 6 * cfg.num_active_params() * tokens
    res = {"layers": cfg.n_layers, "params": cfg.num_params(),
           "active_params": cfg.num_active_params(), "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "batch_cut_from": LM_SHAPES["train_4k"][
               "batch"], "remat": cfg.remat, "grad_accum": cfg.grad_accum,
           "loss_chunk": cfg.loss_chunk, "steps": TRAIN_STEPS,
           "losses": losses, "aux": out["aux"], "step_ms": out["step_ms"],
           "step_ms_p50": p50, "tokens_per_s": tokens / p50 * 1e3,
           "model_flops_per_step": flops,
           "model_tflops_per_s": flops / p50 / 1e9,
           "share_of_bf16_peak": flops / (p50 / 1e3)
           / train_mod.H100_BF16_FLOPS_PER_S,
           "peak_bytes": out["peak_bytes"], "card": smi}
    toks = torch.from_numpy(next(train_mod.token_batches(
        cfg, TRAIN_BATCH, TRAIN_SEQ))).to(device)
    res["profile"] = profile_train_step(cfg, out["state"], toks)
    del out, toks
    _free()
    res["split"] = layer_split(cfg, device)
    _free()
    return res


def remat_check(cfg, device) -> dict:
    """The gradients of one step of ``cfg`` (a depth cut) with remat
    ``full`` against ``none`` on the same weights and tokens, each beside
    a second ``none`` run (the card's own run-to-run spread: MoE outputs
    are summed by ``index_add_`` in varying order). Float32: each leaf
    within ``F32_TOL`` of its largest magnitude; the config's bf16: all
    leaves' relative L2 within ``BF16_REL_L2``."""
    out = {}
    for label, c in (("float32", dataclasses.replace(
            cfg, dtype=torch.float32)), ("bf16", cfg)):
        model = lm_weights(c, device, trainable=True)
        toks = torch.from_numpy(next(train_mod.token_batches(
            c, REMAT_BATCH, TRAIN_SEQ))).to(device)
        runs = {}
        for remat in ("none", "full", "none_again"):
            rc = dataclasses.replace(c, remat=remat.split("_")[0])
            runs[remat] = grads_of(rc, model, toks)[0]
        want = runs["none"]
        rel = {k: grad_rel_l2(runs[k], want) for k in ("full", "none_again")}
        leaf = {k: max(card_rel_err(runs[k][n], w) for n, w in want.items())
                for k in ("full", "none_again")}
        if label == "float32":
            check(leaf["full"] <= F32_TOL, f"float32 remat full within "
                  f"{F32_TOL} of none ({leaf['full']})")
        else:
            check(rel["full"] <= BF16_REL_L2, f"bf16 remat full within "
                  f"{BF16_REL_L2} (relative L2) of none ({rel['full']})")
        out[label] = {"full_vs_none_rel_l2": rel["full"],
                      "none_vs_none_rel_l2": rel["none_again"],
                      "full_vs_none_leaf_max_rel_err": leaf["full"],
                      "none_vs_none_leaf_max_rel_err": leaf["none_again"]}
        del model, runs, want
        _free()
    return {"layers": cfg.n_layers, "batch": REMAT_BATCH, "seq": TRAIN_SEQ,
            "f32_tol": F32_TOL, "bf16_rel_l2_tol": BF16_REL_L2, **out}


def leaves_of(state: dict) -> list:
    return [state["step"], state["opt"]["count"]] + [
        t for tree in (state["params"].tree(), state["opt"]["m"],
                       state["opt"]["v"]) for t in tree_leaves(tree)]


def resume_drill_lm(cfg, device) -> dict:
    """``launch.train`` at ``cfg`` (a depth cut) for 2 steps with a
    checkpoint at step 2 (``save_async``, then the final ``save``); the
    checkpoint restored equals the state in memory bit for bit; a run
    resumed from it (``--resume``, 3 steps) and the state in memory
    stepped once on the same batch (the stream's first: a resumed run
    draws from its start) give the same loss (``RESUME_LOSS_RTOL``)."""
    os.makedirs(BUILD, exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_train_", dir=BUILD)
    try:
        t = time.perf_counter()
        first = train_mod.train(cfg, steps=2, batch=TRAIN_BATCH,
                                seq=TRAIN_SEQ, ckpt_dir=ckpt, ckpt_every=2,
                                device=device)
        train_s = time.perf_counter() - t
        mgr = CheckpointManager(ckpt)
        check(mgr.all_steps() == [2], f"checkpoints {mgr.all_steps()}")
        t = time.perf_counter()
        restored = train_mod.restore(cfg, mgr, 2, first["state"], device)
        restore_s = time.perf_counter() - t
        pairs = list(zip(leaves_of(restored), leaves_of(first["state"])))
        same = all(a.dtype == b.dtype and torch.equal(a, b)
                   for a, b in pairs)
        check(same, "the restored train state equals the saved one")
        del restored
        resumed = train_mod.train(cfg, steps=3, batch=TRAIN_BATCH,
                                  seq=TRAIN_SEQ, ckpt_dir=ckpt, resume=True,
                                  device=device)
        opt = AdamW(lr=cosine_schedule(3e-4, warmup=1, total=3))
        toks = torch.from_numpy(next(train_mod.token_batches(
            cfg, TRAIN_BATCH, TRAIN_SEQ))).to(device)
        _, m = tf_mod.make_train_step(cfg, opt)(first["state"],
                                                {"tokens": toks})
        cont = float(m["loss"])
        err = abs(resumed["losses"][0] - cont) / abs(cont)
        check(len(resumed["losses"]) == 1 and err <= RESUME_LOSS_RTOL,
              f"resumed step's loss {resumed['losses']} equals the "
              f"continued state's {cont}")
        return {"layers": cfg.n_layers, "leaves": len(pairs),
                "bit_identical": same, "checkpoint_bytes": sum(
                    os.path.getsize(os.path.join(ckpt, "step_0000000002", f))
                    for f in ("arrays.npz", "manifest.json")),
                "train_2_steps_s": train_s, "restore_s": restore_s,
                "resumed_loss": resumed["losses"][0], "continued_loss": cont,
                "loss_rel_err": err, "tol": RESUME_LOSS_RTOL}
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
        _free()


def phase_train_lm(smi: str, device="cuda") -> None:
    """Phase 10: the training path of ``repro_torch`` (``make_train_step``,
    ``optim.AdamW``, ``launch.train``; plain torch, no scan kernel)."""
    t_phase = time.perf_counter()
    for name, module in LM_ARCHS.items():
        t = time.perf_counter()
        _free()
        cut = dataclasses.replace(
            module.FULL, n_layers=LM_CUT[name], dtype=torch.float32,
            param_dtype=torch.float32, grad_accum=1)
        emit({"phase": f"train-lm-f32-{name}", "card": smi,
              **train_f32_check(cut, device),
              "seconds": time.perf_counter() - t})
    t = time.perf_counter()
    emit({"phase": "train-lm-granite-full", **train_full(
        granite_moe_1b.FULL, smi, device),
        "seconds": time.perf_counter() - t})
    cut = dataclasses.replace(granite_moe_1b.FULL, n_layers=TRAIN_CUT)
    t = time.perf_counter()
    emit({"phase": "train-lm-remat", "card": smi,
          **remat_check(cut, device), "seconds": time.perf_counter() - t})
    t = time.perf_counter()
    emit({"phase": "train-lm-resume", "card": smi,
          **resume_drill_lm(cut, device),
          "seconds": time.perf_counter() - t})
    emit({"phase": "train-lm", "seconds": time.perf_counter() - t_phase})


# -- 11. GNN training ------------------------------------------------------------

# the four GNN architectures at BASE width and depth through their configs'
# train steps, on three of GNN_SHAPES; ogb_products is cut (one of its
# edge tensors at d 70-512 alone is 17-63 GB: the JAX package trains it
# only partition-parallel over a mesh)
GNN_RUN_SHAPES = ("full_graph_sm", "minibatch_lg", "molecule")
GNN_STEPS = 3                  # the time limit, beside phase 12
# minibatch_lg: the sampler's seeds and fanout over a reddit-scale graph
MB_GRAPH_NODES = 232_965
MB_GRAPH_EDGES = 114_615_892
MB_SEEDS = 1024
MB_FANOUT = (15, 10)
# the float32 check (card against CPU), equivariance and remat run at
# BASE widths on molecule cut to 8 graphs; the float32 check at a depth cut
GNN_CHECK_GRAPHS = 8
GNN_CHECK_DEPTH = 2
GNN_REMAT_ARCHS = ("gatedgcn", "graphcast")
# a gradient leaf is held to F32_TOL of its largest magnitude, or of this
# share of the largest of all leaves where that is more (gnn_grad_errs)
GNN_GRAD_FLOOR = 1e-3
# remat full against none: within F32_TOL, or this many times the card's
# own spread (none against none) where that is more
GNN_REMAT_SPREAD = 4
EQUIVARIANCE_TOL = 2e-3        # the JAX smoke's bound, float32
GNN_MODELS = {"gatedgcn": (gatedgcn, gatedgcn.init_gatedgcn),
              "dimenet": (dimenet, dimenet.init_dimenet),
              "equiformer-v2": (equiformer_v2, equiformer_v2.init_equiformer),
              "graphcast": (graphcast, graphcast.init_graphcast)}


def gnn_config(arch: str, shape: str):
    """The config an architecture trains ``shape`` with (graphcast: BASE
    on every shape, as the JAX bundle)."""
    module = GNN_ARCHS[arch]
    if hasattr(module, "_cfg_for"):
        return module._cfg_for(shape)
    return module.BASE


def gnn_layers(cfg) -> int:
    return cfg.n_blocks if hasattr(cfg, "n_blocks") else cfg.n_layers


def gnn_depth(cfg, n: int):
    field = "n_blocks" if hasattr(cfg, "n_blocks") else "n_layers"
    return dataclasses.replace(cfg, **{field: n})


def gnn_init(arch: str, cfg, device):
    """Seeded random weights of ``cfg`` on ``device`` (the JAX init;
    GraphCast's processor rescaled by ``residual_scale``)."""
    model = GNN_MODELS[arch][1](
        cfg, torch.Generator(device).manual_seed(MODEL_SEED))[0]
    if arch == "graphcast":
        residual_scale(cfg, model)
    return model


def residual_scale(cfg, model) -> None:
    """GraphCast's interaction layers with their residual branches (the
    last layer of each edge and node MLP) at 1/L of the JAX init's scale.
    As drawn, each of BASE's 16 layers multiplies the mesh state ~10-20×
    on a mesh of 16-62 edges a node, and the loss overflows float32 in
    both packages (``tests/test_torch_gnn_train.py::test_jax_init_makes_
    base_graphcast_overflow_in_both_packages``; max |prediction| 4.4e21
    on full_graph_sm, 48 so scaled)."""
    with torch.no_grad():
        for k in ("proc_edge", "proc_node"):
            model[k][-1]["w"].mul_(1.0 / cfg.n_layers)


def gnn_loss(arch: str, cfg, model, batch):
    m = GNN_MODELS[arch][0]
    if arch == "dimenet":
        return m.loss_fn(cfg, model, *batch)
    return m.loss_fn(cfg, model, batch)


def sampled_minibatch(rng) -> tuple:
    """minibatch_lg's input: a CSR (``repro_torch.data.sampler``) over
    ``MB_GRAPH_NODES`` nodes and ``MB_GRAPH_EDGES`` uniform edges,
    ``MB_SEEDS`` seeds sampled with fanout ``MB_FANOUT``, and the sampled
    nodes' features, labels and positions gathered from per-node tables;
    the loss on the seeds. The edges are drawn grouped by source (a
    multinomial count a node, then uniform destinations): the distribution
    of independent uniform edges, in an order the CSR's stable argsort
    passes over once (in a random order the sort took 32.6 s of this
    function's 36.4 s on the host of an H100 machine; 2.3 s so). Returns
    the ``GraphBatch`` (numpy) and the host seconds of each part."""
    info = GNN_SHAPES["minibatch_lg"]
    n = MB_GRAPH_NODES
    t = time.perf_counter()
    counts = rng.multinomial(MB_GRAPH_EDGES, np.full(n, 1.0 / n))
    src = np.repeat(np.arange(n, dtype=np.int32), counts)
    dst = rng.integers(0, n, MB_GRAPH_EDGES, dtype=np.int32)
    edges_s = time.perf_counter() - t
    t = time.perf_counter()
    graph = sampler.CSRGraph.from_edges(src, dst, n)
    csr_s = time.perf_counter() - t
    del src, dst
    t = time.perf_counter()
    seeds = rng.choice(n, MB_SEEDS, replace=False)
    sub = sampler.sample_subgraph(graph, seeds, MB_FANOUT, rng)
    sample_s = time.perf_counter() - t
    n_sub = len(sub.node_ids)
    check((n_sub, len(sub.src)) == (info["n_nodes"], info["n_edges"]),
          f"sampled subgraph {n_sub} nodes, {len(sub.src)} edges")
    del graph
    t = time.perf_counter()
    feats = rng.standard_normal((n, info["d_feat"]), dtype=np.float32)
    labels = rng.integers(0, info["n_classes"], n).astype(np.int32)
    pos = rng.standard_normal((n, 3), dtype=np.float32)
    mask = np.zeros((n_sub,), np.float32)
    mask[:sub.n_seeds] = 1.0
    batch = GraphBatch(
        node_feat=feats[sub.node_ids], src=sub.src, dst=sub.dst,
        n_nodes=n_sub, positions=pos[sub.node_ids],
        labels=labels[sub.node_ids], label_mask=mask)
    features_s = time.perf_counter() - t
    return batch, {"graph_nodes": n, "graph_edges": MB_GRAPH_EDGES,
                   "seeds": MB_SEEDS, "fanout": list(MB_FANOUT),
                   "sub_nodes": n_sub, "sub_edges": len(sub.src),
                   "edges_s": edges_s, "csr_s": csr_s, "sample_s": sample_s,
                   "features_s": features_s}


def gnn_batch(arch: str, shape: str, cfg, rng, minibatch, device):
    """The input of ``arch`` on ``shape``, on ``device``, and the host
    seconds of what was made for this run."""
    info = GNN_SHAPES[shape]
    host = {}
    t = time.perf_counter()
    if arch == "graphcast":       # the shape's nodes are the grid
        batch = graphcast.synth_batch(cfg, info["n_nodes"], info["n_edges"],
                                      rng)
    elif shape == "minibatch_lg":
        batch = minibatch
    elif shape == "molecule":
        batch = block_diagonal_batch(info["n_graphs"], 30, 64,
                                     info["d_feat"], rng, n_classes=1,
                                     with_pos=True)
    else:
        batch = random_graph(info["n_nodes"], info["n_edges"],
                             info["d_feat"], rng,
                             n_classes=info["n_classes"], with_pos=True)
    host["batch_s"] = time.perf_counter() - t
    tri = None
    if arch == "dimenet":
        t = time.perf_counter()
        tri = dimenet.build_triplets(batch.src, batch.dst,
                                     cfg.max_in_per_edge)
        host["triplets_s"] = time.perf_counter() - t
        host["triplets"] = int(tri[2].sum())
        host["triplet_slots"] = len(tri[2])
    t = time.perf_counter()
    out = to_device(batch, device)
    if tri is not None:
        out = (out, dimenet.triplets_to_device(tri, device))
    host["to_device_s"] = time.perf_counter() - t
    return out, host


def gnn_train_run(arch: str, shape: str, smi: str, minibatch, device,
                  profile: bool) -> dict:
    """``arch`` at ``gnn_config(arch, shape)`` (BASE width and depth)
    through its config's train step for ``GNN_STEPS`` steps: every loss
    finite; step ms (p50 over the steps after the first, host clock ending
    in the loss on the host), model TFLOP/s from the config's ``_flops``
    and its share of the dtype's peak, peak bytes, host input seconds; with
    ``profile``, one more step under ``torch.profiler``."""
    module = GNN_ARCHS[arch]
    cfg = gnn_config(arch, shape)
    _free()
    torch.cuda.reset_peak_memory_stats()
    batch, host = gnn_batch(arch, shape, cfg,
                            np.random.default_rng(MODEL_SEED), minibatch,
                            device)
    t = time.perf_counter()
    model = gnn_init(arch, cfg, device)
    state = gnn_common.gnn_train_state(model)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    step = module.train_step(cfg)
    losses, ms = [], []
    for _ in range(GNN_STEPS):
        t = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(metrics["loss"].item())
        ms.append((time.perf_counter() - t) * 1e3)
    check(all(math.isfinite(x) for x in losses),
          f"{arch} {shape}: every loss finite ({losses})")
    p50 = float(np.median(ms[1:]))
    flops = module._flops(shape)["model_flops"]
    bf16 = cfg.dtype == torch.bfloat16
    peak = train_mod.H100_BF16_FLOPS_PER_S if bf16 else F32_FLOPS_PER_S
    res = {"arch": arch, "shape": shape, "dtype": str(cfg.dtype),
           "params": cfg.num_params(), "remat": cfg.remat,
           "depth": gnn_layers(cfg),
           "width": cfg.d_hidden, "steps": GNN_STEPS, "losses": losses,
           "step_ms": ms, "step_ms_first": ms[0], "step_ms_p50": p50,
           "model_flops_per_step": flops,
           "model_tflops_per_s": flops / p50 / 1e9,
           "peak_flops_per_s": peak,
           "share_of_peak": flops / (p50 / 1e3) / peak,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "init_s": init_s, "host": host, "card": smi}
    if arch == "equiformer-v2":
        res["edge_chunks"] = cfg.edge_chunks
    if arch == "dimenet":
        res["triplet_cap"] = cfg.max_in_per_edge
    if arch == "graphcast":
        res["grid"] = GNN_SHAPES[shape]["n_nodes"]
        res["mesh"] = cfg.n_mesh(GNN_SHAPES[shape]["n_nodes"])
    if profile:
        res["profile"] = profile_step(
            lambda: step(state, batch)[1]["loss"].item())
    del state, model, batch
    _free()
    return res


def gnn_check_batch(arch: str, cfg, device):
    """molecule cut to ``GNN_CHECK_GRAPHS`` graphs (graphcast: a grid and
    mesh edges of the same counts), on ``device``."""
    rng = np.random.default_rng(MODEL_SEED)
    info = GNN_SHAPES["molecule"]
    n = GNN_CHECK_GRAPHS
    if arch == "graphcast":
        b = graphcast.synth_batch(cfg, n * 30, n * 64, rng)
        return to_device(b, device)
    b = block_diagonal_batch(n, 30, 64, info["d_feat"], rng, n_classes=1,
                             with_pos=True)
    if arch == "dimenet":
        tri = dimenet.build_triplets(b.src, b.dst, cfg.max_in_per_edge)
        return (to_device(b, device),
                dimenet.triplets_to_device(tri, device))
    return to_device(b, device)


def gnn_grad_errs(got: dict, want: dict) -> dict:
    """Each leaf's max |got - want| over its largest magnitude, or over
    ``GNN_GRAD_FLOOR`` of the largest of all leaves where that is more: a
    leaf whose gradient is zero in exact arithmetic (EquiformerV2's last
    attention bias: each node's softmax ignores it) holds float32 noise
    on both sides."""
    floor = GNN_GRAD_FLOOR * max(float(w.abs().max()) for w in want.values())
    return {n: float((got[n] - w.to(got[n].device)).abs().max())
            / max(float(w.abs().max()), floor, 1e-30)
            for n, w in want.items()}


def gnn_grads(arch: str, cfg, model, batch) -> tuple[dict, float]:
    """One backward pass: {name: gradient} and the loss."""
    loss = gnn_loss(arch, cfg, model, batch)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return grads, loss.item()


def gnn_f32_check(arch: str, device) -> dict:
    """BASE widths at ``GNN_CHECK_DEPTH`` layers or blocks in float32 on
    the molecule cut: every gradient leaf on the card within ``F32_TOL``
    of its largest magnitude of the same model on the CPU with the same
    weights, and the loss."""
    check(not torch.backends.cuda.matmul.allow_tf32,
          "float32 matmuls stay float32 (TF32 off)")
    cfg = dataclasses.replace(gnn_depth(gnn_config(arch, "molecule"),
                                        GNN_CHECK_DEPTH),
                              dtype=torch.float32)
    host = gnn_init(arch, cfg, "cpu")
    card = ParamTree(host.tree(lambda p: p.detach().clone()),
                     requires_grad=True).to(device)
    t = time.perf_counter()
    got, loss_g = gnn_grads(arch, cfg, card, gnn_check_batch(arch, cfg,
                                                             device))
    card_s = time.perf_counter() - t
    t = time.perf_counter()
    want, loss_c = gnn_grads(arch, cfg, host, gnn_check_batch(arch, cfg,
                                                              "cpu"))
    host_s = time.perf_counter() - t
    errs = gnn_grad_errs(got, want)
    worst = max(errs, key=errs.get)
    check(errs[worst] <= F32_TOL, f"{arch} float32 gradients on the card "
          f"within {F32_TOL} of the CPU (worst {worst}: {errs[worst]})")
    loss_err = abs(loss_g - loss_c) / abs(loss_c)
    check(loss_err <= F32_TOL, f"{arch} float32 loss on the card "
          f"({loss_g}) equals the CPU's ({loss_c})")
    check(all(bool(torch.isfinite(g).all()) for g in got.values()),
          f"{arch}: finite gradients on the card")
    return {"depth": GNN_CHECK_DEPTH, "graphs": GNN_CHECK_GRAPHS,
            "params": cfg.num_params(), "loss": loss_g,
            "loss_rel_err": loss_err, "grad_leaves": len(errs),
            "grad_max_rel_err": errs[worst], "worst_leaf": worst,
            "leaves_under_floor": sorted(
                n for n, w in want.items() if float(w.abs().max())
                < GNN_GRAD_FLOOR * max(float(v.abs().max())
                                       for v in want.values())),
            "tol": F32_TOL, "floor": GNN_GRAD_FLOOR, "card_s": card_s,
            "host_s": host_s}


def gnn_equivariance(device) -> dict:
    """EquiformerV2 at BASE width and depth on the molecule cut: the
    output under a random rotation and under a translation of the
    positions, against the output as it is (max |Δ| over max |out|):
    float32 within ``EQUIVARIANCE_TOL``; bf16 reported."""
    base = equiformer_v2_cfg._cfg_for("molecule")
    rng = np.random.default_rng(MODEL_SEED)
    b = block_diagonal_batch(GNN_CHECK_GRAPHS, 30, 64, base.d_feat, rng,
                             n_classes=1, with_pos=True)
    A = rng.normal(size=(3, 3))
    Q, _ = np.linalg.qr(A)
    Q = Q * np.sign(np.linalg.det(Q))
    moved = {"rotation": (b.positions @ Q.T).astype(np.float32),
             "translation": b.positions + np.float32([1.0, -2.0, 3.0])}
    out = {}
    for label, dt in (("float32", torch.float32), ("bf16", torch.bfloat16)):
        cfg = dataclasses.replace(base, dtype=dt)
        model = gnn_init("equiformer-v2", cfg, device)
        with torch.no_grad():
            ref = equiformer_v2.forward(cfg, model, to_device(b, device))
            errs = {}
            for k, pos in moved.items():
                o = equiformer_v2.forward(cfg, model, to_device(
                    dataclasses.replace(b, positions=pos), device))
                errs[k] = float((o - ref).abs().max().float()
                                / (ref.abs().max().float() + 1e-9))
        out[label] = errs
        del model
    for k, e in out["float32"].items():
        check(e < EQUIVARIANCE_TOL, f"equiformer-v2 float32 {k} "
              f"invariance {e} < {EQUIVARIANCE_TOL}")
    _free()
    return {"layers": base.n_layers, "graphs": GNN_CHECK_GRAPHS,
            "tol": EQUIVARIANCE_TOL, **out}


@contextlib.contextmanager
def in_fixed_order():
    """torch's deterministic algorithms for a check: on the card
    ``index_add_`` then sums each row's terms in index order (as XLA's
    ``segment_sum``) instead of with atomics, so two runs of one float32
    step agree bit for bit. With atomics a deep GNN's spread jumps between
    levels from one pair of runs to the next (GraphCast's 16 layers: from
    ~3e-7 to ~5e-4 of a leaf's largest magnitude), so a bound read off one
    pair does not hold the next."""
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    cublas = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    # the workspace torch already gives cuBLAS on Hopper; deterministic
    # algorithms refuse a matmul unless it is named
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
        if cublas is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = cublas


def gnn_remat_check(arch: str, device) -> dict:
    """One backward pass with remat ``full`` against ``none`` at BASE
    width and depth in float32 on the molecule cut, beside a second
    ``none`` run, all three ``in_fixed_order``: remat must add nothing
    beyond the runs' own spread (none once every sum has a fixed order),
    each leaf within ``F32_TOL`` or ``GNN_REMAT_SPREAD`` times the spread,
    whichever is more."""
    cfg = dataclasses.replace(gnn_config(arch, "molecule"),
                              dtype=torch.float32)
    model = gnn_init(arch, cfg, device)
    batch = gnn_check_batch(arch, cfg, device)
    with in_fixed_order():
        runs = {r: gnn_grads(arch, dataclasses.replace(
            cfg, remat=r.split("_")[0]), model, batch)[0]
            for r in ("none", "full", "none_again")}
    want = runs["none"]
    errs = {k: gnn_grad_errs(runs[k], want) for k in ("full", "none_again")}
    worst = {k: max(e, key=e.get) for k, e in errs.items()}
    leaf = {k: errs[k][worst[k]] for k in errs}
    bound = max(F32_TOL, GNN_REMAT_SPREAD * leaf["none_again"])
    check(leaf["full"] <= bound, f"{arch} float32 remat full within "
          f"{bound} of none ({leaf['full']}, {worst['full']})")
    del model, runs, want
    _free()
    return {"depth": gnn_layers(cfg), "graphs": GNN_CHECK_GRAPHS,
            "tol": F32_TOL, "spread_factor": GNN_REMAT_SPREAD,
            "fixed_order": True,
            "full_vs_none_leaf_max_rel_err": leaf["full"],
            "full_vs_none_worst_leaf": worst["full"],
            "none_vs_none_leaf_max_rel_err": leaf["none_again"],
            "none_vs_none_worst_leaf": worst["none_again"]}


def phase_train_gnn(smi: str, device="cuda") -> None:
    """Phase 11: the GNN family of ``repro_torch`` (``models.gnn``,
    ``configs.*_cfg.train_step``; plain torch, no scan kernel)."""
    t_phase = time.perf_counter()
    t = time.perf_counter()
    emit({"phase": "train-gnn-smoke", "card": smi,
          **{arch: module._smoke(device)
             for arch, module in GNN_ARCHS.items()},
          "seconds": time.perf_counter() - t})
    for arch in GNN_ARCHS:
        t = time.perf_counter()
        emit({"phase": f"train-gnn-f32-{arch}", "card": smi,
              **gnn_f32_check(arch, device),
              "seconds": time.perf_counter() - t})
    t = time.perf_counter()
    emit({"phase": "train-gnn-equivariance", "card": smi,
          **gnn_equivariance(device), "seconds": time.perf_counter() - t})
    for arch in GNN_REMAT_ARCHS:
        t = time.perf_counter()
        emit({"phase": f"train-gnn-remat-{arch}", "card": smi,
              **gnn_remat_check(arch, device),
              "seconds": time.perf_counter() - t})
    t = time.perf_counter()
    minibatch, host = sampled_minibatch(np.random.default_rng(MODEL_SEED))
    emit({"phase": "train-gnn-sampler", **host,
          "seconds": time.perf_counter() - t})
    for arch in GNN_ARCHS:
        for shape in GNN_RUN_SHAPES:
            t = time.perf_counter()
            emit({"phase": f"train-gnn-{arch}-{shape}", **gnn_train_run(
                arch, shape, smi, minibatch, device,
                profile=shape == "minibatch_lg"),
                "seconds": time.perf_counter() - t})
    del minibatch
    _free()
    emit({"phase": "train-gnn", "shapes": list(GNN_RUN_SHAPES),
          "cut": {"ogb_products": "partition-parallel over a mesh only "
                  "(ROADMAP A8.3)"},
          "seconds": time.perf_counter() - t_phase})


# -- phase 12, mesh-models: the models sharded over four gloo ranks ----------

# four gloo ranks sharing the card on a (data 2, model 2) mesh (FSDP on);
# granite-moe-1b-a400m at its published width and depth
MM_RANKS = 4
MM_MODEL = 2                   # the model axis; data = MM_RANKS / MM_MODEL
MM_SEQ = 4096                  # train_4k's sequence
MM_FWD_BATCH = 2
MM_TRAIN_BATCH = 4             # train_4k's batch of 256 cut to 4
MM_DECODE = 8
MM_TRAIN_STEPS = 3
MM_REL_L2 = 1e-5               # float32 logits, mesh against one rank
# tests/test_torch_train.py's tolerances: rtol, and an atol of 1e-6 plus
# this share of the leaf's largest magnitude
MM_GRAD_RTOL, MM_GRAD_ATOL, MM_GRAD_LEAF = 1e-4, 1e-6, 3e-5
MM_LOSS_RTOL = 1e-5
# a MoE route the one-rank run would pick otherwise, with the mesh's
# hidden states, is a near-tie: its experts hold at most this share of
# probability more than the mesh's
MM_ROUTE_GAP = 1e-4
MM_TIMEOUT = 1200.0
# the partition-parallel GNN runs: (arch, shape, config, AdamW steps,
# whether the first is held to the blockwise run on one rank). "f32" is
# BASE in float32; "base" BASE as it is (EquiformerV2's bf16). EquiformerV2's
# float32 check is cut to EQ_CHECK_LAYERS of its 12 layers: at 12, four
# ranks' float32 state (~20 GB each on minibatch_lg's shape) does not fit
# the one card they share; its three steps run at BASE
MM_GNN = (("dimenet", "full_graph_sm", "f32", 3, True),
          ("graphcast", "full_graph_sm", "f32", 3, True),
          ("equiformer-v2", "minibatch_lg", "f32-cut", 1, True),
          ("equiformer-v2", "minibatch_lg", "base", 3, False))
EQ_CHECK_LAYERS = 6


def shard_starts(x, coord, local_shape) -> list:
    """Where the shard of ``DTensor`` ``x`` at mesh coordinate ``coord``
    starts in the whole tensor, dimension by dimension. A tensor
    dimension is sharded over one mesh dimension at most, evenly."""
    starts = [0] * x.ndim
    for i, pl in enumerate(x.placements):
        if pl.is_shard():
            starts[pl.dim] = coord[i] * local_shape[pl.dim]
    return starts


def host_full(x):
    """Rank 0: a ``DTensor``'s whole value on the host, from every rank's
    shard sent to it (``dist.gather``); the other ranks: None."""
    loc = x.to_local().detach().cpu().contiguous()
    mesh = x.device_mesh
    rank, world = dist.get_rank(), dist.get_world_size()
    parts = [torch.empty_like(loc) for _ in range(world)] if rank == 0 \
        else None
    dist.gather(loc, parts, dst=0)
    if rank != 0:
        return None
    full = torch.empty(x.shape, dtype=loc.dtype)
    for r, part in enumerate(parts):
        coord = [int(c) for c in (mesh.mesh == r).nonzero()[0]]
        starts = shard_starts(x, coord, part.shape)
        full[tuple(slice(a, a + n) for a, n in zip(starts, part.shape))] = \
            part
    return full


def ordered(tree) -> list:
    """A tree's leaves in the order of its dicts and lists (a
    ``ParamTree``'s ``named_parameters`` order)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in ordered(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in ordered(v)]
    return [tree]


def pinned_floats(n: int):
    """A page-locked float32 host buffer of ``n`` elements."""
    return torch.empty(n, dtype=torch.float32, pin_memory=True)


def write_all(fd: int, t, offset: int) -> None:
    """Host tensor ``t``'s bytes into file ``fd`` at ``offset``."""
    mv = memoryview(t.numpy()).cast("B")
    while mv:
        n = os.pwrite(fd, mv, offset)
        mv, offset = mv[n:], offset + n


def read_all(fd: int, t, offset: int) -> None:
    """``t.nbytes`` bytes of file ``fd`` at ``offset`` into host tensor
    ``t``."""
    mv = memoryview(t.numpy()).cast("B")
    pos = 0
    while pos < len(mv):
        n = os.preadv(fd, [mv[pos:]], offset + pos)
        check(n > 0, f"short read of the moments at {offset + pos}")
        pos += n


class MomentShards:
    """Each rank's shards of AdamW's two moments after every train step,
    kept where the one-rank reference reads them: a ``memfd`` a rank (in
    memory, no disk), which rank 0 opens through ``/proc``; no gloo
    gather, which moved these 10.6 GB a step at about 0.35 GB/s (22-24 s a
    step on an NVIDIA H100 80GB HBM3 at 700 W). The bytes go through a
    page-locked buffer with ``pwrite``/``preadv``: mapping the memfd and
    copying into it page by page took 13-15 s a step. Float32 moments,
    laid out step by step, ``m`` then ``v``, each leaf's local shard in
    ``ordered`` order."""

    def __init__(self, opt_state, steps: int):
        leaves = ordered(opt_state["m"])
        coord = leaves[0].device_mesh.get_coordinate()
        self.layout = [(shard_starts(x, coord, x.to_local().shape),
                        tuple(x.to_local().shape)) for x in leaves]
        self.numel = sum(math.prod(shape) for _, shape in self.layout)
        self.fd = os.memfd_create("mesh-models-moments")
        os.ftruncate(self.fd, steps * 2 * self.numel * 4)
        self.stage = pinned_floats(max(math.prod(shape)
                                       for _, shape in self.layout))

    def save(self, opt_state, step: int) -> None:
        at = step * 2 * self.numel * 4
        for k in ("m", "v"):
            for x in ordered(opt_state[k]):
                loc = x.to_local()
                check(loc.dtype == torch.float32, f"moment dtype {loc.dtype}")
                part = self.stage[:loc.numel()]
                part.copy_(loc.reshape(-1))
                write_all(self.fd, part, at)
                at += part.nbytes

    def share(self) -> list | None:
        """Rank 0: every rank's (file, layout, count), opened to read; the
        other ranks: None. Every rank calls it, and may exit after it."""
        info = [None] * dist.get_world_size()
        dist.all_gather_object(info, (os.getpid(), self.fd, self.layout,
                                      self.numel))
        out = None
        if dist.get_rank() == 0:
            out = [(os.open(f"/proc/{pid}/fd/{fd}", os.O_RDONLY), layout,
                    numel) for pid, fd, layout, numel in info]
        dist.barrier()
        return out


def moments_tol_ratio(shards: list, opt_state, step: int) -> dict:
    """The one-rank reference's moments (on the card) against every rank's
    shards of the mesh's after ``step`` (``MomentShards.share``), compared
    on the card slice by slice: the largest ``within_train_tol`` of each
    moment."""
    out = {}
    stage = pinned_floats(max(math.prod(shape) for _, layout, _ in shards
                              for _, shape in layout))
    for fd, layout, numel in shards:
        at = step * 2 * numel * 4
        for k in ("m", "v"):
            for (starts, shape), want in zip(layout, ordered(opt_state[k])):
                part = stage[:math.prod(shape)]
                read_all(fd, part, at)
                at += part.nbytes
                idx = tuple(slice(a, a + d) for a, d in zip(starts, shape))
                out[k] = max(out.get(k, 0.0), within_train_tol(
                    part.view(shape).cuda(), want[idx],
                    float(want.detach().abs().max())))
    return out


def timed(fn):
    """(fn's result, wall ms, {ms, calls, bytes} of the model's
    collectives): the card synchronized before and after, the
    collectives' counters reset."""
    torch.cuda.synchronize()
    mm_coll.reset_stats()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    st = mm_coll.STATS
    return out, (time.perf_counter() - t) * 1e3, {
        "ms": st["seconds"] * 1e3, "calls": st["calls"],
        "bytes": st["bytes"]}


def within_train_tol(got, want, leaf_max=None) -> float:
    """The largest |got - want| over tests/test_torch_train.py's allowed
    difference (``MM_GRAD_*``): at most 1 passes. ``leaf_max`` is the
    largest magnitude of the whole leaf where ``want`` is a slice of it."""
    got, want = got.float(), want.float()
    if leaf_max is None:
        leaf_max = float(want.abs().max())
    allowed = (MM_GRAD_ATOL + MM_GRAD_LEAF * leaf_max
               + MM_GRAD_RTOL * want.abs())
    return float(((got - want).abs() / allowed).max())


def mm_lm_config():
    """granite-moe-1b-a400m's FULL config in float32 at a capacity that
    drops nothing (each data shard counts its own tokens)."""
    return dataclasses.replace(no_drop(granite_moe_1b.FULL),
                               dtype=torch.float32)


def mm_lm_inputs(cfg) -> dict:
    rng = np.random.default_rng(MODEL_SEED)

    def toks(*shape):
        return torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)).cuda()
    return {"fwd": toks(MM_FWD_BATCH, MM_SEQ),
            "decode": [toks(MM_FWD_BATCH, 1) for _ in range(MM_DECODE)],
            "train": [toks(MM_TRAIN_BATCH, MM_SEQ)
                      for _ in range(MM_TRAIN_STEPS)]}


def gathered_routes(routes: list, mesh) -> list | None:
    """Rank 0: each data shard's recorded MoE routes, call by call (from
    the ranks at model coordinate 0); the other ranks: None. Every rank
    recorded the same calls."""
    flat = torch.cat([r.reshape(-1) for r in routes])
    rank = dist.get_rank()
    parts = ([torch.empty_like(flat) for _ in range(dist.get_world_size())]
             if rank == 0 else None)
    dist.gather(flat, parts, dst=0)
    if rank != 0:
        return None
    sizes = [r.numel() for r in routes]
    return [[x.view(r.shape) for x, r in zip(parts[int(q)].split(sizes),
                                              routes)]
            for q in mesh.mesh[:, 0]]


def whole_batch_calls(shards: list) -> list:
    """The routes of calls over the whole batch: each call's data shards'
    rows in order."""
    return [torch.cat(call) for call in zip(*shards)]


def microbatch_calls(shards: list, k: int) -> list:
    """The routes of one rank's ``grad_accum`` = data shards × ``k``
    microbatches in turn: microbatch j is data shard j // k's microbatch
    j % k, whose calls are the shard's in k equal runs."""
    per = len(shards[0]) // k
    return [c for j in range(len(shards) * k)
            for c in shards[j // k][(j % k) * per:(j % k + 1) * per]]


def mm_lm_rank() -> dict:
    """One rank of the sharded granite: forward, prefill and decode (the
    MoE routes recorded), three float32 train steps and one bf16 step,
    ``compressed_psum`` and a checkpoint across meshes; rank 0 keeps the
    outputs, gathered on the host, and then runs the same on one rank
    (``mm_lm_reference``)."""
    mesh = mesh_mod.make_host_mesh(MM_MODEL, device="cuda")
    rank = dist.get_rank()
    pol = ShardingPolicy(("data", "model"), fsdp=True)
    cfg = mm_lm_config()
    _, logical = tf_mod.init_transformer(cfg, None)
    inp = mm_lm_inputs(cfg)
    keep, out = {}, {"rank": rank, "backend": dist.get_backend()}
    torch.cuda.reset_peak_memory_stats()
    s_max = MM_SEQ + MM_DECODE

    # serving: forward, prefill past 2,048 positions, decode
    sp = distribute_tree(lm_weights(cfg, "cuda"), logical, mesh, pol)
    _free()
    routes: list = []
    with torch.no_grad(), recorded_routes(routes, sort=False):
        (lg, aux), ms, coll = timed(lambda: tf_mod.forward(
            cfg, sp, inp["fwd"], mesh=mesh, policy=pol))
        out["forward"] = {"ms": ms, "collectives": coll}
        keep["forward"], keep["aux"] = host_full(lg), float(aux)
        del lg
        (lg, cache), ms, coll = timed(lambda: tf_mod.prefill(
            cfg, sp, inp["fwd"], s_max, mesh=mesh, policy=pol))
        out["prefill"] = {"ms": ms, "collectives": coll,
                          "cache_seq_sharded": cache["blocks"]["k"]
                          .placements[1].is_shard()}
        keep["prefill"] = host_full(lg)
        dec = []
        for i, t in enumerate(inp["decode"]):
            (lg, cache), ms, coll = timed(lambda: tf_mod.decode_step(
                cfg, sp, cache, t, MM_SEQ + i, mesh=mesh, policy=pol))
            dec.append((ms, coll))
            keep[f"decode{i}"] = host_full(lg)
        out["decode"] = {"ms_p50": float(np.median([d[0] for d in dec])),
                         "collective_ms_p50": float(np.median(
                             [d[1]["ms"] for d in dec])),
                         "collectives_step": dec[-1][1]}
    keep["routes"] = gathered_routes(routes, mesh)
    del sp, cache, lg, routes
    _free()

    # training: three float32 steps; AdamW's moments after the first are
    # 0.1 and 0.05 × the clipped gradient (and its square), every leaf
    sm = ParamTree(distribute_tree(lm_weights(cfg, "cuda",
                                              trainable=True),
                                   logical, mesh, pol), requires_grad=True)
    _free()
    opt = AdamW()
    state = {"params": sm, "opt": opt.init(sm.tree()),
             "step": torch.zeros((), dtype=torch.int32, device="cuda")}
    step = tf_mod.make_train_step(cfg, opt, mesh=mesh, policy=pol)
    steps = []
    keep["train_routes"] = []
    shards = MomentShards(state["opt"], len(inp["train"]))
    for i, t in enumerate(inp["train"]):
        routes: list = []
        with recorded_routes(routes, sort=False):
            (state, m), ms, coll = timed(lambda: step(state, {"tokens": t}))
        keep["train_routes"].append(gathered_routes(routes, mesh))
        del routes
        t0 = time.perf_counter()
        shards.save(state["opt"], i)
        steps.append({"loss": float(m["loss"]), "aux": float(m["aux_loss"]),
                      "ms": ms, "collectives": coll,
                      "moments_save_s": time.perf_counter() - t0})
    keep["moments"] = shards.share()
    out["train"] = steps
    keep["steps"] = [(s["loss"], s["aux"]) for s in steps]
    out["moments_placed"] = all(
        x.placements == p.placements for x, p in zip(
            ordered(state["opt"]["m"]), sm.parameters()))
    # one bf16 step at the config's own capacity (1.25), timed only
    bcfg = dataclasses.replace(cfg, dtype=torch.bfloat16,
                               capacity_factor=granite_moe_1b.FULL
                               .capacity_factor)
    bstep = tf_mod.make_train_step(bcfg, opt, mesh=mesh, policy=pol)
    (state, m), ms, coll = timed(lambda: bstep(state, {
        "tokens": inp["train"][0]}))
    out["train_bf16"] = {"loss": float(m["loss"]), "ms": ms,
                         "collectives": coll}
    out["peak_bytes"] = torch.cuda.max_memory_allocated()

    # a checkpoint from (2, 2), restored onto (1, 4) and onto one rank
    names = ("embed", "unembed", "final_norm")
    sub = {k: state["params"][k] for k in names}
    sub["blocks"] = [state["params"]["blocks"][0].tree(lambda p: p)]
    ck = os.path.join(BUILD, "mesh_models_ckpt")
    if rank == 0:
        shutil.rmtree(ck, ignore_errors=True)
    dist.barrier()
    mgr = CheckpointManager(ck)
    t0 = time.perf_counter()
    mgr.save(1, sub)
    dist.barrier()
    out["ckpt_save_s"] = time.perf_counter() - t0
    mesh14 = mesh_mod.make_host_mesh(MM_RANKS, device="cuda")
    tmpl = tree_map(lambda x: np.zeros(x.shape, np.float32), sub)
    sub_logical = {k: logical[k] for k in names} | {
        "blocks": [logical["blocks"][0]]}
    back = mgr.restore(1, tmpl, shardings=pol.shardings_for_tree(
        mesh14, sub_logical, tmpl))
    out["ckpt_2x2_to_1x4_equal"] = all(
        bool(torch.equal(mm_coll.full_tensor(a).cpu(),
                         mm_coll.full_tensor(b).cpu()))
        for a, b in zip(ordered(back), ordered(sub)))
    if rank == 0:
        keep["ckpt_host"] = ordered(mgr.restore(1, tmpl))
    keep["ckpt_full"] = [host_full(b) for b in ordered(sub)]
    del state, sm, sub, back
    _free()

    # compressed_psum over the four ranks, on the card
    x = np.random.default_rng(0).normal(size=(64, 32)).astype(np.float32)
    xs = torch.from_numpy(x[16 * rank:16 * rank + 16]).cuda()
    true = x.reshape(MM_RANKS, 16, 32).mean(0)
    world = dist.group.WORLD
    m1, _ = compressed_psum(xs, world, torch.zeros_like(xs))
    out["psum_rel1"] = float(np.abs(m1.cpu().numpy() - true).max()
                             / np.abs(true).max())
    acc, e = np.zeros_like(true), torch.zeros_like(xs)
    for _ in range(20):
        m1, e = compressed_psum(xs, world, e)
        acc = acc + m1.cpu().numpy()
    out["psum_rel20"] = float(np.abs(acc - 20 * true).max()
                              / np.abs(20 * true).max())
    out["psum_device"] = str(m1.device)
    dist.barrier()
    mesh_mod.close_ranks()
    if rank == 0:
        t0 = time.perf_counter()
        out["reference"] = mm_lm_reference(cfg, inp, keep)
        out["reference"]["seconds"] = time.perf_counter() - t0
    return out


def mm_lm_reference(cfg, inp, keep) -> dict:
    """Rank 0, alone on the card once the others are gone: the same
    forward, prefill and decode on one rank with the mesh's MoE routes
    replayed (``replayed_routes``: where its own router disagrees, a
    near-tie is counted), and the same three steps; how far the mesh's
    outputs are from them."""
    out = {}
    s_max = MM_SEQ + MM_DECODE
    n_data = MM_RANKS // MM_MODEL
    model = lm_weights(cfg, "cuda")
    stats: dict = {}
    with torch.no_grad(), replayed_routes(
            whole_batch_calls(keep["routes"]), stats):
        lg, aux = tf_mod.forward(cfg, model, inp["fwd"])
        out["forward_rel_l2"] = rel_l2(keep["forward"], lg)
        del lg
        lg, cache = tf_mod.prefill(cfg, model, inp["fwd"], s_max)
        out["prefill_rel_l2"] = rel_l2(keep["prefill"], lg)
        dec = []
        for i, t in enumerate(inp["decode"]):
            lg, cache = tf_mod.decode_step(cfg, model, cache, t, MM_SEQ + i)
            dec.append(rel_l2(keep[f"decode{i}"], lg))
        out["decode_rel_l2_max"] = max(dec)
    out["routes"] = dict(stats)
    with torch.no_grad():
        aux = np.mean([float(tf_mod.forward(cfg, model, t)[1])
                       for t in inp["fwd"].chunk(n_data)])
    out["aux_rel"] = abs(keep["aux"] - aux) / max(abs(aux), 1e-30)
    del model, cache, lg
    _free()
    acfg = dataclasses.replace(cfg, grad_accum=cfg.grad_accum * n_data)
    masters = lm_weights(acfg, "cuda", trainable=True)
    opt = AdamW()
    state = {"params": masters, "opt": opt.init(masters.tree()),
             "step": torch.zeros((), dtype=torch.int32, device="cuda")}
    step = tf_mod.make_train_step(acfg, opt)
    losses = []
    out.update(train_routes=[], m_tol_ratio_max=[], v_tol_ratio_max=[])
    for i, t in enumerate(inp["train"]):
        stats: dict = {}
        with replayed_routes(microbatch_calls(keep["train_routes"][i],
                                              cfg.grad_accum), stats):
            state, m = step(state, {"tokens": t})
        losses.append((float(m["loss"]), float(m["aux_loss"])))
        out["train_routes"].append(stats)
        t0 = time.perf_counter()
        for k, r in moments_tol_ratio(keep["moments"], state["opt"],
                                      i).items():
            out[f"{k}_tol_ratio_max"].append(r)
        out.setdefault("moments_compare_s", []).append(
            time.perf_counter() - t0)
    for fd, _, _ in keep["moments"]:
        os.close(fd)
    out["loss_rel"] = [abs(g[0] - w[0]) / abs(w[0])
                       for g, w in zip(keep["steps"], losses)]
    out["aux_rel_steps"] = [abs(g[1] - w[1]) / abs(w[1])
                            for g, w in zip(keep["steps"], losses)]
    out["losses"] = losses
    out["ckpt_host_equal"] = all(
        np.array_equal(np.asarray(a), b.numpy())
        for a, b in zip(keep["ckpt_host"], keep["ckpt_full"]))
    del masters, state
    _free()
    return out


def regroup(src, dst, n_src: int, n_dst: int, parts: int, multiple: int):
    """cd-0 partitions of an edge list: each partition's edges (both ends
    in its contiguous blocks of ``n_src / parts`` and ``n_dst / parts``
    nodes), renumbered locally, in a block of rows sized by the largest
    partition's and padded to a multiple of ``multiple`` (padding rows: an
    edge between the block's first nodes); an edge between partitions is
    dropped. Returns (src, dst, the original index of each row, -1 for
    padding)."""
    bs, bd = n_src // parts, n_dst // parts
    keep = [np.nonzero((src // bs == r) & (dst // bd == r))[0]
            for r in range(parts)]
    rows = -(-max(len(k) for k in keep) // multiple) * multiple
    s, d, i = (np.zeros(parts * rows, np.int64) for _ in range(3))
    i[:] = -1
    for r, k in enumerate(keep):
        at = slice(r * rows, r * rows + len(k))
        s[at], d[at], i[at] = src[k] - r * bs, dst[k] - r * bd, k
    return s, d, i


def rows_of(a, idx):
    out = a[np.maximum(idx, 0)].copy()
    out[idx < 0] = 0
    return out


def mm_gnn_batch(arch: str, shape: str, cfg) -> dict:
    """The shape's graph (seeded, uniform edges) in ``MM_RANKS`` cd-0
    partitions laid out in blocks of rows, as the partition-parallel step
    takes it; minibatch_lg's loss on its first 1,024 nodes (the seeds)."""
    info = GNN_SHAPES[shape]
    rng = np.random.default_rng(MODEL_SEED)
    n, e, P = info["n_nodes"], info["n_edges"], MM_RANKS
    if arch == "graphcast":
        g = graphcast.synth_batch(cfg, n, e, rng)
        n_mesh = -(-g.n_mesh // P) * P
        pos = np.zeros((n_mesh, 3), np.float32)
        pos[:g.n_mesh] = g.mesh_pos
        gs, gd, gi = regroup(g.g2m_src, g.g2m_dst, n, n_mesh, P, 1)
        ms, md, _ = regroup(g.mesh_src, g.mesh_dst, n_mesh, n_mesh, P, 1)
        ns, nd, ni = regroup(g.m2g_src, g.m2g_dst, n_mesh, n, P, 1)
        return {"grid_feat": g.grid_feat, "mesh_pos": pos,
                "target": g.target, "g2m_src": gs, "g2m_dst": gd,
                "g2m_feat": rows_of(g.g2m_feat, gi), "mesh_src": ms,
                "mesh_dst": md, "m2g_src": ns, "m2g_dst": nd,
                "m2g_feat": rows_of(g.m2g_feat, ni)}
    g = random_graph(n, e, info["d_feat"], rng,
                     n_classes=info["n_classes"], with_pos=True)
    mask = g.label_mask
    if shape == "minibatch_lg":
        mask = np.zeros(n, np.float32)
        mask[:MB_SEEDS] = 1.0
    chunks = getattr(cfg, "edge_chunks", 1)
    s, d, _ = regroup(g.src, g.dst, n, n, P, max(chunks, 1))
    b = {"node_feat": g.node_feat, "positions": g.positions,
         "labels": g.labels.astype(np.int64), "label_mask": mask,
         "src": s, "dst": d}
    if arch == "dimenet":
        rows = len(s) // P
        tri = [dimenet.build_triplets(s[r * rows:(r + 1) * rows],
                                      d[r * rows:(r + 1) * rows],
                                      cfg.max_in_per_edge)
               for r in range(P)]
        b["t_kj"], b["t_ji"], b["t_mask"] = (
            np.concatenate([t[k] for t in tri]) for k in range(3))
        b["t_kj"], b["t_ji"] = (b["t_kj"].astype(np.int64),
                                b["t_ji"].astype(np.int64))
    return b


def mm_gnn_config(arch: str, shape: str, variant: str):
    """BASE width and depth for the shape, as it is (``base``), in
    float32 (``f32``), or in float32 at ``EQ_CHECK_LAYERS`` layers
    (``f32-cut``)."""
    cfg = gnn_config(arch, shape)
    if variant == "base":
        return cfg
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    return gnn_depth(cfg, EQ_CHECK_LAYERS) if variant == "f32-cut" else cfg


def mm_gnn_rank() -> dict:
    """One rank of the partition-parallel GNN runs (``MM_GNN``): the graph
    on the host, this rank's block copied to the card by the step; a
    checked run's steps go ``in_fixed_order``; rank 0 keeps the first
    moment after a checked run's first step (0.1 × the clipped mean
    gradient) and then runs the blockwise reference
    (``mm_gnn_reference``)."""
    mesh = mesh_mod.make_host_mesh(MM_MODEL, device="cuda")
    rank = dist.get_rank()
    out, keep = {"rank": rank}, {}
    for arch, shape, variant, n_steps, checked in MM_GNN:
        cfg = mm_gnn_config(arch, shape, variant)
        _free()
        torch.cuda.reset_peak_memory_stats()
        batch = {k: torch.from_numpy(v) for k, v in
                 mm_gnn_batch(arch, shape, cfg).items()}
        state = gnn_common.gnn_train_state(gnn_init(arch, cfg, "cuda"))
        step = GNN_ARCHS[arch].partitioned_train_step(cfg, mesh)
        runs = []
        with (in_fixed_order() if checked else contextlib.nullcontext()):
            for i in range(n_steps):
                (state, m), ms, coll = timed(lambda: step(state, batch))
                runs.append({"loss": float(m["loss"]), "ms": ms,
                             "collectives": coll})
                if i == 0 and checked and rank == 0:
                    keep[arch] = ([x.detach().to("cpu", copy=True)
                                   for x in ordered(state["opt"]["m"])],
                                  runs[0]["loss"])
        out[f"{arch}-{variant}"] = {
            "shape": shape, "dtype": str(cfg.dtype).split(".")[-1],
            "layers": gnn_layers(cfg), "steps": runs,
            "edge_rows": int(batch["mesh_src" if arch == "graphcast"
                                   else "src"].shape[0]),
            "peak_bytes": torch.cuda.max_memory_allocated()}
        del state, batch, step
    dist.barrier()
    mesh_mod.close_ranks()
    if rank == 0:
        out["reference"] = {
            arch: mm_gnn_reference(arch, shape, variant, keep[arch])
            for arch, shape, variant, _, checked in MM_GNN if checked}
    return out


def mm_gnn_reference(arch: str, shape: str, variant: str, kept) -> dict:
    """The first step of ``arch`` on one rank, twice, ``in_fixed_order``
    as the mesh's checked steps: each partition's ``local_loss`` in turn,
    the losses and gradients averaged, one AdamW update. The mesh's loss
    against the first, and its first moment (each leaf over its largest
    magnitude, ``gnn_grad_errs``' floor) within ``F32_TOL`` or
    ``GNN_REMAT_SPREAD`` times the two one-rank runs' own spread,
    whichever is more."""
    cfg = mm_gnn_config(arch, shape, variant)
    _free()
    batch = {k: torch.from_numpy(v) for k, v in
             mm_gnn_batch(arch, shape, cfg).items()}
    loss_of = GNN_ARCHS[arch].local_loss(cfg)

    def first_step():
        model = gnn_init(arch, cfg, "cuda")
        state = gnn_common.gnn_train_state(model)
        total = 0.0
        for r in range(MM_RANKS):
            loss = loss_of(model, {k: v.chunk(MM_RANKS)[r].cuda()
                                   for k, v in batch.items()})
            (loss / MM_RANKS).backward()
            total += loss.item() / MM_RANKS
        grads = model.tree(lambda p: p.grad)
        opt = gnn_common.OPTIMIZER.update(model.tree(), grads,
                                          state["opt"])[1]
        return total, dict(enumerate(ordered(opt["m"])))
    with in_fixed_order():
        total, want = first_step()
        _, again = first_step()
    got = {i: g.cuda() for i, g in enumerate(kept[0])}
    err = max(gnn_grad_errs(got, want).values())
    spread = max(gnn_grad_errs(again, want).values())
    return {"loss_rel": abs(kept[1] - total) / abs(total),
            "m1_err_max": err, "one_rank_spread": spread,
            "bound": max(F32_TOL, GNN_REMAT_SPREAD * spread)}


def mesh_models_rank(part: str) -> int:
    """``chip_smoke.py --mesh-models-rank lm|gnn``: one rank of phase 12;
    prints one JSON line."""
    out = mm_lm_rank() if part == "lm" else mm_gnn_rank()
    print(json.dumps(out), flush=True)
    return 0


def launch_mesh_models(part: str) -> tuple[list, float]:
    """The ranks of one part of phase 12: their JSON lines and the
    launch's wall seconds."""
    t = time.perf_counter()
    ranks = mesh_mod.launch_ranks(
        MM_RANKS, [os.path.abspath(__file__), "--mesh-models-rank", part],
        timeout=MM_TIMEOUT)
    return ([json.loads(r.stdout.strip().splitlines()[-1]) for r in ranks],
            time.perf_counter() - t)


def phase_mesh_models(smi: str) -> None:
    """Phase 12: the models sharded over four gloo ranks sharing the card
    (module docstring); every check fails the script."""
    t_phase = time.perf_counter()
    _free()          # the ranks share the card with this process
    lm, lm_s = launch_mesh_models("lm")
    ref = lm[0]["reference"]
    emit({"phase": "mesh-models-granite", "card": smi,
          "mesh": [MM_RANKS // MM_MODEL, MM_MODEL],
          "backend": lm[0]["backend"],
          "per_rank": [{k: r[k] for k in ("rank", "forward", "prefill",
                                          "decode", "train", "train_bf16",
                                          "peak_bytes")} for r in lm],
          "reference": ref, "seconds": lm_s})
    emit({"phase": "mesh-models-psum",
          "rel1": lm[0]["psum_rel1"], "rel20": lm[0]["psum_rel20"],
          "device": lm[0]["psum_device"]})
    emit({"phase": "mesh-models-checkpoint",
          "to_1x4_equal": [r["ckpt_2x2_to_1x4_equal"] for r in lm],
          "to_one_rank_equal": ref["ckpt_host_equal"],
          "save_s": lm[0]["ckpt_save_s"]})
    check(all(r["backend"] == "gloo" for r in lm), "gloo ranks")
    check(all(r["prefill"]["cache_seq_sharded"] for r in lm),
          "the prefill cache shards its sequence over model")
    check(all(r["moments_placed"] for r in lm),
          "AdamW's moments are placed like their weights")
    for k in ("forward_rel_l2", "prefill_rel_l2", "decode_rel_l2_max"):
        check(ref[k] <= MM_REL_L2, f"mesh granite {k} {ref[k]:.3g}")
    check(ref["aux_rel"] <= MM_LOSS_RTOL, f"aux {ref['aux_rel']:.3g}")
    for k, st in [("serving", ref["routes"])] + [
            (f"train step {i + 1}", st)
            for i, st in enumerate(ref["train_routes"])]:
        check(st["calls"] == st["recorded"],
              f"every recorded route replayed once: {k} {st}")
        check(st["gap_max"] <= MM_ROUTE_GAP,
              f"routes the one rank would pick otherwise are near-ties: "
              f"{k} {st}")
    # every step, each with its own routes replayed: the loss, aux and
    # both moments after it
    for i in range(MM_TRAIN_STEPS):
        check(ref["loss_rel"][i] <= MM_LOSS_RTOL
              and ref["aux_rel_steps"][i] <= MM_LOSS_RTOL,
              f"mesh granite step {i + 1}: loss {ref['loss_rel'][i]:.3g}, "
              f"aux {ref['aux_rel_steps'][i]:.3g}")
        for k in ("m_tol_ratio_max", "v_tol_ratio_max"):
            check(ref[k][i] <= 1.0,
                  f"mesh granite step {i + 1} {k} {ref[k][i]:.3g}")
    check(all(np.isfinite(r["train_bf16"]["loss"]) for r in lm),
          "the bf16 step's loss is finite")
    check(lm[0]["psum_rel1"] < 0.05 and
          lm[0]["psum_rel20"] < lm[0]["psum_rel1"],
          "compressed_psum error feedback on the card")
    check(all(r["ckpt_2x2_to_1x4_equal"] for r in lm)
          and ref["ckpt_host_equal"],
          "a (2, 2) checkpoint restores onto (1, 4) and one rank")

    gnn, gnn_s = launch_mesh_models("gnn")
    for arch, shape, variant, _, checked in MM_GNN:
        key = f"{arch}-{variant}"
        line = {"phase": f"mesh-models-{key}-{shape}", "card": smi,
                "per_rank": [r[key] for r in gnn]}
        if checked:
            line["reference"] = gnn[0]["reference"][arch]
        emit(line)
        check(all(np.isfinite(s["loss"]) for r in gnn
                  for s in r[key]["steps"]), f"{key} losses finite")
        if checked:
            gref = line["reference"]
            check(gref["loss_rel"] <= MM_LOSS_RTOL
                  and gref["m1_err_max"] <= gref["bound"],
                  f"{key}: the partition-parallel step against the "
                  f"blockwise run: {gref}")
    emit({"phase": "mesh-models", "cut": {
        "train_batch": f"train_4k's 256 cut to {MM_TRAIN_BATCH}",
        "equiformer_f32_check": f"{EQ_CHECK_LAYERS} of 12 layers",
        "ogb_products": "not run: one card holds every partition, and "
                        "one edge tensor alone is 17-63 GB"},
          "lm_s": lm_s, "gnn_s": gnn_s,
          "seconds": time.perf_counter() - t_phase})


DRYRUN_OUT = os.path.join(BUILD, "dryrun_chip", "cells.jsonl")
DRYRUN_CELLS = {"OK": 80, "SKIP": 8, "FAIL": 0}
DRYRUN_TIMEOUT = 300.0


def dryrun_paper_cells() -> list:
    """The ``dist-quality-assessment`` cells: (shape, mesh kind, one rank's
    rows), the shape's triples padded to the mesh and split over it."""
    return [(shape, mk, paper_qa.pad_to(info["n_triples"], world) // world)
            for shape, info in paper_qa.QA_SHAPES.items()
            for mk, world in (("single", 256), ("multi", 512))]


def phase_dryrun(smi: str) -> int:
    """Phase 13 (module docstring): the dry-run registry. Returns the
    ``fused_scan`` launches of its path ((b) and (c))."""
    t_phase = time.perf_counter()
    # (a) every cell on the fake group, in a process of its own, CPU only,
    # while (b) and (c) run here
    shutil.rmtree(os.path.dirname(DRYRUN_OUT), ignore_errors=True)
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun",
         "--no-subprocess", "--out", DRYRUN_OUT],
        env={**SRC_ENV, "CUDA_VISIBLE_DEVICES": ""},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        # (b) each arch's smoke on the card, then (c) one rank's share of
        # each paper cell through the bundle's fn; the launch counts of
        # both set to 0 just before and read just after
        planes = {}
        for shape, mk, rows in dryrun_paper_cells():
            planes[shape, mk] = torch.from_numpy(
                synth_encoded(rows, seed=3).planes).cuda()
        torch.cuda.synchronize()
        smokes, outs = {}, {}
        K.reset_launches()
        for name, spec in configs.REGISTRY.items():
            t = time.perf_counter()
            smokes[name] = {**spec.smoke(device="cuda"),
                            "seconds": time.perf_counter() - t}
        for shape, mk, rows in dryrun_paper_cells():
            mesh = mesh_mod.make_production_mesh(multi_pod=mk == "multi")
            try:
                bundle = paper_qa._bundle(shape, mesh, multi_pod=mk == "multi")
                outs[shape, mk] = bundle.fn(planes[shape, mk])
            finally:
                mesh_mod.close_ranks()
        torch.cuda.synchronize()
        launched = dict(K.LAUNCHES)
        check(launched == {"qap_count": 0, "hll_fold": 0,
                           "fused_scan": 1 + len(outs)},
              f"dry-run phase: one fused_scan a paper scan and the paper "
              f"smoke, nothing else: {launched}")
        for name, r in smokes.items():
            vals = [v for k, v in r.items() if k not in ("values", "seconds")]
            check(all(np.isfinite(v) for v in vals),
                  f"{name} smoke on the card: {r}")
        check(smokes["dist-quality-assessment"]["metrics"] == 16,
              "the paper's smoke gives 16 metrics in one pass")
        emit({"phase": "dryrun-smokes", "card": smi,
              "smokes": {k: {kk: vv for kk, vv in v.items() if kk != "values"}
                         for k, v in smokes.items()}})

        all_plan = plan(get_metrics(ALL_METRICS))
        specs = all_plan.sketch_specs
        cells = []
        for (shape, mk), x in planes.items():
            counts, regs = outs[shape, mk]
            pc, pr = fref.fused_scan_torch(x, all_plan.program,
                                           all_plan.n_counters, specs, MAIN_P)
            same = (torch.equal(counts, pc.cpu().to(counts.dtype))
                    and sorted(regs) == sorted(n for n, _ in specs)
                    and all(torch.equal(regs[n], pr[n].cpu())
                            for n, _ in specs))
            check(same, f"paper cell {shape} {mk}: the bundle's fn equals "
                  f"the plain backend on the card, counters and registers")
            rows = x.shape[0]
            bound_ms, bound_by = bound(rows, all_plan.program,
                                       all_plan.n_counters, specs, MAIN_P)
            launch = scan_launch(x, all_plan, specs, MAIN_P)[2]
            cells.append({
                "shape": shape, "mesh": mk, "rows": rows, "equal": same,
                "ms": cuda_ms(lambda: fops.fused_scan(
                    x, all_plan.program, all_plan.n_counters, specs,
                    MAIN_P), 10),
                "launch_ms": cuda_ms(launch, 10),
                "plain_ms": cuda_ms(lambda: fref.fused_scan_torch(
                    x, all_plan.program, all_plan.n_counters, specs,
                    MAIN_P), 2),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "bytes_ms": rows * 52 / MEM_BYTES_PER_S * 1e3})
        emit({"phase": "dryrun-paper-cells", "card": smi, "cells": cells})
        del planes, outs
        torch.cuda.empty_cache()
        out, _ = proc.communicate(timeout=DRYRUN_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    check(proc.returncode == 0, f"the dry-run exited {proc.returncode}: "
          f"{out[-2000:]}")
    with open(DRYRUN_OUT) as f:
        recs = [json.loads(line) for line in f]
    status = {k: sum(r["status"] == k for r in recs) for k in DRYRUN_CELLS}
    for r in recs:
        emit({"phase": "dryrun-cell", "arch": r["arch"], "shape": r["shape"],
              "mesh": r["mesh"], "status": r["status"],
              "argument_bytes": r.get("memory", {}).get("argument_bytes"),
              **({"error": r["error"]} if r["status"] == "FAIL" else {})})
    check(status == DRYRUN_CELLS and len(recs) == sum(DRYRUN_CELLS.values()),
          f"dry-run cells: {status}")
    big = max((r for r in recs if r["status"] == "OK"),
              key=lambda r: r["memory"]["argument_bytes"])
    emit({"phase": "dryrun", "card": smi, "cells": status,
          "largest": {k: big[k] for k in ("arch", "shape", "mesh")},
          "largest_argument_bytes": big["memory"]["argument_bytes"],
          "card_total_memory": torch.cuda.get_device_properties(0)
          .total_memory,
          "fused_scan_launches": launched["fused_scan"],
          "seconds": time.perf_counter() - t_phase})
    return launched["fused_scan"]


def dryrun_only() -> int:
    """``--dryrun``: phase 13 alone, then the card's line."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = train_mod.card_line()
    phase_dryrun(smi)
    print(smi, flush=True)
    return 0


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

    # -- 12. the models sharded over four ranks; this process only waits on
    # them, so phase 3's rows are synthesized on the host meanwhile
    def synth():
        t = time.perf_counter()
        return synth_encoded(FULL_ROWS, seed=3), time.perf_counter() - t

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        data = pool.submit(synth)
        before = dict(K.LAUNCHES)
        phase_mesh_models(smi)
        check(K.LAUNCHES == before, "the sharded models launch no scan kernel")
        tt, synth_s = data.result()

    # -- 3. the main path at full size ---------------------------------------
    emit({"phase": "data", "rows": tt.n_rows,
          "planes_bytes": tt.planes.nbytes, "synth_seconds": synth_s,
          "beside": "mesh-models"})
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
    phase_train_lm(smi)
    phase_train_gnn(smi)
    check(K.LAUNCHES == before, "the model phases launch no scan kernel")
    # -- 13. the dry-run registry: every cell, every smoke, the paper cells
    launches["fused_scan"] += phase_dryrun(smi)

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


def train_only(phase) -> int:
    """``--train-lm`` (phase 10), ``--train-gnn`` (phase 11) or
    ``--mesh-models`` (phase 12): that phase alone, held to launch no scan
    kernel, then the card's line."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = train_mod.card_line()
    before = dict(K.LAUNCHES)
    phase(smi)
    check(K.LAUNCHES == before, "the training phase launches no scan kernel")
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--mesh-rank":
        sys.exit(mesh_rank(json.loads(sys.argv[2])))
    if sys.argv[1:] == ["--lm-init-witness"]:
        sys.exit(lm_init_witness())
    if sys.argv[1:] == ["--train-lm"]:
        sys.exit(train_only(phase_train_lm))
    if sys.argv[1:] == ["--train-gnn"]:
        sys.exit(train_only(phase_train_gnn))
    if sys.argv[1:] == ["--dryrun"]:
        sys.exit(dryrun_only())
    if len(sys.argv) == 3 and sys.argv[1] == "--mesh-models-rank":
        sys.exit(mesh_models_rank(sys.argv[2]))
    if sys.argv[1:] == ["--mesh-models"]:
        sys.exit(train_only(phase_mesh_models))
    sys.exit(main())
