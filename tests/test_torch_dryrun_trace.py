"""The dry-run's trace of one rank's step (``launch/trace.py``) against
the real run of the same step.

Five step kinds, each in a launch of four gloo ranks (``launch_ranks``)
of its own, so that one kind's fault cannot hide another's: every rank
builds the bundle from the registry's own code at a small size on a
(data 2, model 2) ``make_host_mesh``: qwen2.5-14b's SMOKE train and
decode steps (the LM shapes cut to a few rows and tokens), DIN's SMOKE
train step, GatedGCN's step on full_graph_sm's shape cut to 64 nodes, or
the paper's scan of bsbm_2gb's shape cut to 4,096 triples. Each rank runs
the step on its real shards (``real_arguments``: floats drawn, indices
0) under a ``StepMeter`` (``run_metered``). Rank 0 then runs it again
alone on torch's fake process group, on real tensors, and traces it on
fake CPU tensors (``trace_bundle``). The trace must equal the real run
on the fake group exactly: FLOPs, bytes accessed, output, temp and alias
bytes, the peak of live bytes, and the collectives' counts and bytes by
op. It must equal the gloo run exactly in all but the peak (and the temp
bytes taken from it), which there depends on when gloo's worker thread
drops a finished collective's tensors.

Then, on one device, an MoE LM train step's traced FLOPs equal a count
written from its config; and each kernel wrapper takes its shape-only
route (no launch) for a meta or fake tensor and never for a real one.
"""
import os
import pickle
import subprocess
import sys
import tempfile
import textwrap

import pytest
import torch

from repro_torch.launch.mesh import launch_ranks

DEADLINE = 300.0
SRC = os.pathsep.join(p for p in (
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "src"), os.environ.get("PYTHONPATH")) if p)

RANK = textwrap.dedent("""
    import pickle, sys
    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.configs import (din_cfg, gatedgcn_cfg, gnn_common,
                                     lm_common, paper_qa, qwen2_5_14b)
    from repro_torch.launch.mesh import close_ranks, make_host_mesh
    from repro_torch.launch.trace import (real_arguments, run_metered,
                                          trace_bundle)

    d, cell, where = sys.argv[1:4]
    torch.set_num_threads(1)      # four ranks on the host's cores
    with open(d + "/in.pkl", "rb") as f:
        spec = pickle.load(f)
    lm_common.LM_SHAPES.update(spec["lm_shapes"])
    din_cfg.DIN_SHAPES.update(spec["din_shapes"])
    din_cfg.FULL = din_cfg.SMOKE
    gnn_common.GNN_SHAPES.update(spec["gnn_shapes"])
    paper_qa.QA_SHAPES.update(spec["qa_shapes"])

    def bundle():
        mesh = make_host_mesh(2, device="cpu")
        return {
            "lm_train": lambda: lm_common.lm_bundle(qwen2_5_14b.SMOKE,
                                                    "train_4k", mesh),
            "lm_decode": lambda: lm_common.lm_bundle(qwen2_5_14b.SMOKE,
                                                     "decode_32k", mesh),
            "din_train": lambda: din_cfg._bundle("train_batch", mesh),
            "gnn_step": lambda: gatedgcn_cfg._bundle("full_graph_sm", mesh),
            "paper_scan": lambda: paper_qa._bundle("bsbm_2gb", mesh),
        }[cell]()

    def real_run(b):
        # rank 0's real shards (each in a storage of its own, as the trace
        # gives fake ones): floats drawn, indices 0
        return run_metered(b.fn, real_arguments(b, "cpu"), "cpu",
                           b.donate)[1]

    if where == "gloo":
        # the step on the gloo mesh, every rank with its own shards
        rec = {"gloo": real_run(bundle())}
    else:
        # rank 0 alone on the fake group, on real tensors and traced: no
        # worker thread holds a collective's tensors past its wait, so
        # when each storage dies is the program's alone
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=4)
        b = bundle()
        rec = {"alone": real_run(b), "traced": trace_bundle(b, "cpu")}
        rec["traced"].pop("trace_s")
    if dist.get_rank() == 0:
        with open(f"{d}/{where}.pkl", "wb") as f:
            pickle.dump(rec, f)
    close_ranks()
""")


def spec() -> dict:
    return {
        "lm_shapes": {
            "train_4k": dict(kind="train", seq=16, batch=4),
            "decode_32k": dict(kind="decode", seq=24, batch=2)},
        "din_shapes": {"train_batch": dict(kind="train", batch=8,
                                           n_cands=1)},
        "gnn_shapes": {"full_graph_sm": dict(n_nodes=64, n_edges=256,
                                             d_feat=12, n_classes=7,
                                             task="node")},
        "qa_shapes": {"bsbm_2gb": dict(n_triples=4096)},
    }


# what the gloo run's peak depends on: when gloo's worker thread drops a
# finished collective's tensors, a moment after the wait returns
RACED = ("peak_bytes", "peak_storages", "peak_large_storages",
         "temp_bytes")


def without_raced(rec: dict) -> dict:
    rec = {k: v for k, v in rec.items() if k not in RACED}
    rec["memory"] = {k: v for k, v in rec["memory"].items()
                     if k not in RACED}
    return rec


@pytest.mark.parametrize("cell", ["lm_train", "lm_decode", "din_train",
                                  "gnn_step", "paper_scan"])
def test_trace_equals_the_real_step(cell):
    """Each cell in launches of its own (the gloo ranks, then rank 0 alone
    on the fake group): the trace equals rank 0's real step on the fake
    group exactly, peak included, and on the gloo mesh in all but the
    peak."""
    out = {}
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "in.pkl"), "wb") as f:
            pickle.dump(spec(), f)
        launch_ranks(4, ["-c", RANK, d, cell, "gloo"], timeout=DEADLINE)
        subprocess.run([sys.executable, "-c", RANK, d, cell, "alone"],
                       check=True, timeout=DEADLINE,
                       env={**os.environ, "PYTHONPATH": SRC})
        for where in ("gloo", "alone"):
            with open(os.path.join(d, f"{where}.pkl"), "rb") as f:
                out.update(pickle.load(f))
    real, traced = out["alone"], out["traced"]
    assert traced == real, (cell, traced, real)
    assert without_raced(out["gloo"]) == without_raced(traced), (
        cell, out["gloo"], traced)
    assert real["flops_per_device"] > 0 or cell == "paper_scan", real
    assert real["collectives"]["total_bytes"] > 0, real
    assert real["peak_bytes"] >= real["traced_argument_bytes"], real


@pytest.mark.parametrize("remat", ["none", "full"])
def test_lm_train_flops_equal_a_count_from_the_config(remat):
    """granite-moe-1b-a400m's SMOKE (MoE, 4 experts top-2) without head
    padding or a chunked loss, one train step of 2 × 16 tokens traced on
    one device: per layer the q/k/v/o projections, the scores and their
    product with v, the router and every expert at its capacity (C slots,
    ``_dispatch``'s rule), plus the head; forward and backward (×3), and
    with ``remat="full"`` each layer's forward once more."""
    import dataclasses
    import math

    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import granite_moe_1b
    from repro_torch.launch.trace import run_metered
    from repro_torch.models import transformer as tf
    from repro_torch.optim import AdamW

    cfg = dataclasses.replace(granite_moe_1b.SMOKE, pad_heads_multiple=1,
                              loss_chunk=0, remat=remat)
    B, S = 2, 16
    with FakeTensorMode():
        model, _ = tf.init_transformer(cfg, torch.Generator().manual_seed(0),
                                       trainable=True)
        opt = AdamW(lr=1e-4)
        state = {"params": model, "opt": opt.init(model.tree()),
                 "step": torch.zeros((), dtype=torch.int32)}
        tokens = torch.zeros((B, S), dtype=torch.int64)
        _, rec = run_metered(tf.make_train_step(cfg, opt),
                             (state, {"tokens": tokens}), "cpu", (0,))
    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    E, k, f = cfg.n_experts, cfg.top_k, cfg.d_ff_expert
    T = B * S
    C = max(8, -(-math.ceil(T * k / E * cfg.capacity_factor) // 8) * 8)
    layer = (2 * T * d * H * hd * 2          # q and o
             + 2 * T * d * Hkv * hd * 2      # k and v
             + 2 * 2 * B * H * S * S * hd    # scores, and their product with v
             + 2 * T * d * E                 # router
             + 3 * 2 * E * C * d * f)        # gate, up, down at capacity
    head = 2 * T * d * cfg.vocab_size
    passes = 3 + (remat == "full")
    assert rec["flops_per_device"] == cfg.n_layers * layer * passes + 3 * head


def test_a_real_cpu_tensor_takes_the_plain_route(monkeypatch):
    """Each wrapper on a real CPU tensor runs its plain version (the same
    values), launches nothing and reports no kernel; ``shape_only`` says
    no."""
    from repro_torch import kernels as K
    from repro_torch.core.metrics import ALL_METRICS, get_metrics
    from repro_torch.core.planner import plan
    from repro_torch.kernels.fused_scan import ops as fops, ref as fref
    from repro_torch.kernels.hll import ops as hops, ref as href
    from repro_torch.kernels.qap_count import ops as qops, ref as qref
    from repro_torch.rdf import synth_encoded

    pln = plan(get_metrics(ALL_METRICS))
    planes = torch.from_numpy(synth_encoded(3000, seed=1).planes)
    seen = []
    monkeypatch.setattr(K, "KERNEL_OBSERVERS", [lambda *a: seen.append(a)])
    before = dict(K.LAUNCHES)
    assert not K.shape_only(planes)
    got = fops.fused_scan(planes, pln.program, pln.n_counters,
                          pln.sketch_specs, 12)
    want = fref.fused_scan_torch(planes, pln.program, pln.n_counters,
                                 pln.sketch_specs, 12)
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(got[1][n], want[1][n]) for n in want[1])
    assert torch.equal(qops.fused_count(planes, pln.program, pln.n_counters),
                       qref.counts_ref(planes, pln.program, pln.n_counters))
    cols = pln.sketch_specs[0][1]
    assert torch.equal(hops.hll_fold(planes, cols, 12),
                       href.hll_fold_torch(planes, cols, 12))
    assert K.LAUNCHES == before and seen == []


def test_meta_and_fake_tensors_take_the_shape_only_route(monkeypatch):
    """A meta or fake tensor gets outputs of the right shape, dtype and
    device from each wrapper, with its arguments checked; nothing is
    launched or counted in ``LAUNCHES``, and the kernel is reported as one
    op that reads the planes and writes its outputs."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch import kernels as K
    from repro_torch.core.metrics import ALL_METRICS, get_metrics
    from repro_torch.core.planner import plan
    from repro_torch.kernels.fused_scan import ops as fops
    from repro_torch.kernels.hll import ops as hops
    from repro_torch.kernels.qap_count import ops as qops

    pln = plan(get_metrics(ALL_METRICS))
    seen = []
    monkeypatch.setattr(K, "KERNEL_OBSERVERS",
                        [lambda read, out: seen.append(
                            (read, [tuple(t.shape) for t in out]))])
    before = dict(K.LAUNCHES)
    planes = torch.empty((1000, 13), dtype=torch.int32, device="meta")
    assert K.shape_only(planes)
    with FakeTensorMode():
        assert K.shape_only(torch.empty(3))
    counts, regs = fops.fused_scan(planes, pln.program, pln.n_counters,
                                   pln.sketch_specs, 12)
    assert counts.shape == (pln.n_counters,) and counts.dtype == torch.int64
    assert counts.device.type == "meta"
    assert {n: (tuple(r.shape), r.dtype) for n, r in regs.items()} == {
        n: ((4096,), torch.int32) for n, _ in pln.sketch_specs}
    assert qops.fused_count(planes, pln.program,
                            pln.n_counters).shape == (pln.n_counters,)
    assert hops.hll_fold(planes, pln.sketch_specs[0][1], 12).shape == (4096,)
    with pytest.raises(ValueError):      # the checks still run
        fops.fused_scan(planes, pln.program, pln.n_counters,
                        pln.sketch_specs, 30)
    assert K.LAUNCHES == before
    assert seen == [(1000 * 52, [(pln.n_counters,),
                                 (len(pln.sketch_specs), 4096)]),
                    (1000 * 52, [(pln.n_counters,)]),
                    (1000 * 52, [(4096,)])]
