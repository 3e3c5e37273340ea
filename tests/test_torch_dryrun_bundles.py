"""The dry-run bundles' steps run (``Bundle.fn`` of the LM, DIN and GNN
families; the paper's is run in ``tests/test_torch_dryrun.py``).

The dry-run builds every cell at its production size and calls no
``fn``. Here each family's bundle is built from the registry's own code
at a small size on a (data 2, model 2) ``make_host_mesh`` of four gloo
ranks (``launch_ranks``), each family (LM, DIN, GNN, GraphCast) in a
launch of its own: the LM shapes of ``lm_common.LM_SHAPES`` cut
to a few rows and tokens at qwen2.5-14b's SMOKE config, DIN's at its
SMOKE config, two GNN shapes cut to a few graphs (GatedGCN on
full_graph_sm's, DimeNet and EquiformerV2 on molecule's, each at the
config the bundle picks for the shape). Then each ``fn`` runs
once on real tensors and is held to the step it wraps:

* the LM steps take the weights and the optimizer state as ``DTensor``s
  placed as ``in_shardings`` say (the tokens whole on every rank); the
  logits must be placed as ``out_shardings`` say, the train step must
  keep its state's layout (the state is its ``donate``d argument), and
  the logits and losses must equal the port's one-device ``prefill``,
  ``decode_step`` and train step (``grad_accum`` × data shards) within
  1e-5 relative (other reduction orders of the same float32 sums). The
  cache is the one place where the port's layout is not the JAX
  bundle's: the bundles (and the dry-run's bytes) put its batch over the
  data axes and its kv heads over "model" where they divide; the port's
  sharded ``prefill`` and ``decode_step`` keep the batch there and put
  the sequence over "model" past 2,048 positions (split-KV decode). The
  test holds the port's cache to that layout, and the decode bundle's
  ``fn`` to the cache its ``prefill`` makes. The prompt is 2,050 tokens
  long, so that the sequence shards.
* the DIN, GNN and GraphCast whole-grid steps are DTensor programs: the
  bundle's ``args`` must have the keys and shapes of the family's own
  batch, its ``fn`` on whole tensors must give the model's own loss
  (train) or scores (serve) on them, exactly, and its ``fn`` on each
  rank's shards placed as ``run_shardings`` say (the JAX layout with the
  axes that split rows merged into one) must equal that one-device step
  within 1e-5 relative: the loss and the first moments after the AdamW
  update, all leaves as one vector (train), the scores (serve).
  EquiformerV2's exact check runs at its BASE config (bf16), its mesh
  check at BASE in float32 (in bf16 two orders of the same sums differ
  by bf16's 2^-8); GraphCast runs at its SMOKE config on full_graph_sm's
  cut shape.
"""
import os
import pickle
import tempfile
import textwrap

import numpy as np
import pytest

from repro_torch.launch.mesh import launch_ranks

DEADLINE = 300.0
RTOL = 1e-5
PROMPT = 2050                 # > 2,048: the cache's sequence shards

# each family runs in a rank launch of its own (``family_out``), so that
# one family's fault cannot hide another's checks: the common head, the
# family's part, then rank 0 writes ``out``
HEAD = textwrap.dedent("""
    import dataclasses, pickle, sys
    import numpy as np
    import torch
    from torch.distributed.tensor import Shard, distribute_tensor
    from repro_torch.configs import (dimenet_cfg, din_cfg, equiformer_v2_cfg,
                                     gatedgcn_cfg, gnn_common, graphcast_cfg,
                                     lm_common, qwen2_5_14b)
    from repro_torch.dist.collectives import full_tensor
    from repro_torch.launch.mesh import close_ranks, make_host_mesh
    from repro_torch.launch.trace import map_args
    from repro_torch.models import din as D
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import ParamTree
    from repro_torch.models.gnn import dimenet as DN
    from repro_torch.models.gnn import equiformer_v2 as EQ
    from repro_torch.models.gnn import gatedgcn as GG
    from repro_torch.models.gnn import graphcast as GC
    from repro_torch.models.gnn.common import (GraphBatch,
                                               block_diagonal_batch,
                                               random_graph)
    from repro_torch.optim import AdamW
    from repro_torch.tree import tree_leaves

    d = sys.argv[1]
    torch.set_num_threads(1)      # four ranks on the host's cores
    with open(d + "/in.pkl", "rb") as f:
        spec = pickle.load(f)
    mesh = make_host_mesh(2, device="cpu")
    out = {}

    def map2(fn, a, b):
        if isinstance(a, dict):
            return {k: map2(fn, v, b[k]) for k, v in a.items()}
        if isinstance(a, (list, tuple)):
            return type(a)(map2(fn, v, w) for v, w in zip(a, b))
        return fn(a, b)

    def place(t, s):
        return distribute_tensor(t.detach().clone(), s.mesh, s.placements,
                                 src_data_rank=None)

    def layout_ok(tree, shardings):
        return all(tuple(x.placements) == tuple(s.placements)
                   for x, s in zip(tree_leaves(tree), tree_leaves(shardings)))

    def port_cache_ok(cache, shardings):
        # the batch as the bundle places it, the sequence over "model"
        return all(x.placements[0] == s.placements[0]
                   and x.placements[1] == Shard(2)
                   for x, s in zip(tree_leaves(cache), tree_leaves(shardings)))

    def shapes(tree):
        return [(tuple(x.shape), x.dtype) for x in tree_leaves(tree)]

    def full(x):
        # a DTensor whole (DTensor's own, partial sums too)
        return x.full_tensor() if hasattr(x, "full_tensor") else x

    def rel(got, want):
        got, want = full(got).float(), want.float()
        return float((got - want).abs().max()
                     / (want.abs().max() + 1e-30))


    # -- DIN, the GNNs and GraphCast: DTensor programs against one device ---
    def on_mesh(tree, shardings):
        return map_args(lambda t, s: place(t, s), tree, shardings)

    def steps_agree(b, state, batch):
        # the bundle's fn on this rank's shards placed as the port runs
        # them, against the same fn on the whole tensors: loss and first
        # moments (train) or scores (serve), relative to their magnitude
        if isinstance(state, dict):            # train: the state is updated
            one = b.fn(clone_state(state), batch)
            got = b.fn(on_mesh(clone_state(state), b.run_shardings[0]),
                       on_mesh(batch, b.run_shardings[1]))
            # the moments as one vector: a leaf whose gradient is zero
            # (7e-12 of EquiformerV2's) holds only noise of its own size
            m_got = torch.cat([full(x).reshape(-1).float() for x in
                               tree_leaves(got[0]["opt"]["m"])])
            m_one = torch.cat([x.reshape(-1).float() for x in
                               tree_leaves(one[0]["opt"]["m"])])
            return max(rel(got[1]["loss"], one[1]["loss"]),
                       rel(m_got, m_one))
        one = b.fn(state, batch)
        got = b.fn(on_mesh(state, b.run_shardings[0]),
                   on_mesh(batch, b.run_shardings[1]))
        return rel(got, one)

    def clone_state(state):
        p = state["params"]
        return {"params": ParamTree(p.tree(lambda x: x.detach().clone()),
                                    requires_grad=True),
                "opt": map2(lambda t, _: t.clone(), state["opt"],
                            state["opt"]),
                "step": state["step"].clone()}
""")

LM = textwrap.dedent("""
    # -- LM: qwen2.5-14b's SMOKE at the cut shapes ---------------------------
    lm_common.LM_SHAPES.update(spec["lm_shapes"])
    cfg = qwen2_5_14b.SMOKE
    pol = lm_common._policy(mesh, cfg)
    n_data = 2
    toks = {k: torch.from_numpy(v) for k, v in spec["tokens"].items()}
    masters, _ = tf.init_transformer(cfg, torch.Generator().manual_seed(0),
                                     trainable=True)
    host = masters.tree(lambda p: p.detach().clone())
    lm = out["lm"] = {}

    b = lm_common.lm_bundle(cfg, "train_4k", mesh)
    state_sh = b.in_shardings[0]
    params = ParamTree(map2(place, host, state_sh["params"]),
                       requires_grad=True)
    opt = AdamW(lr=1e-4, state_dtype=cfg.opt_state_dtype)
    state = {"params": params, "opt": opt.init(params.tree()),
             "step": torch.zeros((), dtype=torch.int32)}
    lm["train_args_match"] = (shapes(state["opt"]) == shapes(b.args[0]["opt"])
                              and shapes(host) == shapes(b.args[0]["params"]
                                                         .tree()))
    lm["train_opt_layout"] = (layout_ok(state["opt"]["m"], state_sh["opt"]["m"])
                              and layout_ok(state["opt"]["v"],
                                            state_sh["opt"]["v"]))
    state, m = b.fn(state, {"tokens": toks["train"]})
    lm["train_state_layout"] = (
        layout_ok(state["params"].tree(), state_sh["params"])
        and layout_ok(state["opt"]["m"], state_sh["opt"]["m"])
        and layout_ok(state["opt"]["v"], state_sh["opt"]["v"]))
    k = max(1, min(cfg.grad_accum, toks["train"].shape[0] // n_data))
    acfg = dataclasses.replace(cfg, grad_accum=k * n_data)
    one = ParamTree({**host}, requires_grad=True)
    one_state = {"params": one, "opt": opt.init(one.tree()),
                 "step": torch.zeros((), dtype=torch.int32)}
    _, m1 = tf.make_train_step(acfg, opt)(one_state,
                                          {"tokens": toks["train"]})
    lm["train_loss_rel"] = abs(float(m["loss"]) - float(m1["loss"])) \\
        / abs(float(m1["loss"]))
    lm["train_aux_rel"] = abs(float(m["aux_loss"]) - float(m1["aux_loss"])) \\
        / max(abs(float(m1["aux_loss"])), 1e-30)

    with torch.no_grad():
        served1 = ParamTree(tf.compute_dtypes(cfg, host))
        b = lm_common.lm_bundle(cfg, "prefill_32k", mesh)
        p = ParamTree(map2(place, host, b.in_shardings[0]))
        lg, cache = b.fn(p, toks["prefill"])
        lm["prefill_layout"] = (layout_ok(lg, b.out_shardings[0])
                                and port_cache_ok(cache, b.out_shardings[1]))
        s = toks["prefill"].shape[1]
        lm["prefill_rel"] = rel(lg, tf.prefill(cfg, served1, toks["prefill"],
                                               s)[0])

        b = lm_common.lm_bundle(cfg, "decode_32k", mesh)
        p = ParamTree(map2(place, host, b.in_shardings[0]))
        s_max = spec["lm_shapes"]["decode_32k"]["seq"]
        _, cache = tf.prefill(cfg, ParamTree(tf.compute_dtypes(cfg, p.tree())),
                              toks["prompt"], s_max, mesh=mesh, policy=pol)
        lm["decode_cache_in_layout"] = port_cache_ok(cache, b.in_shardings[1])
        pos = toks["prompt"].shape[1]
        lg, cache = b.fn(p, cache, toks["next"], torch.tensor(pos))
        lm["decode_layout"] = (layout_ok(lg, b.out_shardings[0])
                               and port_cache_ok(cache, b.out_shardings[1]))
        _, c1 = tf.prefill(cfg, served1, toks["prompt"], s_max)
        lm["decode_rel"] = rel(lg, tf.decode_step(cfg, served1, c1,
                                                  toks["next"], pos)[0])
""")

DIN = textwrap.dedent("""
    din_cfg.DIN_SHAPES.update(spec["din_shapes"])
    din_cfg.FULL = din_cfg.SMOKE
    dcfg = din_cfg.SMOKE
    reduced = {"n_items": dcfg.n_items, "n_cats": dcfg.n_cats}
    rng = np.random.default_rng(0)
    out["din"] = {}
    for shape, info in spec["din_shapes"].items():
        b = din_cfg._bundle(shape, mesh)
        batch = D.to_device(D.synth_batch(dcfg, info["batch"],
                                          info["n_cands"], rng,
                                          reduced=reduced), "cpu")
        sds = b.args[1]
        r = out["din"][shape] = {
            "args_match": sorted(sds) == sorted(batch) and all(
                tuple(sds[k].shape) == tuple(batch[k].shape)
                and sds[k].dtype == batch[k].dtype for k in sds)}
        params, _ = D.init_din(dcfg, torch.Generator().manual_seed(1))
        params = ParamTree(params.tree(), requires_grad=True)
        if info["kind"] == "train":
            with torch.no_grad():
                want = float(D.loss_fn(dcfg, params, batch))
            state = gnn_common.gnn_train_state(params)
            r["equal"] = float(b.fn(clone_state(state),
                                    batch)[1]["loss"]) == want
            r["mesh_rel"] = steps_agree(b, state, batch)
        else:
            with torch.no_grad():
                r["equal"] = bool(torch.equal(b.fn(params, batch),
                                              D.forward(dcfg, params, batch)))
                r["mesh_rel"] = steps_agree(b, params, batch)
""")

GNN = textwrap.dedent("""
    # -- GNN: the train steps at cut shapes -----------------------------------
    gnn_common.GNN_SHAPES.update(spec["gnn_shapes"])
    out["gnn"] = {}
    rng = np.random.default_rng(2)
    for arch, mod, model, shape in (
            ("gatedgcn", gatedgcn_cfg, GG, "full_graph_sm"),
            ("dimenet", dimenet_cfg, DN, "molecule"),
            ("equiformer", equiformer_v2_cfg, EQ, "molecule")):
        info = spec["gnn_shapes"][shape]
        gcfg = mod._cfg_for(shape)
        b = mod._bundle(shape, mesh)
        n_g = info.get("n_graphs")
        if n_g:
            g = block_diagonal_batch(n_g, info["n_nodes"] // n_g,
                                     info["n_edges"] // n_g, info["d_feat"],
                                     rng, n_classes=1, with_pos=True)
        else:
            g = random_graph(info["n_nodes"], info["n_edges"],
                             info["d_feat"], rng,
                             n_classes=info["n_classes"])
        arrays = {k: getattr(g, k) for k in ("node_feat", "src", "dst",
                                             "positions", "labels",
                                             "label_mask", "graph_id")
                  if getattr(g, k) is not None}
        if n_g:                   # a molecule batch labels every graph
            arrays["label_mask"] = np.ones((n_g,), np.float32)
        if arch == "dimenet":
            tri = DN.build_triplets(g.src, g.dst, gcfg.max_in_per_edge)
            arrays.update(t_kj=tri[0], t_ji=tri[1], t_mask=tri[2])
        batch = {k: torch.from_numpy(np.asarray(v)) for k, v in arrays.items()}
        sds = b.args[1]
        r = out["gnn"][arch] = {
            "args_match": sorted(sds) == sorted(batch) and all(
                tuple(sds[k].shape) == tuple(batch[k].shape) for k in sds)}
        init = getattr(model, "init_" + arch)
        params, _ = init(gcfg, torch.Generator().manual_seed(3))
        gb = GraphBatch(**{k: batch[k] for k in ("node_feat", "src", "dst")},
                        n_nodes=info["n_nodes"],
                        positions=batch.get("positions"),
                        labels=batch["labels"], label_mask=batch["label_mask"],
                        graph_id=batch.get("graph_id"),
                        n_graphs=info.get("n_graphs") or 1)
        with torch.no_grad():
            want = float(model.loss_fn(gcfg, params, gb) if arch != "dimenet"
                         else model.loss_fn(gcfg, params, gb,
                                            tuple(torch.from_numpy(t)
                                                  for t in tri)))
        state = gnn_common.gnn_train_state(ParamTree(params.tree(),
                                                     requires_grad=True))
        r["equal"] = float(b.fn(clone_state(state),
                                batch)[1]["loss"]) == want
        if arch == "equiformer":
            # BASE is bf16, where two orders of the same sums differ by
            # 2^-8: the partitioning is held to 1e-5 by the same bundle and
            # weights in float32
            cfg_for = mod._cfg_for
            mod._cfg_for = lambda sh: dataclasses.replace(
                cfg_for(sh), dtype=torch.float32)
            try:
                b = mod._bundle(shape, mesh)
            finally:
                mod._cfg_for = cfg_for
            params, _ = init(dataclasses.replace(gcfg, dtype=torch.float32),
                             torch.Generator().manual_seed(3))
            state = gnn_common.gnn_train_state(
                ParamTree(params.tree(), requires_grad=True))
        r["mesh_rel"] = steps_agree(b, state, batch)
""")

GRAPHCAST = textwrap.dedent("""
    # -- GraphCast's whole grid at SMOKE ---------------------------------------
    graphcast_cfg.BASE = graphcast_cfg.SMOKE
    gnn_common.GNN_SHAPES.update(spec["gnn_shapes"])
    rng = np.random.default_rng(6)
    b = graphcast_cfg._bundle("full_graph_sm", mesh)
    sds = b.args[1]
    n_grid, n_mesh = sds["grid_feat"].shape[0], sds["mesh_pos"].shape[0]
    ends = {"g2m_src": n_grid, "g2m_dst": n_mesh, "mesh_src": n_mesh,
            "mesh_dst": n_mesh, "m2g_src": n_mesh, "m2g_dst": n_grid}
    batch = {k: (torch.from_numpy(rng.integers(0, ends[k], t.shape)
                                  .astype(np.int32)) if k in ends
                 else torch.from_numpy(rng.normal(size=t.shape)
                                       .astype(np.float32)))
             for k, t in sds.items()}
    params, _ = GC.init_graphcast(graphcast_cfg.SMOKE,
                                  torch.Generator().manual_seed(4))
    state = gnn_common.gnn_train_state(ParamTree(params.tree(),
                                                 requires_grad=True))
    out["graphcast"] = {"mesh_rel": steps_agree(b, state, batch)}
""")

TAIL = textwrap.dedent("""
    if torch.distributed.get_rank() == 0:
        with open(d + "/out.pkl", "wb") as f:
            pickle.dump(out, f)
    close_ranks()
""")

FAMILIES = {"lm": LM, "din": DIN, "gnn": GNN, "graphcast": GRAPHCAST}


def spec() -> dict:
    rng = np.random.default_rng(5)
    vocab = 128                 # qwen2.5-14b's SMOKE vocabulary
    ints = lambda *s: rng.integers(0, vocab, s).astype(np.int32)
    return {
        "lm_shapes": {
            "train_4k": dict(kind="train", seq=16, batch=4),
            "prefill_32k": dict(kind="prefill", seq=PROMPT, batch=2),
            "decode_32k": dict(kind="decode", seq=PROMPT + 6, batch=2)},
        "tokens": {"train": ints(4, 16), "prefill": ints(2, PROMPT),
                   "prompt": ints(2, PROMPT), "next": ints(2, 1)},
        "din_shapes": {
            "train_batch": dict(kind="train", batch=8, n_cands=1),
            "serve_p99": dict(kind="serve", batch=8, n_cands=1),
            "retrieval_cand": dict(kind="serve", batch=1, n_cands=64)},
        "gnn_shapes": {
            "full_graph_sm": dict(n_nodes=64, n_edges=256, d_feat=12,
                                  n_classes=7, task="node"),
            "molecule": dict(n_nodes=40, n_edges=96, d_feat=16, n_classes=1,
                             task="graph", n_graphs=4)},
    }


@pytest.fixture(scope="module")
def family_out():
    """``family_out(name)``: rank 0's ``out`` of family ``name``'s own rank
    launch (run once)."""
    done = {}

    def run(name):
        if name not in done:
            with tempfile.TemporaryDirectory() as d:
                with open(os.path.join(d, "in.pkl"), "wb") as f:
                    pickle.dump(spec(), f)
                launch_ranks(4, ["-c", HEAD + FAMILIES[name] + TAIL, d],
                             timeout=DEADLINE)
                with open(os.path.join(d, "out.pkl"), "rb") as f:
                    done[name] = pickle.load(f)
        return done[name]
    return run


def test_lm_bundle_fns_on_a_mesh(family_out):
    lm = family_out("lm")["lm"]
    for k in ("train_args_match", "train_opt_layout", "train_state_layout",
              "prefill_layout", "decode_cache_in_layout", "decode_layout"):
        assert lm[k], (k, lm)
    for k in ("train_loss_rel", "train_aux_rel", "prefill_rel",
              "decode_rel"):
        assert lm[k] <= RTOL, (k, lm)


def test_din_bundle_fns(family_out):
    for shape, r in family_out("din")["din"].items():
        assert r["args_match"] and r["equal"], (shape, r)
        assert r["mesh_rel"] <= RTOL, (shape, r)


def test_gnn_bundle_fns(family_out):
    for arch, r in family_out("gnn")["gnn"].items():
        assert r["args_match"] and r["equal"], (arch, r)
        assert r["mesh_rel"] <= RTOL, (arch, r)


def test_graphcast_whole_grid_bundle_fn(family_out):
    gc = family_out("graphcast")["graphcast"]
    assert gc["mesh_rel"] <= RTOL, gc
