"""The dry-run bundles' steps run (``Bundle.fn`` of the LM, DIN and GNN
families; the paper's is run in ``tests/test_torch_dryrun.py``).

The dry-run builds every cell at its production size and calls no
``fn``. Here each family's bundle is built from the registry's own code
at a small size on a (data 2, model 2) ``make_host_mesh`` of four gloo
ranks (``launch_ranks``): the LM shapes of ``lm_common.LM_SHAPES`` cut
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
* the DIN and GNN steps run on one device (the JAX bundles' layout is
  what the dry-run records): the bundle's ``args`` must have the keys
  and shapes of the family's own batch, and its ``fn`` must give the
  model's own loss (train) or scores (serve) on it, exactly.
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

RANK = textwrap.dedent("""
    import dataclasses, pickle, sys
    import numpy as np
    import torch
    from torch.distributed.tensor import Shard, distribute_tensor
    from repro_torch.configs import (dimenet_cfg, din_cfg, equiformer_v2_cfg,
                                     gatedgcn_cfg, gnn_common, lm_common,
                                     qwen2_5_14b)
    from repro_torch.dist.collectives import full_tensor
    from repro_torch.launch.mesh import close_ranks, make_host_mesh
    from repro_torch.models import din as D
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import ParamTree
    from repro_torch.models.gnn import dimenet as DN
    from repro_torch.models.gnn import equiformer_v2 as EQ
    from repro_torch.models.gnn import gatedgcn as GG
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

    def rel(got, want):
        got, want = full_tensor(got).float(), want.float()
        return float((got - want).abs().max()
                     / (want.abs().max() + 1e-30))

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

    # -- DIN: SMOKE at the cut shapes (one device) ----------------------------
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
            r["equal"] = float(b.fn(state, batch)[1]["loss"]) == want
        else:
            with torch.no_grad():
                r["equal"] = bool(torch.equal(b.fn(params, batch),
                                              D.forward(dcfg, params, batch)))

    # -- GNN: the train steps at cut shapes (one device) ----------------------
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
        r["equal"] = float(b.fn(state, batch)[1]["loss"]) == want

    if torch.distributed.get_rank() == 0:
        with open(d + "/out.pkl", "wb") as f:
            pickle.dump(out, f)
    close_ranks()
""")


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
def ranks_out():
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "in.pkl"), "wb") as f:
            pickle.dump(spec(), f)
        launch_ranks(4, ["-c", RANK, d], timeout=DEADLINE)
        with open(os.path.join(d, "out.pkl"), "rb") as f:
            return pickle.load(f)


def test_lm_bundle_fns_on_a_mesh(ranks_out):
    lm = ranks_out["lm"]
    for k in ("train_args_match", "train_opt_layout", "train_state_layout",
              "prefill_layout", "decode_cache_in_layout", "decode_layout"):
        assert lm[k], (k, lm)
    for k in ("train_loss_rel", "train_aux_rel", "prefill_rel",
              "decode_rel"):
        assert lm[k] <= RTOL, (k, lm)


def test_din_bundle_fns(ranks_out):
    for shape, r in ranks_out["din"].items():
        assert r == {"args_match": True, "equal": True}, (shape, r)


def test_gnn_bundle_fns(ranks_out):
    for arch, r in ranks_out["gnn"].items():
        assert r == {"args_match": True, "equal": True}, (arch, r)
