"""din [recsys]: embed_dim=18 seq_len=100 attn_mlp=80-40 mlp=200-80
target-attention [arXiv:1706.06978]."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..dist.sharding import ShardingPolicy, named_sharding
from ..models import din as M
from ..models.common import ParamTree, require_device
from ..models.convert import din_from_numpy
from .base import ArchSpec, Bundle, register
from ..tree import tree_map
from .gnn_common import (dtensor_step, gnn_train_step, merge_axes,
                         on_merged, train_state_abstract)

FULL = M.DINConfig()
SMOKE = dataclasses.replace(FULL, n_items=1000, n_cats=50)

DIN_SHAPES = {
    "train_batch": dict(kind="train", batch=65536, n_cands=1),
    "serve_p99": dict(kind="serve", batch=512, n_cands=1),
    "serve_bulk": dict(kind="serve", batch=262144, n_cands=1),
    "retrieval_cand": dict(kind="serve", batch=1, n_cands=1_000_000),
}


def _batch_sds(cfg, B, C):
    """A batch's meta tensors (``M.synth_batch``'s keys and dtypes)."""
    t = cfg.seq_len

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    return {
        "hist_items": meta((B, t), torch.int32),
        "hist_cats": meta((B, t), torch.int32),
        "hist_mask": meta((B, t), torch.float32),
        "cand_item": meta((B, C), torch.int32),
        "cand_cat": meta((B, C), torch.int32),
        "labels": meta((B, C), torch.float32),
    }


def train_step(cfg: M.DINConfig):
    """The JAX bundle's DIN train step: ``step(state, batch) -> (state,
    {"loss"})`` on a state ``{"params": trainable ParamTree, "opt",
    "step"}`` and a batch of tensors; the loss's gradients by autograd,
    then one ``AdamW(lr=1e-3, weight_decay=0.0)`` update in place (the
    GNN bundles' step, ``gnn_common.gnn_train_step``)."""
    return gnn_train_step(lambda p, b: M.loss_fn(cfg, p, b))


def _bundle(shape_name: str, mesh, multi_pod=False):
    info = DIN_SHAPES[shape_name]
    cfg = FULL
    B, C = info["batch"], info["n_cands"]
    policy = ShardingPolicy(mesh_axes=tuple(mesh.mesh_dim_names),
                            fsdp=False)
    params, logical = M.init_din(cfg, None)
    pshard = policy.shardings_for_tree(mesh, logical, params.tree())
    repl = named_sharding(mesh)
    # retrieval: shard the CANDIDATE axis (B=1); otherwise the batch axis
    if B == 1:
        rows = named_sharding(mesh, None, policy.data_axes)
        row0 = repl
    else:
        rows = named_sharding(mesh, policy.data_axes)
        row0 = rows
    sds = _batch_sds(cfg, B, C)
    bshard = {k: (rows if k.startswith(("cand", "labels")) else row0)
              for k in sds}
    # the port runs the step with the data axes merged into one ("rows")
    n = len(policy.data_axes)
    merged = merge_axes(mesh, n)

    def run(shardings):
        return tree_map(lambda s: on_merged(s, merged, n), shardings)

    if info["kind"] == "train":
        params = ParamTree(params.tree(), requires_grad=True)
        state = train_state_abstract(params)
        state_shard = {"params": pshard,
                       "opt": {"m": pshard, "v": pshard, "count": repl},
                       "step": repl}
        return Bundle(fn=dtensor_step(train_step(cfg)), args=(state, sds),
                      in_shardings=(state_shard, bshard), donate=(0,),
                      description=f"din train B={B}",
                      run_shardings=run((state_shard, bshard)))

    def serve_step(p, b):
        return M.forward(cfg, p, b)
    return Bundle(fn=dtensor_step(serve_step), args=(params, sds),
                  in_shardings=(pshard, bshard),
                  description=f"din serve B={B} C={C}",
                  run_shardings=run((pshard, bshard)))


def _smoke(device="cuda", weights=None):
    """The JAX ``_smoke``: a batch of 8 scored, one loss and its gradients
    finite, then a 4,096-candidate retrieval. ``weights`` (the JAX
    parameter tree as numpy arrays) replaces the seeded draw."""
    device = require_device(device)
    rng = np.random.default_rng(0)
    if weights is None:
        params, _ = M.init_din(SMOKE, torch.Generator(device).manual_seed(0))
        params = ParamTree(params.tree(), requires_grad=True)
    else:
        params = ParamTree(din_from_numpy(SMOKE, weights, device).tree(),
                           requires_grad=True)
    reduced = {"n_items": SMOKE.n_items, "n_cats": SMOKE.n_cats}
    b = M.to_device(M.synth_batch(SMOKE, 8, 1, rng, reduced=reduced),
                    device)
    with torch.no_grad():
        out = M.forward(SMOKE, params, b)
    assert out.shape == (8, 1) and not bool(torch.isnan(out).any())
    loss = M.loss_fn(SMOKE, params, b)
    loss.backward()
    assert np.isfinite(loss.item())
    assert all(bool(torch.isfinite(p.grad).all())
               for p in params.parameters())
    # retrieval path: 1 user × many candidates in one product
    br = M.to_device(M.synth_batch(SMOKE, 1, 4096, rng, reduced=reduced),
                     device)
    with torch.no_grad():
        outr = M.forward(SMOKE, params, br)
    assert outr.shape == (1, 4096)
    return {"loss": loss.item()}


def _flops(shape_name: str) -> dict:
    info = DIN_SHAPES[shape_name]
    cfg = FULL
    B, C, T = info["batch"], info["n_cands"], cfg.seq_len
    d = cfg.d_item
    attn = B * C * T * (4 * d * 80 + 80 * 40 + 40) * 2
    final = B * C * (3 * d * 200 + 200 * 80 + 80) * 2
    fwd = attn + final
    mf = 3 * fwd if info["kind"] == "train" else fwd
    return {"n_params": cfg.num_params(), "n_active": cfg.num_params(),
            "tokens": B * C, "model_flops": mf, "kind": info["kind"],
            "scan_factor": 1}


register(ArchSpec(
    name="din", family="recsys", shape_names=tuple(DIN_SHAPES),
    smoke=_smoke, bundle=_bundle, flops_info=_flops,
    notes="10M-row item table model-axis-sharded ('table_rows'); "
          "EmbeddingBag = take + segment pooling; retrieval_cand shards "
          "the 10⁶-candidate axis over the data axes.",
))
