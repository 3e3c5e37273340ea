"""GatedGCN (Bresson & Laurent, arXiv:1711.07553; config per arXiv:2003.00982),
the port's counterpart of ``repro.models.gnn.gatedgcn``.

Layer (residual, with edge-feature updates):
    e_ij' = A h_i + B h_j + C e_ij
    η_ij  = σ(e_ij') / (Σ_{j'} σ(e_ij'}) + ε)          (edge gates)
    h_i'  = h_i + ReLU(LN(U h_i + Σ_j η_ij ⊙ V h_j))
    e_ij  = e_ij + ReLU(LN(e_ij'))

Message passing = gather(src) → elementwise gate → ``index_add_``(dst).
The weights keep the JAX tree's layer stacks (``layers/*`` lead with L);
the layers run in a Python loop over views of them.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ...dist.sharding import split_params
from ..common import ParamTree, normal
from .common import GraphBatch, label_nll, layer_of, remat, scatter_sum


@dataclasses.dataclass(frozen=True)
class GatedGCNConfig:
    name: str = "gatedgcn"
    n_layers: int = 16
    d_hidden: int = 70
    d_feat: int = 1433
    d_edge_in: int = 0          # 0 → edge feats initialized from constants
    n_classes: int = 8
    task: str = "node"          # 'node' | 'graph'
    dtype: Any = torch.float32
    remat: str = "none"

    def num_params(self) -> int:
        model, _ = init_gatedgcn(self, None)
        return sum(p.numel() for p in model.parameters())


def _lin(rng, shape, logical, dtype):
    return (normal(rng, shape, 1.0 / np.sqrt(shape[-2]), dtype), logical)


def init_gatedgcn(cfg: GatedGCNConfig, rng):
    """Returns (model, logical): trainable weights drawn from ``rng`` (a
    ``torch.Generator``) on its device, or shapes on the meta device."""
    d = cfg.d_hidden
    L = cfg.n_layers
    dt = cfg.dtype

    def zeros(shape, logical):
        if rng is None:
            return (torch.empty(shape, dtype=dt, device="meta"), logical)
        return (torch.zeros(shape, dtype=dt, device=rng.device), logical)

    tree = {
        "embed": _lin(rng, (cfg.d_feat, d), (None, None), dt),
        "edge_embed": _lin(rng, (max(cfg.d_edge_in, 1), d), (None, None),
                           dt),
        "layers": {
            "A": _lin(rng, (L, d, d), (None, None, None), dt),
            "B": _lin(rng, (L, d, d), (None, None, None), dt),
            "C": _lin(rng, (L, d, d), (None, None, None), dt),
            "U": _lin(rng, (L, d, d), (None, None, None), dt),
            "V": _lin(rng, (L, d, d), (None, None, None), dt),
            "ln_h": zeros((L, d), (None, None)),
            "ln_e": zeros((L, d), (None, None)),
        },
        "head": _lin(rng, (d, cfg.n_classes), (None, None), dt),
    }
    params, logical = split_params(tree)
    return ParamTree(params, requires_grad=True), logical


def _ln(x, w, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * (1.0 + w)


def forward(cfg: GatedGCNConfig, params, batch: GraphBatch):
    dt = cfg.dtype
    h = batch.node_feat.to(dt) @ params["embed"]
    if batch.edge_feat is not None:
        e = batch.edge_feat.to(dt) @ params["edge_embed"]
    else:
        e = h.new_ones((batch.src.shape[0], 1)) @ params["edge_embed"]
    src, dst, n = batch.src, batch.dst, batch.n_nodes

    def layer(h, e, lp):
        hi, hj = h[dst], h[src]
        e_new = hi @ lp["A"] + hj @ lp["B"] + e @ lp["C"]
        gate = torch.sigmoid(e_new)
        msg = gate * (hj @ lp["V"])
        agg = scatter_sum(msg, dst, n) / (scatter_sum(gate, dst, n) + 1e-6)
        h_new = h + F.relu(_ln(h @ lp["U"] + agg, lp["ln_h"]))
        e_out = e + F.relu(_ln(e_new, lp["ln_e"]))
        return h_new, e_out

    fn = remat(cfg.remat, layer)
    for i in range(cfg.n_layers):
        h, e = fn(h, e, layer_of(params["layers"], i))

    if cfg.task == "graph":
        pooled = scatter_sum(h, batch.graph_id, batch.n_graphs)
        cnt = scatter_sum(h.new_ones((n,)), batch.graph_id, batch.n_graphs)
        pooled = pooled / torch.clamp(cnt, min=1.0)[:, None]
        return pooled @ params["head"]
    return h @ params["head"]


def loss_fn(cfg: GatedGCNConfig, params, batch: GraphBatch):
    logits = forward(cfg, params, batch).float()
    nll = label_nll(logits, batch.labels)
    if batch.label_mask is not None and cfg.task == "node":
        m = batch.label_mask
        return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
    return nll.mean()
