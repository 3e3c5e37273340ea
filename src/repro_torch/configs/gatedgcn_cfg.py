"""gatedgcn [gnn]: 16L d_hidden=70, gated aggregator [arXiv:2003.00982]."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.common import require_device
from ..models.convert import gnn_from_numpy
from ..models.gnn import gatedgcn as M
from ..models.gnn.common import GraphBatch, random_graph, to_device
from .base import ArchSpec, register
from .gnn_common import (GNN_SHAPES, gnn_flops_info, gnn_train_bundle,
                         gnn_train_step, node_batch_sds, padded_dims)

BASE = M.GatedGCNConfig(n_layers=16, d_hidden=70, remat="full")
SMOKE = M.GatedGCNConfig(n_layers=3, d_hidden=16, d_feat=12, n_classes=4)


def _cfg_for(shape_name: str) -> M.GatedGCNConfig:
    info = GNN_SHAPES[shape_name]
    return dataclasses.replace(
        BASE, d_feat=info["d_feat"], n_classes=max(info["n_classes"], 2),
        task=info["task"])


def train_step(cfg: M.GatedGCNConfig):
    """The single-device train step of the JAX ``_bundle`` at ``cfg``:
    ``step(state, batch)`` with a ``GraphBatch`` of tensors."""
    return gnn_train_step(lambda p, b: M.loss_fn(cfg, p, b))


def _bundle(shape_name: str, mesh, multi_pod=False):
    info = GNN_SHAPES[shape_name]
    cfg = _cfg_for(shape_name)
    n, e = padded_dims(info, mesh)
    params, _ = M.init_gatedgcn(cfg, None)
    n_graphs = info.get("n_graphs")
    sds = node_batch_sds(n, e, info["d_feat"], n_graphs=n_graphs)

    def loss(p, b):
        gb = GraphBatch(node_feat=b["node_feat"], src=b["src"], dst=b["dst"],
                        n_nodes=n, labels=b["labels"],
                        label_mask=b["label_mask"],
                        graph_id=b.get("graph_id"),
                        n_graphs=n_graphs or 1)
        return M.loss_fn(cfg, p, gb)

    row_sharded = {k: True for k in sds}
    if n_graphs:  # per-graph arrays are small — replicate
        row_sharded["labels"] = row_sharded["label_mask"] = False
    return gnn_train_bundle(
        mesh, info, params_abs=params, loss_closure=loss, batch_sds=sds,
        batch_row_sharded=row_sharded,
        description=f"gatedgcn {shape_name} N={n} E={e}")


def _smoke(device="cuda", weights=None):
    """The JAX ``_smoke``; ``weights`` (the JAX parameter tree as numpy
    arrays) replaces the seeded draw."""
    device = require_device(device)
    rng = np.random.default_rng(0)
    params = (M.init_gatedgcn(SMOKE,
                              torch.Generator(device).manual_seed(0))[0]
              if weights is None else gnn_from_numpy(SMOKE, weights, device))
    g = to_device(random_graph(40, 160, SMOKE.d_feat, rng,
                               n_classes=SMOKE.n_classes), device)
    loss = M.loss_fn(SMOKE, params, g)
    loss.backward()
    assert np.isfinite(loss.item())
    assert all(bool(torch.isfinite(p.grad).all())
               for p in params.parameters())
    with torch.no_grad():
        out = M.forward(SMOKE, params, g)
    assert out.shape == (40, SMOKE.n_classes)
    return {"loss": loss.item()}


def _flops(shape_name: str) -> dict:
    cfg = _cfg_for(shape_name)
    d, L = cfg.d_hidden, cfg.n_layers
    per_node = 2 * L * 2 * d * d          # U,h@A per node-ish
    per_edge = 2 * L * 3 * d * d          # A,B,C,V gathers/matmuls
    return gnn_flops_info(shape_name, per_node, per_edge,
                          cfg.num_params(), scan_factor=cfg.n_layers)


register(ArchSpec(
    name="gatedgcn", family="gnn", shape_names=tuple(GNN_SHAPES),
    smoke=_smoke, bundle=_bundle, flops_info=_flops,
    notes="SpMM/SDDMM regime on segment ops; minibatch_lg consumes the "
          "fanout-15·10 sampled subgraph from data.sampler.",
))
