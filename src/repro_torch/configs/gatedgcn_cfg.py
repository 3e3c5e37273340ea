"""gatedgcn [gnn]: 16L d_hidden=70, gated aggregator [arXiv:2003.00982]."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.common import require_device
from ..models.gnn import gatedgcn as M
from ..models.gnn.common import random_graph, to_device
from .gnn_common import GNN_SHAPES, gnn_flops_info, gnn_train_step

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


def _smoke(device="cuda"):
    device = require_device(device)
    rng = np.random.default_rng(0)
    params, _ = M.init_gatedgcn(SMOKE,
                                torch.Generator(device).manual_seed(0))
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
