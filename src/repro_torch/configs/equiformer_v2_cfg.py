"""equiformer-v2 [gnn]: 12L d_hidden=128 l_max=6 m_max=2 n_heads=8,
SO(2)-eSCN equivariant graph attention [arXiv:2306.12059]."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.common import require_device
from ..models.gnn import equiformer_v2 as M
from ..models.gnn.common import GraphBatch, block_diagonal_batch, to_device
from .gnn_common import (GNN_SHAPES, gnn_flops_info, gnn_partitioned_step,
                         gnn_train_step)

BASE = M.EquiformerV2Config(n_layers=12, d_hidden=128, l_max=6, m_max=2,
                            n_heads=8, remat="full", dtype=torch.bfloat16)
SMOKE = dataclasses.replace(BASE, n_layers=2, d_hidden=16, l_max=3,
                            n_heads=2, d_feat=8, remat="none",
                            dtype=torch.float32)


EDGE_CHUNKS = {"ogb_products": 32, "minibatch_lg": 4}


def _cfg_for(shape_name: str) -> M.EquiformerV2Config:
    info = GNN_SHAPES[shape_name]
    return dataclasses.replace(
        BASE, d_feat=info["d_feat"],
        n_classes=info["n_classes"] if info["task"] == "node" else 1,
        task=info["task"], edge_chunks=EDGE_CHUNKS.get(shape_name, 1))


def train_step(cfg: M.EquiformerV2Config):
    """The single-device train step of the JAX ``_bundle`` at ``cfg``:
    ``step(state, batch)`` with a ``GraphBatch`` of tensors."""
    return gnn_train_step(lambda p, b: M.loss_fn(cfg, p, b))


def local_loss(cfg: M.EquiformerV2Config):
    """The loss of one partition's block of rows (the JAX ``_bundle``'s
    ``local_loss``): ``node_feat``, ``positions``, ``labels`` and
    ``label_mask`` a row a node, ``src``/``dst`` a row an edge, indices
    local."""
    def loss(p, b):
        gb = GraphBatch(node_feat=b["node_feat"], src=b["src"],
                        dst=b["dst"], n_nodes=b["node_feat"].shape[0],
                        positions=b["positions"], labels=b["labels"],
                        label_mask=b["label_mask"])
        return M.loss_fn(cfg, p, gb)
    return loss


def partitioned_train_step(cfg: M.EquiformerV2Config, mesh):
    """The partition-parallel (cd-0) train step of the JAX ``_bundle`` on
    ``mesh`` (its branch for minibatch_lg and ogb_products, with
    ``cfg.edge_chunks`` two-pass edge chunks a partition):
    ``step(state, batch)`` with ``batch`` a dict of the whole graph's
    tensors laid out in partition blocks, the edge rows a multiple of
    the ranks times ``cfg.edge_chunks``
    (``gnn_common.gnn_partitioned_step``)."""
    return gnn_partitioned_step(local_loss(cfg), mesh)


def _smoke(device="cuda"):
    device = require_device(device)
    rng = np.random.default_rng(3)
    params, _ = M.init_equiformer(SMOKE,
                                  torch.Generator(device).manual_seed(0))
    b = block_diagonal_batch(3, 8, 20, SMOKE.d_feat, rng, n_classes=1,
                             with_pos=True)
    with torch.no_grad():
        out = M.forward(SMOKE, params, to_device(b, device))
    assert out.shape == (3, 1) and not bool(torch.isnan(out).any())
    # equivariance property is part of the smoke contract for this arch
    A = rng.normal(size=(3, 3))
    Q, _ = np.linalg.qr(A)
    Q = Q * np.sign(np.linalg.det(Q))
    b2 = dataclasses.replace(
        b, positions=(b.positions @ Q.T).astype(np.float32))
    with torch.no_grad():
        out2 = M.forward(SMOKE, params, to_device(b2, device))
    rel = float((out - out2).abs().max() / (out.abs().max() + 1e-9))
    assert rel < 2e-3, f"equivariance broken: {rel}"
    loss = M.loss_fn(SMOKE, params, to_device(b, device))
    loss.backward()
    assert np.isfinite(loss.item())
    assert all(bool(torch.isfinite(p.grad).all())
               for p in params.parameters())
    return {"loss": loss.item(), "equivariance_rel_err": rel}


def _flops(shape_name: str) -> dict:
    cfg = _cfg_for(shape_name)
    C, L = cfg.d_hidden, cfg.n_layers
    # per edge: rotation (2 × K-block matvec × C) + SO(2) conv channel mixes
    rot = 2 * sum((2 * l + 1) ** 2 for l in range(cfg.l_max + 1)) * 2 * C
    so2 = sum(2 * (cfg.l_max - m + 1) * (2 * C) * C * (1 if m == 0 else 4)
              for m in range(cfg.m_max + 1))
    per_edge = 2 * L * (rot + so2)
    per_node = 2 * L * (cfg.l_max + 1) * C * C
    return gnn_flops_info(
        shape_name, per_node, per_edge, cfg.num_params(),
        scan_factor=cfg.n_layers * max(cfg.edge_chunks, 1))
