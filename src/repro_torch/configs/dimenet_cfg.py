"""dimenet [gnn]: 6 blocks d_hidden=128 n_bilinear=8 n_spherical=7
n_radial=6 [arXiv:2003.03123]."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.common import require_device
from ..models.gnn import dimenet as M
from ..models.gnn.common import GraphBatch, block_diagonal_batch, to_device
from .gnn_common import (GNN_SHAPES, gnn_flops_info, gnn_partitioned_step,
                         gnn_train_step)

BASE = M.DimeNetConfig(n_blocks=6, d_hidden=128, n_bilinear=8,
                       n_spherical=7, n_radial=6, remat="full")
SMOKE = dataclasses.replace(BASE, n_blocks=2, d_hidden=32, d_feat=8,
                            max_in_per_edge=3, remat="none")

# triplet caps per shape: exact-ish for molecules, capped on power-law webs
TRIPLET_CAP = {"molecule": 4, "full_graph_sm": 4, "minibatch_lg": 2,
               "ogb_products": 2}


def _cfg_for(shape_name: str) -> M.DimeNetConfig:
    info = GNN_SHAPES[shape_name]
    return dataclasses.replace(
        BASE, d_feat=info["d_feat"],
        n_classes=info["n_classes"] if info["task"] == "node" else 1,
        task=info["task"], max_in_per_edge=TRIPLET_CAP[shape_name])


def train_step(cfg: M.DimeNetConfig):
    """The single-device train step of the JAX ``_bundle`` at ``cfg``:
    ``step(state, (graph, triplets))`` with a ``GraphBatch`` of tensors and
    ``build_triplets``' arrays as tensors (``M.triplets_to_device``)."""
    return gnn_train_step(lambda p, b: M.loss_fn(cfg, p, b[0], b[1]))


def local_loss(cfg: M.DimeNetConfig):
    """The loss of one partition's block of rows (the JAX ``_bundle``'s
    ``local_loss``): ``node_feat``, ``positions``, ``labels`` and
    ``label_mask`` a row a node, ``src``/``dst`` a row an edge, ``t_kj``,
    ``t_ji`` and ``t_mask`` a row a triplet slot, indices local."""
    def loss(p, b):
        gb = GraphBatch(node_feat=b["node_feat"], src=b["src"],
                        dst=b["dst"], n_nodes=b["node_feat"].shape[0],
                        positions=b["positions"], labels=b["labels"],
                        label_mask=b["label_mask"])
        return M.loss_fn(cfg, p, gb, (b["t_kj"], b["t_ji"], b["t_mask"]))
    return loss


def partitioned_train_step(cfg: M.DimeNetConfig, mesh):
    """The partition-parallel (cd-0) train step of the JAX ``_bundle`` on
    ``mesh``: ``step(state, batch)`` with ``batch`` a dict of the whole
    graph's tensors laid out in partition blocks
    (``gnn_common.gnn_partitioned_step``)."""
    return gnn_partitioned_step(local_loss(cfg), mesh)


def _smoke(device="cuda"):
    device = require_device(device)
    rng = np.random.default_rng(1)
    params, _ = M.init_dimenet(SMOKE, torch.Generator(device).manual_seed(0))
    b = block_diagonal_batch(4, 10, 24, SMOKE.d_feat, rng, n_classes=1,
                             with_pos=True)
    tri = M.triplets_to_device(
        M.build_triplets(b.src, b.dst, SMOKE.max_in_per_edge), device)
    b = to_device(b, device)
    loss = M.loss_fn(SMOKE, params, b, tri)
    loss.backward()
    assert np.isfinite(loss.item())
    assert all(bool(torch.isfinite(p.grad).all())
               for p in params.parameters())
    with torch.no_grad():
        out = M.forward(SMOKE, params, b, tri)
    assert out.shape == (4, 1)
    return {"loss": loss.item()}


def _flops(shape_name: str) -> dict:
    cfg = _cfg_for(shape_name)
    d, nb = cfg.d_hidden, cfg.n_blocks
    cap = cfg.max_in_per_edge
    per_edge = 2 * nb * (4 * d * d + cap * (d * d + cfg.n_bilinear * d))
    per_node = 2 * nb * d * d
    return gnn_flops_info(shape_name, per_node, per_edge,
                          cfg.num_params(), scan_factor=cfg.n_blocks)
