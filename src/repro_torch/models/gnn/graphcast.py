"""GraphCast-style encoder–processor–decoder mesh GNN (arXiv:2212.12794),
the port's counterpart of ``repro.models.gnn.graphcast``.

Three bipartite/homogeneous interaction-network stages:
* encoder: grid→mesh edges lift n_vars grid features onto mesh nodes
* processor: 16 interaction-net layers on (multi-)mesh edges
  (edge update MLP([e, h_src, h_dst]) → node update MLP([h, Σ_in e]))
* decoder: mesh→grid edges produce per-grid-node n_vars outputs

The generic graph shapes parameterize the *grid*; mesh size is derived as
``max(n_grid // 16, 42)`` (≈ icosahedral refinement-6's 40,962 nodes for the
0.25° grid in the paper). Edges carry 4-d features (displacement + length).
The processor's weights keep the JAX tree's stacks (``proc_edge``,
``proc_node``: MLPs whose weights lead with L).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ...dist.sharding import split_params
from ..common import ParamTree
from .common import init_mlp, layer_of, mlp, remat, scatter_sum


@dataclasses.dataclass(frozen=True)
class GraphCastConfig:
    name: str = "graphcast"
    n_layers: int = 16
    d_hidden: int = 512
    n_vars: int = 227
    d_edge: int = 4
    mesh_ratio: int = 16          # n_mesh = max(n_grid // ratio, 42)
    dtype: Any = torch.float32
    remat: str = "none"

    def n_mesh(self, n_grid: int) -> int:
        return max(n_grid // self.mesh_ratio, 42)

    def num_params(self) -> int:
        model, _ = init_graphcast(self, None)
        return sum(p.numel() for p in model.parameters())


def init_graphcast(cfg: GraphCastConfig, rng):
    """Returns (model, logical): trainable weights drawn from ``rng`` (a
    ``torch.Generator``) on its device, or shapes on the meta device."""
    d, L = cfg.d_hidden, cfg.n_layers
    tree = {
        "grid_embed": init_mlp(rng, (cfg.n_vars, d, d), dtype=cfg.dtype),
        "mesh_embed": init_mlp(rng, (3, d, d), dtype=cfg.dtype),
        "e_g2m": init_mlp(rng, (cfg.d_edge + 2 * d, d, d), dtype=cfg.dtype),
        "proc_edge": init_mlp(rng, (3 * d, d, d), dtype=cfg.dtype,
                              lead=(L,), lead_logical=(None,)),
        "proc_node": init_mlp(rng, (2 * d, d, d), dtype=cfg.dtype,
                              lead=(L,), lead_logical=(None,)),
        "e_m2g": init_mlp(rng, (cfg.d_edge + 2 * d, d, d), dtype=cfg.dtype),
        "decode": init_mlp(rng, (2 * d, d, cfg.n_vars), dtype=cfg.dtype),
    }
    params, logical = split_params(tree)
    return ParamTree(params, requires_grad=True), logical


@dataclasses.dataclass
class GraphCastBatch:
    """grid_feat (G, n_vars); mesh_pos (M, 3); three edge sets with 4-d
    feats; target (G, n_vars) for the training loss."""
    grid_feat: Any
    mesh_pos: Any
    g2m_src: Any; g2m_dst: Any; g2m_feat: Any
    mesh_src: Any; mesh_dst: Any; mesh_feat_unused: Any
    m2g_src: Any; m2g_dst: Any; m2g_feat: Any
    n_grid: int
    n_mesh: int
    target: Any | None = None


def synth_batch(cfg: GraphCastConfig, n_grid: int, n_mesh_edges: int,
                rng: np.random.Generator) -> GraphCastBatch:
    """A batch of numpy arrays: the JAX package's arrays from the same
    generator (``to_device`` of ``models.gnn.common`` moves it)."""
    n_mesh = cfg.n_mesh(n_grid)
    ng2m = n_grid            # one edge per grid node (nearest mesh node)
    nm2g = n_grid
    f32 = np.float32
    return GraphCastBatch(
        grid_feat=rng.normal(size=(n_grid, cfg.n_vars)).astype(f32),
        mesh_pos=rng.normal(size=(n_mesh, 3)).astype(f32),
        g2m_src=rng.integers(0, n_grid, ng2m).astype(np.int32),
        g2m_dst=rng.integers(0, n_mesh, ng2m).astype(np.int32),
        g2m_feat=rng.normal(size=(ng2m, cfg.d_edge)).astype(f32),
        mesh_src=rng.integers(0, n_mesh, n_mesh_edges).astype(np.int32),
        mesh_dst=rng.integers(0, n_mesh, n_mesh_edges).astype(np.int32),
        mesh_feat_unused=np.zeros((1,), f32),
        m2g_src=rng.integers(0, n_mesh, nm2g).astype(np.int32),
        m2g_dst=rng.integers(0, n_grid, nm2g).astype(np.int32),
        m2g_feat=rng.normal(size=(nm2g, cfg.d_edge)).astype(f32),
        n_grid=n_grid, n_mesh=n_mesh,
        target=rng.normal(size=(n_grid, cfg.n_vars)).astype(f32))


def forward(cfg: GraphCastConfig, params, b: GraphCastBatch):
    dt = cfg.dtype
    hg = mlp(params["grid_embed"], b.grid_feat.to(dt))
    hm = mlp(params["mesh_embed"], b.mesh_pos.to(dt))

    # encoder: grid → mesh
    e_in = torch.cat([b.g2m_feat.to(dt), hg[b.g2m_src], hm[b.g2m_dst]],
                     dim=-1)
    e = mlp(params["e_g2m"], e_in)
    hm = hm + scatter_sum(e, b.g2m_dst, b.n_mesh)

    # processor: interaction nets on mesh edges (edge state carried)
    em = hm.new_zeros((b.mesh_src.shape[0], cfg.d_hidden))

    def layer(hm, em, edge_mlp, node_mlp):
        e_in = torch.cat([em, hm[b.mesh_src], hm[b.mesh_dst]], dim=-1)
        em2 = em + mlp(edge_mlp, e_in)
        agg = scatter_sum(em2, b.mesh_dst, b.n_mesh)
        hm2 = hm + mlp(node_mlp, torch.cat([hm, agg], dim=-1))
        return hm2, em2

    fn = remat(cfg.remat, layer)
    for i in range(cfg.n_layers):
        hm, em = fn(hm, em, layer_of(params["proc_edge"], i),
                    layer_of(params["proc_node"], i))

    # decoder: mesh → grid
    e_in = torch.cat([b.m2g_feat.to(dt), hm[b.m2g_src], hg[b.m2g_dst]],
                     dim=-1)
    e = mlp(params["e_m2g"], e_in)
    agg = scatter_sum(e, b.m2g_dst, b.n_grid)
    return mlp(params["decode"], torch.cat([hg, agg], dim=-1))  # (G, n_vars)


def loss_fn(cfg: GraphCastConfig, params, b: GraphCastBatch):
    pred = forward(cfg, params, b).float()
    return torch.mean((pred - b.target.float()) ** 2)
