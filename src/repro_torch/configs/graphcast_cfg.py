"""graphcast [gnn]: 16L d_hidden=512 mesh_refinement=6 n_vars=227,
encoder-processor-decoder mesh GNN [arXiv:2212.12794]."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..dist.sharding import named_sharding
from ..models.common import require_device
from ..models.convert import gnn_from_numpy
from ..models.gnn import graphcast as M
from ..models.gnn.common import to_device
from .base import ArchSpec, Bundle, pad_to, register
from .gnn_common import (GNN_SHAPES, dtensor_step, gnn_flops_info,
                         gnn_partitioned_bundle, gnn_partitioned_step,
                         gnn_policy, gnn_train_step, rows_merged,
                         replicated_state_shardings, train_state_abstract)

BASE = M.GraphCastConfig(n_layers=16, d_hidden=512, n_vars=227,
                         remat="full", dtype=torch.bfloat16)
SMOKE = dataclasses.replace(BASE, n_layers=3, d_hidden=32, n_vars=11,
                            remat="none", dtype=torch.float32)


def train_step(cfg: M.GraphCastConfig):
    """The single-device train step of the JAX ``_bundle`` at ``cfg``:
    ``step(state, batch)`` with a ``GraphCastBatch`` of tensors. The JAX
    bundle trains ``BASE`` on every shape: the shape's nodes are the grid,
    its edges the processor's mesh edges."""
    return gnn_train_step(lambda p, b: M.loss_fn(cfg, p, b))


def local_loss(cfg: M.GraphCastConfig):
    """The loss of one partition's block of rows (the JAX ``_bundle``'s
    ``local_loss``): ``grid_feat``, ``target`` and the g2m and m2g edges
    (one a grid node) a row a grid node, ``mesh_pos`` a row a mesh node,
    ``mesh_src``/``mesh_dst`` a row a mesh edge, indices local."""
    def loss(p, b):
        gb = M.GraphCastBatch(
            grid_feat=b["grid_feat"], mesh_pos=b["mesh_pos"],
            g2m_src=b["g2m_src"], g2m_dst=b["g2m_dst"],
            g2m_feat=b["g2m_feat"], mesh_src=b["mesh_src"],
            mesh_dst=b["mesh_dst"], mesh_feat_unused=None,
            m2g_src=b["m2g_src"], m2g_dst=b["m2g_dst"],
            m2g_feat=b["m2g_feat"], n_grid=b["grid_feat"].shape[0],
            n_mesh=b["mesh_pos"].shape[0], target=b["target"])
        return M.loss_fn(cfg, p, gb)
    return loss


def partitioned_train_step(cfg: M.GraphCastConfig, mesh):
    """The partition-parallel (cd-0) train step of the JAX ``_bundle`` on
    ``mesh``: ``step(state, batch)`` with ``batch`` a dict of the whole
    graph's tensors laid out in partition blocks
    (``gnn_common.gnn_partitioned_step``)."""
    return gnn_partitioned_step(local_loss(cfg), mesh)


def _bundle(shape_name: str, mesh, multi_pod=False):
    info = GNN_SHAPES[shape_name]
    cfg = BASE
    m = mesh.size()
    n_grid = pad_to(info["n_nodes"], m)
    n_mesh = pad_to(cfg.n_mesh(n_grid), m)
    n_me = pad_to(info["n_edges"], m)      # shape's edges = processor edges
    f32, i32 = torch.float32, torch.int32

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    sds = {
        "grid_feat": meta((n_grid, cfg.n_vars), f32),
        "mesh_pos": meta((n_mesh, 3), f32),
        "g2m_src": meta((n_grid,), i32),
        "g2m_dst": meta((n_grid,), i32),
        "g2m_feat": meta((n_grid, cfg.d_edge), f32),
        "mesh_src": meta((n_me,), i32),
        "mesh_dst": meta((n_me,), i32),
        "m2g_src": meta((n_grid,), i32),
        "m2g_dst": meta((n_grid,), i32),
        "m2g_feat": meta((n_grid, cfg.d_edge), f32),
        "target": meta((n_grid, cfg.n_vars), f32),
    }
    params, _ = M.init_graphcast(cfg, None)
    description = (f"graphcast {shape_name} grid={n_grid} mesh={n_mesh} "
                   f"mesh_edges={n_me}")
    if shape_name == "ogb_products":
        # 61.9M-edge processor state cannot replicate — partition-parallel
        return gnn_partitioned_bundle(
            mesh, info, params_abs=params, local_loss=local_loss(cfg),
            batch_sds=sds, description=description)
    rows = named_sharding(mesh, gnn_policy(mesh).data_axes)
    shardings = (replicated_state_shardings(mesh, params),
                 {k: rows for k in sds})
    # local_loss over the whole grid and mesh
    return Bundle(fn=dtensor_step(gnn_train_step(local_loss(cfg))),
                  args=(train_state_abstract(params), sds),
                  in_shardings=shardings, donate=(0,),
                  description=description,
                  run_shardings=rows_merged(shardings, mesh))


def _smoke(device="cuda", weights=None):
    """The JAX ``_smoke``; ``weights`` (the JAX parameter tree as numpy
    arrays) replaces the seeded draw."""
    device = require_device(device)
    rng = np.random.default_rng(2)
    params = (M.init_graphcast(SMOKE,
                               torch.Generator(device).manual_seed(0))[0]
              if weights is None else gnn_from_numpy(SMOKE, weights, device))
    b = to_device(M.synth_batch(SMOKE, n_grid=256, n_mesh_edges=128,
                                rng=rng), device)
    with torch.no_grad():
        pred = M.forward(SMOKE, params, b)
    assert pred.shape == (256, SMOKE.n_vars)
    assert not bool(torch.isnan(pred).any())
    loss = M.loss_fn(SMOKE, params, b)
    loss.backward()
    assert np.isfinite(loss.item())
    assert all(bool(torch.isfinite(p.grad).all())
               for p in params.parameters())
    return {"loss": loss.item()}


def _flops(shape_name: str) -> dict:
    cfg = BASE
    d, L = cfg.d_hidden, cfg.n_layers
    per_edge = 2 * L * (3 * d) * d * 2           # edge MLP (3d→d→d)
    per_node = 2 * (cfg.n_vars * d + L * (2 * d) * d * 2 + 2 * d * d)
    return gnn_flops_info(shape_name, per_node, per_edge,
                          cfg.num_params(), scan_factor=cfg.n_layers)


register(ArchSpec(
    name="graphcast", family="gnn", shape_names=tuple(GNN_SHAPES),
    smoke=_smoke, bundle=_bundle, flops_info=_flops,
    notes="generic graph shapes parameterize the GRID; mesh nodes = "
          "max(grid//16, 42) (≈40,962 at refinement 6); the shape's edge "
          "count drives the multi-mesh processor.",
))
