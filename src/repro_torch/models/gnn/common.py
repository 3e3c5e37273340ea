"""GNN substrate: segment-op message passing over edge-index tensors.

The counterpart of ``repro.models.gnn.common``: message passing is built on
``index_add_`` / ``scatter_reduce`` over an (E,) src/dst edge index (the
JAX package's ``segment_sum`` / ``segment_max``). Graphs are
struct-of-arrays; batched small graphs are block-diagonal with a
``graph_id`` vector for pooling. The synthetic graph generators are numpy,
and give the JAX package's arrays from the same generator.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from .. import common


@dataclasses.dataclass
class GraphBatch:
    """node_feat (N,F); edge src/dst (E,); optional positions, edge feats,
    labels, graph_id (for pooled graph-level tasks)."""
    node_feat: Any
    src: Any
    dst: Any
    n_nodes: int
    edge_feat: Any | None = None
    positions: Any | None = None
    labels: Any | None = None
    label_mask: Any | None = None
    graph_id: Any | None = None
    n_graphs: int = 1


def gather_src(h, src):
    return h[src]


def scatter_sum(msgs, dst, n_nodes):
    out = msgs.new_zeros((n_nodes,) + tuple(msgs.shape[1:]))
    return out.index_add_(0, dst.long(), msgs)


def scatter_mean(msgs, dst, n_nodes):
    s = scatter_sum(msgs, dst, n_nodes)
    cnt = scatter_sum(msgs.new_ones((msgs.shape[0],)), dst, n_nodes)
    return s / torch.clamp(cnt, min=1.0)[:, None]


def scatter_max(msgs, dst, n_nodes):
    """Per-segment maximum; an empty segment holds the identity of max
    (-inf, or the dtype's least integer), as ``jax.ops.segment_max``."""
    low = (-torch.inf if msgs.dtype.is_floating_point
           else torch.iinfo(msgs.dtype).min)
    out = msgs.new_full((n_nodes,) + tuple(msgs.shape[1:]), low)
    idx = dst.long().reshape((-1,) + (1,) * (msgs.ndim - 1)).expand_as(msgs)
    return out.scatter_reduce_(0, idx, msgs, "amax", include_self=False)


def segment_softmax(scores, dst, n_nodes):
    """Edge-wise softmax normalized over incoming edges of each dst node."""
    m = scatter_max(scores, dst, n_nodes)
    m = torch.where(torch.isfinite(m), m, 0.0)
    e = torch.exp(scores - m[dst])
    z = scatter_sum(e, dst, n_nodes)
    return e / torch.clamp(z[dst], min=1e-9)


def mlp(params, x, act=F.relu, final_act=False):
    """params: a sequence of layers, each holding ``w`` and ``b``."""
    n = len(params)
    for i, layer in enumerate(params):
        x = x @ layer["w"].to(x.dtype) + layer["b"].to(x.dtype)
        if i < n - 1 or final_act:
            x = act(x)
    return x


def init_mlp(rng, dims, logical_hidden="mlp", dtype=torch.float32,
             lead: tuple[int, ...] = (), lead_logical: tuple = ()):
    """Returns a list of ``{"w": (w, logical), "b": (b, logical)}`` layers
    (``rng``: a ``torch.Generator``, or None for shapes on the meta
    device).

    Hidden dims get ``logical_hidden`` (TP-shardable); in/out dims of the
    first/last matrices stay replicated. ``lead`` adds stacking dims."""
    out = []
    for i in range(len(dims) - 1):
        is_last = i == len(dims) - 2
        in_l = None if i == 0 else logical_hidden
        out_l = None if is_last else logical_hidden
        wshape = lead + (dims[i], dims[i + 1])
        bshape = lead + (dims[i + 1],)
        w = common.normal(rng, wshape, 1.0 / np.sqrt(dims[i]), dtype)
        b = (torch.empty(bshape, dtype=dtype, device="meta") if rng is None
             else torch.zeros(bshape, dtype=dtype, device=rng.device))
        out.append({"w": (w, lead_logical + (in_l, out_l)),
                    "b": (b, lead_logical + (out_l,))})
    return out


def block_diagonal_batch(n_graphs: int, nodes_per: int, edges_per: int,
                         d_feat: int, rng: np.random.Generator,
                         n_classes: int = 1, with_pos: bool = False
                         ) -> GraphBatch:
    """Synthetic batch of small graphs as one block-diagonal graph."""
    N = n_graphs * nodes_per
    src = np.concatenate([
        rng.integers(0, nodes_per, edges_per) + g * nodes_per
        for g in range(n_graphs)])
    dst = np.concatenate([
        rng.integers(0, nodes_per, edges_per) + g * nodes_per
        for g in range(n_graphs)])
    gid = np.repeat(np.arange(n_graphs), nodes_per)
    return GraphBatch(
        node_feat=rng.normal(size=(N, d_feat)).astype(np.float32),
        src=src.astype(np.int32), dst=dst.astype(np.int32), n_nodes=N,
        positions=(rng.normal(size=(N, 3)).astype(np.float32)
                   if with_pos else None),
        labels=rng.integers(0, n_classes, n_graphs).astype(np.int32),
        graph_id=gid.astype(np.int32), n_graphs=n_graphs)


def random_graph(n_nodes: int, n_edges: int, d_feat: int,
                 rng: np.random.Generator, n_classes: int = 8,
                 with_pos: bool = False) -> GraphBatch:
    src = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    dst = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    return GraphBatch(
        node_feat=rng.normal(size=(n_nodes, d_feat)).astype(np.float32),
        src=src, dst=dst, n_nodes=n_nodes,
        positions=(rng.normal(size=(n_nodes, 3)).astype(np.float32)
                   if with_pos else None),
        labels=rng.integers(0, n_classes, n_nodes).astype(np.int32),
        label_mask=np.ones((n_nodes,), np.float32))
