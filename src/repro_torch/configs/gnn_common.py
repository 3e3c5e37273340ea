"""Shared plumbing of the four GNN architectures, the port's counterpart of
``repro.configs.gnn_common``.

The four assignment shapes:
  full_graph_sm  N=2,708  E=10,556  d_feat=1,433   (cora-like full-batch)
  minibatch_lg   1,024 seeds × fanout 15·10 on a 232,965-node graph
                 (reddit-like; the step sees the SAMPLED subgraph —
                 169,984 nodes / 168,960 edges, static shapes)
  ogb_products   N=2,449,029  E=61,859,140  d_feat=100 (full-batch-large)
  molecule       128 graphs × 30 nodes / 64 edges (block-diagonal batch)

``gnn_train_step`` is the single-device train step of the JAX package's
``gnn_train_bundle`` (and of graphcast's ``_bundle``): the loss and its
gradients, then ``AdamW(lr=1e-3, weight_decay=0.0)``, then ``step + 1``,
on a state in the JAX layout ``{"params", "opt": {"m", "v", "count"},
"step"}``. The update writes the weights in their own dtype, as the JAX
optimizer does: bf16 weights keep no float32 masters.

Under a mesh (``torch.distributed``'s ``DeviceMesh``): ``gnn_policy`` is
the JAX package's (node and edge rows over every mesh axis, replicated
weights), ``padded_dims`` pads a shape's node and edge counts to a
multiple of the mesh's size, and ``gnn_partitioned_step`` is the step of
the JAX ``gnn_partitioned_bundle`` (DistGNN's cd-0): every rank runs the
unchanged model loss on its own block of rows. The JAX bundles' all-axes
row sharding of one graph (``gnn_train_bundle``) waits for the dry-run
slice.
"""
from __future__ import annotations

import torch

from ..data.sampler import subgraph_shape
from ..dist.collectives import all_reduce
from ..dist.sharding import ShardingPolicy
from ..optim import AdamW

MB_NODES, MB_EDGES = subgraph_shape(1024, (15, 10))

GNN_SHAPES = {
    "full_graph_sm": dict(n_nodes=2708, n_edges=10556, d_feat=1433,
                          n_classes=7, task="node"),
    "minibatch_lg": dict(n_nodes=MB_NODES, n_edges=MB_EDGES, d_feat=602,
                         n_classes=41, task="node", sampled=True),
    "ogb_products": dict(n_nodes=2449029, n_edges=61859140, d_feat=100,
                         n_classes=47, task="node"),
    "molecule": dict(n_nodes=30 * 128, n_edges=64 * 128, d_feat=16,
                     n_classes=1, task="graph", n_graphs=128),
}

# the JAX bundles' optimizer; its other settings are AdamW's defaults
OPTIMIZER = AdamW(lr=1e-3, weight_decay=0.0)


def gnn_train_state(model) -> dict:
    """A train state for ``model`` (a trainable ``ParamTree``): zero
    moments and counts on its device."""
    opt = OPTIMIZER.init(model.tree())
    return {"params": model, "opt": opt,
            "step": torch.zeros((), dtype=torch.int32,
                                device=opt["count"].device)}


def gnn_train_step(loss_closure):
    """Builds ``train_step(state, batch) -> (state, {"loss"})`` from
    ``loss_closure(params, batch)``: the loss's gradients by autograd, one
    ``OPTIMIZER`` update written into the weights and moments in place, and
    ``step + 1``."""
    def train_step(state, batch):
        model = state["params"]
        loss = loss_closure(model, batch)
        loss.backward()
        grads = model.tree(lambda p: p.grad if p.grad is not None
                           else torch.zeros_like(p))
        opt = OPTIMIZER.update(model.tree(), grads, state["opt"])[1]
        model.zero_grad(set_to_none=True)
        return ({"params": model, "opt": opt, "step": state["step"] + 1},
                {"loss": loss.detach()})

    return train_step


def pad_to(n: int, m: int) -> int:
    """``n`` rounded up to a multiple of ``m``."""
    return ((n + m - 1) // m) * m


def gnn_policy(mesh) -> ShardingPolicy:
    """Node and edge rows over every mesh axis (a GNN has no tensor-parallel
    dimension, so "model" joins the data axes); weights replicated."""
    return ShardingPolicy(mesh_axes=tuple(mesh.mesh_dim_names), fsdp=False,
                          batch_over_all=True)


def padded_dims(shape_info, mesh) -> tuple[int, int]:
    """A shape's node and edge counts padded to a multiple of the mesh's
    size (pad rows carry zero masks)."""
    m = mesh.size()
    return (pad_to(shape_info["n_nodes"], m),
            pad_to(shape_info["n_edges"], m))


def gnn_partitioned_step(local_loss, mesh):
    """Partition-parallel GNN train step (DistGNN cd-0 style), the JAX
    ``gnn_partitioned_bundle``'s step: ``train_step(state, batch) ->
    (state, {"loss"})``.

    ``batch`` maps names to the whole graph's arrays (tensors, the same on
    every rank, on the host or on the card) in which the data pipeline has
    laid the partitions out in blocks of rows: rank r of the mesh (its
    coordinate over every axis, row-major) owns block r of every array, a
    partition's nodes and its edges, triplets and labels, its indices
    local to the block; an edge between partitions is dropped. Each rank
    copies its own blocks to its weights' device. Each rank runs
    ``local_loss(params, local_batch)`` (the unchanged model loss) on its
    block; the loss is averaged over the ranks (JAX's ``pmean``), the
    gradients of the replicated weights are the mean over the ranks (one
    SUM all-reduce of them flattened, divided by the number of ranks), and
    every rank applies the same ``OPTIMIZER`` update."""
    names = mesh.mesh_dim_names
    coord = mesh.get_coordinate()
    n = mesh.size()
    rank = 0
    for a in gnn_policy(mesh).data_axes:
        i = names.index(a)
        rank = rank * mesh.size(i) + coord[i]
    groups = [mesh.get_group(i) for i in range(mesh.ndim)
              if mesh.size(i) > 1]

    def mean(t):
        for g in groups:
            t = all_reduce(t, g)
        return t / n

    def block(t, device):
        if t.shape[0] % n:
            raise ValueError(f"{t.shape[0]} rows do not split into {n} "
                             f"partitions")
        rows = t.shape[0] // n
        return t[rank * rows:(rank + 1) * rows].to(device)

    def train_step(state, batch):
        model = state["params"]
        device = next(model.parameters()).device
        loss = local_loss(model, {k: block(v, device)
                                  for k, v in batch.items()})
        loss.backward()
        params = list(model.parameters())
        with torch.no_grad():
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params]
            flat = mean(torch.cat([g.reshape(-1).float() for g in grads]))
            for g, part in zip(grads, flat.split([g.numel() for g in grads])):
                g.copy_(part.view_as(g))
            for p, g in zip(params, grads):
                p.grad = g
            grads = model.tree(lambda p: p.grad)
            opt = OPTIMIZER.update(model.tree(), grads, state["opt"])[1]
            loss = mean(loss.detach().float().clone())
        model.zero_grad(set_to_none=True)
        return ({"params": model, "opt": opt, "step": state["step"] + 1},
                {"loss": loss})

    return train_step


def gnn_flops_info(shape_name: str, per_node_flops: float,
                   per_edge_flops: float, n_params: int,
                   train: bool = True, scan_factor: int = 1) -> dict:
    info = GNN_SHAPES[shape_name]
    fwd = (info["n_nodes"] * per_node_flops
           + info["n_edges"] * per_edge_flops)
    model_flops = 3 * fwd if train else fwd  # fwd + bwd ≈ 2×fwd
    return {"n_params": n_params, "n_active": n_params,
            "tokens": info["n_nodes"], "model_flops": model_flops,
            "kind": "train", "scan_factor": scan_factor}
