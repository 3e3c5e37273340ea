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
optimizer does: bf16 weights keep no float32 masters. The mesh half of the
JAX bundles (row sharding over every mesh axis, the partition-parallel cd-0
step) waits for the sharding slice.
"""
from __future__ import annotations

import torch

from ..data.sampler import subgraph_shape
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
