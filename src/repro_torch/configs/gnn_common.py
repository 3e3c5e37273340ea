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
unchanged model loss on its own block of rows.

The dry-run's bundles: ``node_batch_sds`` is a batch's meta tensors,
``gnn_train_bundle`` the JAX bundle of a train step over one graph (node
and edge rows over every mesh axis, replicated weights and AdamW state)
and ``gnn_partitioned_bundle`` that of the partition-parallel step (its
``fn`` ``gnn_partitioned_step``). A whole-graph bundle's ``fn`` is
``gnn_train_step`` as a ``dtensor_step``: given ``DTensor``s placed as
the bundle's ``run_shardings`` say (the JAX layout on the mesh with every
axis merged into one, ``merge_axes``), DTensor's sharding propagation
partitions it, as XLA partitions the JAX step, and every rank holds its
own rows; the models' scatters are partitioned explicitly
(``models/gnn/common.py``). On plain tensors it is the one-device step.
"""
from __future__ import annotations

import torch

from ..data.sampler import subgraph_shape
from ..dist.collectives import all_reduce
from ..dist.sharding import ShardingPolicy, named_sharding
from ..optim import AdamW
from ..tree import tree_map
from .base import Bundle, pad_to

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


def dtensor_step(step):
    """``step`` as a program over ``DTensor`` inputs, which DTensor's
    sharding propagation partitions: a plain tensor the step makes (an
    ``arange``, a constant) counts as replicated beside them. Three ops
    are placed by hand (``_Placed``): a ``stack`` or ``cat`` gets its
    dimension counted from the front (torch 2.11 places ``stack(...,
    dim=-1)`` of row-sharded tensors as sharded along the new dimension);
    rows gathered by a ``DTensor`` of indices (``x[idx]``) are gathered
    from ``x`` whole, as XLA partitions a gather whose indices are
    sharded (torch 2.11's backward of it scatters a rank's rows as if
    they were all), and so are a table's rows looked up by ``DTensor``
    indices (``F.embedding``: torch 2.11 places its backward's
    ``index_put`` wrongly). On plain tensors it is ``step`` itself."""
    def run(*args):
        from torch.distributed.tensor.experimental import (
            implicit_replication)
        with implicit_replication(), _Placed():
            return step(*args)
    return run


def _gather_rows(x, idx):
    """``x[idx]`` for a ``DTensor`` ``x`` and a ``DTensor`` of row indices
    of any shape: ``x`` gathered whole on every rank, each rank's indices
    taken from it; the result placed as ``idx`` is, and the gradient of
    ``x`` a partial sum over the ranks that split ``idx``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = x.device_mesh
    whole = x.redistribute(mesh, [Replicate()] * mesh.ndim)
    grad = [Partial() if p.is_shard() else Replicate()
            for p in idx.placements]
    local = whole.to_local(grad_placements=grad)[idx.to_local()]
    shape = torch.Size(tuple(idx.shape) + tuple(x.shape[1:]))
    return DTensor.from_local(local, mesh, idx.placements, run_check=False,
                              shape=shape, stride=torch.empty(
                                  shape, device="meta").stride())


class _Placed(torch.overrides.TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = dict(kwargs or {})
        if func in (torch.stack, torch.cat, torch.concat):
            dim = kwargs.pop("dim", args[1] if len(args) > 1 else 0)
            first = args[0][0]
            if dim < 0:
                dim += first.ndim + (func is torch.stack)
            return func(args[0], dim=dim, **kwargs)
        if (func is torch.Tensor.__getitem__ and len(args) == 2
                and isinstance(args[0], DTensor)
                and isinstance(args[1], DTensor) and args[1].ndim == 1
                and not args[1].dtype.is_floating_point
                and args[1].dtype != torch.bool):
            return _gather_rows(*args)
        if (func is torch.nn.functional.embedding and len(args) == 2
                and isinstance(args[0], DTensor)
                and isinstance(args[1], DTensor)
                and not any(v for k, v in kwargs.items()
                            if k != "norm_type")):   # a plain lookup
            return _gather_rows(args[1], args[0])
        return func(*args, **kwargs)


def merge_axes(mesh, n: int):
    """``mesh`` with its ``n`` leading dimensions merged into one, named
    "rows", the ranks in the same order: a tensor dimension split over
    those axes (JAX's ``P(("data", "model"))``) is one ``Shard`` on it.
    DTensor splits such a dimension one mesh axis at a time (a gather one
    collective an axis) and has no rule for some ops on it (torch 2.11:
    an index into rows sharded twice); XLA gathers once over them all."""
    from torch.distributed.device_mesh import DeviceMesh

    shape = tuple(mesh.mesh.shape)
    rest = shape[n:]
    return DeviceMesh(mesh.device_type,
                      mesh.mesh.reshape((-1,) + rest),
                      mesh_dim_names=("rows",) + tuple(
                          mesh.mesh_dim_names[n:]))


def on_merged(sharding, merged, n: int):
    """``sharding`` (on a mesh whose ``n`` leading dimensions ``merged``
    merges) placed on ``merged``: the same shard on every rank."""
    from ..dist.sharding import NamedSharding

    lead = set(sharding.placements[:n])
    if len(lead) != 1:
        raise ValueError(f"axes merged into rows place a tensor "
                         f"differently: {sharding.placements[:n]}")
    return NamedSharding(merged, (lead.pop(),) + tuple(
        sharding.placements[n:]), sharding.spec)


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
    from torch.distributed.tensor import Shard

    names = mesh.mesh_dim_names
    coord = mesh.get_coordinate()
    n = mesh.size()
    rank = 0
    for a in gnn_policy(mesh).data_axes:
        i = names.index(a)
        rank = rank * mesh.size(i) + coord[i]
    groups = [mesh.get_group(i) for i in range(mesh.ndim)
              if mesh.size(i) > 1]

    def local(t):
        return t.to_local() if hasattr(t, "to_local") else t

    def mean(t):
        for g in groups:
            t = all_reduce(t, g)
        return t / n

    def block(t, device):
        if hasattr(t, "to_local"):   # a DTensor placed by rows: its block
            m = t.device_mesh
            return t.redistribute(m, [Shard(0)] * m.ndim).to_local()
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
            flat = mean(torch.cat([local(g).reshape(-1).float()
                                   for g in grads]))
            for g, part in zip(grads, flat.split([g.numel() for g in grads])):
                g.copy_(part.view_as(g))
            for p, g in zip(params, grads):
                p.grad = g
            grads = model.tree(lambda p: p.grad)
            opt = OPTIMIZER.update(model.tree(), grads, state["opt"])[1]
            loss = mean(local(loss).detach().float().clone())
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


def train_state_abstract(params_abs) -> dict:
    """A train state of meta tensors for ``params_abs`` (a ``ParamTree``
    on the meta device): the JAX layout, ``OPTIMIZER``'s moments."""
    return {"params": params_abs,
            "opt": OPTIMIZER.init_abstract(params_abs.tree()),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def replicated_state_shardings(mesh, params_abs) -> dict:
    """Shardings of ``train_state_abstract(params_abs)``: everything
    replicated on ``mesh``."""
    repl = named_sharding(mesh)
    pshard = tree_map(lambda _: repl, params_abs.tree())
    return {"params": pshard,
            "opt": {"m": pshard, "v": pshard, "count": repl},
            "step": repl}


def gnn_train_bundle(mesh, shape_info, *, params_abs, loss_closure,
                     batch_sds: dict, batch_row_sharded: dict,
                     description: str) -> Bundle:
    """Generic GNN train-step bundle: replicated small params + AdamW,
    node/edge tensors sharded over every mesh axis."""
    policy = gnn_policy(mesh)
    repl = named_sharding(mesh)
    rows = named_sharding(mesh, policy.data_axes)
    batch_shard = {k: (rows if batch_row_sharded.get(k, True) else repl)
                   for k in batch_sds}
    shardings = (replicated_state_shardings(mesh, params_abs), batch_shard)
    return Bundle(fn=dtensor_step(gnn_train_step(loss_closure)),
                  args=(train_state_abstract(params_abs), batch_sds),
                  in_shardings=shardings, donate=(0,),
                  description=description,
                  run_shardings=rows_merged(shardings, mesh))


def rows_merged(shardings, mesh):
    """A bundle's shardings on ``mesh`` with every axis merged into one
    (``merge_axes``): the layout in which the port runs a step whose rows
    are split over every axis."""
    merged = merge_axes(mesh, mesh.ndim)
    return tree_map(lambda s: on_merged(s, merged, mesh.ndim), shardings)


def node_batch_sds(n_nodes, n_edges, d_feat, *, with_pos=False,
                   n_graphs=None, triplet_cap=None) -> dict:
    """A graph batch's meta tensors: the JAX ``node_batch_sds``'s keys,
    shapes and dtypes."""
    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    f32, i32 = torch.float32, torch.int32
    rows = (n_graphs,) if n_graphs else (n_nodes,)
    sds = {
        "node_feat": meta((n_nodes, d_feat), f32),
        "src": meta((n_edges,), i32),
        "dst": meta((n_edges,), i32),
        "labels": meta(rows, i32),
        "label_mask": meta(rows, f32),
    }
    if with_pos:
        sds["positions"] = meta((n_nodes, 3), f32)
    if n_graphs:
        sds["graph_id"] = meta((n_nodes,), i32)
    if triplet_cap:
        t = n_edges * triplet_cap
        sds["t_kj"] = meta((t,), i32)
        sds["t_ji"] = meta((t,), i32)
        sds["t_mask"] = meta((t,), f32)
    return sds


def gnn_partitioned_bundle(mesh, shape_info, *, params_abs, local_loss,
                           batch_sds: dict, description: str) -> Bundle:
    """Partition-parallel GNN train step (DistGNN cd-0 style): every rank
    runs the model on its own partition's block of rows
    (``gnn_partitioned_step``); every batch array's rows sharded over all
    mesh axes, the weights and AdamW state replicated."""
    rows = named_sharding(mesh, gnn_policy(mesh).data_axes)
    shardings = (replicated_state_shardings(mesh, params_abs),
                 {k: rows for k in batch_sds})
    return Bundle(fn=dtensor_step(gnn_partitioned_step(local_loss, mesh)),
                  args=(train_state_abstract(params_abs), batch_sds),
                  in_shardings=shardings, donate=(0,),
                  description=description + " [partition-parallel cd-0]",
                  run_shardings=rows_merged(shardings, mesh))
