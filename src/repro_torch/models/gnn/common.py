"""GNN substrate: segment-op message passing over edge-index tensors.

The counterpart of ``repro.models.gnn.common``: message passing is built on
``index_add_`` / ``scatter_reduce`` over an (E,) src/dst edge index (the
JAX package's ``segment_sum`` / ``segment_max``). Graphs are
struct-of-arrays; batched small graphs are block-diagonal with a
``graph_id`` vector for pooling. The synthetic graph generators are numpy,
and give the JAX package's arrays from the same generator.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ...tree import tree_map
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


def to_device(batch, device):
    """A batch of numpy arrays (a ``GraphBatch``, or any dataclass of
    arrays and counts) as tensors on ``device``: integer arrays as int64,
    torch's index dtype; counts and ``None`` stay as they are."""
    def tensor(a):
        if not isinstance(a, np.ndarray):
            return a
        t = torch.from_numpy(np.ascontiguousarray(a))
        return (t.long() if not t.dtype.is_floating_point else t).to(device)
    return dataclasses.replace(batch, **{
        f.name: tensor(getattr(batch, f.name))
        for f in dataclasses.fields(batch)})


def layer_of(tree, i: int):
    """Layer ``i`` of a subtree whose leaves all lead with a layer dim (a
    ``ParamTree``, a list of them, or dicts and lists of tensors): the same
    structure of views, through which gradients reach the stacked
    weights."""
    if isinstance(tree, common.ParamTree):
        tree = tree.tree(lambda p: p)
    elif isinstance(tree, nn.ModuleList):
        return [layer_of(x, i) for x in tree]
    return tree_map(lambda t: t[i], tree)


def remat(mode: str, fn):
    """``fn`` as it is (``"none"``), or saving only its inputs and
    recomputing the rest in the backward pass (``"full"``, the JAX code's
    ``jax.checkpoint``)."""
    if mode == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False,
                                 context_fn=_forward_modes)
    return fn


def _forward_modes():
    """Checkpoint contexts: the recompute runs under the torch-function
    modes the forward pass ran under (a DTensor step's,
    ``configs.gnn_common.dtensor_step``), which the backward pass leaves
    behind."""
    modes = torch.overrides._get_current_function_mode_stack()

    @contextlib.contextmanager
    def again():
        with contextlib.ExitStack() as stack:
            for m in modes:
                stack.enter_context(m)
            yield
    return contextlib.nullcontext(), again()


def gather_src(h, src):
    return h[src]


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _scatter_over_mesh(msgs, dst, n_nodes, fill, reduce: str):
    """A scatter of ``DTensor`` messages into a whole ``(n_nodes, ...)``
    result filled with ``fill``, replicated. A sum is partitioned as XLA
    partitions a scatter whose updates are sharded by row: every rank
    scatters its own rows, and an all-reduce completes it. A max gathers
    the messages first, so that its gradient reaches the rows that hold
    the maximum over the whole mesh. (DTensor's own strategies for
    ``index_add`` and ``scatter_reduce`` either have no rule or, in place,
    relabel a replicated result as sharded without moving its data;
    torch 2.13.)"""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = msgs.device_mesh
    rows = [p if p == Shard(0) and reduce == "sum" else Replicate()
            for p in msgs.placements]
    msgs = msgs.redistribute(mesh, rows)
    if not _is_dtensor(dst):
        dst = DTensor.from_local(dst, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    dst = dst.redistribute(mesh, rows)
    m, i = msgs.to_local(), dst.to_local().long()
    out = m.new_full((n_nodes,) + tuple(m.shape[1:]), fill)
    if reduce == "sum":
        out = out.index_add(0, i, m)
    else:
        i = i.reshape((-1,) + (1,) * (m.ndim - 1)).expand_as(m)
        out = out.scatter_reduce(0, i, m, "amax", include_self=False)
    part = [Partial(reduce) if p.is_shard() else Replicate() for p in rows]
    return DTensor.from_local(out, mesh, part, run_check=False).redistribute(
        mesh, [Replicate()] * mesh.ndim)


def scatter_sum(msgs, dst, n_nodes):
    if _is_dtensor(msgs):
        return _scatter_over_mesh(msgs, dst, n_nodes, 0, "sum")
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
    if _is_dtensor(msgs):
        return _scatter_over_mesh(msgs, dst, n_nodes, low, "max")
    out = msgs.new_full((n_nodes,) + tuple(msgs.shape[1:]), low)
    idx = dst.long().reshape((-1,) + (1,) * (msgs.ndim - 1)).expand_as(msgs)
    return out.scatter_reduce_(0, idx, msgs, "amax", include_self=False)


def label_nll(logits, labels):
    """``-log_softmax(logits)[i, labels[i]]`` of every row ``i``, as a
    gather: DTensor places it row by row, where an index beside an
    ``arange`` of all the rows is placed wrong (torch 2.11)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, 1, labels.long()[:, None])[:, 0]


def segment_softmax(scores, dst, n_nodes):
    """Edge-wise softmax normalized over incoming edges of each dst node."""
    m = scatter_max(scores, dst, n_nodes)
    m = torch.where(torch.isfinite(m), m, 0.0)
    e = torch.exp(scores - m[dst])
    z = scatter_sum(e, dst, n_nodes)
    return e / torch.clamp(z[dst], min=1e-9)


def rows_only(x):
    """A ``DTensor`` with every placement but ``Shard(0)`` replicated (a
    plain tensor as it is): DTensor (torch 2.13) places a reshape that
    folds a sharded inner dimension as a strided shard that no product
    takes, and reduces a partial sum onto whichever dimension it likes,
    one that does not divide included, where a later view fails."""
    if not _is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    want = [p if p == Shard(0) else Replicate() for p in x.placements]
    return x if list(x.placements) == want else x.redistribute(
        x.device_mesh, want)


def settled(x):
    """A ``DTensor``'s partial sums reduced (replicated); anything else as
    it is."""
    if not _is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_partial() else p for p in x.placements])


def mlp(params, x, act=F.relu, final_act=False):
    """params: a sequence of layers, each holding ``w`` and ``b``."""
    n = len(params)
    for i, layer in enumerate(params):
        x = settled(x @ layer["w"].to(x.dtype)) + layer["b"].to(x.dtype)
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
