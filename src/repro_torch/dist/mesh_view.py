"""One rank's view of a ``(data axes…, model)`` mesh, for model code that
runs sharded: the analog, written out, of what the JAX package leaves to
GSPMD (and of ``shard_map``'s per-device view).

Weights are ``DTensor``s placed by a ``ShardingPolicy``. ``weight`` reads
this rank's part of one: every dimension sharded over a data axis (FSDP)
is all-gathered, its gradient reduce-scattered; a dimension sharded over
``model`` stays local when it is the dimension the caller computes
tensor-parallel over, and is otherwise gathered, its gradient sliced. The
batch is split over the data axes (``rows``): rank ``r`` of them takes
rows ``r·B/D .. (r+1)·B/D - 1``, as ``Shard(0)`` places them.

After the backward pass, ``sync_grads`` sums over the data axes the
gradients of the weights replicated over them (those sharded over a data
axis were summed by their gather's reduce-scatter), and ``grad_norm``
gives the norm of the whole gradient from every rank's shards.
"""
from __future__ import annotations

import math

import torch

from .collectives import all_reduce, gather_same, gather_sum, reduce_from

_BUCKET = 1 << 26          # elements a gradient all-reduce carries at most


class MeshView:
    def __init__(self, mesh, policy=None):
        from torch.distributed.tensor import Replicate, Shard

        names = tuple(mesh.mesh_dim_names)
        data_axes = (policy.data_axes if policy is not None
                     else tuple(a for a in names if a != "model"))
        if "model" in data_axes:
            raise ValueError("a batch over the model axis (batch_over_all) "
                             "is not a tensor-parallel layout")
        self.mesh = mesh
        coord = mesh.get_coordinate()
        self.model = names.index("model") if "model" in names else None
        self.n_model = mesh.size(self.model) if self.model is not None else 1
        self.model_rank = coord[self.model] if self.model is not None else 0
        self.model_group = (mesh.get_group(self.model) if self.n_model > 1
                            else None)
        self.data = tuple(names.index(a) for a in data_axes)
        self.n_data = math.prod(mesh.size(i) for i in self.data)
        r = 0
        for i in self.data:
            r = r * mesh.size(i) + coord[i]
        self.data_rank = r
        self._shard, self._rep = Shard, Replicate

    # -- weights -------------------------------------------------------------
    def weight(self, p, tp_dim=None):
        """(this rank's tensor of weight ``p``, whether it is sharded over
        ``model`` along ``tp_dim``). A plain tensor is returned as it is."""
        if not hasattr(p, "placements"):
            return p, False
        w = p.to_local()
        tp = False
        # innermost mesh dimension first: a tensor dimension split over
        # several mesh axes is gathered back in their order
        for i in reversed(range(self.mesh.ndim)):
            pl = p.placements[i]
            if not pl.is_shard() or self.mesh.size(i) == 1:
                continue
            group = self.mesh.get_group(i)
            if i == self.model:
                if pl.dim == tp_dim:
                    tp = True
                else:
                    w = gather_same(w, pl.dim, group)
            else:
                w = gather_sum(w, pl.dim, group)
        return w, tp

    def gathered(self, tree):
        """Every weight of a dict of them, whole (``weight`` with no
        tensor-parallel dimension)."""
        return {k: (self.gathered(v) if isinstance(v, dict)
                    else self.weight(v)[0]) for k, v in tree.items()}

    # -- the batch -----------------------------------------------------------
    def rows(self, t):
        """This rank's rows of a global batch ``t`` (the same on every
        rank), or of a ``DTensor`` whose rows are placed over the data
        axes (its local tensor)."""
        if hasattr(t, "placements"):
            # a batch the data shards do not divide: every one takes it all
            split = t.shape[0] % self.n_data == 0
            want = [self._shard(0) if split and i in self.data
                    else self._rep() for i in range(self.mesh.ndim)]
            return t.redistribute(self.mesh, want).to_local()
        b = t.shape[0]
        if b % self.n_data:
            raise ValueError(f"batch {b} does not split over "
                             f"{self.n_data} data shards")
        n = b // self.n_data
        return t[self.data_rank * n:(self.data_rank + 1) * n]

    def placements(self, batch_dim: int = 0, model_dim=None) -> list:
        """Placements of an activation: ``batch_dim`` over the data axes,
        ``model_dim`` (or nothing) over ``model``."""
        out = [self._rep()] * self.mesh.ndim
        for i in self.data:
            out[i] = self._shard(batch_dim)
        if self.model is not None and model_dim is not None:
            out[self.model] = self._shard(model_dim)
        return out

    def dtensor(self, local, batch_dim: int = 0, model_dim=None):
        """This rank's ``local`` part as a ``DTensor`` on the mesh."""
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(local, self.mesh,
                                  self.placements(batch_dim, model_dim),
                                  run_check=False)

    def data_mean(self, x):
        """The mean of ``x`` over the data shards (its gradient reaches
        each shard's ``x`` divided by their number)."""
        for i in self.data:
            x = reduce_from(x, self.mesh.get_group(i))
        return x / self.n_data

    # -- gradients -----------------------------------------------------------
    def sync_grads(self, params) -> None:
        """Sum over every data axis the gradients of the weights
        replicated over it (in buckets of at most ``_BUCKET`` elements of
        one dtype)."""
        params = [p for p in params if p.grad is not None]
        for i in self.data:
            if self.mesh.size(i) == 1:
                continue
            group = self.mesh.get_group(i)
            grads = [p.grad.to_local() for p in params
                     if p.grad.placements[i].is_replicate()]
            for dtype in sorted({g.dtype for g in grads}, key=str):
                same = [g for g in grads if g.dtype == dtype]
                at = 0
                while at < len(same):
                    bucket, n = [], 0
                    while at < len(same) and (
                            not bucket or n + same[at].numel() <= _BUCKET):
                        bucket.append(same[at])
                        n += same[at].numel()
                        at += 1
                    flat = all_reduce(torch.cat(
                        [b.reshape(-1) for b in bucket]), group)
                    for b, part in zip(bucket, flat.split(
                            [b.numel() for b in bucket])):
                        b.copy_(part.view_as(b))

    def grad_norm(self, params) -> torch.Tensor:
        """The norm of the whole gradient of ``params`` (``DTensor``s),
        the same on every rank: each leaf's squares summed over the mesh
        axes it is sharded over."""
        by_axes: dict = {}
        for p in params:
            g = p.grad
            if g is None:
                continue
            axes = tuple(i for i, pl in enumerate(g.placements)
                         if pl.is_shard() and self.mesh.size(i) > 1)
            s = torch.sum(torch.square(g.to_local().float()))
            by_axes[axes] = by_axes.get(axes, 0.0) + s
        total = 0.0
        for axes, s in sorted(by_axes.items()):
            for i in axes:
                s = all_reduce(s.clone(), self.mesh.get_group(i))
            total = total + s
        return torch.sqrt(total)
