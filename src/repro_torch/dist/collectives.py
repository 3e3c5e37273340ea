"""The collectives of the sharded models, one helper each, and the
autograd functions built on them.

Every collective of the model path goes through ``all_reduce``,
``all_gather`` or ``reduce_scatter`` here, which pick how by the group's
backend: under ``nccl`` they run on the card's tensors; under ``gloo`` a
CUDA tensor goes through a host copy (gloo reduces host memory; ranks
that share one card use it, see ``launch.mesh.group_backend``), staged in
page-locked buffers kept for reuse by size (at most ``PINNED_BYTES`` in
all), and a host tensor is reduced in place. The choice is made from the
backend, never by catching a failed collective.

``STATS`` counts the calls, the host seconds spent in them (a gloo
collective, and its host copies, end before the call returns; an nccl one
is only enqueued) and the bytes each rank contributed; ``reset_stats``
sets them to 0.

The autograd functions are the pairs of a tensor-parallel layer
(Megatron-LM's ``f`` and ``g``) and of FSDP's gather:

* ``copy_to``: identity forward, SUM all-reduce backward — where a value
  replicated over the group enters a sharded computation;
* ``reduce_from``: SUM all-reduce forward, identity backward — where the
  partial results of the group's shards leave it;
* ``gather_sum``: all-gather forward, reduce-scatter backward — a weight
  sharded over data-parallel ranks (FSDP), each of which uses it on a
  batch of its own;
* ``gather_same``: all-gather forward, this rank's slice backward — a
  sharded weight used by a computation every rank of the group repeats.
"""
from __future__ import annotations

import contextlib
import time

import torch
import torch.distributed as dist
from torch.distributed import ReduceOp

STATS = {"calls": 0, "seconds": 0.0, "bytes": 0}
PINNED_BYTES = 4 << 30
_pinned: dict = {}


def reset_stats() -> None:
    STATS.update(calls=0, seconds=0.0, bytes=0)


@contextlib.contextmanager
def _counted(t: torch.Tensor):
    t0 = time.perf_counter()
    yield
    STATS["calls"] += 1
    STATS["seconds"] += time.perf_counter() - t0
    STATS["bytes"] += t.numel() * t.element_size()


def _through_host(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _staging(dtype, shape, slot: int = 0) -> torch.Tensor:
    """A page-locked host buffer of ``shape``, the same one for the same
    size, dtype and ``slot`` (copies into and out of it are synchronous,
    so a call reuses it safely)."""
    n = 1
    for d in shape:
        n *= d
    key = (dtype, n, slot)
    buf = _pinned.get(key)
    if buf is None:
        size = n * torch.empty((), dtype=dtype).element_size()
        if size + sum(b.numel() * b.element_size()
                      for b in _pinned.values()) > PINNED_BYTES:
            _pinned.clear()
        buf = _pinned[key] = torch.empty(n, dtype=dtype, pin_memory=True)
    return buf.view(shape)


def all_reduce(t: torch.Tensor, group, op=ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over ``group`` (written into ``t``, and returned)."""
    if dist.get_world_size(group) == 1:
        return t
    with _counted(t):
        return _all_reduce(t, group, op)


def _all_reduce(t, group, op):
    if _through_host(t, group):
        h = _staging(t.dtype, t.shape)
        h.copy_(t.detach())
        dist.all_reduce(h, op=op, group=group)
        t.copy_(h)
        return t
    dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's shards of ``t``, concatenated along ``dim`` in rank
    order."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    with _counted(t):
        return _all_gather(t, dim, group, n)


def _all_gather(t, dim, group, n):
    src = t.detach().contiguous()
    if _through_host(t, group):
        h = _staging(src.dtype, src.shape)
        h.copy_(src)
        out = _staging(src.dtype, (n,) + tuple(src.shape), slot=1)
        dist.all_gather(list(out.unbind(0)), h, group=group)
        return torch.cat(out.to(t.device).unbind(0), dim)
    if t.is_cuda:
        out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        dist.all_gather_into_tensor(out, src, group=group)
        return torch.cat(out.chunk(n), dim) if dim else out
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim)


def reduce_scatter(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's chunk along ``dim`` of ``t`` summed over ``group``."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    r = dist.get_rank(group)
    if _through_host(t, group) or not t.is_cuda:
        # gloo: the sum on every rank, then this rank's chunk
        total = all_reduce(t.detach().clone(), group)
        return total.chunk(n, dim)[r].contiguous()
    with _counted(t):
        src = torch.cat(t.chunk(n, dim), 0) if dim else t
        src = src.contiguous()
        out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        dist.reduce_scatter_tensor(out, src, group=group)
    return out


def rank_slice(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's chunk of ``t`` along ``dim``."""
    n = dist.get_world_size(group)
    return t.chunk(n, dim)[dist.get_rank(group)] if n > 1 else t


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g.contiguous(), ctx.dim, ctx.group), None, None


class _GatherSame(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return rank_slice(g, ctx.dim, ctx.group).contiguous(), None, None


def copy_to(x, group):
    """Identity forward, SUM all-reduce of the gradient over ``group``."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    return _CopyTo.apply(x, group)


def reduce_from(x, group):
    """SUM all-reduce over ``group`` forward, identity backward."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    return _ReduceFrom.apply(x, group)


def gather_sum(x, dim: int, group):
    """All-gather along ``dim`` forward; the gradient reduce-scattered
    (summed over ``group``, this rank's chunk kept)."""
    if dist.get_world_size(group) == 1:
        return x
    return _GatherSum.apply(x, dim, group)


def gather_same(x, dim: int, group):
    """All-gather along ``dim`` forward; the gradient's own chunk kept
    (the group's ranks computed the same gradient)."""
    if dist.get_world_size(group) == 1:
        return x
    return _GatherSame.apply(x, dim, group)


def full_tensor(x) -> torch.Tensor:
    """A ``DTensor``'s whole value, on every rank of its mesh (each
    sharded mesh dimension gathered, innermost first, through
    ``all_gather``); a plain tensor as it is. The value of a placement
    other than ``Shard`` and ``Replicate`` is not supported."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    t = x.to_local().detach()
    mesh = x.device_mesh
    for i in reversed(range(mesh.ndim)):
        pl = x.placements[i]
        if pl.is_shard():
            t = all_gather(t, pl.dim, mesh.get_group(i))
        elif not pl.is_replicate():
            raise ValueError(f"full_tensor: placement {pl} on mesh "
                             f"dimension {i}")
    return t
