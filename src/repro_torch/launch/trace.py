"""One rank's step, traced: the port's counterpart of the JAX dry-run's
``jax.jit(fn, in_shardings=...).lower(*args).compile()``.

``trace_bundle`` gives a dry-run ``Bundle``'s step what rank 0 of its
mesh would hold: every argument a ``DTensor`` whose local tensor is a
fake tensor of rank 0's shard shape (``FakeTensorMode``: shapes, dtypes
and devices, no storage), placed as the bundle's shardings say. It runs
``bundle.fn`` once. Nothing is allocated and no collective moves data
(the mesh's process group is torch's ``fake`` one in the dry-run, and
``torch.distributed._tools.fake_collectives`` gives every c10d op a fake
kernel). DTensor's sharding propagation partitions the step where its
inputs are ``DTensor``s, as XLA's SPMD partitioner partitions the JAX
step; the LM and partition-parallel steps are rank programs already,
with collectives of their own.

``StepMeter`` is the measuring half, a ``TorchDispatchMode`` that sees
every op of rank 0's program (the local ops under a ``DTensor``, whose
own ops it hands back to ``DTensor`` first, and every c10d and
functional collective), on fake tensors and on real ones alike:

* ``flops``: each op's FLOPs by ``torch.utils.flop_counter``'s registry
  (``FlopCounterMode``'s formulas: the matmul, bmm, convolution and
  attention families). XLA's ``cost_analysis`` also counts elementwise
  work, so XLA's count is the larger.
* ``bytes_accessed``: the bytes of the input and output tensors of every
  op but views, an eager program's traffic with nothing fused; it bounds
  XLA's (whose fusions keep intermediates on chip) from above.
* ``collectives``: bytes and counts by op under the JAX dry-run's names
  (``all-reduce``, ``all-gather``, ``reduce-scatter``, ``all-to-all``,
  ``collective-permute``; ``broadcast`` under its own), the bytes of each
  op's result as the JAX dry-run reads them off the partitioned HLO.
* ``peak``: the most bytes live at once on the step's device. The meter
  holds the size of every storage it has seen (the arguments', and each
  op's outputs') until the storage dies (a ``weakref.finalize`` on it).

A kernel wrapper of ``repro_torch.kernels`` tells the meter of its
kernel as one op (``kernels.KERNEL_OBSERVERS``): the planes it reads, the
counters and registers it writes. On fake tensors on the card it
launches nothing (``kernels.shape_only``).
"""
from __future__ import annotations

import gc
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# op packet name -> the JAX dry-run's name for it
_COLLECTIVE_NAMES = {
    "c10d.allreduce_": "all-reduce",
    "c10d.allreduce_coalesced_": "all-reduce",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.all_reduce_coalesced_": "all-reduce",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.allgather_coalesced_": "all-gather",
    "c10d.allgather_into_tensor_coalesced_": "all-gather",
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_out": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional_autograd.all_gather_into_tensor": "all-gather",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_out": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional_autograd.reduce_scatter_tensor": "reduce-scatter",
    "c10d.alltoall_": "all-to-all",
    "c10d.alltoall_base_": "all-to-all",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_c10d_functional_autograd.all_to_all_single": "all-to-all",
    "_dtensor.shard_dim_alltoall": "all-to-all",
    "c10d.send": "collective-permute",
    "c10d.recv_": "collective-permute",
    "_c10d_functional.isend": "collective-permute",
    "_c10d_functional.irecv": "collective-permute",
    "c10d.broadcast_": "broadcast",
    "_c10d_functional.broadcast": "broadcast",
    "_c10d_functional.broadcast_": "broadcast",
}


# ops that read a tensor's metadata, not its data (a fake tensor's
# ``device`` and sizes come through the dispatcher; a real one's do not)
_METADATA = frozenset({
    "prim.device", "prim.layout", "aten.size", "aten.sym_size",
    "aten.stride", "aten.sym_stride", "aten.storage_offset",
    "aten.sym_storage_offset", "aten.numel", "aten.sym_numel", "aten.dim",
    "aten.is_contiguous", "aten.sym_is_contiguous",
    "aten.is_strides_like_format", "aten.is_non_overlapping_and_dense",
})


# ops that move no data of their own: a functional collective's wait, and
# the autograd wrapper a real one's result gets
_NO_DATA = frozenset({"_c10d_functional.wait_tensor",
                      "_c10d_functional._wrap_tensor_autograd"})


# a storage the CUDA caching allocator serves from its large pool (over
# 1 MiB): counted apart at the peak, as the allocator may hand it a cached
# block up to 1 MiB larger than it asked for
LARGE = 1 << 20


def _tensors(tree) -> list:
    """The tensors among ``tree``'s leaves (lists, tuples, dicts)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepMeter(TorchDispatchMode):
    """Counts one rank's step op by op (module docstring): ``flops``,
    ``bytes_accessed``, ``collectives`` and the ``peak`` of live bytes on
    ``device``. ``hold`` the step's arguments before it runs
    (``run_metered``)."""

    def __init__(self, device):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.device = torch.device(device).type
        self._flop_fns = flop_registry
        self.flops = 0
        self.bytes_accessed = 0
        self.coll_bytes: dict[str, int] = {}
        self.coll_counts: dict[str, int] = {}
        self.live = 0
        self.peak = 0
        self.peak_storages = 0        # storages live at the peak
        self.peak_large = 0           # of which over LARGE bytes
        self._large = 0
        self._sizes: dict[int, int] = {}     # id(storage) -> bytes held
        self._on = True

    # -- storages ------------------------------------------------------------
    def _release(self, key: int) -> None:
        n = self._sizes.pop(key, 0)
        self.live -= n
        self._large -= n > LARGE

    def hold(self, t: torch.Tensor) -> bool:
        """Count ``t``'s storage as live until it dies; False if it was
        held already or lies on another device."""
        if t.device.type != self.device:
            return False
        st = t.untyped_storage()
        key = id(st)
        if key in self._sizes:
            return False
        n = st.nbytes()
        self._sizes[key] = n
        weakref.finalize(st, self._release, key)
        self.live += n
        self._large += n > LARGE
        if self.live > self.peak:
            self.peak, self.peak_storages = self.live, len(self._sizes)
            self.peak_large = self._large
        return True

    # -- ops -----------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented      # DTensor first: its local ops come back
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = str(func._overloadpacket)
        if not self._on or name in _METADATA:
            return out
        outs = _tensors(out)
        coll = _COLLECTIVE_NAMES.get(name)
        if coll is not None:
            res = outs or _tensors(args)[:1]
            self.coll_bytes[coll] = (self.coll_bytes.get(coll, 0)
                                     + sum(_nbytes(t) for t in res))
            self.coll_counts[coll] = self.coll_counts.get(coll, 0) + 1
        fl = self._flop_fns.get(func._overloadpacket)
        if fl is not None:
            self.flops += int(fl(*args, **kwargs, out_val=out))
        if not func.is_view and name not in _NO_DATA:
            self.bytes_accessed += sum(
                _nbytes(t) for t in _tensors(args) + _tensors(kwargs) + outs)
        for t in outs:
            self.hold(t)
        return out

    def _kernel(self, read_bytes: int, written) -> None:
        if self._on:
            self.bytes_accessed += read_bytes + sum(_nbytes(t)
                                                    for t in written)

    def _unmetered(self, fn):
        def run(*args, **kwargs):
            on, self._on = self._on, False
            try:
                return fn(*args, **kwargs)
            finally:
                self._on = on
        return run

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        from .. import kernels

        kernels.KERNEL_OBSERVERS.append(self._kernel)
        # DTensor derives an op's output shape by running it once on fake
        # tensors of the global shapes (the first time it meets those
        # shapes): that is not rank 0's program, so none of it is counted
        self._shadow = ShardingPropagator._propagate_tensor_meta_non_cached
        ShardingPropagator._propagate_tensor_meta_non_cached = (
            self._unmetered(self._shadow))
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        from .. import kernels

        kernels.KERNEL_OBSERVERS.remove(self._kernel)
        ShardingPropagator._propagate_tensor_meta_non_cached = self._shadow
        return super().__exit__(*exc)

    def collectives(self) -> dict:
        return {"bytes_by_op": dict(self.coll_bytes),
                "counts": dict(self.coll_counts),
                "total_bytes": sum(self.coll_bytes.values())}


# -- walking a bundle's argument trees --------------------------------------

def map_args(fn, args, shardings):
    """``args`` with each tensor leaf ``t`` replaced by ``fn(t, sharding)``
    (``shardings`` a tree of the same structure); a ``ParamTree`` comes
    back as a ``ParamTree`` whose parameters require gradients as
    ``args``' did."""
    from ..models.common import ParamTree

    if isinstance(args, ParamTree):
        leaves = list(args.parameters())
        rg = bool(leaves) and leaves[0].requires_grad
        return ParamTree(map_args(fn, args.tree(lambda p: p), shardings),
                         requires_grad=rg)
    if isinstance(args, dict):
        return {k: map_args(fn, v, shardings[k]) for k, v in args.items()}
    if isinstance(args, (list, tuple)):
        return type(args)(map_args(fn, v, shardings[i])
                          for i, v in enumerate(args))
    if isinstance(args, torch.Tensor):
        return fn(args, shardings)
    return args


def flat_leaves(tree, path: str = "") -> list:
    """``(key path, leaf)`` of every leaf of ``tree`` (dicts, lists,
    tuples and ``ParamTree``s), the key path written as JAX's
    ``keystr``: ``[0]['params']['blocks'][3]['attn']['wq']``."""
    from ..models.common import ParamTree

    if isinstance(tree, ParamTree):
        tree = tree.tree(lambda p: p)
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in flat_leaves(v, f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in flat_leaves(v, f"{path}[{i}]")]
    return [(path, tree)]


def leaves(tree) -> list:
    """The tensor leaves of a step's inputs or outputs, each ``DTensor``
    as its local tensor."""
    return [t.to_local() if hasattr(t, "to_local") else t
            for _, t in flat_leaves(tree) if isinstance(t, torch.Tensor)]


def place(local: torch.Tensor, sharding, shape) -> torch.Tensor:
    """``local`` (rank 0's shard) as a ``DTensor`` of global ``shape``
    placed as ``sharding`` says."""
    from torch.distributed.tensor import DTensor

    shape = torch.Size(shape)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, sharding.mesh, sharding.placements,
                              run_check=False, shape=shape, stride=stride)


def run_metered(fn, args, device, donate=()) -> tuple:
    """``fn(*args)`` under a ``StepMeter`` on ``device`` (``args``' local
    tensors held as live from the start): ``(outputs, record)``, the
    record's keys the JAX dry-run's (``memory``, ``flops_per_device``,
    ``bytes_accessed_per_device``, ``collectives``) and ``peak_bytes``,
    the step's most live bytes (``peak_storages`` storages live then,
    ``peak_large_storages`` of them over ``LARGE``). ``donate`` are the indices of arguments
    the step may update in place: an output sharing storage with one of
    them is an alias, as XLA's donated buffers are."""
    from ..models.common import clear_device_caches

    meter = StepMeter(device)
    arg_bytes = 0
    for t in leaves(args):
        if meter.hold(t):
            arg_bytes += t.untyped_storage().nbytes()
    donated = {id(t.untyped_storage()) for i in donate
               for t in leaves(args[i])}
    clear_device_caches()
    # tensors held in reference cycles die when the cyclic collector runs,
    # which is at no fixed point of the step: it does not run inside it
    gc.collect()
    gc.disable()
    try:
        with meter:
            out = fn(*args)
    finally:
        gc.enable()
        clear_device_caches()
    meter._on = False
    out_bytes = alias = 0
    seen = set()
    for t in leaves(out):
        key = id(t.untyped_storage())
        if t.device.type != meter.device or key in seen:
            continue
        seen.add(key)
        out_bytes += _nbytes(t)
        if key in donated:
            alias += _nbytes(t)
    temp = meter.peak - arg_bytes - out_bytes + alias
    rec = {"memory": {"output_bytes": out_bytes, "temp_bytes": temp,
                      "alias_bytes": alias},
           "peak_bytes": meter.peak, "peak_storages": meter.peak_storages,
           "peak_large_storages": meter.peak_large,
           "traced_argument_bytes": arg_bytes,
           "flops_per_device": meter.flops,
           "bytes_accessed_per_device": meter.bytes_accessed,
           "collectives": meter.collectives()}
    return out, rec


def rank_arguments(bundle, make):
    """The bundle's arguments as rank 0 holds them: ``DTensor``s over
    local shards ``make(shard shape, dtype)`` (``bundle.run_shardings``
    where the port's step takes an argument in another layout than the
    JAX bundle's), then ``bundle.trace_values`` in place of the arguments
    they name."""
    shardings = (bundle.in_shardings if bundle.run_shardings is None
                 else bundle.run_shardings)

    def one(t, s):
        local = make(s.shard_shape(tuple(t.shape)), t.dtype)
        return place(local, s, t.shape).requires_grad_(t.requires_grad)
    args = list(map_args(one, tuple(bundle.args), tuple(shardings)))
    for i, v in (bundle.trace_values or {}).items():
        args[i] = v
    return tuple(args)


def real_arguments(bundle, device, seed: int = 0):
    """``rank_arguments`` on real tensors on ``device``: floating point
    shards drawn from a seeded normal, integer ones (indices, tokens,
    counts) zero, a valid value of each."""
    gen = torch.Generator(device).manual_seed(seed)

    def make(shape, dtype):
        if dtype.is_floating_point:
            return torch.randn(shape, generator=gen, device=device).to(dtype)
        return torch.zeros(shape, dtype=dtype, device=device)
    return rank_arguments(bundle, make)


def trace_bundle(bundle, device) -> dict:
    """Trace ``bundle.fn`` as rank 0 of its mesh on fake tensors on
    ``device`` (module docstring): ``run_metered``'s record and
    ``trace_s``. An op the trace cannot run raises, as XLA's compile of
    the JAX step would fail."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    import torch.distributed._tools.fake_collectives  # noqa: F401 — c10d fakes

    t0 = time.time()
    mode = FakeTensorMode(allow_non_fake_inputs=True)

    def make(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)
    with mode:
        args = rank_arguments(bundle, make)
        _, rec = run_metered(bundle.fn, args, device, bundle.donate)
    rec["trace_s"] = round(time.time() - t0, 2)
    return rec
