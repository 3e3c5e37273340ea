"""Sharding policy: logical parameter axes → mesh placements.

Models annotate every parameter with a tuple of *logical* axis names
(``("embed", "q_heads", None)``), as the JAX package's models do; the
policy maps those names onto the physical mesh axes:

* tensor-parallel names (``q_heads``, ``mlp``, ``vocab``, …) → the
  ``"model"`` mesh axis,
* ``embed``/``table_rows`` → the ``"data"`` axis when FSDP is on
  (weights sharded over data-parallel workers, gathered on use),
* ``batch`` → all data axes grouped (optionally *all* axes, for pure
  data-parallel workloads like GNNs),
* anything else (or a non-divisible dimension) → replicated.

A mesh axis is never used twice within one spec; first matching
dimension wins, later ones fall back to replication.

``ShardingPolicy.spec_for`` returns the entries of the JAX package's
``PartitionSpec`` for the same inputs, as a tuple (a mesh-axis name, a
tuple of names, or ``None`` per dimension, trailing ``None``s dropped).
The DTensor half places them on a ``torch.distributed`` ``DeviceMesh``
whose dimension names are the mesh axes: ``placements_for`` turns a spec
into one placement per mesh dimension, ``shardings_for_tree`` a logical
tree into a tree of ``NamedSharding``s (the mesh and its placements), and
``distribute_tree`` a tree of weights into ``DTensor``s.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence

# Logical names that shard over the tensor-parallel ("model") axis.
MODEL_AXES = frozenset({
    "model", "mlp", "moe_mlp", "q_heads", "kv_heads", "heads", "vocab",
    "experts",
})
# Logical names that shard over the data axis under FSDP.
FSDP_AXES = frozenset({"embed", "table_rows"})


def _is_logical_axes(x: Any) -> bool:
    """A logical-axes annotation: tuple of str-or-None (possibly empty)."""
    return (isinstance(x, tuple)
            and all(a is None or isinstance(a, str) for a in x))


def _is_pair(x: Any) -> bool:
    return (isinstance(x, tuple) and len(x) == 2
            and _is_logical_axes(x[1]) and not _is_logical_axes(x))


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    mesh_axes: tuple[str, ...]
    fsdp: bool = False
    batch_over_all: bool = False

    @property
    def data_axes(self) -> tuple[str, ...]:
        """Axes used for batch/data parallelism."""
        if self.batch_over_all:
            return tuple(self.mesh_axes)
        return tuple(a for a in self.mesh_axes if a != "model")

    @property
    def model_axis(self) -> Optional[str]:
        return "model" if "model" in self.mesh_axes else None

    def _fsdp_axis(self) -> Optional[str]:
        if not self.fsdp:
            return None
        da = self.data_axes
        if not da:
            return None
        return "data" if "data" in da else da[-1]

    def spec_for(self, logical: Sequence[Optional[str]],
                 shape: Optional[Sequence[int]] = None,
                 axis_sizes: Optional[dict[str, int]] = None) -> tuple:
        """The ``PartitionSpec`` entries for one parameter.

        With ``shape`` and ``axis_sizes`` given, any dimension that does not
        divide evenly over its target mesh axes falls back to replication
        (odd head counts, vocab remainders, …).
        """
        entries: list = []
        used: set[str] = set()
        for i, name in enumerate(logical):
            cand: Any = None
            if name == "batch":
                group = tuple(a for a in self.data_axes if a not in used)
                cand = group if group else None
            elif name in MODEL_AXES:
                cand = self.model_axis
            elif name in FSDP_AXES:
                cand = self._fsdp_axis()
            if cand is not None:
                group = cand if isinstance(cand, tuple) else (cand,)
                if any(a in used for a in group):
                    cand = None
                elif shape is not None and axis_sizes is not None:
                    n = math.prod(axis_sizes[a] for a in group)
                    if n == 0 or shape[i] % n != 0:
                        cand = None
            if cand is not None:
                group = cand if isinstance(cand, tuple) else (cand,)
                used.update(group)
            entries.append(cand)
        while entries and entries[-1] is None:
            entries.pop()
        return tuple(entries)

    def shardings_for_tree(self, mesh, logical, shapes=None):
        """Map a logical-axes tree to ``NamedSharding``s on ``mesh``.

        ``shapes`` (optional): a matching tree of tensors (or anything with
        a ``shape``) enabling the divisibility fallback.
        """
        sizes = axis_sizes(mesh)

        def one(lg, s):
            shape = getattr(s, "shape", None)
            spec = self.spec_for(lg, shape,
                                 sizes if shape is not None else None)
            return NamedSharding(mesh, placements_for(spec, mesh), spec)
        return _map2(one, logical, shapes)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """Where one tensor lives: a ``DeviceMesh`` and one placement per mesh
    dimension (the counterpart of ``jax.sharding.NamedSharding``), with
    the spec it was made from."""
    mesh: Any
    placements: tuple
    spec: tuple = ()


def axis_sizes(mesh) -> dict[str, int]:
    """Mesh-axis name → its size."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def placements_for(spec: Sequence, mesh) -> tuple:
    """A spec (``spec_for``'s entries) as ``DeviceMesh`` placements: a
    tensor dimension sharded over a group of mesh axes gets ``Shard(d)``
    on each of them; every other mesh dimension is ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    out: list = [Replicate()] * mesh.ndim
    names = mesh.mesh_dim_names
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            out[names.index(axis)] = Shard(d)
    return tuple(out)


def distribute_tree(params, logical, mesh, policy: ShardingPolicy):
    """``params`` (a tree of tensors, or a ``ParamTree``) as a tree of
    ``DTensor``s placed by ``policy`` on ``mesh``.

    Every rank must hold the same full tensors (weights drawn from the same
    seed, or read from the same checkpoint): each keeps its own shard of
    its copy (``distribute_tensor(..., src_data_rank=None)``), so nothing
    is sent between ranks. The ``DTensor``s share no storage with
    ``params``.
    """
    from torch.distributed.tensor import distribute_tensor

    if hasattr(params, "tree"):
        params = params.tree()
    shardings = policy.shardings_for_tree(mesh, logical, params)

    def place(t, s):
        # a replicated tensor would keep (and alias) the caller's storage
        if all(pl.is_replicate() for pl in s.placements):
            t = t.clone()
        return distribute_tensor(t, mesh, s.placements, src_data_rank=None)
    return _map2(place, params, shardings)


def _map2(fn, a, b):
    """``fn`` over the leaves of ``a`` (logical annotations count as
    leaves) beside those of ``b`` (a tree of ``a``'s structure, or
    ``None``)."""
    if _is_logical_axes(a) or not isinstance(a, (dict, list, tuple)):
        return fn(a, b)
    if isinstance(a, dict):
        return {k: _map2(fn, v, None if b is None else b[k])
                for k, v in a.items()}
    return type(a)(_map2(fn, v, None if b is None else b[i])
                   for i, v in enumerate(a))


def split_params(tree):
    """Split a tree of ``(tensor, logical_axes)`` leaves into two trees.

    The tree is built of dicts, lists and tuples; models build one tree
    carrying both the parameter and its logical-axes annotation, and this
    separates them into structurally identical ``(params, logical)`` trees.
    """
    if _is_pair(tree):
        return tree
    if isinstance(tree, dict):
        parts = {k: split_params(v) for k, v in tree.items()}
        return ({k: p for k, (p, _) in parts.items()},
                {k: lg for k, (_, lg) in parts.items()})
    if isinstance(tree, (list, tuple)):
        parts = [split_params(v) for v in tree]
        return (type(tree)(p for p, _ in parts),
                type(tree)(lg for _, lg in parts))
    raise TypeError(f"not a (tensor, logical_axes) leaf: {type(tree)}")
