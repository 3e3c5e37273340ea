"""Logical parameter axes: the annotations the models build beside their
weights.

Models annotate every parameter with a tuple of *logical* axis names
(``("embed", "q_heads", None)``), as the JAX package's models do; a
sharding policy maps those names onto a mesh. This slice of the port keeps
the annotations and splits them from the weights (``split_params``); the
policy that places them waits for the FSDP slice.
"""
from __future__ import annotations

from typing import Any


def _is_logical_axes(x: Any) -> bool:
    """A logical-axes annotation: tuple of str-or-None (possibly empty)."""
    return (isinstance(x, tuple)
            and all(a is None or isinstance(a, str) for a in x))


def _is_pair(x: Any) -> bool:
    return (isinstance(x, tuple) and len(x) == 2
            and _is_logical_axes(x[1]) and not _is_logical_axes(x))


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
