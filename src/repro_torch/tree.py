"""Trees of tensors or arrays (nested dicts, lists and tuples): the
leaves in ``jax.tree.leaves`` order (dict keys sorted) and a map over
them, as the port's models, optimizer and converters nest their weights
and states."""
from __future__ import annotations


def tree_leaves(tree):
    """The leaves of ``tree``, dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def tree_map(fn, tree):
    """``tree`` with each leaf mapped by ``fn`` (tuples become lists)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)
