"""Weights and decode caches carried between the JAX package and the port.

The JAX models' parameter trees reach this module as numpy arrays
(``jax.tree.map(np.asarray, params)``): dicts of arrays whose layer stacks
lead (``blocks/attn/wq`` of shape ``(L, d, H, dh)``; gemma's
``blocks_local`` ``(nb, r, ...)``), and DIN's MLPs as lists of ``(w, b)``
pairs. The port's modules hold one ``ParamTree`` per layer instead. bfloat16
arrays (numpy's ``bfloat16`` extension dtype) are reinterpreted bit for bit.
Imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .common import ParamTree
from .din import DINConfig
from .transformer import TransformerConfig, compute_dtypes

# the JAX layer stacks and how many leading stacking dims each has
_STACKS = {"blocks": 1, "dense_layers": 1, "blocks_global": 1,
           "blocks_local": 2}


def tensor_from_numpy(a, device) -> torch.Tensor:
    """A numpy array as a tensor on ``device``; bfloat16 by its bits."""
    a = np.require(a, requirements=["C", "W"])   # copies only if needed
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16
                                                       ).to(device)
    return torch.from_numpy(a).to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host; bfloat16 as float32 (exact)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _unstack(tree, depth: int):
    """A dict of arrays with ``depth`` leading stacking dims → nested lists
    of dicts, one per layer."""
    if depth == 0:
        return tree
    n = len(next(iter(tree_leaves(tree))))
    return [_unstack(_map(lambda a, i=i: a[i], tree), depth - 1)
            for i in range(n)]


def tree_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    else:
        yield tree


def transformer_from_numpy(cfg: TransformerConfig, tree: dict,
                           device="cuda") -> ParamTree:
    """The port's model from a JAX transformer parameter tree of numpy
    arrays, with the dtypes the port stores (see ``compute_dtypes``)."""
    params = {}
    for key, sub in tree.items():
        sub = _map(lambda a: tensor_from_numpy(a, device), sub)
        params[key] = (_unstack(sub, _STACKS[key]) if key in _STACKS
                       else sub)
    return ParamTree(compute_dtypes(cfg, params))


def din_from_numpy(cfg: DINConfig, tree: dict, device="cuda") -> ParamTree:
    """The port's DIN from a JAX DIN parameter tree of numpy arrays."""
    del cfg  # DIN keeps every weight in its param_dtype, as the JAX code

    def layers(pairs):
        return [{"w": tensor_from_numpy(w, device),
                 "b": tensor_from_numpy(b, device)} for w, b in pairs]
    return ParamTree({
        "item_table": tensor_from_numpy(tree["item_table"], device),
        "cat_table": tensor_from_numpy(tree["cat_table"], device),
        "attn": layers(tree["attn"]),
        "final": layers(tree["final"]),
    })


def cache_from_numpy(cfg: TransformerConfig, cache: dict,
                     device="cuda") -> dict:
    """A decode cache of numpy arrays (the JAX layout, which the port
    keeps) as tensors in ``cfg.dtype`` on ``device``."""
    return _map(lambda a: tensor_from_numpy(a, device).to(cfg.dtype), cache)


def cache_to_numpy(cache: dict) -> dict:
    """A decode cache as numpy arrays (bfloat16 as float32)."""
    return _map(tensor_to_numpy, cache)
