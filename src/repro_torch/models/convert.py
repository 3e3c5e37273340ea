"""Weights, decode caches and train states carried between the JAX package
and the port.

The JAX models' parameter trees reach this module as numpy arrays
(``jax.tree.map(np.asarray, params)``): dicts of arrays whose layer stacks
lead (``blocks/attn/wq`` of shape ``(L, d, H, dh)``; gemma's
``blocks_local`` ``(nb, r, ...)``), and DIN's MLPs as lists of ``(w, b)``
pairs. The port's modules hold one ``ParamTree`` per layer instead. bfloat16
arrays (numpy's ``bfloat16`` extension dtype) are reinterpreted bit for bit.
A train state, ``{"params", "opt": {"m", "v", "count"}, "step"}``, goes to
numpy in the JAX layout, so that either package's ``CheckpointManager``
writes the same keys and a checkpoint resumes in the other. The GNNs keep
the JAX layer stacks (``gnn_from_numpy``). Imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from ..tree import tree_leaves, tree_map
from .common import ParamTree
from .din import DINConfig
from .transformer import TransformerConfig, compute_dtypes, master_dtypes

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


def _unstack(tree, depth: int):
    """A dict of arrays with ``depth`` leading stacking dims → nested lists
    of dicts, one per layer."""
    if depth == 0:
        return tree
    n = len(next(iter(tree_leaves(tree))))
    return [_unstack(tree_map(lambda a, i=i: a[i], tree), depth - 1)
            for i in range(n)]


def _per_layer(tree: dict, device) -> dict:
    """A JAX transformer tree of numpy arrays as tensors on ``device``,
    each layer stack as nested lists of per-layer dicts."""
    out = {}
    for key, sub in tree.items():
        sub = tree_map(lambda a: tensor_from_numpy(a, device), sub)
        out[key] = _unstack(sub, _STACKS[key]) if key in _STACKS else sub
    return out


def _stacked(trees: list):
    """Same-structure dicts of arrays → one dict of arrays stacked on a new
    leading dim."""
    if isinstance(trees[0], dict):
        return {k: _stacked([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def _stack(layers, depth: int):
    """Nested lists ``depth`` deep of per-layer dicts → one dict of arrays
    with ``depth`` leading stacking dims (the inverse of ``_unstack``)."""
    if depth == 0:
        return layers
    return _stacked([_stack(x, depth - 1) for x in layers])


def transformer_from_numpy(cfg: TransformerConfig, tree: dict,
                           device="cuda", *, trainable=False) -> ParamTree:
    """The port's model from a JAX transformer parameter tree of numpy
    arrays, with the dtypes the port stores (see ``compute_dtypes``), or,
    ``trainable``, as master weights (``master_dtypes``, copies) that
    require gradients."""
    params = _per_layer(tree, device)
    if trainable:
        return ParamTree(master_dtypes(cfg, params), requires_grad=True)
    return ParamTree(compute_dtypes(cfg, params))


def transformer_to_numpy(cfg: TransformerConfig, tree) -> dict:
    """A port transformer tree (a ``ParamTree``, or a tree shaped like one:
    its gradients, its optimizer moments) as a JAX parameter tree of numpy
    arrays: layer stacks leading (``blocks`` (L, ...), gemma's
    ``blocks_local`` (nb, r, ...)), bfloat16 as float32."""
    del cfg  # the stacks follow from the tree's keys
    if isinstance(tree, ParamTree):
        tree = tree.tree()
    out = {}
    for key, sub in tree.items():
        sub = tree_map(tensor_to_numpy, sub)
        out[key] = _stack(sub, _STACKS[key]) if key in _STACKS else sub
    return out


def train_state_to_numpy(cfg: TransformerConfig, state: dict) -> dict:
    """A train state of ``make_train_step`` as the JAX launcher's state
    tree of numpy arrays (``count`` and ``step`` int32 scalars)."""
    opt = state["opt"]
    return {"params": transformer_to_numpy(cfg, state["params"]),
            "opt": {"m": transformer_to_numpy(cfg, opt["m"]),
                    "v": transformer_to_numpy(cfg, opt["v"]),
                    "count": np.asarray(int(opt["count"]), np.int32)},
            "step": np.asarray(int(state["step"]), np.int32)}


def train_state_from_numpy(cfg: TransformerConfig, tree: dict,
                           device="cuda",
                           state_dtype=torch.float32) -> dict:
    """A train state from the JAX launcher's state tree of numpy arrays:
    trainable master weights, the moments in ``state_dtype``, ``count`` and
    ``step`` int32 scalars, all on ``device`` and none sharing memory with
    the arrays (training writes them in place)."""
    def moments(t):
        return tree_map(lambda a: a.to(state_dtype, copy=True),
                    _per_layer(t, device))

    def scalar(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int32,
                               device=device)
    opt = tree["opt"]
    return {"params": transformer_from_numpy(cfg, tree["params"], device,
                                             trainable=True),
            "opt": {"m": moments(opt["m"]), "v": moments(opt["v"]),
                    "count": scalar(opt["count"])},
            "step": scalar(tree["step"])}


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


def gnn_from_numpy(cfg, tree: dict, device="cuda") -> ParamTree:
    """The port's GNN (gatedgcn, dimenet, equiformer-v2 or graphcast) from
    a JAX parameter tree of numpy arrays, trainable, sharing no memory
    with the arrays (training writes it in place). The layer stacks stay
    stacked (``layers/*``, ``blocks/*``, ``proc_edge``: L leading), and the
    models index them layer by layer; each MLP's list of ``(w, b)`` pairs
    becomes a list of ``{"w", "b"}`` layers."""
    del cfg  # the structure follows from the tree

    def convert(x):
        if isinstance(x, dict):
            return {k: convert(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [{"w": convert(w), "b": convert(b)} for w, b in x]
        return tensor_from_numpy(x, device).clone()
    return ParamTree(convert(tree), requires_grad=True)


def gnn_to_numpy(cfg, tree) -> dict:
    """A port GNN tree (a ``ParamTree``, or a tree shaped like one: its
    gradients, its optimizer moments) as the JAX parameter tree of numpy
    arrays (MLPs as lists of ``(w, b)`` pairs), bfloat16 as float32: the
    inverse of ``gnn_from_numpy``."""
    del cfg
    if isinstance(tree, ParamTree):
        tree = tree.tree()

    def convert(x):
        if isinstance(x, dict):
            return {k: convert(v) for k, v in x.items()}
        if isinstance(x, list):
            return [(convert(layer["w"]), convert(layer["b"]))
                    for layer in x]
        return tensor_to_numpy(x)
    return convert(tree)


def cache_from_numpy(cfg: TransformerConfig, cache: dict,
                     device="cuda") -> dict:
    """A decode cache of numpy arrays (the JAX layout, which the port
    keeps) as tensors in ``cfg.dtype`` on ``device``."""
    return tree_map(lambda a: tensor_from_numpy(a, device).to(cfg.dtype),
                    cache)


def cache_to_numpy(cache: dict) -> dict:
    """A decode cache as numpy arrays (bfloat16 as float32)."""
    return tree_map(tensor_to_numpy, cache)
