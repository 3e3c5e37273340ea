"""AdamW on trees of tensors, the counterpart of ``repro.optim.adamw``
formula for formula.

The state has the JAX package's layout, ``{"m": tree, "v": tree, "count":
int32}``, with ``m`` and ``v`` shaped like the parameter tree (nested
dicts and lists of tensors) and stored in ``state_dtype``; the update math
is float32. ``update`` writes the new parameters and moments into the
tensors it is given (no second copy of a 1.4B-parameter state) and returns
them. Not ``torch.optim.AdamW``: that has no bf16 moment storage, and its
operations come in another order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from ..tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float | Callable[[torch.Tensor], torch.Tensor] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # bf16 moment storage halves the optimizer's memory; the update math
    # stays float32 (moments cast in, cast back out)
    state_dtype: Any = torch.float32

    def init(self, params) -> dict:
        """Zero moments shaped like ``params``, on their devices (a
        ``DTensor`` weight's moments are ``DTensor``s placed like it)."""
        def zeros(p):
            return torch.zeros_like(p, dtype=self.state_dtype,
                                    requires_grad=False)
        count = torch.zeros((), dtype=torch.int32,
                            device=next(tree_leaves(params)).device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "count": count}

    def init_abstract(self, params) -> dict:
        """``init``'s shapes and dtypes on the meta device (nothing
        allocated): the dry-run's optimizer state."""
        def meta(p):
            return torch.empty(p.shape, dtype=self.state_dtype,
                               device="meta")
        return {"m": tree_map(meta, params), "v": tree_map(meta, params),
                "count": torch.empty((), dtype=torch.int32, device="meta")}

    def state_logical(self, logical) -> dict:
        """The moments shard exactly like their weights."""
        return {"m": logical, "v": logical, "count": ()}

    @torch.no_grad()
    def update(self, params, grads, state, *, gnorm=None):
        """One AdamW step: (params, state), both written in place.

        ``gnorm``: the global norm of the gradients, when ``grads`` hold
        only this rank's shards of them (the caller reduces it over the
        mesh); by default it is the norm of ``grads``."""
        count = state["count"] + 1
        lr = self.lr(count) if callable(self.lr) else self.lr
        leaves = list(zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["m"]), tree_leaves(state["v"])))
        scale = None
        if self.grad_clip:
            if gnorm is None:
                gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                       for _, g, _, _ in leaves))
            scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
        c1 = 1 - torch.pow(torch.tensor(self.b1, device=count.device),
                           count.float())
        c2 = 1 - torch.pow(torch.tensor(self.b2, device=count.device),
                           count.float())
        for p, g, m, v in leaves:
            g = g.float() if scale is None else g.float() * scale
            m.copy_(self.b1 * m.float() + (1 - self.b1) * g)
            v.copy_(self.b2 * v.float() + (1 - self.b2) * g * g)
            step = (m.float() / c1) / (torch.sqrt(v.float() / c2) + self.eps)
            step = step + self.weight_decay * p.float()
            p.copy_(p.float() - lr * step)
        state["count"] = count
        return params, state


def cosine_schedule(peak: float, warmup: int, total: int, floor: float = 0.1):
    """Linear warmup to ``peak`` over ``warmup`` counts, then a cosine down
    to ``floor`` × ``peak`` at ``total``: a function of the int32 count
    giving a float32 0-d tensor."""
    def lr(count):
        c = count.float()
        warm = peak * c / max(warmup, 1)
        frac = torch.clamp((c - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak * (floor + (1 - floor) * 0.5
                      * (1 + torch.cos(math.pi * frac)))
        return torch.where(c < warmup, warm, cos)
    return lr
