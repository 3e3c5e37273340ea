"""DIN — Deep Interest Network (arXiv:1706.06978), the port's counterpart
of ``repro.models.din``.

Target attention over the user behaviour sequence: for candidate item v and
history {e_1..e_T}, attention unit a(e_t, v) = MLP([e_t, v, e_t − v,
e_t ⊙ v]) (80→40→1 per the paper), weighted-sum pooling (NOT softmax-
normalized, per the paper), then the final 200→80 MLP over
[user_pooled, candidate, context].

Embedding substrate: row gathers from the item table (10M × 18) and the
category table, concatenated (item ⊕ category).

Shapes: serve_p99 512 / serve_bulk 262,144 scored batches; retrieval_cand
scores 1 user against many candidates with one batched product — the
attention unit broadcasts the user history against every candidate (no
loop), so it holds a (B, C, T, 4·2D) float32 tensor.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..dist.sharding import split_params
from .common import ParamTree, normal
from .gnn.common import init_mlp, mlp


@dataclasses.dataclass(frozen=True)
class DINConfig:
    name: str = "din"
    embed_dim: int = 18
    seq_len: int = 100
    n_items: int = 10_000_000
    n_cats: int = 10_000
    attn_hidden: tuple[int, ...] = (80, 40)    # attention MLP 80-40
    mlp_hidden: tuple[int, ...] = (200, 80)    # final MLP 200-80
    dtype: Any = torch.float32
    param_dtype: Any = torch.float32

    @property
    def d_item(self) -> int:
        return 2 * self.embed_dim  # item ⊕ category

    def num_params(self) -> int:
        model, _ = init_din(self, None)
        return sum(p.numel() for p in model.parameters())


def init_din(cfg: DINConfig, rng):
    """Returns (model, logical): random weights from ``rng`` (a
    ``torch.Generator``) on its device, or shapes on the meta device."""
    d = cfg.d_item

    def table(rows, dim):
        return (normal(rng, (rows, dim), 0.01, cfg.param_dtype),
                ("table_rows", None))

    tree = {
        "item_table": table(cfg.n_items, cfg.embed_dim),
        "cat_table": table(cfg.n_cats, cfg.embed_dim),
        "attn": init_mlp(rng, (4 * d,) + cfg.attn_hidden + (1,),
                         dtype=cfg.param_dtype),
        "final": init_mlp(rng, (3 * d,) + cfg.mlp_hidden + (1,),
                          dtype=cfg.param_dtype),
    }
    params, logical = split_params(tree)
    return ParamTree(params), logical


def embed_items(cfg: DINConfig, params, item_ids, cat_ids):
    """EmbeddingBag-style lookup: row gathers + concat(item, cat) → (..., 2D)."""
    dt = cfg.dtype
    # F.embedding, not an index: a DTensor step places it by hand
    # (configs/gnn_common.py::dtensor_step)
    it = F.embedding(item_ids.long(), params["item_table"]).to(dt)
    ct = F.embedding(cat_ids.long(), params["cat_table"]).to(dt)
    return torch.cat([it, ct], dim=-1)


def _attention_unit(params, hist, cand, hist_mask):
    """hist (B,T,D), cand (B,C,D) → pooled (B,C,D).

    Broadcasts candidates against the history: the (B,C,T,·) activation is
    the retrieval-scoring hot loop."""
    b, t, d = hist.shape
    c = cand.shape[1]
    h_b = hist[:, None, :, :].expand(b, c, t, d)           # (B,C,T,D)
    v_b = cand[:, :, None, :].expand(b, c, t, d)
    feats = torch.cat([h_b, v_b, h_b - v_b, h_b * v_b], dim=-1)
    w = mlp(params["attn"], feats, act=torch.sigmoid)[..., 0]  # (B,C,T)
    w = w * hist_mask[:, None, :]
    return torch.einsum("bct,btd->bcd", w, hist)          # weighted sum


def forward(cfg: DINConfig, params, batch):
    """batch: tensors hist_items/hist_cats (B,T), hist_mask (B,T),
    cand_item/cand_cat (B,C). Returns logits (B, C)."""
    hist = embed_items(cfg, params, batch["hist_items"], batch["hist_cats"])
    cand = embed_items(cfg, params, batch["cand_item"], batch["cand_cat"])
    pooled = _attention_unit(params, hist, cand,
                             batch["hist_mask"].to(hist.dtype))
    x = torch.cat([pooled, cand, pooled * cand], dim=-1)
    return mlp(params["final"], x)[..., 0]                # (B,C)


def loss_fn(cfg: DINConfig, params, batch):
    logits = forward(cfg, params, batch).float()
    labels = batch["labels"].float()                      # (B,C) clicks
    return torch.mean(
        torch.clamp(logits, min=0) - logits * labels
        + torch.log1p(torch.exp(-torch.abs(logits))))     # stable BCE


def synth_batch(cfg: DINConfig, batch: int, n_cands: int,
                rng: np.random.Generator, reduced: dict | None = None):
    """A batch of numpy arrays: the JAX package's arrays from the same
    generator."""
    n_items = (reduced or {}).get("n_items", cfg.n_items)
    n_cats = (reduced or {}).get("n_cats", cfg.n_cats)
    t = cfg.seq_len
    lens = rng.integers(1, t + 1, batch)
    mask = (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)
    return {
        "hist_items": rng.integers(0, n_items, (batch, t)).astype(np.int32),
        "hist_cats": rng.integers(0, n_cats, (batch, t)).astype(np.int32),
        "hist_mask": mask,
        "cand_item": rng.integers(0, n_items, (batch, n_cands)
                                  ).astype(np.int32),
        "cand_cat": rng.integers(0, n_cats, (batch, n_cands)
                                 ).astype(np.int32),
        "labels": rng.integers(0, 2, (batch, n_cands)).astype(np.float32),
    }


def to_device(batch: dict, device) -> dict:
    """A ``synth_batch`` batch as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
