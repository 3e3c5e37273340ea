"""din [recsys]: embed_dim=18 seq_len=100 attn_mlp=80-40 mlp=200-80
target-attention [arXiv:1706.06978]."""
from __future__ import annotations

import dataclasses

from ..models import din as M

FULL = M.DINConfig()
SMOKE = dataclasses.replace(FULL, n_items=1000, n_cats=50)

DIN_SHAPES = {
    "train_batch": dict(kind="train", batch=65536, n_cands=1),
    "serve_p99": dict(kind="serve", batch=512, n_cands=1),
    "serve_bulk": dict(kind="serve", batch=262144, n_cands=1),
    "retrieval_cand": dict(kind="serve", batch=1, n_cands=1_000_000),
}
