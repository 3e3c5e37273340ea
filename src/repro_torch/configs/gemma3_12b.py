"""gemma3-12b [dense]: 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144 — 5:1 local:global interleave, 128k+ context
[hf:google/gemma-3-12b family; marked unverified upstream]."""
from __future__ import annotations

import dataclasses
import functools

import torch

from ..models.transformer import TransformerConfig
from .base import ArchSpec, register
from .lm_common import LM_SHAPES, lm_bundle, lm_flops_info, lm_smoke

FULL = TransformerConfig(
    name="gemma3-12b", n_layers=48, d_model=3840, n_heads=16,
    n_kv_heads=8, head_dim=256, d_ff=15360, vocab_size=262144,
    act="gelu", rope_theta=1_000_000.0, rope_theta_local=10_000.0,
    local_global_ratio=5, local_window=1024,
    qk_norm=True, post_norm=True, embed_scale=True,
    attn_scale=1.0 / 16.0,  # query_pre_attn_scalar = 256
    dtype=torch.bfloat16, param_dtype=torch.bfloat16,
    remat="full", grad_accum=16, fsdp=True,
    pad_heads_multiple=16,
    loss_chunk=512,
)

SMOKE = dataclasses.replace(
    FULL, n_layers=6, local_global_ratio=2, local_window=8,
    d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    vocab_size=128, dtype=torch.float32, param_dtype=torch.float32,
    remat="none", grad_accum=1)

register(ArchSpec(
    name="gemma3-12b", family="lm", shape_names=tuple(LM_SHAPES),
    smoke=functools.partial(lm_smoke, SMOKE),
    bundle=lambda shape, mesh, multi_pod=False: lm_bundle(
        FULL, shape, mesh, sub_quadratic=True),
    flops_info=functools.partial(lm_flops_info, FULL),
    notes="hybrid 5:1 local(1024-window):global — long_500k RUNS for this "
          "arch (40/48 layers keep ring-buffer window caches; only 8 "
          "global layers see the 524k cache).",
))
