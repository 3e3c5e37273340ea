"""internlm2-20b [dense]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92544 — GQA [arXiv:2403.17297]."""
from __future__ import annotations

import dataclasses
import functools

import torch

from ..models.transformer import TransformerConfig
from .base import ArchSpec, register
from .lm_common import LM_SHAPES, lm_bundle, lm_flops_info, lm_smoke

FULL = TransformerConfig(
    name="internlm2-20b", n_layers=48, d_model=6144, n_heads=48,
    n_kv_heads=8, head_dim=128, d_ff=16384, vocab_size=92544,
    qkv_bias=False, act="silu", rope_theta=1_000_000.0,
    dtype=torch.bfloat16, param_dtype=torch.bfloat16,
    remat="full", grad_accum=8, fsdp=True,
    pad_heads_multiple=16,
    loss_chunk=512,
)

SMOKE = dataclasses.replace(
    FULL, n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=128, vocab_size=128, dtype=torch.float32, param_dtype=torch.float32,
    remat="none", grad_accum=1)

register(ArchSpec(
    name="internlm2-20b", family="lm", shape_names=tuple(LM_SHAPES),
    smoke=functools.partial(lm_smoke, SMOKE),
    bundle=lambda shape, mesh, multi_pod=False: lm_bundle(FULL, shape, mesh),
    flops_info=functools.partial(lm_flops_info, FULL),
    notes="48 q-heads divide the 16-way model axis exactly (3/shard); "
          "kv=8 falls back to replicated kv projections.",
))
