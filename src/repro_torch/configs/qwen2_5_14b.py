"""qwen2.5-14b [dense]: 48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064 — GQA with QKV bias [hf:Qwen/Qwen2.5-14B]."""
from __future__ import annotations

import dataclasses
import functools

import torch

from ..models.transformer import TransformerConfig
from .base import ArchSpec, register
from .lm_common import LM_SHAPES, lm_bundle, lm_flops_info, lm_smoke

FULL = TransformerConfig(
    name="qwen2.5-14b", n_layers=48, d_model=5120, n_heads=40,
    n_kv_heads=8, head_dim=128, d_ff=13824, vocab_size=152064,
    qkv_bias=True, act="silu", rope_theta=1_000_000.0,
    dtype=torch.bfloat16, param_dtype=torch.bfloat16,
    remat="full", grad_accum=8, fsdp=True,
    pad_heads_multiple=16,
    loss_chunk=512,
)

SMOKE = dataclasses.replace(
    FULL, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=128, dtype=torch.float32, param_dtype=torch.float32,
    remat="none", grad_accum=1)

register(ArchSpec(
    name="qwen2.5-14b", family="lm", shape_names=tuple(LM_SHAPES),
    smoke=functools.partial(lm_smoke, SMOKE),
    bundle=lambda shape, mesh, multi_pod=False: lm_bundle(FULL, shape, mesh),
    flops_info=functools.partial(lm_flops_info, FULL),
    notes="40 q-heads / 8 kv-heads are indivisible by the 16-way model axis:"
          " the baseline replicates attention weights over 'model'"
          " (FSDP-sharded over 'data'); §Perf hillclimbs padded-head TP.",
))
