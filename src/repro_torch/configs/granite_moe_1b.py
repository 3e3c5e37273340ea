"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) d_ff=512,
32 experts top-8, vocab=49155 [hf:ibm-granite/granite-3.0-1b-a400m-base]."""
from __future__ import annotations

import dataclasses
import functools

import torch

from ..models.transformer import TransformerConfig
from .base import ArchSpec, register
from .lm_common import LM_SHAPES, lm_bundle, lm_flops_info, lm_smoke

FULL = TransformerConfig(
    name="granite-moe-1b-a400m", n_layers=24, d_model=1024, n_heads=16,
    n_kv_heads=8, head_dim=64, d_ff=512, vocab_size=49155,
    act="silu", rope_theta=10_000.0,
    moe=True, n_experts=32, n_shared_experts=0, top_k=8,
    d_ff_expert=512, capacity_factor=1.25,
    dtype=torch.bfloat16, param_dtype=torch.float32,
    remat="full", grad_accum=2, fsdp=True,
    pad_heads_multiple=16,
    loss_chunk=512,
)

SMOKE = dataclasses.replace(
    FULL, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=64, vocab_size=128, n_experts=4, top_k=2, d_ff_expert=32,
    capacity_factor=2.0, dtype=torch.float32, param_dtype=torch.float32,
    remat="none", grad_accum=1)

register(ArchSpec(
    name="granite-moe-1b-a400m", family="lm", shape_names=tuple(LM_SHAPES),
    smoke=functools.partial(lm_smoke, SMOKE),
    bundle=lambda shape, mesh, multi_pod=False: lm_bundle(FULL, shape, mesh),
    flops_info=functools.partial(lm_flops_info, FULL),
    notes="32 experts / 16-way model axis = 2 experts/shard; vocab 49155 is "
          "indivisible by 16 → unembed falls back to replicated vocab dim "
          "(small model; acceptable).",
))
