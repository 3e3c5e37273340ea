"""deepseek-v2-236b [moe]: 60L d_model=5120 128H MLA(kv_lora=512)
d_ff_expert=1536 vocab=102400, 2 shared + 160 routed top-6
[arXiv:2405.04434]."""
from __future__ import annotations

import dataclasses
import functools

import torch

from ..models.transformer import TransformerConfig
from .base import ArchSpec, register
from .lm_common import LM_SHAPES, lm_bundle, lm_flops_info, lm_smoke

FULL = TransformerConfig(
    name="deepseek-v2-236b", n_layers=60, d_model=5120, n_heads=128,
    n_kv_heads=128, head_dim=128, d_ff=12288, vocab_size=102400,
    attn_type="mla", q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    act="silu", rope_theta=10_000.0,
    moe=True, n_experts=160, n_shared_experts=2, top_k=6,
    d_ff_expert=1536, first_dense_layers=1, capacity_factor=1.25,
    dtype=torch.bfloat16, param_dtype=torch.bfloat16,
    remat="full", grad_accum=16, fsdp=True,
    loss_chunk=512,
    opt_state_dtype=torch.bfloat16,
)

SMOKE = dataclasses.replace(
    FULL, n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=128, q_lora_rank=32, kv_lora_rank=32,
    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
    n_experts=8, n_shared_experts=2, top_k=2, d_ff_expert=32,
    first_dense_layers=1, capacity_factor=2.0,
    dtype=torch.float32, param_dtype=torch.float32, remat="none",
    grad_accum=1)

register(ArchSpec(
    name="deepseek-v2-236b", family="lm", shape_names=tuple(LM_SHAPES),
    smoke=functools.partial(lm_smoke, SMOKE),
    bundle=lambda shape, mesh, multi_pod=False: lm_bundle(FULL, shape, mesh),
    flops_info=functools.partial(lm_flops_info, FULL),
    notes="MLA latent KV cache (512+64/token/layer) with weight-absorbed "
          "decode; EP: 160 experts / 16-way model axis = 10 experts/shard, "
          "shard_map dispatch. long_500k skipped: MLA compresses cache "
          "STORAGE but attention is still dense over 524k positions.",
))
