"""LM transformer family of the port: ``repro.models.transformer`` for the
five in-repo architectures, served and trained on one device or sharded
over a mesh of ranks.

One implementation, config-selected variants (as in the JAX package):
* GQA attention with optional QKV bias (qwen2.5-14b, internlm2-20b)
* 5:1 local(sliding-window):global interleave + QK-norm + pre/post norms
  (gemma3-12b), laid out as super-blocks of (ratio local + 1 global)
  layers so the local layers keep window-sized ring caches
* MLA (multi-head latent attention, deepseek-v2): latent KV cache
  (kv_lora + rope per token) with weight-absorbed decode
* MoE FFN (deepseek-v2: 2 shared + 160 routed top-6, first layer dense;
  granite: 32 experts top-8): capacity-based top-k dispatch on one device
* padded heads (``pad_heads_multiple``): the weights carry the padded
  heads, the attention output is masked by ``head_mask``, and decode
  caches hold only the real kv heads (``kv_map_cache``)

The weights are a ``ParamTree`` whose names follow the JAX keys
(``embed``, ``unembed``, ``final_norm``, ``blocks`` / ``dense_layers`` /
``blocks_local`` / ``blocks_global``, ``attn.wq`` …); each layer stack is an
``nn.ModuleList`` (gemma's local stack one list per super-block). Every
weight the JAX code casts to ``cfg.dtype`` on use is stored in
``cfg.dtype`` (the same values: the cast happens once, at load); norm
scales keep ``param_dtype`` (``rmsnorm`` reads them in float32) and the
router stays float32.

Decode caches have the JAX package's layout, layer stacks leading
(``(L, B, S, Hkv, D)``; gemma's local rings ``(nb, r, B, w, Hkv, D)``;
MLA's ``ckv`` / ``krope``). ``decode_step`` writes the new token's entries
into the cache it is given, in place, and returns it; ``cache_pos`` must
be below the cache's length.

Training (``make_train_step``) keeps float32 master weights
(``init_transformer(..., trainable=True)``: ``param_dtype``, the router
float32) and casts them to the stored dtypes at the top of each
microbatch (``compute_dtypes``), a cast autograd sees, as the JAX code's
``.astype(dt)`` on use. ``cfg.remat`` wraps each layer in a checkpoint,
``cfg.loss_chunk`` computes the loss a block of positions at a time, and
``cfg.grad_accum`` splits the batch into microbatches.

Under ``mesh=`` (a ``DeviceMesh`` with a "model" axis and data axes) and
``policy=`` (a ``ShardingPolicy``), ``forward``, ``prefill``,
``decode_step`` and ``make_train_step`` take weights that are
``DTensor``s placed by the policy (``dist.sharding.distribute_tree``) and
the whole batch on every rank; each rank runs its data shard's rows. The
JAX package leaves the collectives to GSPMD and ``shard_map``; here they
are written out (``dist.collectives``, ``dist.mesh_view.MeshView``):

* FSDP: a weight's ``embed``/``table_rows`` dimension, sharded over the
  data axis, is all-gathered where it is used and its gradient
  reduce-scattered;
* tensor parallel: q/kv heads, ``mlp`` and ``vocab`` sharded over
  "model" (column-parallel projections, then the output projection's and
  FFN down projection's sum over "model"; the embedding and the loss over
  a vocabulary shard), where the dimension divides; where it does not,
  the policy replicated it and the block runs as on one device;
* expert parallel MoE: every model rank routes its data shard's tokens
  and dispatches them to its own E/n_model experts (``_dispatch``'s
  ``e_start``), the outputs summed over "model";
* the decode cache: batch over the data axes and, past ``SEQ_SHARD_MIN``
  positions, the sequence over "model", which decode attends split-KV;
* training: gradients placed like their weights, those of weights
  replicated over the data axes summed over them, AdamW on every rank's
  shards with the global gradient norm. The step equals the one-device
  step with ``grad_accum`` times the number of data shards (each shard's
  rows its microbatches): MoE capacity and the aux loss are each data
  shard's, and aux is averaged over them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Optional

import numpy as np
import torch
from torch.distributed import ReduceOp
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..dist.collectives import (all_gather, all_reduce, copy_to,
                                reduce_from)
from ..dist.mesh_view import MeshView
from ..dist.sharding import split_params
from ..tree import tree_map
from .common import (ParamTree, apply_rope, attend, normal, rmsnorm,
                     rope_freqs, softmax_xent, swiglu)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    qkv_bias: bool = False
    act: str = "silu"
    rope_theta: float = 1e4
    rope_theta_local: float = 1e4
    norm_eps: float = 1e-6
    embed_scale: bool = False          # gemma: x *= sqrt(d_model)
    qk_norm: bool = False
    post_norm: bool = False            # gemma3 post-attn/post-ffn RMSNorm
    attn_scale: Optional[float] = None
    # local:global interleave (gemma3): ratio local layers then 1 global
    local_global_ratio: int = 0
    local_window: int = 1024
    # MLA (deepseek-v2)
    attn_type: str = "gqa"             # 'gqa' | 'mla'
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # MoE
    moe: bool = False
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001
    # systems
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: str = "full"                # 'none' | 'full' | 'dots'
    grad_accum: int = 1
    fsdp: bool = True
    attn_chunk: int = 1024             # KV block for online-softmax attention
    loss_chunk: int = 0                # >0: blockwise vocab loss (S chunks)
    opt_state_dtype: Any = torch.float32
    # pad head counts up to a multiple (TP divisibility) — heads beyond the
    # architectural count are masked out of the attention output, so the math
    # stays exactly the configured architecture. 0 = off.
    pad_heads_multiple: int = 0

    # -- derived --------------------------------------------------------------
    def _pad(self, n: int) -> int:
        m = self.pad_heads_multiple
        return n if not m else ((n + m - 1) // m) * m

    @property
    def n_heads_p(self) -> int:
        return self._pad(self.n_heads)

    @property
    def n_kv_heads_p(self) -> int:
        return self._pad(self.n_kv_heads)

    def kv_map(self) -> np.ndarray:
        """q head → kv head index (real heads keep the real GQA grouping;
        padded q heads point at padded kv heads)."""
        group = self.n_heads // self.n_kv_heads
        m = np.arange(self.n_heads_p) // group
        extra_kv = self.n_kv_heads_p - self.n_kv_heads
        dead = np.arange(self.n_heads_p) >= self.n_heads
        if extra_kv > 0:
            m = np.where(
                dead,
                self.n_kv_heads + (np.arange(self.n_heads_p)
                                   - self.n_heads) % extra_kv,
                np.minimum(m, self.n_kv_heads - 1))
        else:
            m = np.minimum(m, self.n_kv_heads - 1)
        return m.astype(np.int32)

    def head_mask(self) -> np.ndarray:
        return (np.arange(self.n_heads_p) < self.n_heads)

    def kv_map_cache(self) -> np.ndarray:
        """q head → UNPADDED kv index (decode caches store only the real
        kv heads; dead/padded q heads map to 0 and are masked out)."""
        group = self.n_heads // self.n_kv_heads
        m = np.arange(self.n_heads_p) // group
        return np.where(np.arange(self.n_heads_p) < self.n_heads,
                        np.minimum(m, self.n_kv_heads - 1), 0
                        ).astype(np.int32)

    @property
    def n_blocks(self) -> int:
        if self.local_global_ratio:
            assert self.n_layers % (self.local_global_ratio + 1) == 0
            return self.n_layers // (self.local_global_ratio + 1)
        return self.n_layers

    def num_params(self) -> int:
        model, _ = init_abstract(self)
        return sum(p.numel() for p in model.parameters())

    def num_active_params(self) -> int:
        """Params touched per token (MoE: top_k of routed experts)."""
        total = self.num_params()
        if not self.moe:
            return total
        per_expert = (2 * self.d_model * self.d_ff_expert
                      + self.d_ff_expert * self.d_model)
        n_moe_layers = self.n_layers - self.first_dense_layers
        inactive = (self.n_experts - self.top_k) * per_expert * n_moe_layers
        return total - inactive


# =============================================================================
# Parameter construction
# =============================================================================

# weights that rmsnorm reads in float32, and the float32 router: stored as
# they are made; every other weight is stored in cfg.dtype
_KEEP_DTYPE = frozenset({"ln1", "ln2", "ln1_post", "ln2_post", "final_norm",
                         "qn", "kn", "q_norm", "kv_norm", "router"})


def compute_dtypes(cfg: TransformerConfig, tree, key: str | None = None):
    """Cast a weight tree (dicts and lists of tensors) to the dtypes the
    port stores: ``cfg.dtype``, except the norms and the router."""
    if isinstance(tree, torch.Tensor):
        return tree if key in _KEEP_DTYPE else tree.to(cfg.dtype)
    if isinstance(tree, dict):
        return {k: compute_dtypes(cfg, v, k) for k, v in tree.items()}
    return [compute_dtypes(cfg, v, key) for v in tree]


def master_dtypes(cfg: TransformerConfig, tree, key: str | None = None):
    """A copy of a weight tree in the dtypes the JAX init makes, which
    training keeps and updates in place: ``cfg.param_dtype``, the router
    float32."""
    if isinstance(tree, torch.Tensor):
        return tree.to(torch.float32 if key == "router"
                       else cfg.param_dtype, copy=True)
    if isinstance(tree, dict):
        return {k: master_dtypes(cfg, v, k) for k, v in tree.items()}
    return [master_dtypes(cfg, v, key) for v in tree]


def _dense_init(rng, shape, logical, dtype, scale=None):
    scale = scale if scale is not None else 1.0 / np.sqrt(shape[-2] if
                                                          len(shape) > 1
                                                          else shape[-1])
    return normal(rng, shape, scale, dtype), tuple(logical)


def _zeros_init(rng, shape, logical, dtype):
    device = "meta" if rng is None else rng.device
    return torch.zeros(shape, dtype=dtype, device=device), tuple(logical)


def _attn_params(cfg: TransformerConfig, rng):
    d, H = cfg.d_model, cfg.n_heads
    dt = cfg.param_dtype
    if cfg.attn_type == "mla":
        qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
        rope = cfg.qk_rope_head_dim
        nope, vd = cfg.qk_nope_head_dim, cfg.v_head_dim
        return {
            "wq_a": _dense_init(rng, (d, qr), ("embed", None), dt),
            "q_norm": _zeros_init(rng, (qr,), (None,), dt),
            "wq_b": _dense_init(rng, (qr, H, nope + rope),
                                (None, "q_heads", None), dt),
            "wkv_a": _dense_init(rng, (d, kvr + rope), ("embed", None), dt),
            "kv_norm": _zeros_init(rng, (kvr,), (None,), dt),
            "wkv_b": _dense_init(rng, (kvr, H, nope + vd),
                                 (None, "q_heads", None), dt),
            "wo": _dense_init(rng, (H, vd, d), ("q_heads", None, "embed"),
                              dt, scale=1.0 / np.sqrt(H * vd)),
        }
    dh = cfg.head_dim
    H, Hkv = cfg.n_heads_p, cfg.n_kv_heads_p
    p = {
        "wq": _dense_init(rng, (d, H, dh), ("embed", "q_heads", None), dt),
        "wk": _dense_init(rng, (d, Hkv, dh), ("embed", "kv_heads", None),
                          dt),
        "wv": _dense_init(rng, (d, Hkv, dh), ("embed", "kv_heads", None),
                          dt),
        "wo": _dense_init(rng, (H, dh, d), ("q_heads", None, "embed"), dt,
                          scale=1.0 / np.sqrt(H * dh)),
    }
    if cfg.qkv_bias:
        p["bq"] = _zeros_init(rng, (H, dh), ("q_heads", None), dt)
        p["bk"] = _zeros_init(rng, (Hkv, dh), ("kv_heads", None), dt)
        p["bv"] = _zeros_init(rng, (Hkv, dh), ("kv_heads", None), dt)
    if cfg.qk_norm:
        p["qn"] = _zeros_init(rng, (dh,), (None,), dt)
        p["kn"] = _zeros_init(rng, (dh,), (None,), dt)
    return p


def _dense_mlp_params(cfg, rng, d_ff=None):
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    dt = cfg.param_dtype
    return {
        "wg": _dense_init(rng, (d, ff), ("embed", "mlp"), dt),
        "wu": _dense_init(rng, (d, ff), ("embed", "mlp"), dt),
        "wd": _dense_init(rng, (ff, d), ("mlp", "embed"), dt),
    }


def _moe_params(cfg, rng):
    d, E, ffe = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    dt = cfg.param_dtype
    p = {
        "router": _dense_init(rng, (d, E), ("embed", None), torch.float32),
        "we_g": _dense_init(rng, (E, d, ffe), ("experts", "moe_mlp", None),
                            dt),
        "we_u": _dense_init(rng, (E, d, ffe), ("experts", "moe_mlp", None),
                            dt),
        "we_d": _dense_init(rng, (E, ffe, d), ("experts", None, "moe_mlp"),
                            dt),
    }
    if cfg.n_shared_experts:
        p["shared"] = _dense_mlp_params(
            cfg, rng, d_ff=cfg.n_shared_experts * ffe)
    return p


def _norm(cfg, rng):
    return _zeros_init(rng, (cfg.d_model,), (None,), cfg.param_dtype)


def _layer_params(cfg: TransformerConfig, rng, moe: bool):
    p = {
        "ln1": _norm(cfg, rng),
        "ln2": _norm(cfg, rng),
        "attn": _attn_params(cfg, rng),
        "mlp": _moe_params(cfg, rng) if moe else _dense_mlp_params(cfg, rng),
    }
    if cfg.post_norm:
        p["ln1_post"] = _norm(cfg, rng)
        p["ln2_post"] = _norm(cfg, rng)
    return p


def init_transformer(cfg: TransformerConfig, rng, *, trainable=False):
    """Returns (model, logical): random weights drawn from ``rng`` (a
    ``torch.Generator``) on its device, or, with ``rng=None``, shapes only
    on the meta device. ``logical`` holds each weight's logical axes in a
    tree of the model's structure. Served weights are stored in
    ``compute_dtypes``; ``trainable=True`` keeps the masters as drawn and
    makes them require gradients."""
    dt = cfg.param_dtype
    tree: dict = {
        "embed": _dense_init(rng, (cfg.vocab_size, cfg.d_model),
                             ("vocab", "embed"), dt, scale=0.02),
        "unembed": _dense_init(rng, (cfg.d_model, cfg.vocab_size),
                               ("embed", "vocab"), dt),
        "final_norm": _norm(cfg, rng),
    }
    if cfg.local_global_ratio:
        nb, r = cfg.n_blocks, cfg.local_global_ratio
        tree["blocks_local"] = [[_layer_params(cfg, rng, moe=False)
                                 for _ in range(r)] for _ in range(nb)]
        tree["blocks_global"] = [_layer_params(cfg, rng, moe=cfg.moe)
                                 for _ in range(nb)]
    else:
        n_main = cfg.n_layers - cfg.first_dense_layers
        if cfg.first_dense_layers:
            tree["dense_layers"] = [_layer_params(cfg, rng, moe=False)
                                    for _ in range(cfg.first_dense_layers)]
        tree["blocks"] = [_layer_params(cfg, rng, moe=cfg.moe)
                          for _ in range(n_main)]
    params, logical = split_params(tree)
    if trainable:
        return ParamTree(params, requires_grad=True), logical
    return ParamTree(compute_dtypes(cfg, params)), logical


def init_abstract(cfg: TransformerConfig):
    """Shapes only (meta tensors, nothing allocated): the master weights in
    the dtypes the JAX init makes (``cfg.param_dtype``, the router
    float32), as a trainable ``ParamTree``, and their logical axes — the
    dry-run's weights and ``num_params``."""
    return init_transformer(cfg, None, trainable=True)


# =============================================================================
# Forward
# =============================================================================

@functools.lru_cache(maxsize=32)
def _heads(cfg: TransformerConfig, device: torch.device):
    """kv_map, kv_map_cache and the head mask (in cfg.dtype) on ``device``,
    copied once per config and device (a copy a call would wait for the
    card at every layer)."""
    return (torch.as_tensor(cfg.kv_map(), dtype=torch.long, device=device),
            torch.as_tensor(cfg.kv_map_cache(), dtype=torch.long,
                            device=device),
            torch.as_tensor(cfg.head_mask(), device=device
                            ).to(cfg.dtype)[None, None, :, None])


def _embed(cfg: TransformerConfig, params, tokens):
    return _scale_embed(cfg, params["embed"][tokens.long()])


def _scale_embed(cfg: TransformerConfig, x):
    if cfg.embed_scale:
        # sqrt(d_model) rounded to the activation dtype, as the JAX code
        x = x * float(torch.tensor(np.sqrt(cfg.d_model), dtype=cfg.dtype))
    return x


def _gqa_attention(cfg: TransformerConfig, p, x, positions, window=None,
                   theta=None):
    """Full-sequence GQA attention (forward/prefill): causal (+optional
    sliding window) positional masking, KV-chunked online softmax. Returns
    the output and this sequence's cache entries (real kv heads only)."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.qk_norm:
        q = rmsnorm(q, p["qn"], cfg.norm_eps)
        k = rmsnorm(k, p["kn"], cfg.norm_eps)
    theta = theta if theta is not None else cfg.rope_theta
    cos, sin = rope_freqs(cfg.head_dim, theta, positions)
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    scale = cfg.attn_scale or 1.0 / np.sqrt(cfg.head_dim)
    kv_map = head_mask = None
    if cfg.pad_heads_multiple:
        kv_map, _, head_mask = _heads(cfg, x.device)
    out = attend(q, k, v, scale=scale, kv_map=kv_map, q_pos=positions,
                 k_pos=positions, window=window, chunk=cfg.attn_chunk)
    if head_mask is not None:
        out = out * head_mask
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return out, {"k": k[:, :, :cfg.n_kv_heads], "v": v[:, :, :cfg.n_kv_heads]}


def _mla_attention(cfg: TransformerConfig, p, x, positions, mask=None,
                   cache=None, cache_pos=None):
    """MLA. Without ``cache`` (forward/prefill): k/v expanded per head,
    positional causal attention. With ``cache`` (decode: dict of ckv
    (B,S,kvr) and krope (B,S,rope), written in place at ``cache_pos``):
    the weight-absorbed path, scores and values against the latent cache.
    Returns the output and this sequence's latent cache entries."""
    dt = cfg.dtype
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    kvr = cfg.kv_lora_rank
    # --- queries ---
    q_lat = torch.einsum("bsd,dr->bsr", x, p["wq_a"])
    q_lat = rmsnorm(q_lat, p["q_norm"], cfg.norm_eps)
    q = torch.einsum("bsr,rhk->bshk", q_lat, p["wq_b"])
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    cos, sin = rope_freqs(rope, cfg.rope_theta, positions)
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    q_rope = apply_rope(q_rope, cos, sin)
    # --- latent kv ---
    kv = torch.einsum("bsd,dr->bsr", x, p["wkv_a"])
    ckv = rmsnorm(kv[..., :kvr], p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(kv[:, :, None, kvr:], cos, sin)[:, :, 0, :]
    new = {"ckv": ckv, "krope": k_rope}
    scale = cfg.attn_scale or 1.0 / np.sqrt(nope + rope)
    wkv_b = p["wkv_b"]                      # (kvr, H, nope+vd)
    wk_b, wv_b = wkv_b[..., :nope], wkv_b[..., nope:]
    if cache is not None:
        s = x.shape[1]
        cache["ckv"][:, cache_pos:cache_pos + s] = ckv
        cache["krope"][:, cache_pos:cache_pos + s] = k_rope
        ckv_all, krope_all = cache["ckv"], cache["krope"]
        # decode: fold wk_b into q, attend in latent space (the MLA trick)
        q_lat2 = torch.einsum("bshn,rhn->bshr", q_nope, wk_b)
        scores = (torch.einsum("bshr,btr->bhst", q_lat2.float(),
                               ckv_all.float())
                  + torch.einsum("bshr,btr->bhst", q_rope.float(),
                                 krope_all.float())) * float(scale)
        scores = torch.where(mask[None, None], scores, -1e30)
        w = torch.softmax(scores, dim=-1).to(dt)
        o_lat = torch.einsum("bhst,btr->bshr", w, ckv_all)
        out = torch.einsum("bshr,rhv->bshv", o_lat, wv_b)
    else:
        # forward/prefill: expand k/v per head
        k_nope = torch.einsum("btr,rhn->bthn", ckv, wk_b)
        v = torch.einsum("btr,rhv->bthv", ckv, wv_b)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
            k_nope.shape[:3] + (rope,))], dim=-1)
        qfull = torch.cat([q_nope, q_rope], dim=-1)
        out = attend(qfull, k, v, mask, scale=scale, q_pos=positions,
                     k_pos=positions, chunk=cfg.attn_chunk)
    out = torch.einsum("bshv,hvd->bsd", out, p["wo"])
    return out, new


# --- FFN ---------------------------------------------------------------------

def _dense_ffn(cfg, p, x):
    g = torch.einsum("bsd,df->bsf", x, p["wg"])
    u = torch.einsum("bsd,df->bsf", x, p["wu"])
    return torch.einsum("bsf,fd->bsd", swiglu(g, u, cfg.act), p["wd"])


def _route(cfg: TransformerConfig, x, router_w):
    """Top-k routing of x (T, d): (gates (T,k), expert ids (T,k), aux).
    The router and its softmax are float32; aux is the Switch-style
    load-balance loss E · Σ_e density_e · mean_prob_e."""
    T = x.shape[0]
    E, k = cfg.n_experts, cfg.top_k
    dev = x.device
    logits = torch.einsum("td,de->te", x.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)           # (T,k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    density = torch.zeros(E, device=dev).index_add_(
        0, idx.reshape(-1), torch.ones(T * k, device=dev)) / (T * k)
    aux = E * torch.sum(density * probs.mean(0))
    return gates, idx, aux


def _dispatch(cfg: TransformerConfig, x, gates, idx, we_g, we_u, we_d,
              e_start: int = 0):
    """Capacity-based dispatch of x (T, d) to the experts ``e_start ..
    e_start + E_loc - 1`` (``we_*``: (E_loc, ...)), and their gated outputs
    summed per token: y (T, d), the sum over the local experts only.

    The capacity is ``max(8, ceil8(ceil(T·k/E·capacity_factor)))`` slots
    an expert, counted over all E experts; an assignment past it is
    dropped. Ranks within an expert come from a stable sort, so the drops
    are the JAX package's."""
    T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    E_loc = we_g.shape[0]
    C = int(np.ceil(T * k / E * cfg.capacity_factor))
    C = max(8, ((C + 7) // 8) * 8)
    dt = cfg.dtype
    dev = x.device
    e_flat = idx.reshape(-1)                            # (T*k,)
    n = T * k
    # rank of each assignment within its expert (stable, sort-based)
    order = torch.argsort(e_flat, stable=True)
    sorted_e = e_flat[order]
    pos = torch.arange(n, device=dev)
    is_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          sorted_e[1:] != sorted_e[:-1]])
    start_idx = torch.cummax(torch.where(is_start, pos, 0), dim=0).values
    rank = torch.empty_like(pos).scatter_(0, order, pos - start_idx)

    e_loc = e_flat - e_start
    ok = (e_loc >= 0) & (e_loc < E_loc) & (rank < C)
    dest = torch.where(ok, e_loc * C + rank, E_loc * C)  # sentinel row
    x_rep = torch.repeat_interleave(x, k, dim=0)        # (T*k, d)
    buf = torch.zeros((E_loc * C + 1, d), dtype=dt, device=dev).index_add_(
        0, dest, x_rep.to(dt))
    buf = buf[:E_loc * C].reshape(E_loc, C, d)

    g = torch.einsum("ecd,edf->ecf", buf, we_g)
    u = torch.einsum("ecd,edf->ecf", buf, we_u)
    h = torch.einsum("ecf,efd->ecd", swiglu(g, u, cfg.act), we_d)

    h_flat = torch.cat([h.reshape(E_loc * C, d),
                        torch.zeros((1, d), dtype=dt, device=dev)])
    vals = (h_flat[dest] * gates.reshape(-1)[:, None].to(dt)
            * ok[:, None].to(dt))
    tok = torch.arange(n, device=dev) // k
    return torch.zeros((T, d), dtype=dt, device=dev).index_add_(0, tok, vals)


def _moe_dispatch_local(cfg: TransformerConfig, x, router_w, we_g, we_u,
                        we_d, e_start: int = 0):
    """Capacity-based top-k dispatch over the experts local to this shard
    (``we_*``: (E_loc, ...), the first of them expert ``e_start``).

    x: (T, d). Returns (y (T,d), aux_loss scalar)."""
    gates, idx, aux = _route(cfg, x, router_w)
    return _dispatch(cfg, x, gates, idx, we_g, we_u, we_d, e_start), aux


def _moe_ffn(cfg: TransformerConfig, p, x):
    """MoE FFN on one device: shared experts + every routed expert."""
    y_shared = (_dense_ffn(cfg, p["shared"], x)
                if cfg.n_shared_experts else 0.0)
    y, aux = _moe_dispatch_local(cfg, x.reshape(-1, cfg.d_model),
                                 p["router"], p["we_g"], p["we_u"],
                                 p["we_d"])
    return y.reshape(x.shape).to(cfg.dtype) + y_shared, aux


def _ffn(cfg, p, h, moe: bool):
    if moe and "router" in p["mlp"]:
        return _moe_ffn(cfg, p["mlp"], h)
    return _dense_ffn(cfg, p["mlp"], h), None


# --- Tensor-parallel blocks (mesh=) ------------------------------------------
#
# Each block takes one layer's weights as DTensors and this rank's rows of
# the activations, replicated over "model". A replicated value (the block's
# input, a replicated weight) enters a sharded computation through
# ``copy_to`` (its gradient summed over "model"), and partial results leave
# through ``reduce_from`` (summed over "model"): the weights' gradients are
# then this rank's shards, and a replicated weight's the same on every
# model rank. A block whose tensor-parallel dimension did not divide over
# "model" (``spec_for`` replicated it) runs the one-device code on the
# gathered weights, repeated on every model rank.

def _kv_map_full(cfg: TransformerConfig) -> np.ndarray:
    """q head → kv head over all (padded) heads."""
    if cfg.pad_heads_multiple:
        return cfg.kv_map()
    return np.arange(cfg.n_heads) // (cfg.n_heads // cfg.n_kv_heads)


@functools.lru_cache(maxsize=64)
def _kv_fits(cfg: TransformerConfig, n_model: int) -> bool:
    """Whether every rank's real q heads read kv heads of its own shard
    when both shard over ``n_model`` ranks (padded heads are masked out
    and may read any)."""
    hp, kp = cfg.n_heads_p, cfg.n_kv_heads_p
    if hp % n_model or kp % n_model:
        return False
    full, real = _kv_map_full(cfg), cfg.head_mask()
    hl, kl = hp // n_model, kp // n_model
    return all(((full[r * hl:(r + 1) * hl] // kl == r)
                | ~real[r * hl:(r + 1) * hl]).all() for r in range(n_model))


@functools.lru_cache(maxsize=64)
def _local_heads(cfg: TransformerConfig, n_model: int, rank: int,
                 kv_tp: bool, device: torch.device):
    """(kv_map or None, head mask or None) of this rank's q heads: q head
    i of the rank reads kv head kv_map[i] of its k/v (its own kv heads
    when they are sharded too, else all of them; a padded head, masked
    out, reads the first); None where the one-device grouping of q heads
    over kv heads holds locally."""
    hl = cfg.n_heads_p // n_model
    q0 = rank * hl
    loc = _kv_map_full(cfg)[q0:q0 + hl]
    mask = None
    if cfg.pad_heads_multiple:
        real = cfg.head_mask()[q0:q0 + hl]
        mask = torch.as_tensor(real, device=device
                               ).to(cfg.dtype)[None, None, :, None]
    if kv_tp:
        kl = cfg.n_kv_heads_p // n_model
        loc = loc - rank * kl
        if cfg.pad_heads_multiple:
            loc = np.where(real, loc, 0)
        elif (loc == np.arange(hl) // (hl // kl)).all():
            return None, mask
    return torch.as_tensor(loc, dtype=torch.long, device=device), mask


def _embed_tp(cfg: TransformerConfig, mv, params, tokens):
    """The embedding with its vocabulary sharded over "model": each rank
    looks up the tokens in its rows, the others read zero, and the sum
    over "model" is the one-device lookup."""
    w, tp = mv.weight(params["embed"], 0)
    if not tp:
        return _embed(cfg, {"embed": w}, tokens)
    t = tokens.long() - mv.model_rank * w.shape[0]
    inr = (t >= 0) & (t < w.shape[0])
    x = w[torch.where(inr, t, 0)] * inr[..., None].to(w.dtype)
    return _scale_embed(cfg, reduce_from(x, mv.model_group))


def _gqa_attention_tp(cfg: TransformerConfig, mv, p, x, positions,
                      window=None, theta=None, cache_kv=False):
    """``_gqa_attention`` with the q heads (and the kv heads, where they
    divide) sharded over "model"; the output projection's sum over heads
    is reduced over "model". With ``cache_kv`` the second result holds
    every real kv head (this sequence's cache entries)."""
    wq, tp = mv.weight(p["wq"], 1)
    if not tp:
        return _gqa_attention(cfg, mv.gathered(p), x, positions, window,
                              theta)
    grp = mv.model_group
    kv_dim = 1 if _kv_fits(cfg, mv.n_model) else None
    wk, kv_tp = mv.weight(p["wk"], kv_dim)
    wv, _ = mv.weight(p["wv"], kv_dim)
    wo, _ = mv.weight(p["wo"], 0)

    def rep(w):          # a replicated weight read inside the heads' shard
        return w if kv_tp else copy_to(w, grp)
    xm = copy_to(x, grp)
    q = torch.einsum("bsd,dhk->bshk", xm, wq)
    k = torch.einsum("bsd,dhk->bshk", xm, rep(wk))
    v = torch.einsum("bsd,dhk->bshk", xm, rep(wv))
    if cfg.qkv_bias:
        kv_dim = 0 if kv_tp else None
        q = q + mv.weight(p["bq"], 0)[0]
        k = k + rep(mv.weight(p["bk"], kv_dim)[0])
        v = v + rep(mv.weight(p["bv"], kv_dim)[0])
    if cfg.qk_norm:
        q = rmsnorm(q, copy_to(mv.weight(p["qn"])[0], grp), cfg.norm_eps)
        k = rmsnorm(k, copy_to(mv.weight(p["kn"])[0], grp), cfg.norm_eps)
    theta = theta if theta is not None else cfg.rope_theta
    cos, sin = rope_freqs(cfg.head_dim, theta, positions)
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    scale = cfg.attn_scale or 1.0 / np.sqrt(cfg.head_dim)
    kv_map, head_mask = _local_heads(cfg, mv.n_model, mv.model_rank, kv_tp,
                                     x.device)
    out = attend(q, k, v, scale=scale, kv_map=kv_map, q_pos=positions,
                 k_pos=positions, window=window, chunk=cfg.attn_chunk)
    if head_mask is not None:
        out = out * head_mask
    out = reduce_from(torch.einsum("bshk,hkd->bsd", out, wo), grp)
    kv = None
    if cache_kv:
        k, v = k.detach(), v.detach()
        if kv_tp:
            k, v = all_gather(k, 2, grp), all_gather(v, 2, grp)
        kv = {"k": k[:, :, :cfg.n_kv_heads], "v": v[:, :, :cfg.n_kv_heads]}
    return out, kv


def _mla_attention_tp(cfg: TransformerConfig, mv, p, x, positions):
    """``_mla_attention`` (forward/prefill) with the heads sharded over
    "model": the latent queries and keys, computed on every model rank,
    enter the heads' shard through ``copy_to``."""
    wq_b, tp = mv.weight(p["wq_b"], 1)
    if not tp:
        return _mla_attention(cfg, mv.gathered(p), x, positions)
    grp = mv.model_group
    w = {k: mv.weight(p[k])[0]
         for k in ("wq_a", "q_norm", "wkv_a", "kv_norm")}
    wkv_b, _ = mv.weight(p["wkv_b"], 1)
    wo, _ = mv.weight(p["wo"], 0)
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    kvr = cfg.kv_lora_rank
    q_lat = rmsnorm(torch.einsum("bsd,dr->bsr", x, w["wq_a"]), w["q_norm"],
                    cfg.norm_eps)
    q = torch.einsum("bsr,rhk->bshk", copy_to(q_lat, grp), wq_b)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    cos, sin = rope_freqs(rope, cfg.rope_theta, positions)
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    q_rope = apply_rope(q_rope, cos, sin)
    kv = torch.einsum("bsd,dr->bsr", x, w["wkv_a"])
    ckv = rmsnorm(kv[..., :kvr], w["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(kv[:, :, None, kvr:], cos, sin)[:, :, 0, :]
    new = {"ckv": ckv, "krope": k_rope}
    ckv_m, kr_m = copy_to(ckv, grp), copy_to(k_rope, grp)
    wk_b, wv_b = wkv_b[..., :nope], wkv_b[..., nope:]
    k_nope = torch.einsum("btr,rhn->bthn", ckv_m, wk_b)
    v = torch.einsum("btr,rhv->bthv", ckv_m, wv_b)
    k = torch.cat([k_nope, kr_m[:, :, None, :].expand(
        k_nope.shape[:3] + (rope,))], dim=-1)
    scale = cfg.attn_scale or 1.0 / np.sqrt(nope + rope)
    out = attend(torch.cat([q_nope, q_rope], dim=-1), k, v, scale=scale,
                 q_pos=positions, k_pos=positions, chunk=cfg.attn_chunk)
    return reduce_from(torch.einsum("bshv,hvd->bsd", out, wo), grp), new


def _dense_ffn_tp(cfg, mv, p, x):
    """Column-parallel gate/up, row-parallel down, summed over "model"."""
    wg, tp = mv.weight(p["wg"], 1)
    if not tp:
        return _dense_ffn(cfg, mv.gathered(p), x)
    lp = {"wg": wg, "wu": mv.weight(p["wu"], 1)[0],
          "wd": mv.weight(p["wd"], 0)[0]}
    return reduce_from(_dense_ffn(cfg, lp, copy_to(x, mv.model_group)),
                       mv.model_group)


def _moe_ffn_tp(cfg: TransformerConfig, mv, p, x):
    """MoE FFN under a mesh: shared experts tensor-parallel, routed
    experts expert-parallel. Every model rank routes all of its data
    shard's tokens (the router is replicated, so the routes and aux are the
    same on each), dispatches them to its own E/n_model experts, the first
    of them ``e_start = rank · E_loc``, and the outputs are summed over
    "model". The capacity counts this data shard's tokens."""
    y_shared = (_dense_ffn_tp(cfg, mv, p["shared"], x)
                if cfg.n_shared_experts else 0.0)
    xf = x.reshape(-1, cfg.d_model)
    gates, idx, aux = _route(cfg, xf, mv.weight(p["router"])[0])
    we_g, ep = mv.weight(p["we_g"], 0)
    if not ep:
        y = _dispatch(cfg, xf, gates, idx, we_g, mv.weight(p["we_u"])[0],
                      mv.weight(p["we_d"])[0])
    else:
        grp = mv.model_group
        y = reduce_from(_dispatch(
            cfg, copy_to(xf, grp), copy_to(gates, grp), idx, we_g,
            mv.weight(p["we_u"], 0)[0], mv.weight(p["we_d"], 0)[0],
            e_start=mv.model_rank * we_g.shape[0]), grp)
    return y.reshape(x.shape).to(cfg.dtype) + y_shared, aux


def _ffn_tp(cfg, mv, p, h, moe: bool):
    if moe and "router" in p["mlp"]:
        return _moe_ffn_tp(cfg, mv, p["mlp"], h)
    return _dense_ffn_tp(cfg, mv, p["mlp"], h), None


def _unembed_tp(mv, params, x):
    """(this rank's logits, whether they are its vocabulary shard)."""
    w, tp = mv.weight(params["unembed"], 1)
    if tp:
        x = copy_to(x, mv.model_group)
    return torch.einsum("bsd,dv->bsv", x, w), tp


# --- Layer -------------------------------------------------------------------

def _layer(cfg: TransformerConfig, p, x, positions, window=None, *,
           moe: bool, theta: float, mv=None, cache_kv=False):
    """One full-sequence layer: (x, aux or None, this layer's cache
    entries). Under a mesh (``mv``, a ``MeshView``) the blocks run
    tensor-parallel."""
    ln = (lambda k: p[k]) if mv is None else (lambda k: mv.weight(p[k])[0])
    h = rmsnorm(x, ln("ln1"), cfg.norm_eps)
    if mv is None:
        if cfg.attn_type == "mla":
            attn_out, kv = _mla_attention(cfg, p["attn"], h, positions)
        else:
            attn_out, kv = _gqa_attention(cfg, p["attn"], h, positions,
                                          window, theta)
    elif cfg.attn_type == "mla":
        attn_out, kv = _mla_attention_tp(cfg, mv, p["attn"], h, positions)
    else:
        attn_out, kv = _gqa_attention_tp(cfg, mv, p["attn"], h, positions,
                                         window, theta, cache_kv)
    if cfg.post_norm:
        attn_out = rmsnorm(attn_out, ln("ln1_post"), cfg.norm_eps)
    x = x + attn_out
    h = rmsnorm(x, ln("ln2"), cfg.norm_eps)
    ffn_out, aux = (_ffn(cfg, p, h, moe) if mv is None
                    else _ffn_tp(cfg, mv, p, h, moe))
    if cfg.post_norm:
        ffn_out = rmsnorm(ffn_out, ln("ln2_post"), cfg.norm_eps)
    return x + ffn_out, aux, kv


def _layers(cfg: TransformerConfig, params):
    """Every layer in order: (weights, moe, theta, window, cache stack,
    index in that stack)."""
    if cfg.local_global_ratio:
        for i in range(cfg.n_blocks):
            for j, lp in enumerate(params["blocks_local"][i]):
                yield (lp, False, cfg.rope_theta_local, cfg.local_window,
                       "local", (i, j))
            yield (params["blocks_global"][i], cfg.moe, cfg.rope_theta,
                   None, "global", (i,))
        return
    for i, lp in enumerate(params["dense_layers"]
                           if cfg.first_dense_layers else ()):
        yield lp, False, cfg.rope_theta, None, "dense", (i,)
    for i, lp in enumerate(params["blocks"]):
        yield lp, cfg.moe, cfg.rope_theta, None, "blocks", (i,)


# the matmuls of the aten graph under einsum: what ``remat="dots"`` saves,
# as ``jax.checkpoint_policies.checkpoint_dots`` saves every dot_general
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                   torch.ops.aten.addmm.default,
                   torch.ops.aten.baddbmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: TransformerConfig, fn):
    """``fn`` under ``cfg.remat``: as it is (``none``), saving only its
    inputs and recomputing the rest in the backward pass (``full``), or
    saving its matmul outputs too (``dots``)."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "dots":
        ctx = functools.partial(create_selective_checkpoint_contexts,
                                _save_dots)
        return functools.partial(checkpoint, fn, use_reentrant=False,
                                 context_fn=ctx)
    return functools.partial(checkpoint, fn, use_reentrant=False)


def _run(cfg: TransformerConfig, params, tokens, cache=None, *, mv=None,
         seq_lo: int = 0):
    """Embedding and every layer over the full sequence: (final hidden
    states before the norm, aux); fills ``cache`` when it is given (under
    a mesh, its positions from ``seq_lo`` on, where the cache's sequence
    is sharded). Where autograd records (training), each layer runs under
    ``_remat``, but gemma's global layers, as in the JAX code."""
    s = tokens.shape[1]
    x = (_embed(cfg, params, tokens) if mv is None
         else _embed_tp(cfg, mv, params, tokens))
    positions = torch.arange(s, device=x.device)
    aux_total = torch.zeros((), device=x.device)
    remat = cache is None and torch.is_grad_enabled()
    for lp, moe, theta, window, stack, at in _layers(cfg, params):
        def layer(x, lp=lp, moe=moe, theta=theta, window=window):
            return _layer(cfg, lp, x, positions, window, moe=moe,
                          theta=theta, mv=mv, cache_kv=cache is not None)
        if remat and stack != "global":
            layer = _remat(cfg, layer)
        x, aux, kv = layer(x)
        if aux is not None:
            aux_total = aux_total + aux
        if cache is None:
            continue
        for name, val in kv.items():
            dst = cache[stack][name][at]
            if window is None:
                # this cache's positions seq_lo .. seq_lo + len - 1
                n = min(max(s - seq_lo, 0), dst.shape[1])
                dst[:, :n] = val[:, seq_lo:seq_lo + n]
            else:
                w = dst.shape[1]        # ring size: min(window, s_max)
                if s >= w:
                    # place position p at ring slot p % w
                    slots = torch.remainder(
                        torch.arange(s - w, s, device=x.device), w)
                    dst[:, slots] = val[:, -w:]
                else:
                    dst[:, :s] = val
    return x, aux_total


def forward(cfg: TransformerConfig, params, tokens, *, mesh=None,
            policy=None, return_hidden=False):
    """tokens (B,S) int → (logits (B,S,V), aux loss).

    ``return_hidden=True`` returns the final-norm hidden states instead of
    logits: the chunked vocab loss fuses the unembedding into the loss, so
    the (B,S,V) tensor never exists.

    Under ``mesh`` (a ``DeviceMesh`` with a "model" axis and data axes;
    ``policy`` names the data axes) ``params`` are ``DTensor``s placed by
    the policy and ``tokens`` the whole batch, the same on every rank;
    each rank runs its data shard's rows. The logits come back as a
    ``DTensor`` (batch over the data axes, vocabulary over "model" where
    it divides), the hidden states likewise (replicated over "model"), and
    aux as the mean over the data shards of each one's aux (each data
    shard routes and counts capacity over its own tokens)."""
    if mesh is None:
        x, aux = _run(cfg, params, tokens)
        x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
        if return_hidden:
            return x, aux
        return torch.einsum("bsd,dv->bsv", x, params["unembed"]), aux
    mv = MeshView(mesh, policy)
    x, aux = _run(cfg, params, mv.rows(tokens), mv=mv)
    x = rmsnorm(x, mv.weight(params["final_norm"])[0], cfg.norm_eps)
    aux = mv.data_mean(aux)
    if return_hidden:
        return mv.dtensor(x), aux
    logits, tp = _unembed_tp(mv, params, x)
    return mv.dtensor(logits, 0, 2 if tp else None), aux


# =============================================================================
# KV caches, prefill, decode
# =============================================================================

# a cache sequence longer than this shards over "model" under a mesh
# (split-KV decode), as the JAX package's ``_constrain_cache`` pins it
SEQ_SHARD_MIN = 2048


def _cache_entry(cfg: TransformerConfig, lead, B, S, device,
                 seq_shard=False, seq_tp=False):
    """One layer-stack cache (zeros in cfg.dtype) and its logical axes, the
    JAX package's: batch on B; S named "batch" for single-sequence
    long-context decode (``seq_shard``), or "kv_seq" (``seq_tp``)."""
    b_l = None if seq_shard else "batch"
    s_l = "batch" if seq_shard else ("kv_seq" if seq_tp else None)
    if cfg.attn_type == "mla":
        shapes = {"ckv": lead + (B, S, cfg.kv_lora_rank),
                  "krope": lead + (B, S, cfg.qk_rope_head_dim)}
        lg = (None,) * len(lead) + (b_l, s_l, None)
    else:
        kv = lead + (B, S, cfg.n_kv_heads, cfg.head_dim)  # unpadded
        shapes = {"k": kv, "v": kv}
        lg = (None,) * len(lead) + (b_l, s_l, "kv_heads", None)
    vals = {k: torch.zeros(sh, dtype=cfg.dtype, device=device)
            for k, sh in shapes.items()}
    return vals, {k: lg for k in shapes}


def init_cache(cfg: TransformerConfig, batch: int, s_max: int, *,
               device="cuda", seq_len: int | None = None,
               seq_shard: bool = False, seq_tp: bool = False):
    """Returns (cache, logical). Layout mirrors the layer stacks;
    ``device="meta"`` gives shapes only. ``seq_len`` (default ``s_max``)
    is the length of the stacks that are not local rings: a rank's shard
    of a sequence-sharded cache. ``seq_shard`` and ``seq_tp`` name those
    stacks' sequence dimension in ``logical`` as the JAX package's
    ``init_cache`` does (the dry-run's decode layouts); the values do not
    change."""
    vals: dict = {}
    logical: dict = {}
    seq_len = s_max if seq_len is None else seq_len
    seq = {"seq_shard": seq_shard, "seq_tp": seq_tp}
    if cfg.local_global_ratio:
        nb, r = cfg.n_blocks, cfg.local_global_ratio
        w = min(cfg.local_window, s_max)
        vals["local"], logical["local"] = _cache_entry(
            cfg, (nb, r), batch, w, device)
        vals["global"], logical["global"] = _cache_entry(
            cfg, (nb,), batch, seq_len, device, **seq)
    else:
        if cfg.first_dense_layers:
            vals["dense"], logical["dense"] = _cache_entry(
                cfg, (cfg.first_dense_layers,), batch, seq_len, device,
                **seq)
        n_main = cfg.n_layers - cfg.first_dense_layers
        vals["blocks"], logical["blocks"] = _cache_entry(
            cfg, (n_main,), batch, seq_len, device, **seq)
    return vals, logical


def _decode_mask(cache_pos: int, s_max: int, device, lo: int = 0):
    """(1, s_max) mask for standard decode: positions ≤ cache_pos (the
    cache's positions starting at ``lo``)."""
    return (torch.arange(lo, lo + s_max, device=device) <= cache_pos)[None, :]


def _ring_mask_and_slotpos(cache_pos: int, window: int, device):
    """Positions stored in each ring slot + validity mask for local decode."""
    j = torch.arange(window, device=device)
    slot_pos = cache_pos - torch.remainder(cache_pos - j, window)
    return (slot_pos >= 0)[None, :], slot_pos


def _write_token(c, val, cache_pos: int, lo: int) -> None:
    """Write one token's entries at ``cache_pos`` into cache ``c`` (B, S,
    ...) holding positions ``lo .. lo + S - 1``, if it holds that one."""
    if lo <= cache_pos < lo + c.shape[1]:
        c[:, cache_pos - lo:cache_pos - lo + 1] = val


def _split_softmax(scores, group):
    """This rank's part of the softmax over the last axis of scores whose
    positions are split over ``group``: the maximum and the sum of
    exponentials are reduced over the group (split-KV decode)."""
    m = all_reduce(scores.amax(-1, keepdim=True), group, ReduceOp.MAX)
    p = torch.exp(scores - m)
    return p / all_reduce(p.sum(-1, keepdim=True), group)


def _decode_layer_gqa(cfg, p, x, cache, cache_pos: int, theta, window=None,
                      mv=None, lo=None):
    """One-token GQA decode for one layer; ring-buffer update when window.
    Writes the token's k/v into ``cache`` in place.

    Under a mesh the projections run on this rank's heads and the new
    token's q/k/v are gathered over "model"; a cache whose sequence is
    sharded over "model" (``lo``: its first position) is attended split-KV,
    else every model rank attends the whole cache. The output projection
    runs on the rank's heads and is summed over "model"."""
    wo, o_tp = p["wo"], False
    if mv is None:
        w = {k: p[k] for k in ("wq", "wk", "wv", "bq", "bk", "bv", "qn",
                               "kn") if k in p}
        q_tp = kv_tp = False
    else:
        fits = _kv_fits(cfg, mv.n_model)
        fetched = {k: mv.weight(p[k], None if k[1] in "kv" and not fits
                                else 0 if k[0] == "b" else 1)
                   for k in ("wq", "wk", "wv", "bq", "bk", "bv") if k in p}
        w = {k: t for k, (t, _) in fetched.items()}
        w.update({k: mv.weight(p[k])[0] for k in ("qn", "kn") if k in p})
        q_tp, kv_tp = fetched["wq"][1], fetched["wk"][1]
        wo, o_tp = mv.weight(p["wo"], 0)
    q = torch.einsum("bsd,dhk->bshk", x, w["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, w["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, w["wv"])
    if cfg.qkv_bias:
        q = q + w["bq"]
        k = k + w["bk"]
        v = v + w["bv"]
    if cfg.qk_norm:
        q = rmsnorm(q, w["qn"], cfg.norm_eps)
        k = rmsnorm(k, w["kn"], cfg.norm_eps)
    pos = torch.arange(cache_pos, cache_pos + 1, device=x.device)
    cos, sin = rope_freqs(cfg.head_dim, theta, pos)
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if q_tp:
        q = all_gather(q, 2, mv.model_group)
    if kv_tp:
        k = all_gather(k, 2, mv.model_group)
        v = all_gather(v, 2, mv.model_group)
    k = k[:, :, :cfg.n_kv_heads]   # cache stores unpadded kv heads
    v = v[:, :, :cfg.n_kv_heads]
    kc, vc = cache["k"], cache["v"]
    scale = cfg.attn_scale or 1.0 / np.sqrt(cfg.head_dim)
    kv_map = head_mask = None
    if cfg.pad_heads_multiple:
        _, kv_map, head_mask = _heads(cfg, x.device)
    if window is not None:
        slot = cache_pos % window
        kc[:, slot:slot + 1] = k
        vc[:, slot:slot + 1] = v
        mask, _ = _ring_mask_and_slotpos(cache_pos, window, x.device)
        out = attend(q, kc, vc, mask, scale=scale, kv_map=kv_map)
    elif lo is None:
        kc[:, cache_pos:cache_pos + 1] = k
        vc[:, cache_pos:cache_pos + 1] = v
        mask = _decode_mask(cache_pos, kc.shape[1], x.device)
        out = attend(q, kc, vc, mask, scale=scale, kv_map=kv_map)
    else:
        _write_token(kc, k, cache_pos, lo)
        _write_token(vc, v, cache_pos, lo)
        mask = _decode_mask(cache_pos, kc.shape[1], x.device, lo)
        out = _attend_split(q, kc, vc, mask, scale, kv_map, mv.model_group)
    if head_mask is not None:
        out = out * head_mask
    if o_tp:
        hl = wo.shape[0]
        out = out[:, :, mv.model_rank * hl:(mv.model_rank + 1) * hl]
        return all_reduce(torch.einsum("bshk,hkd->bsd", out, wo),
                          mv.model_group)
    return torch.einsum("bshk,hkd->bsd", out, wo)


def _attend_split(q, k, v, mask, scale, kv_map, group):
    """``attend`` with a dense mask (decode) over a cache whose positions
    are split over ``group``: this rank's positions through
    ``_split_softmax``, the outputs summed over the group."""
    b, s, h, d = q.shape
    if kv_map is not None:
        k, v = k[:, :, kv_map], v[:, :, kv_map]
    kh = k.shape[2]
    qg = q.reshape(b, s, kh, h // kh, d).float()
    sc = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * float(scale)
    sc = torch.where(mask[None, None, None], sc, -1e30)
    w = _split_softmax(sc, group)
    out = torch.einsum("bkgst,btkd->bskgd", w.to(v.dtype), v)
    return all_reduce(out, group).reshape(b, s, h, v.shape[-1])


def _decode_mla_tp(cfg: TransformerConfig, mv, p, x, cache, cache_pos: int,
                   lo=None):
    """One-token MLA decode under a mesh: the weight-absorbed latent path,
    the heads sharded over "model" (the token's absorbed queries gathered
    over it), split-KV over a sequence-sharded latent cache (``lo``: its
    first position), the output projection summed over "model"."""
    wq_b, tp = mv.weight(p["wq_b"], 1)
    grp = mv.model_group
    w = {k: mv.weight(p[k])[0]
         for k in ("wq_a", "q_norm", "wkv_a", "kv_norm")}
    wkv_b, _ = mv.weight(p["wkv_b"], 1)
    wo, _ = mv.weight(p["wo"], 0)
    dt = cfg.dtype
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    kvr = cfg.kv_lora_rank
    pos = torch.arange(cache_pos, cache_pos + 1, device=x.device)
    q_lat = rmsnorm(torch.einsum("bsd,dr->bsr", x, w["wq_a"]), w["q_norm"],
                    cfg.norm_eps)
    q = torch.einsum("bsr,rhk->bshk", q_lat, wq_b)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    cos, sin = rope_freqs(rope, cfg.rope_theta, pos)
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    q_rope = apply_rope(q_rope, cos, sin)
    kv = torch.einsum("bsd,dr->bsr", x, w["wkv_a"])
    ckv = rmsnorm(kv[..., :kvr], w["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(kv[:, :, None, kvr:], cos, sin)[:, :, 0, :]
    cc, kc = cache["ckv"], cache["krope"]
    _write_token(cc, ckv, cache_pos, lo or 0)
    _write_token(kc, k_rope, cache_pos, lo or 0)
    wk_b, wv_b = wkv_b[..., :nope], wkv_b[..., nope:]
    q_lat2 = torch.einsum("bshn,rhn->bshr", q_nope, wk_b)
    if tp:
        q_lat2 = all_gather(q_lat2, 2, grp)
        q_rope = all_gather(q_rope, 2, grp)
    scale = cfg.attn_scale or 1.0 / np.sqrt(nope + rope)
    scores = (torch.einsum("bshr,btr->bhst", q_lat2.float(), cc.float())
              + torch.einsum("bshr,btr->bhst", q_rope.float(),
                             kc.float())) * float(scale)
    mask = _decode_mask(cache_pos, cc.shape[1], x.device, lo or 0)
    scores = torch.where(mask[None, None], scores, -1e30)
    if lo is None:
        o_lat = torch.einsum("bhst,btr->bshr",
                             torch.softmax(scores, dim=-1).to(dt), cc)
    else:
        o_lat = all_reduce(torch.einsum(
            "bhst,btr->bshr", _split_softmax(scores, grp).to(dt), cc), grp)
    if tp:
        hl = wv_b.shape[1]
        o_lat = o_lat[:, :, mv.model_rank * hl:(mv.model_rank + 1) * hl]
    out = torch.einsum("bshr,rhv->bshv", o_lat, wv_b)
    out = torch.einsum("bshv,hvd->bsd", out, wo)
    return all_reduce(out, grp) if tp else out


def _cache_len(cache) -> int:
    entry = cache["global"] if "global" in cache else cache["blocks"]
    return next(iter(entry.values())).shape[2]


def _seq_sharded(mv, s_max: int) -> bool:
    """Whether a cache of ``s_max`` positions shards its sequence over
    "model" (where the length divides; else it is replicated)."""
    return (mv.n_model > 1 and s_max > SEQ_SHARD_MIN
            and s_max % mv.n_model == 0)


def _cache_lead(stack: str) -> int:
    return 2 if stack == "local" else 1


def decode_step(cfg: TransformerConfig, params, cache, tokens, cache_pos, *,
                mesh=None, policy=None):
    """One-token decode. tokens (B,1) int, cache_pos an int below the
    cache's length.

    Returns (logits (B,1,V), cache): the token's entries are written into
    ``cache`` in place. MLA uses the weight-absorbed latent path; gemma
    local layers use ring-buffer window caches.

    Under ``mesh``, ``params`` and ``cache`` are ``DTensor``s (the cache
    as ``prefill(..., mesh=)`` returns it), ``tokens`` the whole batch on
    every rank; the logits come back as ``forward``'s do.
    """
    cache_pos = int(cache_pos)
    if not 0 <= cache_pos < _cache_len(cache):
        raise ValueError(f"cache_pos {cache_pos} outside the cache "
                         f"(length {_cache_len(cache)})")
    mv = None if mesh is None else MeshView(mesh, policy)
    lo = {}
    if mv is not None:
        tokens = mv.rows(tokens)
        for stack, entry in cache.items():
            t = next(iter(entry.values()))
            sharded = (mv.model is not None
                       and t.placements[mv.model].is_shard())
            lo[stack] = (mv.model_rank * t.to_local().shape[
                _cache_lead(stack) + 1] if sharded else None)
        local = {stack: {n: t.to_local() for n, t in entry.items()}
                 for stack, entry in cache.items()}
    else:
        local = cache
    with contextlib.nullcontext() if mv is None else torch.no_grad():
        x = (_embed(cfg, params, tokens) if mv is None
             else _embed_tp(cfg, mv, params, tokens))
        for lp, moe, theta, window, stack, at in _layers(cfg, params):
            ln = ((lambda k: lp[k]) if mv is None
                  else (lambda k: mv.weight(lp[k])[0]))
            lcache = {name: val[at] for name, val in local[stack].items()}
            h = rmsnorm(x, ln("ln1"), cfg.norm_eps)
            if cfg.attn_type == "mla" and mv is not None:
                a = _decode_mla_tp(cfg, mv, lp["attn"], h, lcache, cache_pos,
                                   lo[stack])
            elif cfg.attn_type == "mla":
                mask = _decode_mask(cache_pos, lcache["ckv"].shape[1],
                                    x.device)
                a, _ = _mla_attention(
                    cfg, lp["attn"], h,
                    torch.arange(cache_pos, cache_pos + 1, device=x.device),
                    mask, cache=lcache, cache_pos=cache_pos)
            else:
                a = _decode_layer_gqa(
                    cfg, lp["attn"], h, lcache, cache_pos, theta,
                    window=None if window is None else lcache["k"].shape[1],
                    mv=mv, lo=lo.get(stack))
            if cfg.post_norm:
                a = rmsnorm(a, ln("ln1_post"), cfg.norm_eps)
            x = x + a
            h = rmsnorm(x, ln("ln2"), cfg.norm_eps)
            f, _ = (_ffn(cfg, lp, h, moe) if mv is None
                    else _ffn_tp(cfg, mv, lp, h, moe))
            if cfg.post_norm:
                f = rmsnorm(f, ln("ln2_post"), cfg.norm_eps)
            x = x + f
        if mv is None:
            x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
            return torch.einsum("bsd,dv->bsv", x, params["unembed"]), cache
        x = rmsnorm(x, mv.weight(params["final_norm"])[0], cfg.norm_eps)
        logits, tp = _unembed_tp(mv, params, x)
    return mv.dtensor(logits, 0, 2 if tp else None), cache


def prefill(cfg: TransformerConfig, params, tokens, s_max: int, *,
            mesh=None, policy=None, logits_last_only: bool = True):
    """Full-sequence forward that also fills decode caches of length
    ``s_max``.

    ``logits_last_only`` returns only the final position's logits (what a
    serving prefill needs) — avoids materializing the (B,S,V) tensor.

    Under ``mesh`` (see ``forward``) the cache comes back as ``DTensor``s
    in the decode layout: batch over the data axes; past ``SEQ_SHARD_MIN``
    positions (where ``s_max`` divides over "model") the sequence of every
    stack but gemma's local rings over "model", else replicated over it.
    """
    if mesh is None:
        cache, _ = init_cache(cfg, tokens.shape[0], s_max,
                              device=tokens.device)
        x, _ = _run(cfg, params, tokens, cache)
        if logits_last_only:
            x = x[:, -1:]
        x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
        return torch.einsum("bsd,dv->bsv", x, params["unembed"]), cache
    mv = MeshView(mesh, policy)
    tokens = mv.rows(tokens)
    seq = _seq_sharded(mv, s_max)
    s_loc = s_max // mv.n_model if seq else s_max
    cache, _ = init_cache(cfg, tokens.shape[0], s_max, device=tokens.device,
                          seq_len=s_loc)
    with torch.no_grad():
        x, _ = _run(cfg, params, tokens, cache, mv=mv,
                    seq_lo=mv.model_rank * s_loc if seq else 0)
        if logits_last_only:
            x = x[:, -1:]
        x = rmsnorm(x, mv.weight(params["final_norm"])[0], cfg.norm_eps)
        logits, tp = _unembed_tp(mv, params, x)
    out = {stack: {n: mv.dtensor(
        t, _cache_lead(stack),
        _cache_lead(stack) + 1 if seq and stack != "local" else None)
        for n, t in entry.items()} for stack, entry in cache.items()}
    return mv.dtensor(logits, 0, 2 if tp else None), out


# =============================================================================
# Training step
# =============================================================================

def _chunk_xent(xc, lc, unembed, v0: int = 0, group=None):
    """One block of positions: (summed next-token loss, positions counted),
    labels -100 masked. With ``group``, ``unembed`` holds this rank's
    vocabulary shard (from id ``v0``): the logsumexp and the gold logit
    are reduced over the group."""
    lg = torch.einsum("bsd,dv->bsv", xc, unembed).float()
    mask = lc >= 0
    if group is None:
        safe = torch.where(mask, lc, 0)
        logz = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1, safe[..., None].long())[..., 0]
        return ((logz - gold) * mask).sum(), mask.sum()
    m = all_reduce(lg.detach().amax(-1), group, ReduceOp.MAX)
    logz = m + torch.log(reduce_from(
        torch.exp(lg - m[..., None]).sum(-1), group))
    t = lc.long() - v0
    inr = mask & (t >= 0) & (t < lg.shape[-1])
    gold = torch.gather(lg, -1, torch.where(inr, t, 0)[..., None])[..., 0]
    gold = reduce_from(gold * inr, group)
    return ((logz - gold) * mask).sum(), mask.sum()


def _xent(cfg: TransformerConfig, x, tokens, unembed, v0=0, group=None):
    """The next-token loss of final hidden states ``x`` (B,S,d) through
    ``unembed``: (loss, or a vocabulary shard's, see ``_chunk_xent``).

    With ``cfg.loss_chunk`` the labels are shifted, padded with -100 to a
    multiple of the chunk, and each chunk's unembedding, logsumexp and
    gold gather run under their own checkpoint: the (B,S,V) logits never
    exist, in the forward or the backward pass."""
    if not cfg.loss_chunk:
        tot, cnt = _chunk_xent(x[:, :-1], tokens[:, 1:], unembed, v0, group)
        return tot / torch.clamp(cnt, min=1)
    b, s, d = x.shape
    labels = torch.cat([tokens[:, 1:].long(), torch.full(
        (b, 1), -100, dtype=torch.long, device=tokens.device)], 1)
    cs = cfg.loss_chunk
    pad = (-s) % cs
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=-100)
    tot = torch.zeros((), device=x.device)
    cnt = torch.zeros((), dtype=torch.long, device=x.device)
    for i in range(0, s + pad, cs):
        t, c = checkpoint(_chunk_xent, x[:, i:i + cs], labels[:, i:i + cs],
                          unembed, v0, group, use_reentrant=False)
        tot, cnt = tot + t, cnt + c
    return tot / torch.clamp(cnt, min=1)


def loss_fn(cfg: TransformerConfig, params, tokens, *, mv=None):
    """Next-token loss of ``tokens`` (B,S) under the weights as
    ``forward`` reads them (``compute_dtypes`` of the masters):
    (loss + router_aux_coef · aux, (loss, aux)).

    Under a mesh (``mv``, a ``MeshView``; ``tokens`` this rank's rows) the
    loss and aux are this data shard's, the loss over a vocabulary sharded
    over "model" where it divides."""
    if mv is None and not cfg.loss_chunk:
        logits, aux = forward(cfg, params, tokens)
        loss = softmax_xent(logits[:, :-1], tokens[:, 1:])
    elif mv is None:
        x, aux = forward(cfg, params, tokens, return_hidden=True)
        loss = _xent(cfg, x, tokens, params["unembed"])
    else:
        x, aux = _run(cfg, params, tokens, mv=mv)
        x = rmsnorm(x, mv.weight(params["final_norm"])[0], cfg.norm_eps)
        w, tp = mv.weight(params["unembed"], 1)
        if tp:
            loss = _xent(cfg, copy_to(x, mv.model_group), tokens, w,
                         mv.model_rank * w.shape[1], mv.model_group)
        else:
            loss = _xent(cfg, x, tokens, w)
    return loss + cfg.router_aux_coef * aux, (loss, aux)


def accumulate_grads(cfg: TransformerConfig, model: ParamTree, tokens, *,
                     mesh=None, policy=None):
    """The gradient of the loss of ``tokens`` (B,S) into each master
    weight's ``.grad``: over ``cfg.grad_accum`` microbatches of B/k rows,
    summed then divided by k. Returns (loss, aux), each the microbatches'
    mean, detached.

    Under ``mesh`` the masters are ``DTensor``s and ``tokens`` the whole
    batch: each data shard accumulates over microbatches of its own rows,
    and the gradients and (loss, aux) are the mean over the data shards,
    so the step equals the one-device step with ``grad_accum`` = data
    shards × k (each shard's rows its microbatches). Each ``.grad`` holds
    this rank's shard of the gradient, placed like its weight."""
    mv = None if mesh is None else MeshView(mesh, policy)
    if mv is not None:
        tokens = mv.rows(tokens)
    k = cfg.grad_accum
    b = tokens.shape[0]
    mbs = tokens.reshape(k, b // k, -1) if k > 1 else tokens[None]
    loss_sum = aux_sum = 0.0
    for mb in mbs:
        view = compute_dtypes(cfg, model.tree(lambda p: p))
        total, (loss, aux) = loss_fn(cfg, view, mb, mv=mv)
        (total if mv is None else total / mv.n_data).backward()
        del view, total
        loss_sum = loss_sum + loss.detach()
        aux_sum = aux_sum + aux.detach()
    if k > 1:
        with torch.no_grad():
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(k)
        loss_sum, aux_sum = loss_sum / k, aux_sum / k
    if mv is None:
        return loss_sum, aux_sum
    with torch.no_grad():
        mv.sync_grads(list(model.parameters()))
        return mv.data_mean(loss_sum), mv.data_mean(aux_sum)


def make_train_step(cfg: TransformerConfig, optimizer, *, mesh=None,
                    policy=None):
    """Builds ``train_step(state, batch) -> (state, metrics)``.

    ``state = {"params": ParamTree of trainable masters, "opt":
    optimizer state, "step": int32}``; ``batch = {"tokens": (B, S)}``.
    Gradients accumulate over ``cfg.grad_accum`` microbatches, then one
    optimizer update writes the masters in place and ``step`` goes up by
    one. Metrics: ``loss`` (the next-token loss) and ``aux_loss``.

    Under ``mesh`` (see ``accumulate_grads``) the masters are ``DTensor``s
    and the optimizer state is placed like them (``optimizer.init`` of
    the ``DTensor`` tree); the update runs on every rank's shards, with the
    global gradient norm (``optimizer.update(..., gnorm=)``)."""

    def train_step(state, batch):
        model = state["params"]
        loss, aux = accumulate_grads(cfg, model, batch["tokens"], mesh=mesh,
                                     policy=policy)
        grads = model.tree(lambda p: p.grad if p.grad is not None
                           else torch.zeros_like(p))
        if mesh is None:
            opt = optimizer.update(model.tree(), grads, state["opt"])[1]
        else:
            with torch.no_grad():
                gnorm = MeshView(mesh, policy).grad_norm(model.parameters())
                local = tree_map(lambda t: t.to_local(), {
                    "params": model.tree(lambda p: p), "grads": grads,
                    "m": state["opt"]["m"], "v": state["opt"]["v"]})
                inner = optimizer.update(
                    local["params"], local["grads"],
                    {"m": local["m"], "v": local["v"],
                     "count": state["opt"]["count"]}, gnorm=gnorm)[1]
                opt = {**state["opt"], "count": inner["count"]}
        model.zero_grad(set_to_none=True)
        new_state = {"params": model, "opt": opt, "step": state["step"] + 1}
        return new_state, {"loss": loss, "aux_loss": aux}

    return train_step
