"""LM transformer family of the port: the inference half of
``repro.models.transformer`` for the five in-repo architectures.

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

Not in this slice: the train step (and remat, gradient accumulation, the
chunked loss), the mesh and sharding arguments and the expert-parallel
branch of the MoE FFN.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import numpy as np
import torch

from ..dist.sharding import split_params
from .common import (ParamTree, apply_rope, attend, normal, rmsnorm,
                     rope_freqs, swiglu)


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
        model, _ = init_transformer(self, None)
        return sum(p.numel() for p in model.parameters())


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


def init_transformer(cfg: TransformerConfig, rng):
    """Returns (model, logical): random weights drawn from ``rng`` (a
    ``torch.Generator``) on its device, or, with ``rng=None``, shapes only
    on the meta device. ``logical`` holds each weight's logical axes in a
    tree of the model's structure."""
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
    return ParamTree(compute_dtypes(cfg, params)), logical


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
    x = params["embed"][tokens.long()]
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


def _moe_dispatch_local(cfg: TransformerConfig, x, router_w, we_g, we_u,
                        we_d):
    """Capacity-based top-k dispatch over every expert (``we_*``: (E, ...)).

    x: (T, d). Returns (y (T,d), aux_loss scalar). The capacity is
    ``max(8, ceil8(ceil(T·k/E·capacity_factor)))`` slots an expert; an
    assignment past it is dropped. The router and its softmax are float32;
    ranks within an expert come from a stable sort, so the drops are the
    JAX package's.
    """
    T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = int(np.ceil(T * k / E * cfg.capacity_factor))
    C = max(8, ((C + 7) // 8) * 8)
    dt = cfg.dtype
    dev = x.device

    logits = torch.einsum("td,de->te", x.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)           # (T,k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # load-balance aux (Switch-style): E * Σ_e density_e · mean_prob_e
    e_flat = idx.reshape(-1)                            # (T*k,)
    n = T * k
    density = torch.zeros(E, device=dev).index_add_(
        0, e_flat, torch.ones(n, device=dev)) / (T * k)
    aux = E * torch.sum(density * probs.mean(0))

    # rank of each assignment within its expert (stable, sort-based)
    order = torch.argsort(e_flat, stable=True)
    sorted_e = e_flat[order]
    pos = torch.arange(n, device=dev)
    is_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          sorted_e[1:] != sorted_e[:-1]])
    start_idx = torch.cummax(torch.where(is_start, pos, 0), dim=0).values
    rank = torch.empty_like(pos).scatter_(0, order, pos - start_idx)

    ok = rank < C
    dest = torch.where(ok, e_flat * C + rank, E * C)    # sentinel row
    x_rep = torch.repeat_interleave(x, k, dim=0)        # (T*k, d)
    buf = torch.zeros((E * C + 1, d), dtype=dt, device=dev).index_add_(
        0, dest, x_rep.to(dt))
    buf = buf[:E * C].reshape(E, C, d)

    g = torch.einsum("ecd,edf->ecf", buf, we_g)
    u = torch.einsum("ecd,edf->ecf", buf, we_u)
    h = torch.einsum("ecf,efd->ecd", swiglu(g, u, cfg.act), we_d)

    h_flat = torch.cat([h.reshape(E * C, d),
                        torch.zeros((1, d), dtype=dt, device=dev)])
    vals = (h_flat[dest] * gates.reshape(-1)[:, None].to(dt)
            * ok[:, None].to(dt))
    tok = torch.arange(n, device=dev) // k
    y = torch.zeros((T, d), dtype=dt, device=dev).index_add_(0, tok, vals)
    return y, aux


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


# --- Layer -------------------------------------------------------------------

def _layer(cfg: TransformerConfig, p, x, positions, window=None, *,
           moe: bool, theta: float):
    """One full-sequence layer: (x, aux or None, this layer's cache
    entries)."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if cfg.attn_type == "mla":
        attn_out, kv = _mla_attention(cfg, p["attn"], h, positions)
    else:
        attn_out, kv = _gqa_attention(cfg, p["attn"], h, positions, window,
                                      theta)
    if cfg.post_norm:
        attn_out = rmsnorm(attn_out, p["ln1_post"], cfg.norm_eps)
    x = x + attn_out
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    ffn_out, aux = _ffn(cfg, p, h, moe)
    if cfg.post_norm:
        ffn_out = rmsnorm(ffn_out, p["ln2_post"], cfg.norm_eps)
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


def _run(cfg: TransformerConfig, params, tokens, cache=None):
    """Embedding and every layer over the full sequence: (final hidden
    states before the norm, aux); fills ``cache`` when it is given."""
    s = tokens.shape[1]
    x = _embed(cfg, params, tokens)
    positions = torch.arange(s, device=x.device)
    aux_total = torch.zeros((), device=x.device)
    for lp, moe, theta, window, stack, at in _layers(cfg, params):
        x, aux, kv = _layer(cfg, lp, x, positions, window, moe=moe,
                            theta=theta)
        if aux is not None:
            aux_total = aux_total + aux
        if cache is None:
            continue
        for name, val in kv.items():
            dst = cache[stack][name][at]
            if window is None:
                dst[:, :s] = val
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


def forward(cfg: TransformerConfig, params, tokens):
    """tokens (B,S) int → (logits (B,S,V), aux loss)."""
    x, aux = _run(cfg, params, tokens)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return torch.einsum("bsd,dv->bsv", x, params["unembed"]), aux


# =============================================================================
# KV caches, prefill, decode
# =============================================================================

def _cache_entry(cfg: TransformerConfig, lead, B, S, device):
    """One layer-stack cache (zeros in cfg.dtype) and its logical axes."""
    if cfg.attn_type == "mla":
        shapes = {"ckv": lead + (B, S, cfg.kv_lora_rank),
                  "krope": lead + (B, S, cfg.qk_rope_head_dim)}
        lg = (None,) * len(lead) + ("batch", None, None)
    else:
        kv = lead + (B, S, cfg.n_kv_heads, cfg.head_dim)  # unpadded
        shapes = {"k": kv, "v": kv}
        lg = (None,) * len(lead) + ("batch", None, "kv_heads", None)
    vals = {k: torch.zeros(sh, dtype=cfg.dtype, device=device)
            for k, sh in shapes.items()}
    return vals, {k: lg for k in shapes}


def init_cache(cfg: TransformerConfig, batch: int, s_max: int, *,
               device="cuda"):
    """Returns (cache, logical). Layout mirrors the layer stacks;
    ``device="meta"`` gives shapes only."""
    vals: dict = {}
    logical: dict = {}
    if cfg.local_global_ratio:
        nb, r = cfg.n_blocks, cfg.local_global_ratio
        w = min(cfg.local_window, s_max)
        vals["local"], logical["local"] = _cache_entry(
            cfg, (nb, r), batch, w, device)
        vals["global"], logical["global"] = _cache_entry(
            cfg, (nb,), batch, s_max, device)
    else:
        if cfg.first_dense_layers:
            vals["dense"], logical["dense"] = _cache_entry(
                cfg, (cfg.first_dense_layers,), batch, s_max, device)
        n_main = cfg.n_layers - cfg.first_dense_layers
        vals["blocks"], logical["blocks"] = _cache_entry(
            cfg, (n_main,), batch, s_max, device)
    return vals, logical


def _decode_mask(cache_pos: int, s_max: int, device):
    """(1, s_max) mask for standard decode: positions ≤ cache_pos."""
    return (torch.arange(s_max, device=device) <= cache_pos)[None, :]


def _ring_mask_and_slotpos(cache_pos: int, window: int, device):
    """Positions stored in each ring slot + validity mask for local decode."""
    j = torch.arange(window, device=device)
    slot_pos = cache_pos - torch.remainder(cache_pos - j, window)
    return (slot_pos >= 0)[None, :], slot_pos


def _decode_layer_gqa(cfg, p, x, cache, cache_pos: int, theta, window=None):
    """One-token GQA decode for one layer; ring-buffer update when window.
    Writes the token's k/v into ``cache`` in place."""
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
    pos = torch.arange(cache_pos, cache_pos + 1, device=x.device)
    cos, sin = rope_freqs(cfg.head_dim, theta, pos)
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    k = k[:, :, :cfg.n_kv_heads]   # cache stores unpadded kv heads
    v = v[:, :, :cfg.n_kv_heads]
    kc, vc = cache["k"], cache["v"]
    if window is not None:
        slot = cache_pos % window
        kc[:, slot:slot + 1] = k
        vc[:, slot:slot + 1] = v
        mask, _ = _ring_mask_and_slotpos(cache_pos, window, x.device)
    else:
        kc[:, cache_pos:cache_pos + 1] = k
        vc[:, cache_pos:cache_pos + 1] = v
        mask = _decode_mask(cache_pos, kc.shape[1], x.device)
    scale = cfg.attn_scale or 1.0 / np.sqrt(cfg.head_dim)
    kv_map = head_mask = None
    if cfg.pad_heads_multiple:
        _, kv_map, head_mask = _heads(cfg, x.device)
    out = attend(q, kc, vc, mask, scale=scale, kv_map=kv_map)
    if head_mask is not None:
        out = out * head_mask
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def _cache_len(cache) -> int:
    entry = cache["global"] if "global" in cache else cache["blocks"]
    return next(iter(entry.values())).shape[2]


def decode_step(cfg: TransformerConfig, params, cache, tokens, cache_pos):
    """One-token decode. tokens (B,1) int, cache_pos an int below the
    cache's length.

    Returns (logits (B,1,V), cache): the token's entries are written into
    ``cache`` in place. MLA uses the weight-absorbed latent path; gemma
    local layers use ring-buffer window caches.
    """
    cache_pos = int(cache_pos)
    if not 0 <= cache_pos < _cache_len(cache):
        raise ValueError(f"cache_pos {cache_pos} outside the cache "
                         f"(length {_cache_len(cache)})")
    x = _embed(cfg, params, tokens)
    for lp, moe, theta, window, stack, at in _layers(cfg, params):
        lcache = {name: val[at] for name, val in cache[stack].items()}
        h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        if cfg.attn_type == "mla":
            mask = _decode_mask(cache_pos, lcache["ckv"].shape[1], x.device)
            a, _ = _mla_attention(
                cfg, lp["attn"], h,
                torch.arange(cache_pos, cache_pos + 1, device=x.device),
                mask, cache=lcache, cache_pos=cache_pos)
        else:
            a = _decode_layer_gqa(
                cfg, lp["attn"], h, lcache, cache_pos, theta,
                window=None if window is None else lcache["k"].shape[1])
        if cfg.post_norm:
            a = rmsnorm(a, lp["ln1_post"], cfg.norm_eps)
        x = x + a
        h = rmsnorm(x, lp["ln2"], cfg.norm_eps)
        f, _ = _ffn(cfg, lp, h, moe)
        if cfg.post_norm:
            f = rmsnorm(f, lp["ln2_post"], cfg.norm_eps)
        x = x + f
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return torch.einsum("bsd,dv->bsv", x, params["unembed"]), cache


def prefill(cfg: TransformerConfig, params, tokens, s_max: int, *,
            logits_last_only: bool = True):
    """Full-sequence forward that also fills decode caches of length
    ``s_max``.

    ``logits_last_only`` returns only the final position's logits (what a
    serving prefill needs) — avoids materializing the (B,S,V) tensor."""
    cache, _ = init_cache(cfg, tokens.shape[0], s_max, device=tokens.device)
    x, _ = _run(cfg, params, tokens, cache)
    if logits_last_only:
        x = x[:, -1:]
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return torch.einsum("bsd,dv->bsv", x, params["unembed"]), cache
