"""Shared model building blocks (plain torch on tensors).

The counterpart of ``repro.models.common``, op for op: norms, RoPE and the
softmax run in float32 whatever the activation dtype, and attention scores
are float32 products of float32 operands (the JAX code's
``preferred_element_type=jnp.float32``).

``ParamTree`` holds a model's weights as ``nn.Module``s whose names follow
the JAX parameter tree's keys: a dict becomes a module, a list an
``nn.ModuleList``, a tensor a parameter; ``p["wq"]`` reads one.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F


class ParamTree(nn.Module):
    """A nested dict of tensors as modules (see the module docstring).

    Parameters do not require gradients: this slice of the port serves.
    """

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, torch.Tensor):
                self.register_parameter(
                    k, nn.Parameter(v, requires_grad=False))
            else:
                self.add_module(k, _as_module(v))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules

    def tree(self) -> dict:
        """The weights as the nested dict (and lists) they came from."""
        out: dict = {k: p.data for k, p in self._parameters.items()}
        out.update({k: _as_tree(m) for k, m in self._modules.items()})
        return out


def _as_module(v):
    if isinstance(v, dict):
        return ParamTree(v)
    if isinstance(v, (list, tuple)):
        return nn.ModuleList(_as_module(x) for x in v)
    raise TypeError(f"cannot hold {type(v)} in a ParamTree")


def _as_tree(m):
    if isinstance(m, ParamTree):
        return m.tree()
    return [_as_tree(x) for x in m]


def normal(rng, shape, scale, dtype):
    """``scale`` × a standard normal draw from generator ``rng`` (on its
    device), cast to ``dtype``; ``rng=None`` gives an empty tensor on the
    meta device (shapes only)."""
    if rng is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    return (scale * torch.randn(shape, generator=rng, device=rng.device)
            ).to(dtype)


def rmsnorm(x, weight, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + weight.float())).to(dt)


@functools.lru_cache(maxsize=64)
def _inv_freq(head_dim: int, theta: float, device: torch.device):
    """The inverse frequencies, computed in float64 numpy and used in
    float32 (as the JAX package does with 64-bit mode off), copied to the
    device once: a copy a call would wait for the card at every layer."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim // 2) * 2.0 / head_dim))
    return torch.as_tensor(inv.astype(np.float32), device=device)


def rope_freqs(head_dim: int, theta: float, positions):
    """positions: (...,) int tensor → cos/sin of shape (..., head_dim//2)."""
    ang = positions[..., None].float() * _inv_freq(head_dim, theta,
                                                   positions.device)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (..., head_dim); cos/sin broadcastable to (..., head_dim//2).

    Rotates pairs (x[..., :h], x[..., h:]) — the 'split-half' convention.
    """
    half = x.shape[-1] // 2
    cos, sin = cos.float(), sin.float()
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin],
                     dim=-1).to(x.dtype)


def swiglu(gate, up, act: str = "silu"):
    if act == "silu":
        return F.silu(gate.float()).to(gate.dtype) * up
    if act == "gelu":
        return F.gelu(gate.float(), approximate="tanh").to(gate.dtype) * up
    raise ValueError(act)


def softmax_xent(logits, labels, z_loss: float = 0.0):
    """Cross entropy, fp32 reduction; labels -100 are masked."""
    logits = logits.float()
    mask = labels >= 0
    safe = torch.where(mask, labels, 0)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None].long())[..., 0]
    nll = (logz - gold) * mask
    if z_loss:
        nll = nll + z_loss * (logz ** 2) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1)


def causal_mask(q_pos, k_pos, window: int | None = None):
    """True where attention allowed. q_pos/k_pos: int tensors."""
    ok = k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        ok &= k_pos[None, :] > q_pos[:, None] - window
    return ok


def attend(q, k, v, mask=None, scale: float | None = None, kv_map=None,
           *, q_pos=None, k_pos=None, window: int | None = None,
           chunk: int | None = None):
    """Attention with optional KV-chunked online softmax (flash-style).

    q: (B,S,H,D), k/v: (B,T,Hkv,D[v]). Masking: either a dense ``mask``
    ((S,T) or (B,S,T) bool — small decode masks), or positional causal
    masking from ``q_pos``/``k_pos`` (+ sliding ``window``) — the positional
    form is what the chunked path uses so the (S,T) mask is NEVER
    materialized. ``kv_map`` (H,) int tensor gathers k/v per q-head
    (padded-head TP). ``chunk``: KV block size for the online softmax;
    None = dense. Scores and the softmax are float32; the probabilities
    are cast to ``v.dtype`` for the product with ``v``.
    """
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    scale = float(scale if scale is not None else 1.0 / np.sqrt(d))

    if kv_map is not None:
        k = k[:, :, kv_map]
        v = v[:, :, kv_map]
        group = 1
        kh = h
    else:
        group = h // hkv
        kh = hkv

    qg = q.reshape(b, s, kh, group, d).float()

    def block_scores(k_blk):
        return torch.einsum("bskgd,btkd->bkgst", qg, k_blk.float()) * scale

    def block_mask(kp):
        m = kp[None, :] <= q_pos[:, None]
        if window is not None:
            m &= kp[None, :] > q_pos[:, None] - window
        return m  # (S, T_blk)

    use_chunks = (chunk is not None and mask is None and t >= 2 * chunk
                  and t % chunk == 0)
    if not use_chunks:
        scores = block_scores(k)
        if mask is None:
            mask = block_mask(k_pos)
        mask_b = mask[None, None, None] if mask.ndim == 2 \
            else mask[:, None, None]
        scores = torch.where(mask_b, scores, -1e30)
        w = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgst,btkd->bskgd", w.to(v.dtype), v)
        return out.reshape(b, s, h, v.shape[-1])

    # ---- online softmax over KV chunks (never materializes S×T) ----
    dv = v.shape[-1]
    m_run = torch.full((b, kh, group, s), -1e30, device=q.device)
    l_run = torch.zeros((b, kh, group, s), device=q.device)
    acc = torch.zeros((b, s, kh, group, dv), device=q.device)
    for i in range(0, t, chunk):
        sc = block_scores(k[:, i:i + chunk])               # (b,kh,g,s,chunk)
        msk = block_mask(k_pos[i:i + chunk])[None, None, None]
        sc = torch.where(msk, sc, -1e30)
        m_new = torch.maximum(m_run, sc.amax(dim=-1))
        corr = torch.exp(m_run - m_new)
        p = torch.exp(sc - m_new[..., None])
        l_run = l_run * corr + p.sum(-1)
        pv = torch.einsum("bkgst,btkd->bskgd", p.to(v.dtype),
                          v[:, i:i + chunk])
        acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
        m_run = m_new
    out = acc / torch.clamp(l_run, min=1e-30).permute(0, 3, 1, 2)[..., None]
    return out.to(v.dtype).reshape(b, s, h, dv)
