"""EquiformerV2-style equivariant graph attention via eSCN SO(2) convolutions
(arXiv:2306.12059 + eSCN arXiv:2302.03655), the port's counterpart of
``repro.models.gnn.equiformer_v2``.

Core eSCN mechanism:
* node features are real-SH irreps ``x (N, (l_max+1)², C)``;
* per edge, features are rotated so the edge aligns with the SH polar axis
  (``rotation_to_axis`` + Ivanic–Ruedenberg ``wigner_stack`` — see
  wigner.py);
* in the rotated frame the equivariant tensor product reduces to an SO(2)
  convolution that is block-diagonal over m and truncated at ``m_max``
  (the O(L⁶)→O(L³) win);
* messages are attention-weighted (invariant m=0 channels → per-head logits,
  segment-softmax over incoming edges), rotated back with Dᵀ and scattered.

The per-m SO(2) weight acts separably on the degree index and the channel
index (W_l ⊗ W_c), and the S² grid activation is replaced by the scalar-gated
nonlinearity, as in the JAX code. ``forward`` runs the m-block path; the
dense ``_rotate`` / ``_so2_conv`` compute the same convolution over every
(l, m) and are what the m-block path is tested against.

Geometry (the radial basis, the edges' spherical harmonics and the Wigner
matrices) is computed in float32 and cast to the model's dtype after, at
the JAX code's points.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ...dist.sharding import split_params
from ..common import ParamTree, normal
from .common import (GraphBatch, init_mlp, label_nll, layer_of, mlp,
                     remat, scatter_sum, segment_softmax)
from .wigner import real_sh, rotation_to_axis, wigner_stack


@dataclasses.dataclass(frozen=True)
class EquiformerV2Config:
    name: str = "equiformer-v2"
    n_layers: int = 12
    d_hidden: int = 128           # channels C
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    n_rad: int = 16               # gaussian radial basis size
    d_feat: int = 16
    cutoff: float = 6.0
    n_classes: int = 1
    task: str = "graph"
    dtype: Any = torch.float32
    remat: str = "none"
    # >1: stream edges through the layer in chunks (two-pass attention) —
    # bounds the edge working set for web-scale graphs
    edge_chunks: int = 1

    @property
    def K(self) -> int:
        return (self.l_max + 1) ** 2

    def m_indices(self, m: int) -> tuple[np.ndarray, np.ndarray]:
        """Flat irrep indices of the +m and −m components for l ≥ m."""
        ls = np.arange(max(m, 0), self.l_max + 1)
        ls = ls[ls >= m]
        return (ls * ls + ls + m).astype(np.int32), \
               (ls * ls + ls - m).astype(np.int32)

    def num_params(self) -> int:
        model, _ = init_equiformer(self, None)
        return sum(p.numel() for p in model.parameters())


def _lin(rng, shape, dtype, scale_dim=None):
    logical = (None,) * len(shape)
    # parses as (scale_dim or shape[-2]) if len(shape) > 1 else shape[-1],
    # as the JAX code's: a 1-D weight ignores scale_dim
    sd = scale_dim or shape[-2] if len(shape) > 1 else shape[-1]
    return (normal(rng, shape, 1.0 / np.sqrt(sd), dtype), logical)


def init_equiformer(cfg: EquiformerV2Config, rng):
    """Returns (model, logical): trainable weights drawn from ``rng`` (a
    ``torch.Generator``) on its device, or shapes on the meta device."""
    C, L = cfg.d_hidden, cfg.n_layers
    nl0 = cfg.l_max + 1
    dt = cfg.dtype

    def so2_block(m):
        """Separable SO(2) weights for one |m| block (stacked over layers)."""
        nl = cfg.l_max - m + 1
        blk = {
            "wl_re": _lin(rng, (L, nl, nl), dt, scale_dim=nl),
            "wc_re": _lin(rng, (L, 2 * C, C), dt, scale_dim=2 * C),
        }
        if m > 0:
            blk["wl_im"] = _lin(rng, (L, nl, nl), dt, scale_dim=nl)
            blk["wc_im"] = _lin(rng, (L, 2 * C, C), dt, scale_dim=2 * C)
        return blk

    tree = {
        "embed": _lin(rng, (cfg.d_feat, C), dt),
        "edge_embed_w": _lin(rng, (cfg.n_rad, C), dt),
        "layers": {
            "so2": {f"m{m}": so2_block(m) for m in range(cfg.m_max + 1)},
            "rad_gate": init_mlp(rng, (cfg.n_rad, C, 2 * C), dtype=dt,
                                 lead=(L,), lead_logical=(None,)),
            "attn_mlp": init_mlp(rng, (nl0 * 2 * C, C, cfg.n_heads),
                                 dtype=dt, lead=(L,), lead_logical=(None,)),
            "gate_mlp": init_mlp(rng, (C, C, cfg.l_max * C), dtype=dt,
                                 lead=(L,), lead_logical=(None,)),
            "ffn0": init_mlp(rng, (C, 2 * C, C), dtype=dt, lead=(L,),
                             lead_logical=(None,)),
            "wch_l": _lin(rng, (L, cfg.l_max + 1, C, C), dt, scale_dim=C),
            "ln_scale": _lin(rng, (L, cfg.l_max + 1, C), dt, scale_dim=1),
        },
        "head": init_mlp(rng, (C, C, cfg.n_classes), dtype=dt),
    }
    params, logical = split_params(tree)
    return ParamTree(params, requires_grad=True), logical


def _gauss_rbf(d, cfg: EquiformerV2Config):
    mus = torch.linspace(0.0, cfg.cutoff, cfg.n_rad, device=d.device)
    gamma = cfg.n_rad / cfg.cutoff
    return torch.exp(-gamma * (d[:, None] - mus[None, :]) ** 2)


def _rotate(x_e, D, cfg, transpose=False):
    """x_e (E, K, C) ← blockwise D^l @ x_l (or Dᵀ)."""
    outs = []
    for l in range(cfg.l_max + 1):
        s, e = l * l, (l + 1) * (l + 1)
        eq = "eji,ejc->eic" if transpose else "eij,ejc->eic"
        outs.append(torch.einsum(eq, D[l], x_e[:, s:e, :]))
    return torch.cat(outs, dim=1)


def _l_blocks(x, l_max):
    """x (N, K, C) split along K into its degrees' blocks (N, 2l+1, C):
    views, whose gradients come back as one concatenation (each slice of
    its own would bring back a zero-filled (N, K, C) gradient)."""
    return torch.split(x, [2 * l + 1 for l in range(l_max + 1)], dim=1)


def _equiv_layernorm(x, scale, l_max):
    """RMS over each l-block (rotation-invariant norm) × learned scale."""
    outs = []
    for l, blk in enumerate(_l_blocks(x, l_max)):
        rms = torch.sqrt(torch.mean(blk ** 2, dim=(1, 2), keepdim=True)
                         + 1e-6)
        outs.append(blk / rms * (1.0 + scale[l])[None, None, :])
    return torch.cat(outs, dim=1)


def _mix(v, wl, wc):
    """The separable SO(2) weight: W_l over the degree index, then W_c over
    the channels."""
    v = torch.einsum("elc,lk->ekc", v, wl)
    return torch.einsum("ekc,cd->ekd", v, wc)


def _so2_conv(z, so2, rad_scale, cfg):
    """z (E, K, 2C) rotated edge features → (E, K, C); block-diag over m,
    truncated at m_max (components with |m| > m_max do not propagate)."""
    E = z.shape[0]
    out = z.new_zeros((E, cfg.K, cfg.d_hidden))
    for m in range(cfg.m_max + 1):
        ip, im = (torch.as_tensor(i, dtype=torch.long, device=z.device)
                  for i in cfg.m_indices(m))
        blk = so2[f"m{m}"]
        zp = z[:, ip, :] * rad_scale[:, None, :]
        if m == 0:
            out = out.index_copy(1, ip, _mix(zp, blk["wl_re"],
                                             blk["wc_re"]))
        else:
            zn = z[:, im, :] * rad_scale[:, None, :]
            yp = (_mix(zp, blk["wl_re"], blk["wc_re"])
                  - _mix(zn, blk["wl_im"], blk["wc_im"]))
            yn = (_mix(zp, blk["wl_im"], blk["wc_im"])
                  + _mix(zn, blk["wl_re"], blk["wc_re"]))
            out = out.index_copy(1, ip, yp).index_copy(1, im, yn)
    return out


def _rotate_to_mblocks(x_e, D, cfg):
    """Rotate edge features and keep ONLY |m| ≤ m_max components.

    eSCN's actual memory/compute trick: the SO(2) conv discards |m| > m_max,
    so those rotated rows are never materialized. Returns
    {m: (zp, zn)} with zp/zn (E, n_l(m), C); zn is None for m=0.
    Cost: E·C·Σ_l Σ_{|m|≤m_max}(2l+1) vs E·C·Σ_l(2l+1)² for the full rotate.
    """
    xls = _l_blocks(x_e, cfg.l_max)                  # (E, 2l+1, C) each
    out = {}
    for m in range(cfg.m_max + 1):
        zps, zns = [], []
        for l in range(m, cfg.l_max + 1):
            xl = xls[l]
            zps.append(torch.einsum("ek,ekc->ec", D[l][:, l + m, :], xl))
            if m > 0:
                zns.append(torch.einsum("ek,ekc->ec", D[l][:, l - m, :],
                                        xl))
        out[m] = (torch.stack(zps, dim=1),
                  torch.stack(zns, dim=1) if m > 0 else None)
    return out


def _so2_conv_mblocks(zblocks, so2, rad_scale, cfg):
    """SO(2) conv on m-grouped blocks: {m: (zp, zn)} → same structure."""
    out = {}
    for m in range(cfg.m_max + 1):
        blk = so2[f"m{m}"]
        zp, zn = zblocks[m]
        zp = zp * rad_scale[:, None, :]
        if m == 0:
            out[m] = (_mix(zp, blk["wl_re"], blk["wc_re"]), None)
        else:
            zn = zn * rad_scale[:, None, :]
            yp = (_mix(zp, blk["wl_re"], blk["wc_re"])
                  - _mix(zn, blk["wl_im"], blk["wc_im"]))
            yn = (_mix(zp, blk["wl_im"], blk["wc_im"])
                  + _mix(zn, blk["wl_re"], blk["wc_re"]))
            out[m] = (yp, yn)
    return out


def _scatter_back_rotated(yblocks, D, dst, n, evalid, cfg):
    """Rotate m-blocks back (Dᵀ rows) and scatter-sum to nodes, one degree l
    at a time — the (E, K, C) message tensor is never materialized."""
    # each m-block's rows (E, C) by degree, index l - m
    rows = {m: tuple(None if y is None else y.unbind(1) for y in pair)
            for m, pair in yblocks.items()}
    ev = evalid[:, None, None]
    out = []
    for l in range(cfg.l_max + 1):
        parts = []
        for m in range(0, min(l, cfg.m_max) + 1):
            yp, yn = rows[m]
            li = l - m                               # index into the stack
            contrib = torch.einsum("ek,ec->ekc", D[l][:, l + m, :], yp[li])
            if m > 0:
                contrib = contrib + torch.einsum(
                    "ek,ec->ekc", D[l][:, l - m, :], yn[li])
            parts.append(contrib)
        out_l = sum(parts) * ev                      # (E, 2l+1, C)
        out.append(scatter_sum(out_l, dst, n))
    return torch.cat(out, dim=1)


def _rotate_m0(x_e, D, cfg):
    """Only the m=0 (invariant) rotated components — the attention-logit
    input for the chunked two-pass path."""
    return torch.stack([torch.einsum("ek,ekc->ec", D[l][:, l, :], xl)
                        for l, xl in enumerate(_l_blocks(x_e, cfg.l_max))],
                       dim=1)


def forward(cfg: EquiformerV2Config, params, batch: GraphBatch):
    dt = cfg.dtype
    pos = batch.positions.float()
    src, dst, n = batch.src, batch.dst, batch.n_nodes
    vec = pos[dst] - pos[src]
    raw = torch.linalg.norm(vec, dim=-1)
    # degenerate edges (self-loops / coincident nodes) have no direction —
    # mask them out of every geometric term (keeps exact equivariance).
    evalid = (raw > 1e-6).to(dt)
    dist = torch.clamp(raw, min=0.1)
    rbf = _gauss_rbf(dist, cfg).to(dt)
    sh_e = real_sh(vec, cfg.l_max).to(dt) * evalid[:, None]
    rot = rotation_to_axis(vec)
    D = [d.to(dt) for d in wigner_stack(rot, cfg.l_max)]

    # --- embedding: scalars into l=0; geometry into l>0 via SH scatter ---
    C = cfg.d_hidden
    x0 = batch.node_feat.to(dt) @ params["embed"]
    x = torch.cat([x0[:, None, :], x0.new_zeros((n, cfg.K - 1, C))], dim=1)
    geo = sh_e[:, :, None] * (rbf @ params["edge_embed_w"])[:, None, :]
    x = x + scatter_sum(geo, dst, n) / 8.0

    heads = cfg.n_heads
    Ch = C // heads

    n_edges = src.shape[0]
    ch = max(cfg.edge_chunks, 1)
    if n_edges % ch:
        raise ValueError(f"{n_edges} edges do not split into {ch} chunks")
    e_c = n_edges // ch

    def weight(y, alpha):
        """Messages (E, nl, C) weighted by their heads' attention."""
        if y is None:
            return None
        E_, nl, _ = y.shape
        yh = y.reshape(E_, nl, heads, Ch)
        yh = yh * alpha[:, None, :, None].to(dt)
        return yh.reshape(E_, nl, C)

    def layer(x, lp):
        rad_scale_all = F.silu(mlp(lp["rad_gate"], rbf))  # (E, 2C)

        if ch == 1:
            z = torch.cat([x[src], x[dst]], dim=-1)
            zb = _rotate_to_mblocks(z, D, cfg)
            hb = _so2_conv_mblocks(zb, lp["so2"], rad_scale_all, cfg)
            inv = zb[0][0].reshape(z.shape[0], -1)    # rotated m=0 inputs
            logits = mlp(lp["attn_mlp"], inv)
            logits = torch.where(evalid[:, None] > 0, logits, -1e30)
            alpha = segment_softmax(logits, dst, n)
            hb = {m: (weight(p, alpha), weight(q, alpha))
                  for m, (p, q) in hb.items()}
            agg = _scatter_back_rotated(hb, D, dst, n, evalid, cfg)
        else:
            # ---- two-pass edge streaming (web-scale graphs) ----
            # Each chunk runs under checkpoint, and its recompute in the
            # backward pass reads the tensors it is given as arguments
            # (a closure would read the names as rebound by then).
            # pass 1: attention logits from the rotated invariant (m=0)
            # input channels (chunk-local; only (E, heads) persists)
            def logits_chunk(x, i):
                c = slice(i * e_c, (i + 1) * e_c)
                zc = torch.cat([x[src[c]], x[dst[c]]], dim=-1)
                z0 = _rotate_m0(zc, [d[c] for d in D], cfg)  # (e_c, nl0, 2C)
                return mlp(lp["attn_mlp"], z0.reshape(z0.shape[0], -1))
            logits = torch.cat([checkpoint(logits_chunk, x, i,
                                           use_reentrant=False)
                                for i in range(ch)], dim=0)
            logits = torch.where(evalid[:, None] > 0, logits, -1e30)
            alpha = segment_softmax(logits, dst, n)

            # pass 2: messages, chunk by chunk, accumulated on nodes
            def msg_chunk(x, alpha, i):
                c = slice(i * e_c, (i + 1) * e_c)
                Dc = [d[c] for d in D]
                zc = torch.cat([x[src[c]], x[dst[c]]], dim=-1)
                zb = _rotate_to_mblocks(zc, Dc, cfg)
                hb = _so2_conv_mblocks(zb, lp["so2"], rad_scale_all[c], cfg)
                hb = {m: (weight(p, alpha[c]), weight(q, alpha[c]))
                      for m, (p, q) in hb.items()}
                return _scatter_back_rotated(hb, Dc, dst[c], n, evalid[c],
                                             cfg)
            agg = x.new_zeros((n, cfg.K, C))
            for i in range(ch):
                agg = agg + checkpoint(msg_chunk, x, alpha, i,
                                       use_reentrant=False)
        x = _equiv_layernorm(x + agg, lp["ln_scale"], cfg.l_max)
        # FFN: per-l channel mix, scalar-gated for l>0
        xls = _l_blocks(x, cfg.l_max)
        s = xls[0][:, 0, :]
        gates = torch.sigmoid(mlp(lp["gate_mlp"], s))    # (N, l_max*C)
        gates = gates.reshape(-1, cfg.l_max, C).unbind(1)
        outs = [mlp(lp["ffn0"], s)[:, None, :]]
        for l in range(1, cfg.l_max + 1):
            blk = torch.einsum("nic,cd->nid", xls[l], lp["wch_l"][l])
            outs.append(blk * gates[l - 1][:, None, :])
        return x + torch.cat(outs, dim=1)

    fn = remat(cfg.remat, layer)
    for i in range(cfg.n_layers):
        x = fn(x, layer_of(params["layers"], i))

    out = mlp(params["head"], x[:, 0, :])                 # invariant readout
    if cfg.task == "graph" and batch.graph_id is not None:
        return scatter_sum(out, batch.graph_id, batch.n_graphs)
    return out


def loss_fn(cfg: EquiformerV2Config, params, batch: GraphBatch):
    out = forward(cfg, params, batch).float()
    if cfg.task == "graph":
        tgt = batch.labels.float().reshape(out.shape[0], -1)
        return torch.mean((out - tgt) ** 2)
    nll = label_nll(out, batch.labels)
    if batch.label_mask is not None:
        return (nll * batch.label_mask).sum() / torch.clamp(
            batch.label_mask.sum(), min=1.0)
    return nll.mean()
