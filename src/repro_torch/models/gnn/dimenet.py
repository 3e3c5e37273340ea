"""DimeNet (arXiv:2003.03123): directional message passing with spherical
Bessel / spherical-harmonic bases and triplet (k→j→i) interactions, the
port's counterpart of ``repro.models.gnn.dimenet``.

Structure per the paper: embedding block → ``n_blocks`` interaction blocks
(radial-basis gating + triplet gather + SBF bilinear contraction with
``n_bilinear`` channels + residual MLPs) → per-block output heads summed into
node outputs and pooled per graph.

Systems notes:
* spherical Bessel roots z_{ln} are computed numerically on the host (no
  scipy), as the JAX code does: ``_spherical_jn``, ``bessel_roots`` and
  ``build_triplets`` are its numpy functions, copied;
* triplets are precomputed host-side with a per-edge in-degree cap
  (``max_in_per_edge``) — exact for molecular graphs, capped for web-scale
  power-law graphs;
* the geometry (distances, angles) and the Bessel and Legendre bases run
  in float64 (``BASIS_DTYPE``) whatever the model's dtype, and are rounded
  to it once: the JAX code runs them in float32, where the recurrences'
  roundings and each device's own ``sin``/``cos``/``pow`` move a basis by
  ulps that the model amplifies (SMOKE's ``out_mlp`` bias gradient, a
  difference of much larger terms, parts the card from the CPU by more
  than the train tests' rule with float32 bases); true divisions where
  the JAX code divides a constant by a tensor (``torch``'s ``c / x`` is
  ``c * (1 / x)``, one rounding more).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ...dist.sharding import split_params
from ..common import ParamTree, normal
from .common import (GraphBatch, init_mlp, layer_of, mlp, remat,
                     scatter_sum)


@dataclasses.dataclass(frozen=True)
class DimeNetConfig:
    name: str = "dimenet"
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    d_feat: int = 16
    cutoff: float = 5.0
    envelope_p: int = 6
    n_classes: int = 1          # regression target dim (graph-level)
    task: str = "graph"
    max_in_per_edge: int = 4    # triplet cap (exact for small molecules)
    dtype: Any = torch.float32
    remat: str = "none"

    def num_params(self) -> int:
        model, _ = init_dimenet(self, None)
        return sum(p.numel() for p in model.parameters())


# --- Bessel machinery (host-side constants) ----------------------------------

def _spherical_jn(l: int, x: np.ndarray) -> np.ndarray:
    """j_l(x) via Miller's downward recurrence with tracked log-scale
    (stable for all x, l; float64, host-side)."""
    x = np.asarray(x, np.float64)
    safe = np.where(np.abs(x) < 1e-12, 1e-12, x)
    L = int(max(l + 25, np.max(np.abs(x)) + 30))  # Miller needs L ≫ x
    jp = np.zeros_like(safe)
    jc = np.full_like(safe, 1e-30)
    logscale = np.zeros_like(safe)
    snap_v, snap_ls = None, None
    for ll in range(L, 0, -1):
        jm = (2 * ll + 1) / safe * jc - jp
        jp, jc = jc, jm
        renorm = np.where(np.abs(jc) > 1e100, 1e-100, 1.0)
        jp = jp * renorm
        jc = jc * renorm
        logscale = logscale - np.log(renorm)
        if ll - 1 == l:
            snap_v, snap_ls = jc.copy(), logscale.copy()
    j0_true = np.sin(safe) / safe
    with np.errstate(divide="ignore", invalid="ignore"):
        out = snap_v * np.exp(snap_ls - logscale) * (j0_true / jc)
    return np.where(np.abs(x) < 1e-12, 1.0 if l == 0 else 0.0, out)


@functools.lru_cache(maxsize=None)
def bessel_roots(n_spherical: int, n_radial: int) -> np.ndarray:
    """First ``n_radial`` positive roots of j_l for l < n_spherical."""
    grid = np.linspace(1e-3, (n_radial + n_spherical + 2) * np.pi, 20000)
    roots = np.zeros((n_spherical, n_radial))
    for l in range(n_spherical):
        vals = _spherical_jn(l, grid)
        sign = np.sign(vals)
        idx = np.where(sign[:-1] * sign[1:] < 0)[0]
        found = []
        for i in idx[: n_radial]:
            a, b = grid[i], grid[i + 1]
            for _ in range(60):  # bisection
                m = 0.5 * (a + b)
                if _spherical_jn(l, np.array([a]))[0] * \
                        _spherical_jn(l, np.array([m]))[0] <= 0:
                    b = m
                else:
                    a = m
            found.append(0.5 * (a + b))
        roots[l, : len(found)] = found
    return roots


# the dtype of the geometry and its bases (module docstring)
BASIS_DTYPE = torch.float64


@functools.lru_cache(maxsize=16)
def _roots_on(n_spherical: int, n_radial: int, device: torch.device,
              dtype=torch.float32):
    """``bessel_roots`` in ``dtype`` on ``device``, copied there once."""
    return torch.as_tensor(bessel_roots(n_spherical, n_radial),
                           dtype=dtype, device=device)


def _rdiv(c: float, x):
    """``c / x`` as one true division (the JAX code's)."""
    return torch.div(torch.tensor(c, dtype=x.dtype), x)


def envelope(x, p: int):
    """Smooth polynomial cutoff u(x), x = d/cutoff ∈ [0,1]."""
    a = -(p + 1) * (p + 2) / 2.0
    b = p * (p + 2.0)
    c = -p * (p + 1) / 2.0
    e = _rdiv(1.0, x + 1e-9) + a * x ** (p - 1) + b * x ** p \
        + c * x ** (p + 1)
    return torch.where(x < 1.0, e, 0.0)


def radial_basis(d, cfg: DimeNetConfig):
    """(E,) distances → (E, n_radial) Bessel RBF with envelope."""
    x = d / cfg.cutoff
    n = torch.arange(1, cfg.n_radial + 1, dtype=d.dtype, device=d.device)
    # the JAX code's float32 square root of a float32 constant
    scale = float(np.sqrt(np.float32(2.0 / cfg.cutoff)))
    return scale * torch.sin(n[None, :] * np.pi * x[:, None]) \
        * envelope(x, cfg.envelope_p)[:, None]


def _jl_stack(lmax: int, x):
    """j_l(x) for l=0..lmax-1, fp32-stable hybrid:

    upward recurrence where x > l (its stable regime), Miller downward with
    tracked log-scale where x ≤ l (where upward explodes)."""
    xs = torch.where(torch.abs(x) < 1e-6, 1e-6, x)
    # --- upward ---
    up = [torch.sin(xs) / xs]
    if lmax > 1:
        up.append(torch.sin(xs) / xs ** 2 - torch.cos(xs) / xs)
        for l in range(1, lmax - 1):
            up.append(_rdiv(2 * l + 1, xs) * up[-1] - up[-2])
    up = torch.stack(up, dim=-1)
    # --- downward (Miller, tracked log-scale) ---
    L = lmax + 20
    jp = torch.zeros_like(xs)
    jc = torch.ones_like(xs) * 1e-10
    logscale = torch.zeros_like(xs)
    snaps = [None] * lmax
    for ll in range(L, 0, -1):
        jm = _rdiv(2 * ll + 1, xs) * jc - jp
        jp, jc = jc, jm
        renorm = torch.where(torch.abs(jc) > 1e10, 1e-10, 1.0)
        jp = jp * renorm
        jc = jc * renorm
        logscale = logscale - torch.log(renorm)
        if ll - 1 < lmax:
            snaps[ll - 1] = (jc, logscale)
    j0_true = torch.sin(xs) / xs
    down = torch.stack(
        [v * torch.exp(ls - logscale) * (j0_true / jc) for v, ls in snaps],
        dim=-1)
    ls_idx = torch.arange(lmax, dtype=xs.dtype, device=xs.device)
    use_up = xs[..., None] > ls_idx
    return torch.where(use_up, up, down)


def _legendre_stack(lmax: int, c):
    """P_l(c) for l=0..lmax-1; c (T,)."""
    out = [torch.ones_like(c)]
    if lmax > 1:
        out.append(c)
        for l in range(1, lmax - 1):
            out.append(((2 * l + 1) * c * out[-1] - l * out[-2]) / (l + 1))
    return torch.stack(out, dim=-1)  # (T, lmax)


def spherical_basis(d_kj, angle_cos, cfg: DimeNetConfig):
    """(T,) dist + (T,) cos(angle) → (T, n_spherical*n_radial) SBF."""
    roots = _roots_on(cfg.n_spherical, cfg.n_radial, d_kj.device,
                      d_kj.dtype)                    # (L, N)
    x = d_kj / cfg.cutoff
    arg = x[:, None, None] * roots[None]            # (T, L, N)
    # evaluate j_l at its own l, per-l slices
    per_l = [_jl_stack(l + 1, arg[:, l, :])[..., -1]  # (T, N)
             for l in range(cfg.n_spherical)]
    jln = torch.stack(per_l, dim=1)                  # (T, L, N)
    pl = _legendre_stack(cfg.n_spherical, angle_cos)  # (T, L)
    sbf = jln * pl[:, :, None] * envelope(x, cfg.envelope_p)[:, None, None]
    return sbf.reshape(sbf.shape[0], -1)             # (T, L*N)


# --- Triplet precompute (host-side, part of the data pipeline) ---------------

def build_triplets(src: np.ndarray, dst: np.ndarray, cap: int
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """For each edge e=(j→i), pair it with up to ``cap`` in-edges (k→j).

    Returns (t_kj, t_ji, t_mask) of length E*cap (padded)."""
    E = len(src)
    in_edges: dict[int, list[int]] = {}
    for e in range(E):
        in_edges.setdefault(int(dst[e]), []).append(e)
    t_kj = np.zeros((E * cap,), np.int32)
    t_ji = np.zeros((E * cap,), np.int32)
    t_mask = np.zeros((E * cap,), np.float32)
    w = 0
    for e in range(E):
        j, i = int(src[e]), int(dst[e])
        cnt = 0
        for ke in in_edges.get(j, ()):
            if cnt >= cap:
                break
            if int(src[ke]) == i:   # exclude backtracking k == i
                continue
            t_kj[w], t_ji[w], t_mask[w] = ke, e, 1.0
            w += 1
            cnt += 1
    return t_kj, t_ji, t_mask


def triplets_to_device(triplets, device) -> tuple:
    """``build_triplets``' arrays as tensors on ``device`` (indices int64)."""
    t_kj, t_ji, t_mask = triplets
    return (torch.from_numpy(t_kj).long().to(device),
            torch.from_numpy(t_ji).long().to(device),
            torch.from_numpy(t_mask).to(device))


# --- Model --------------------------------------------------------------------

def init_dimenet(cfg: DimeNetConfig, rng):
    """Returns (model, logical): trainable weights drawn from ``rng`` (a
    ``torch.Generator``) on its device, or shapes on the meta device."""
    d, nb = cfg.d_hidden, cfg.n_blocks
    nsr = cfg.n_spherical * cfg.n_radial

    def lin(shape, scale_dim=None):
        sd = scale_dim if scale_dim else (
            shape[-2] if len(shape) > 1 else shape[-1])
        return (normal(rng, shape, 1.0 / np.sqrt(sd), cfg.dtype),
                (None,) * len(shape))

    tree = {
        "embed": lin((cfg.d_feat, d)),
        "edge_init": init_mlp(rng, (2 * d + cfg.n_radial, d, d),
                              dtype=cfg.dtype),
        "blocks": {
            "w_rbf": lin((nb, cfg.n_radial, d)),
            "w_sbf": lin((nb, nsr, cfg.n_bilinear)),
            "w_bilin": lin((nb, cfg.n_bilinear, d, d), scale_dim=d),
            "w_msg": lin((nb, d, d)),
            "mlp1": init_mlp(rng, (d, d, d), dtype=cfg.dtype, lead=(nb,),
                             lead_logical=(None,)),
            "out_rbf": lin((nb, cfg.n_radial, d)),
            "out_mlp": init_mlp(rng, (d, d, cfg.n_classes),
                                dtype=cfg.dtype, lead=(nb,),
                                lead_logical=(None,)),
        },
    }
    params, logical = split_params(tree)
    return ParamTree(params, requires_grad=True), logical


def forward(cfg: DimeNetConfig, params, batch: GraphBatch,
            triplets: tuple | None = None):
    """triplets = (t_kj, t_ji, t_mask) tensors from build_triplets."""
    dt = cfg.dtype
    pos = batch.positions.to(BASIS_DTYPE)
    src, dst, n = batch.src, batch.dst, batch.n_nodes
    vec = pos[dst] - pos[src]
    # numeric guard: synthetic graphs can sample near-coincident nodes; real
    # molecular distances are bounded below (~0.5 Å), so clip harmlessly.
    dist = torch.clamp(torch.sqrt((vec ** 2).sum(-1) + 1e-12), min=0.1)
    rbf = radial_basis(dist, cfg).to(dt)

    t_kj, t_ji, t_mask = triplets
    # angle at j between (k→j) and (j→i)
    v_kj = -vec[t_kj]                      # points k→j
    v_ji = vec[t_ji]                       # points j→i
    cosang = ((v_kj * v_ji).sum(-1)
              / (torch.linalg.norm(v_kj, dim=-1)
                 * torch.linalg.norm(v_ji, dim=-1) + 1e-9))
    sbf = spherical_basis(dist[t_kj], cosang, cfg).to(dt)
    sbf = sbf * t_mask[:, None].to(dt)

    h = batch.node_feat.to(dt) @ params["embed"]
    m = mlp(params["edge_init"], torch.cat([h[src], h[dst], rbf], dim=-1))

    def block(m, node_out, bp):
        m_t = F.silu(m @ bp["w_msg"])
        m_t = m_t * (rbf @ bp["w_rbf"])            # radial gating
        g = m_t[t_kj]                               # triplet gather (T, d)
        sp = sbf @ bp["w_sbf"]                      # (T, n_bilinear)
        # "tb,td,bdf->tf" in the JAX code's contraction order: the (T, b, d)
        # outer product first, then one product over (b, d)
        w = bp["w_bilin"]
        t_out = ((sp[:, :, None] * g[:, None, :]).reshape(g.shape[0], -1)
                 @ w.reshape(-1, w.shape[-1]))
        agg = scatter_sum(t_out, t_ji, m.shape[0])  # back to ji edges
        m2 = m + mlp(bp["mlp1"], F.silu(m_t + agg))
        # per-block output head → nodes
        e_out = m2 * (rbf @ bp["out_rbf"])
        node_contrib = scatter_sum(e_out, dst, n)
        node_out = node_out + mlp(bp["out_mlp"], node_contrib)
        return m2, node_out

    fn = remat(cfg.remat, block)
    node_out = h.new_zeros((n, cfg.n_classes))
    for i in range(cfg.n_blocks):
        m, node_out = fn(m, node_out, layer_of(params["blocks"], i))

    if cfg.task == "graph" and batch.graph_id is not None:
        return scatter_sum(node_out, batch.graph_id, batch.n_graphs)
    return node_out


def loss_fn(cfg: DimeNetConfig, params, batch: GraphBatch, triplets):
    out = forward(cfg, params, batch, triplets).float()
    if cfg.task == "graph":
        tgt = batch.labels.float().reshape(out.shape[0], -1)
        return torch.mean((out - tgt) ** 2)
    nll = -torch.log_softmax(out, dim=-1)[
        torch.arange(out.shape[0], device=out.device), batch.labels]
    if batch.label_mask is not None:
        return (nll * batch.label_mask).sum() / torch.clamp(
            batch.label_mask.sum(), min=1.0)
    return nll.mean()
