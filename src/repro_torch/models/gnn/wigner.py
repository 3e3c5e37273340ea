"""Real Wigner rotation matrices for spherical-harmonic (irrep) features,
the port's counterpart of ``repro.models.gnn.wigner``, entry for entry.

``wigner_stack(rot, l_max)`` returns block-diagonal real rotation matrices
D^l(R) for l = 0..l_max, built by the Ivanic–Ruedenberg recursion
(J. Phys. Chem. 1996 + 1998 erratum) from the 3×3 rotation — vectorized over
a batch of rotations with static unrolling over l (l_max ≤ ~8). This is the
rotation step of the eSCN trick (EquiformerV2, arXiv:2306.12059): rotate each
edge's features so the edge aligns with the polar axis, after which the
tensor-product conv is block-diagonal over m (an SO(2) conv).

Real-SH basis order within degree l: m = -l..l at flat index l² + l + m.
l=1 basis (m=-1,0,1) corresponds to (y, z, x).

The recursion builds D^l one entry at a time, as the JAX code does, so that
the port adds the same terms in the same order: a few small operations per
entry, about 445 entries for l ≤ 6.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

# l=1 real-SH index (m=-1,0,1) ↔ cartesian (y,z,x)
_PERM = [1, 2, 0]


def rot_to_d1(rot):
    """(B,3,3) cartesian rotation → (B,3,3) D^1 in real-SH basis."""
    return rot[:, _PERM][:, :, _PERM]


def _ir_coeffs(l: int):
    """Static U,V,W coefficient tables + P-index plumbing for degree l."""
    ms = np.arange(-l, l + 1)
    mps = np.arange(-l, l + 1)
    m_g, mp_g = np.meshgrid(ms, mps, indexing="ij")
    at_edge = np.abs(mp_g) == l
    denom = np.where(at_edge, (2 * l) * (2 * l - 1),
                     (l + mp_g) * (l - mp_g))
    u = np.sqrt((l + m_g) * (l - m_g) / denom)
    d_m0 = (m_g == 0).astype(np.float64)
    v = (0.5 * np.sqrt((1 + d_m0) * (l + np.abs(m_g) - 1)
                       * (l + np.abs(m_g)) / denom) * (1 - 2 * d_m0))
    w = (-0.5 * np.sqrt((l - np.abs(m_g) - 1) * (l - np.abs(m_g)) / denom)
         * (1 - d_m0))
    return u, v, w


def _p_term(d1, dlm1, i: int, mu: int, mp: int, l: int):
    """P(i, l, mu, m') from IR: batched (B,) values.

    d1: (B,3,3) indexed [m+1]; dlm1: (B, 2l-1, 2l-1) indexed [mu+l-1]."""
    def d1e(a, b):
        return d1[:, a + 1, b + 1]

    def dl(a, b):
        return dlm1[:, a + l - 1, b + l - 1]

    if abs(mu) > l - 1:
        return d1.new_zeros((d1.shape[0],))
    if mp == l:
        return d1e(i, 1) * dl(mu, l - 1) - d1e(i, -1) * dl(mu, -l + 1)
    if mp == -l:
        return d1e(i, 1) * dl(mu, -l + 1) + d1e(i, -1) * dl(mu, l - 1)
    return d1e(i, 0) * dl(mu, mp)


def _next_wigner(d1, dlm1, l: int):
    """(B,3,3) D^1 + (B,2l-1,2l-1) D^{l-1} → (B,2l+1,2l+1) D^l."""
    u_t, v_t, w_t = _ir_coeffs(l)
    rows = []
    for m in range(-l, l + 1):
        cols = []
        for mp in range(-l, l + 1):
            acc = 0.0
            # the coefficients as Python floats: a numpy scalar on the left
            # of a tensor would take over the product
            uu = float(u_t[m + l, mp + l])
            vv = float(v_t[m + l, mp + l])
            ww = float(w_t[m + l, mp + l])
            if uu != 0.0:
                acc = acc + uu * _p_term(d1, dlm1, 0, m, mp, l)
            if vv != 0.0:
                if m == 0:
                    t = (_p_term(d1, dlm1, 1, 1, mp, l)
                         + _p_term(d1, dlm1, -1, -1, mp, l))
                elif m > 0:
                    t = (_p_term(d1, dlm1, 1, m - 1, mp, l)
                         * float(np.sqrt(1.0 + (m == 1)))
                         - _p_term(d1, dlm1, -1, -m + 1, mp, l)
                         * (1.0 - (m == 1)))
                else:
                    t = (_p_term(d1, dlm1, 1, m + 1, mp, l)
                         * (1.0 - (m == -1))
                         + _p_term(d1, dlm1, -1, -m - 1, mp, l)
                         * float(np.sqrt(1.0 + (m == -1))))
                acc = acc + vv * t
            if ww != 0.0:
                if m > 0:
                    t = (_p_term(d1, dlm1, 1, m + 1, mp, l)
                         + _p_term(d1, dlm1, -1, -m - 1, mp, l))
                else:
                    t = (_p_term(d1, dlm1, 1, m - 1, mp, l)
                         - _p_term(d1, dlm1, -1, -m + 1, mp, l))
                acc = acc + ww * t
            cols.append(acc)
        rows.append(torch.stack(cols, dim=-1))
    return torch.stack(rows, dim=-2)


def wigner_stack(rot, l_max: int) -> list:
    """(B,3,3) rotations → [D^0 (B,1,1), D^1 (B,3,3), ..., D^{l_max}]."""
    out = [rot.new_ones((rot.shape[0], 1, 1))]
    if l_max >= 1:
        d1 = rot_to_d1(rot)
        out.append(d1)
        dl = d1
        for l in range(2, l_max + 1):
            dl = _next_wigner(d1, dl, l)
            out.append(dl)
    return out


def rotation_to_axis(vec):
    """(B,3) unit-ish vectors → (B,3,3) proper rotation R with R v̂ = ẑ.

    ẑ is the polar axis of this module's real-SH convention, so the residual
    gauge freedom (rotations about the aligned edge) acts diagonally on
    (m,−m) pairs — the property the SO(2) conv relies on.

    Numerically stable everywhere: vectors in the lower hemisphere are first
    flipped by F = 180°-about-x̂ (proper), then Rodrigues is applied in the
    upper hemisphere where 1/(1+cosθ) is well-conditioned; R = Rod(Fv)·F.
    """
    v = vec / (torch.linalg.norm(vec, dim=-1, keepdim=True) + 1e-12)
    flip = torch.tensor([[1.0, 0.0, 0.0],
                         [0.0, -1.0, 0.0],
                         [0.0, 0.0, -1.0]], dtype=v.dtype, device=v.device)
    lower = v[..., 2] < 0.0
    u = torch.where(lower[:, None], v @ flip.T, v)   # upper-hemisphere copy

    # axis * sinθ = u × ẑ = (u_y, −u_x, 0), in components: DTensor has no
    # rule for linalg.cross (torch 2.11)
    a = torch.stack([u[..., 1], -u[..., 0], torch.zeros_like(u[..., 0])], -1)
    c = u[..., 2]
    zeros = torch.zeros_like(c)
    K = torch.stack([
        torch.stack([zeros, -a[..., 2], a[..., 1]], -1),
        torch.stack([a[..., 2], zeros, -a[..., 0]], -1),
        torch.stack([-a[..., 1], a[..., 0], zeros], -1)], -2)
    eye = torch.eye(3, dtype=u.dtype, device=u.device)[None]
    R_up = eye + K + (K @ K) / (1.0 + c)[:, None, None]
    return torch.where(lower[:, None, None], R_up @ flip[None], R_up)


# kept name for callers; alignment axis is ẑ (see docstring above)
rotation_to_y = rotation_to_axis


# --- independent real-SH evaluator (for tests + embeddings) ------------------

@functools.lru_cache(maxsize=None)
def _sh_norms(l_max: int):
    """Normalization constants N_l^m for real SH (orthonormal on S²)."""
    from math import factorial, pi, sqrt
    out = {}
    for l in range(l_max + 1):
        for m in range(0, l + 1):
            n = sqrt((2 * l + 1) / (4 * pi)
                     * factorial(l - m) / factorial(l + m))
            out[(l, m)] = n * (sqrt(2.0) if m > 0 else 1.0)
    return out


def real_sh(vec, l_max: int):
    """(B,3) → (B, (l_max+1)²) real spherical harmonics (orthonormal).

    Associated Legendre by stable recursion; convention matches wigner_stack
    (l=1 ∝ (y,z,x))."""
    v = vec / (torch.linalg.norm(vec, dim=-1, keepdim=True) + 1e-12)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    ct = z
    st = torch.sqrt(torch.clamp(1.0 - ct ** 2, min=1e-12))
    phi = torch.atan2(y, x)
    norms = _sh_norms(l_max)
    # P_l^m via recursion
    P = {(0, 0): torch.ones_like(ct)}
    for m in range(1, l_max + 1):
        # no Condon-Shortley phase (matches the (y,z,x) l=1 convention)
        P[(m, m)] = (2 * m - 1) * st * P[(m - 1, m - 1)]
    for m in range(0, l_max):
        P[(m + 1, m)] = (2 * m + 1) * ct * P[(m, m)]
    for m in range(0, l_max + 1):
        for l in range(m + 2, l_max + 1):
            P[(l, m)] = (((2 * l - 1) * ct * P[(l - 1, m)]
                          - (l + m - 1) * P[(l - 2, m)]) / (l - m))
    cols = []
    for l in range(l_max + 1):
        for m in range(-l, l + 1):
            am = abs(m)
            base = norms[(l, am)] * P[(l, am)]
            if m > 0:
                cols.append(base * torch.cos(am * phi))
            elif m < 0:
                cols.append(base * torch.sin(am * phi))
            else:
                cols.append(base)
    return torch.stack(cols, dim=-1)
