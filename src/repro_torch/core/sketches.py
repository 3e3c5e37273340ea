"""HyperLogLog distinct-count sketches (beyond-paper action).

Luzzu *approximates* I2/CN2-style metrics for speed (paper §3.2 Correctness);
the dense engine computes them exactly — but true distinct-counts (distinct
triples, distinct predicates) need dedup. HLL sketches make distinct-count a
*mergeable* O(2^p) register state: block-local updates, ``max``-merge across
chunks — the same associativity that makes re-merging a re-executed chunk
idempotent.

torch has no unsigned 32-bit arithmetic on every device and its int32
``>>`` is arithmetic, so the murmur arithmetic runs in int64 holding values
in ``[0, 2^32)``, masked to 32 bits after every step; the 32×32-bit
products are split into 16-bit halves so they never overflow int64.
"""
from __future__ import annotations

import torch

from .. import tracing

DEFAULT_P = 12  # 4096 registers, ~1.6% relative error

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for int64 ``x`` in ``[0, 2^32)``: each half
    product stays below 2^48."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finalizer over int64 lanes holding uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def hash_columns(planes: torch.Tensor, cols: tuple[int, ...],
                 salt: int = 0x9E3779B9) -> torch.Tensor:
    """Combine int32 plane columns into one uint32 hash per row, returned
    as int64 in ``[0, 2^32)``."""
    h = torch.full((planes.shape[0],), salt, dtype=torch.int64,
                   device=planes.device)
    for c in cols:
        col = planes[:, c].to(torch.int64) & _M32
        h = _fmix32(h ^ col)
        h = (h * 5 + 0xE6546B64) & _M32
    return _fmix32(h)


def hll_init(p: int = DEFAULT_P, device=None) -> torch.Tensor:
    return torch.zeros((1 << p,), dtype=torch.int32, device=device)


def rank_and_bucket(h: torch.Tensor, p: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """bucket = top p bits; rank = 1 + clz of the remaining bits.

    torch has no clz: the bit length of ``w`` is the exponent ``frexp``
    returns for it in float64, which holds every uint32 exactly."""
    bucket = (h >> (32 - p)).to(torch.int64)
    w = (h << p) & _M32
    _, exp = torch.frexp(w.to(torch.float64))      # w = m·2^exp, m∈[.5,1)
    max_rank = 32 - p + 1
    rank = torch.where(w == 0, max_rank, 32 - exp.to(torch.int64) + 1)
    rank = torch.clamp(rank, max=max_rank).to(torch.int32)
    return bucket, rank


def hll_update(registers: torch.Tensor, planes: torch.Tensor,
               cols: tuple[int, ...], valid: torch.Tensor | None = None
               ) -> torch.Tensor:
    """Fold a block of rows into a copy of the registers (scatter-max)."""
    p = registers.shape[0].bit_length() - 1
    h = hash_columns(planes, cols)
    bucket, rank = rank_and_bucket(h, p)
    if valid is not None:
        rank = torch.where(valid, rank, 0)
    return registers.clone().scatter_reduce_(0, bucket, rank, reduce="amax")


def hll_merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.maximum(a, b)


def hll_estimate(registers: torch.Tensor) -> torch.Tensor:
    """Standard HLL estimator with small-range (linear counting)
    correction, in float32 like the reference estimator."""
    with tracing.span("sketches.estimate"):
        m = registers.shape[0]
        if m >= 128:
            alpha = 0.7213 / (1.0 + 1.079 / m)
        else:
            alpha = {16: 0.673, 32: 0.697, 64: 0.709}.get(m, 0.7213)
        inv = torch.sum(torch.exp2(-registers.to(torch.float32)))
        raw = alpha * m * m / inv
        zeros = torch.sum(registers == 0)
        small = m * torch.log(m / torch.clamp(zeros, min=1)
                              .to(torch.float32))
        return torch.where((raw <= 2.5 * m) & (zeros > 0), small, raw)
