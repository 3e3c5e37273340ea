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

import functools
import math
import struct

import numpy as np
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


SUM_ROUNDED = "sketches.sum_rounded"
PAST_RANGE = "sketches.past_range"

# Past 2^32/30 distinct keys of a 32-bit hash, HyperLogLog (Flajolet et al.,
# 2007) applies a large-range correction, -2^32·ln(1 - E/2^32), for hash
# collisions. This estimator applies none, as neither the JAX package's nor
# the benchmark's reference (qabench/reference/hll.py) does. The counter marks
# where the estimator leaves that range, not a measured bias: on the
# benchmark's generated rows the spo row hash collides little, and the raw
# estimate reads 0.96 to 0.99 of the row count at 817,774,057 and
# 1,292,933,812 rows on two seeds, where the correction would read 1.07 to
# 1.17.
LARGE_RANGE = 2.0 ** 32 / 30

_F32 = struct.Struct("f")


def _f32(x: float) -> float:
    """``x`` rounded to the nearest float32."""
    return _F32.unpack(_F32.pack(x))[0]


def _alpha(m: int) -> float:
    if m >= 128:
        return 0.7213 / (1.0 + 1.079 / m)
    return {16: 0.673, 32: 0.697, 64: 0.709}.get(m, 0.7213)


def _raw(inv: float, m: int) -> float:
    """``alpha·m²/inv`` for a float32 ``inv``, in float32 in torch's order
    for a Python number over a float32 tensor: the reciprocal, then the
    product. Each step is taken in float64 and rounded once to float32,
    which gives float32's own result: a quotient rounded to 53 bits and
    then to 24 rounds as it would directly (53 >= 2·24 + 2), and a product
    of two float32 values is exact in float64."""
    return _f32(_f32(1.0 / inv) * _f32(_alpha(m) * m * m))


@functools.cache
def _linear_count(m: int, zeros: int) -> float:
    """``m·ln(m/zeros)`` in float32, from torch's ops on 0-dim tensors,
    computed once for each ``(m, zeros)``: numpy's and libm's ``log``
    differ from torch's in the last bit for some counts."""
    z = torch.clamp(torch.tensor(zeros), min=1).to(torch.float32)
    return float(m * torch.log(m / z))


def estimate_bank(registers: np.ndarray) -> float:
    """Standard HLL estimator with small-range (linear counting)
    correction, in float32 like the reference estimator, from a numpy bank
    of ``m = 2^p`` registers.

    Amid a request's other work every numpy or torch call costs tens of
    microseconds, so one ``np.bincount`` gives the rank histogram and the
    rest is arithmetic on its at most ``34 - p`` counts.

    ``sum(2^-reg)`` is taken exactly, as the integer
    ``sum(count·2^(top - rank))`` with ``top = 33 - p`` the largest rank (at
    most 2^33), and rounded once to float32. Below ``2^(24 - kmax)``,
    ``kmax`` the largest register, every partial sum of any order is a
    float32 value, so this is the float32 sum in whatever order it is
    added; estimates on the raw branch past it are counted in
    ``SUM_ROUNDED``. Estimates past ``LARGE_RANGE`` are returned as they
    are, uncorrected, and counted in ``PAST_RANGE``."""
    with tracing.span("sketches.estimate"):
        m = registers.shape[0]
        top = 33 - (m.bit_length() - 1)
        hist = np.bincount(registers).tolist()
        units = 0
        for rank, count in enumerate(hist):
            units += count << (top - rank)
        raw = _raw(_f32(math.ldexp(units, -top)), m)
        zeros = hist[0]
        if raw <= 2.5 * m and zeros > 0:
            return _linear_count(m, zeros)
        if units >= 1 << (24 + top - (len(hist) - 1)):
            tracing.add(SUM_ROUNDED)
        if raw > LARGE_RANGE:
            tracing.add(PAST_RANGE)
        return raw


def hll_estimate(registers: torch.Tensor) -> torch.Tensor:
    """``estimate_bank`` of a tensor's registers, as a 0-dim float32
    tensor on its device."""
    est = estimate_bank(registers.detach().cpu().numpy())
    return torch.tensor(est, dtype=torch.float32, device=registers.device)
