"""HyperLogLog: the row hash, bucket and rank, the register fold and the
estimator, transcribed from the port's ``csrc/scan_common.cuh`` (hash,
rank, the fold skipping rows whose s_flags plane is 0) and
``core/sketches.py`` (the estimator with its linear-counting correction).

The estimator here runs in float64 on the host; the port's runs in
float32, so estimates differ by float32 rounding.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import rdf as R

HASH_SEED = 0x9E3779B9


def row_hash(cols, planes: tuple[int, ...]) -> torch.Tensor:
    """The 32-bit hash of each row over ``planes``, as int64 words:
    h = seed; h = fmix32(h ^ word) * 5 + 0xE6546B64 per plane;
    fmix32(h)."""
    h = None
    for c in planes:
        w = R.as_word(cols[c])
        h = (torch.full_like(w, HASH_SEED) if h is None else h) ^ w
        h = (R.fmix32(h) * 5 + 0xE6546B64) & R.M32
    return R.fmix32(h)


def bit_length(w: torch.Tensor) -> torch.Tensor:
    """The bit length of each int64 word in ``[0, 2^32)``, by halving."""
    n = torch.zeros_like(w)
    for step in (16, 8, 4, 2, 1):
        big = (w >> step) != 0
        n = n + torch.where(big, step, 0)
        w = torch.where(big, w >> step, w)
    return n + (w != 0).to(n.dtype)


def fold(regs: torch.Tensor, cols, planes: tuple[int, ...], p: int,
         live: torch.Tensor) -> None:
    """Raise ``regs`` (``2^p`` int32) by the rows of a block where
    ``live``: bucket = the top ``p`` bits of the hash, rank = the leading
    zeros of the rest plus 1, at most ``33 - p``."""
    f = row_hash(cols, planes)
    bucket = f >> (32 - p)
    w = (f << p) & R.M32
    rank = torch.clamp(33 - bit_length(w), max=33 - p)
    rank = torch.where(live, rank, 0).to(torch.int32)
    regs.scatter_reduce_(0, bucket, rank, reduce="amax")


def estimate(regs: np.ndarray) -> float:
    """The HLL estimate of a register bank, in float64."""
    regs = np.asarray(regs, dtype=np.float64)
    m = regs.shape[0]
    alpha = (0.7213 / (1.0 + 1.079 / m) if m >= 128
             else {16: 0.673, 32: 0.697, 64: 0.709}.get(m, 0.7213))
    raw = alpha * m * m / float(np.sum(np.exp2(-regs)))
    zeros = int(np.sum(regs == 0))
    if raw <= 2.5 * m and zeros > 0:
        return m * math.log(m / zeros)
    return raw
