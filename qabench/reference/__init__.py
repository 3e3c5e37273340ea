"""The plain reference of the quality assessment: the same metrics over the
same planes, in plain torch, in blocks of rows, on whatever device holds
the planes.

It imports nothing of the port (``repro_torch``) or of the JAX package
(``repro``), and reads nothing the port made: only the planes, which the
benchmark made from the seed.
"""
from __future__ import annotations

import dataclasses

import torch

from . import hll, rdf as R
from .metrics import METRICS, Cols

BLOCK_ROWS = 1 << 25


@dataclasses.dataclass
class Answer:
    """What one metric set's report must say."""
    counts: dict          # metric -> counter -> int
    registers: dict       # sketch -> (2^p,) int32
    values: dict          # metric -> float


def assess(planes: torch.Tensor, metric_names, p: int, *,
           block_rows: int = BLOCK_ROWS, control: bool = False) -> dict:
    """Each metric's answer over ``planes`` (an ``(N, 13)`` int32 tensor):
    ``{metric: Answer}``.

    ``control`` computes the same one step below the precision the
    configuration states: counters tallied in float32 instead of exact
    int64, and HLL banks of ``2^(p - 1)`` registers instead of ``2^p``.
    """
    dev = planes.device
    names = list(dict.fromkeys(metric_names))
    sketches = {}
    for m in names:
        for s, cols in METRICS[m][2]:
            sketches[s] = cols
    tally_t = torch.float32 if control else torch.int64
    q = p - 1 if control else p
    tallies: dict = {}
    regs = {s: torch.zeros((1 << q,), dtype=torch.int32, device=dev)
            for s in sketches}
    for block in torch.split(planes, block_rows):
        x = Cols(block)
        valid = x.valid()
        for m in names:
            for c, mask in METRICS[m][0](x).items():
                n = (mask & valid).to(tally_t).sum(dtype=tally_t)
                key = (m, c)
                tallies[key] = tallies[key] + n if key in tallies else n
        live = x[R.S_FLAGS] != 0
        for s, cols in sketches.items():
            hll.fold(regs[s], x, cols, q, live)
        del x
    host_regs = {s: r.cpu().numpy() for s, r in regs.items()}
    est = {s: hll.estimate(r) for s, r in host_regs.items()}
    out = {}
    for m in names:
        counts = {c: int(tallies[(m, c)].item()) for (mm, c) in tallies
                  if mm == m}
        out[m] = Answer(
            counts=counts,
            registers={s: host_regs[s] for s, _ in METRICS[m][2]},
            values={m: METRICS[m][1](counts, est)})
    return out


def for_set(per_metric: dict, metric_set) -> Answer:
    """The answer of a request for ``metric_set``, from ``assess``'s."""
    ans = Answer({}, {}, {})
    for m in metric_set:
        a = per_metric[m]
        ans.counts[m] = a.counts
        ans.registers.update(a.registers)
        ans.values.update(a.values)
    return ans


__all__ = ["Answer", "assess", "for_set", "BLOCK_ROWS"]
