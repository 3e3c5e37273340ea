"""Plain torch version of the hll_fold kernel: the scatter-max sketch
update of ``core.sketches`` over a fresh bank, with a row's validity read
from its s_flags plane (zero ⇒ padding row)."""
from __future__ import annotations

import torch

from ...core import sketches as hll
from ...rdf.triple_tensor import COL_S_FLAGS


def hll_fold_torch(planes: torch.Tensor, cols: tuple[int, ...],
                   p: int) -> torch.Tensor:
    """(N, 13) int32 planes → (2^p,) int32 registers of one sketch."""
    return hll.hll_update(hll.hll_init(p, planes.device), planes, cols,
                          valid=planes[:, COL_S_FLAGS] != 0)
