"""Public wrapper for the HLL fold CUDA kernel (``csrc/hll_fold.cu``).

For a CUDA tensor the wrapper launches the kernel or raises; for a CPU
tensor it runs the plain torch version (``ref.hll_fold_torch``). There is
no fallback from one to the other. A fake or meta tensor on the card
(``kernels.shape_only``) gets its output's shape and no launch.

The JAX wrapper's ``bounded_block_n`` has no counterpart: it caps the rows
of the TPU kernel's dense (rows, 2^p) one-hot so it fits VMEM, and this
kernel builds no one-hot. Nor is there a ``block_n`` to pad to: the kernel
masks the ragged tail itself.
"""
from __future__ import annotations

import torch

from ... import tracing
from .. import _build, note_kernel, record_launch, record_scan, shape_only
from ..fused_scan.ops import check_sketches
from ..qap_count.ops import check_planes
from .ref import hll_fold_torch


def hll_fold(planes: torch.Tensor, cols: tuple[int, ...],
             p: int) -> torch.Tensor:
    """Fold (N, 13) planes into one sketch's (2^p,) int32 registers, in
    one pass.

    Row validity comes from the s_flags plane (zero ⇒ padding row, rank
    0), as the JAX wrapper derives it, so zero rows are invisible.
    """
    record_scan(1)
    cols = tuple(cols)
    with tracing.span("kernel.check"):
        check_planes(planes)
        # the columns, validated, out of check_sketches' row (n_cols,
        # cols...)
        host_cols = check_sketches((("hll_fold", cols),),
                                   p)[0, 1:1 + len(cols)]
    if planes.device.type == "cpu":
        return hll_fold_torch(planes, cols, p)
    with tracing.span("kernel.outputs"):
        regs = torch.zeros((1 << p,), dtype=torch.int32,
                           device=planes.device)
    if planes.shape[0] and not shape_only(planes):
        lib = _build.load("hll_fold")
        with torch.cuda.device(planes.device):
            stream = torch.cuda.current_stream(planes.device).cuda_stream
            err = lib.hll_fold(planes.data_ptr(), planes.shape[0],
                               host_cols.ctypes.data, len(host_cols), p,
                               regs.data_ptr(), stream)
        _build.check("hll_fold", err)
        record_launch("hll_fold")
    note_kernel(planes.numel() * 4, (regs,))
    return regs
