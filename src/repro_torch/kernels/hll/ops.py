"""Public wrapper for the HLL fold CUDA kernel (``csrc/hll_fold.cu``).

For a CUDA tensor the wrapper launches the kernel or raises; for a CPU
tensor it runs the plain torch version (``ref.hll_fold_torch``). There is
no fallback from one to the other. A fake or meta tensor on the card
(``kernels.shape_only``) gets its output's shape and no launch.

The kernel is built and launched as the scan kernel is
(``kernels/_build.py``); ``launch_geometry`` chooses its launch.

The JAX wrapper's ``bounded_block_n`` has no counterpart: it caps the rows
of the TPU kernel's dense (rows, 2^p) one-hot so it fits VMEM, and this
kernel builds no one-hot. Nor is there a ``block_n`` to pad to: the kernel
masks the ragged tail itself.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib

import torch

from ... import tracing
from .. import _build, note_kernel, record_launch, record_scan, shape_only
from ..fused_scan.ops import check_sketches
from ..qap_count.ops import check_planes
from ..scan_codegen import ROW_BYTES, SHARED_BANK_BYTES
from .ref import hll_fold_torch

THREADS = 128           # a block: hll_fold.cu's THREADS, its launch bound


@functools.lru_cache(maxsize=1)
def kernel_source() -> _build.FixedSource:
    source = (_build.CSRC / "hll_fold.cu").read_text()
    return _build.FixedSource(
        source, hashlib.sha256(source.encode()).hexdigest(),
        "hll_fold_kernel", THREADS, SHARED_BANK_BYTES, ROW_BYTES)


def launch_geometry(n_rows: int, p: int, resident) -> tuple[int, bool, int]:
    """(dynamic shared memory a block, whether the bank lives there, grid)
    over ``n_rows`` rows at ``p``: the bank of 2^p int32 in shared memory
    up to ``SHARED_BANK_BYTES``, else in the global output; a block per
    ``THREADS`` rows, at most ``resident(smem)`` and at least one."""
    bank = 4 << p
    shared = bank <= SHARED_BANK_BYTES
    smem = bank if shared else 0
    return smem, shared, max(1, min(-(-n_rows // THREADS), resident(smem)))


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
        # the kernel's Columns struct, validated: check_sketches' row
        # (n_cols, cols...)
        row = check_sketches((("hll_fold", cols),), p)[0]
    if planes.device.type == "cpu":
        return hll_fold_torch(planes, cols, p)
    with tracing.span("kernel.outputs"):
        regs = torch.zeros((1 << p,), dtype=torch.int32,
                           device=planes.device)
    if planes.shape[0] and not shape_only(planes):
        kern = _build.spec_kernel(kernel_source())
        n = planes.shape[0]
        smem, shared, grid = launch_geometry(
            n, p, functools.partial(kern.resident, planes.device.index))
        kern.launch_with(planes, grid, smem, (
            ctypes.c_void_p(planes.data_ptr()), ctypes.c_longlong(n),
            (ctypes.c_int * len(row)).from_buffer_copy(row),
            ctypes.c_int(p), ctypes.c_bool(shared),
            ctypes.c_void_p(regs.data_ptr())))
        record_launch("hll_fold")
    note_kernel(planes.numel() * 4, (regs,))
    return regs
