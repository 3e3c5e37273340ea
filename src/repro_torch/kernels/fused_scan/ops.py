"""Public wrapper for the fused counts+sketches CUDA kernel: the
plan-specialized scan kernel (``csrc/scan_spec.cuh``) generated for the
program and the sketches (``kernels/scan_codegen.py``), compiled with
NVRTC on first use.

For a CUDA tensor the wrapper launches the kernel or raises; for a CPU
tensor it runs the plain torch version (``ref.fused_scan_torch``). There
is no fallback from one to the other. A fake or meta tensor on the card
(``kernels.shape_only``) gets its outputs' shapes and no launch.
"""
from __future__ import annotations

import numpy as np
import torch

from ... import tracing
from .. import _build, note_kernel, record_launch, record_scan, shape_only
from ..qap_count.ops import check_planes, check_program, fused_count
from ...rdf.triple_tensor import N_PLANES
from .ref import fused_scan_torch

MAX_SKETCHES = 16    # most sketches one plan may have
P_RANGE = (4, 20)    # register bank sizes 2^4 .. 2^20


def check_sketches(sketch_specs, p: int) -> np.ndarray:
    """Validate sketch specs and ``p``; returns a host table, one row of
    ``N_PLANES + 1`` int32 per sketch, ``(n_cols, cols...)`` (``hll_fold``
    takes its columns from it)."""
    if not P_RANGE[0] <= p <= P_RANGE[1]:
        raise ValueError(f"hll p={p}; the kernel takes {P_RANGE[0]}.."
                         f"{P_RANGE[1]}")
    if len(sketch_specs) > MAX_SKETCHES:
        raise ValueError(f"{len(sketch_specs)} sketches; the kernel takes "
                         f"at most {MAX_SKETCHES}")
    table = np.zeros((len(sketch_specs), N_PLANES + 1), np.int32)
    for i, (name, cols) in enumerate(sketch_specs):
        if not 1 <= len(cols) <= N_PLANES or not all(
                0 <= c < N_PLANES for c in cols):
            raise ValueError(f"sketch {name!r}: bad columns {cols}")
        table[i, 0] = len(cols)
        table[i, 1:1 + len(cols)] = cols
    return table


def fused_scan(planes: torch.Tensor, program, n_counters: int,
               sketch_specs: tuple[tuple[str, tuple[int, ...]], ...],
               p: int):
    """ONE pass over (N, 13) planes → ((n_counters,) int64 counts,
    {sketch name: (2^p,) int32 registers}).

    Zero rows (padding) are invisible: they carry no VALID bit for the
    counters, and rows whose s_flags plane is 0 fold no rank into any
    register. The kernel masks the ragged tail itself.
    """
    if not sketch_specs:        # pure-counter plan: the qap_count kernel IS
        return fused_count(planes, program, n_counters), {}  # the one pass
    record_scan(1)
    with tracing.span("kernel.check"):
        check_planes(planes)
        check_program(program, n_counters)
        check_sketches(sketch_specs, p)
    if planes.device.type == "cpu":
        return fused_scan_torch(planes, program, n_counters, sketch_specs, p)
    dev = planes.device
    with tracing.span("kernel.outputs"):
        counts = torch.zeros((n_counters,), dtype=torch.int64, device=dev)
        regs = torch.zeros((len(sketch_specs), 1 << p), dtype=torch.int32,
                           device=dev)
    if planes.shape[0] and not shape_only(planes):
        with torch.cuda.device(dev):
            _build.launch_scan(planes, program, n_counters, sketch_specs, p,
                               counts, regs)
        record_launch("fused_scan")
    note_kernel(planes.numel() * 4, (counts, regs))
    return counts, {name: regs[i] for i, (name, _) in enumerate(sketch_specs)}
