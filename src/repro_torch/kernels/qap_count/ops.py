"""Public wrapper around the qap_count CUDA kernel: the plan-specialized
scan kernel (``csrc/scan_spec.cuh``) generated for the program with no
sketches (``kernels/scan_codegen.py``), compiled with NVRTC on first use.

For a CUDA tensor the wrapper launches the kernel or raises; for a CPU
tensor it runs the plain torch version (``ref.counts_ref``). There is no
fallback from one to the other. A fake or meta tensor on the card
(``kernels.shape_only``) gets its output's shape and no launch.
"""
from __future__ import annotations

import torch

from ... import tracing
from .. import _build, note_kernel, record_launch, record_scan, shape_only
from ...core.expr import OP_AND, OP_EMIT, OP_EQP, OP_NOT, OP_OR
from ...rdf.triple_tensor import N_PLANES
from .ref import counts_ref

COUNTS_WIDTH = 128   # most counters one program may have (kernel's table)
MAX_STACK = 16       # deepest evaluation stack a program may have
MAX_INSTR = 4096     # longest program the generator takes


def check_planes(planes: torch.Tensor) -> None:
    if not isinstance(planes, torch.Tensor):
        raise TypeError(f"planes must be a torch.Tensor, got "
                        f"{type(planes).__name__}")
    if planes.dtype != torch.int32:
        raise TypeError(f"planes must be int32, got {planes.dtype}")
    if planes.dim() != 2 or planes.shape[1] != N_PLANES:
        raise ValueError(f"planes must be (N, {N_PLANES}), got "
                         f"{tuple(planes.shape)}")
    if planes.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"planes must be on cuda or cpu (or meta, for "
                         f"shapes), got {planes.device}")
    if planes.device.type == "cuda" and not planes.is_contiguous():
        raise ValueError("planes must be contiguous")


def check_program(program, n_counters: int) -> int:
    """Validate a bytecode program against the kernels' limits; returns
    its stack depth."""
    if not 0 <= n_counters <= COUNTS_WIDTH:
        raise ValueError(f"{n_counters} counters; the kernels take at most "
                         f"{COUNTS_WIDTH}")
    if len(program) > MAX_INSTR:
        raise ValueError(f"program of {len(program)} instructions; the "
                         f"kernels take at most {MAX_INSTR}")
    depth = max_depth = 0
    for op, a, b in program:
        if not 0 <= op <= OP_EMIT:
            raise ValueError(f"bad opcode {op}")
        if op == OP_EMIT:
            if not 0 <= a < n_counters:
                raise ValueError(f"EMIT to counter {a} of {n_counters}")
        elif op not in (OP_AND, OP_OR, OP_NOT):
            if not 0 <= a < N_PLANES or (op == OP_EQP
                                         and not 0 <= b < N_PLANES):
                raise ValueError(f"plane out of range in {(op, a, b)}")
            if not -2**31 <= b < 2**31:
                raise ValueError(f"immediate out of int32 in {(op, a, b)}")
        depth += -1 if op in (OP_AND, OP_OR, OP_EMIT) else (
            0 if op == OP_NOT else 1)
        if depth < (0 if op == OP_EMIT else 1):
            raise ValueError("unbalanced program")
        max_depth = max(max_depth, depth)
    if depth:
        raise ValueError("unbalanced program")
    if max_depth > MAX_STACK:
        raise ValueError(f"stack depth {max_depth}; the kernels take at "
                         f"most {MAX_STACK}")
    return max_depth


def fused_count(planes: torch.Tensor, program, n_counters: int):
    """Evaluate the fused bytecode over (N, 13) planes → (n_counters,)
    int64 counts. Zero rows (padding) carry no VALID bit and count in no
    counter; the kernel masks the ragged tail itself."""
    record_scan(1)
    with tracing.span("kernel.check"):
        check_planes(planes)
        check_program(program, n_counters)
    if planes.device.type == "cpu":
        return counts_ref(planes, program, n_counters)
    with tracing.span("kernel.outputs"):
        counts = torch.zeros((n_counters,), dtype=torch.int64,
                             device=planes.device)
    if planes.shape[0] and program and not shape_only(planes):
        with torch.cuda.device(planes.device):
            _build.launch_scan(planes, program, n_counters, (), None, counts,
                               None)
        record_launch("qap_count")
    note_kernel(planes.numel() * 4, (counts,))
    return counts
