"""Plain torch version of the qap_count kernel (the same function, with
torch ops), plus an independent numpy interpreter.

* ``counts_ref`` — the shared stack-machine interpreter in torch
  (``core.expr.eval_program_torch``): what the kernel's wrapper runs for a
  CPU tensor, what the ``"torch"`` backend runs, and what the kernel is
  held to on the card.
* ``counts_ref_np`` — a from-scratch numpy interpreter (no torch), so the
  kernel, the torch interpreter, and this one triangulate each other.
"""
from __future__ import annotations

import numpy as np

from ...core.expr import (OP_AND, OP_ANYBITS, OP_EMIT, OP_EQ, OP_EQP, OP_GE,
                          OP_GT, OP_HASBITS, OP_LE, OP_LT, OP_NE, OP_NOT,
                          OP_OR, VALID_BIT, VALID_PLANE, eval_program_torch)


# (N, 13) int32 torch planes → (n_counters,) int64 counts
counts_ref = eval_program_torch


def counts_ref_np(planes: np.ndarray, program, n_counters: int) -> np.ndarray:
    planes = np.asarray(planes)
    stack: list[np.ndarray] = []
    counts = np.zeros((n_counters,), np.int64)
    valid = (planes[:, VALID_PLANE] & VALID_BIT) != 0
    for op, a, b in program:
        if op == OP_HASBITS:
            stack.append((planes[:, a] & b) == b)
        elif op == OP_ANYBITS:
            stack.append((planes[:, a] & b) != 0)
        elif op == OP_LT:
            stack.append(planes[:, a] < b)
        elif op == OP_LE:
            stack.append(planes[:, a] <= b)
        elif op == OP_GT:
            stack.append(planes[:, a] > b)
        elif op == OP_GE:
            stack.append(planes[:, a] >= b)
        elif op == OP_EQ:
            stack.append(planes[:, a] == b)
        elif op == OP_NE:
            stack.append(planes[:, a] != b)
        elif op == OP_EQP:
            stack.append(planes[:, a] == planes[:, b])
        elif op == OP_AND:
            y = stack.pop(); x = stack.pop()
            stack.append(x & y)
        elif op == OP_OR:
            y = stack.pop(); x = stack.pop()
            stack.append(x | y)
        elif op == OP_NOT:
            stack.append(~stack.pop())
        elif op == OP_EMIT:
            counts[a] += int((stack.pop() & valid).sum())
        else:
            raise ValueError(f"bad opcode {op}")
    assert not stack
    return counts
