"""QAP predicate expressions (paper Defs 1–3).

A *Filter*/*Rule* is a boolean expression over the TripleTensor planes; rule
composition ``∩``/``∪`` (Def 2–3) is ``&``/``|`` here. Expressions compile to

* a torch bool mask (``to_mask``) — the reference path, and
* a stack-machine **bytecode** shared by the CUDA scan kernels and their
  plain torch versions (``compile_program``), so one data pass evaluates
  many metrics.

Expressions are hashable/structurally-comparable, which the planner uses to
deduplicate identical counters across metrics (the paper's future-work
"dependency analysis to evaluate multiple metrics simultaneously").
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

# --- Bytecode opcodes --------------------------------------------------------
OP_HASBITS = 0   # push (plane[a] & b) == b
OP_ANYBITS = 1   # push (plane[a] & b) != 0
OP_LT = 2        # push plane[a] < b
OP_LE = 3
OP_GT = 4
OP_GE = 5
OP_EQ = 6
OP_NE = 7
OP_AND = 8       # pop y, x; push x & y
OP_OR = 9        # pop y, x; push x | y
OP_NOT = 10      # pop x; push ~x
OP_EQP = 11      # push plane[a] == plane[b]
OP_EMIT = 12     # pop x; counter[a] += popcount(x)

OP_NAMES = {v: k for k, v in list(globals().items()) if k.startswith("OP_")}

_CMP_OPS = {"lt": OP_LT, "le": OP_LE, "gt": OP_GT, "ge": OP_GE,
            "eq": OP_EQ, "ne": OP_NE}


class Expr:
    """Base class for QAP boolean expressions."""

    def __and__(self, other: "Expr") -> "Expr":
        return And(self, other)

    def __or__(self, other: "Expr") -> "Expr":
        return Or(self, other)

    def __invert__(self) -> "Expr":
        return Not(self)

    # -- compilation ---------------------------------------------------------
    def to_mask(self, planes: torch.Tensor) -> torch.Tensor:
        """torch bool mask of shape (N,). Reference semantics."""
        raise NotImplementedError

    def emit(self, code: list) -> None:
        """Append stack-machine instructions evaluating self."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class HasBits(Expr):
    plane: int
    mask: int

    def to_mask(self, planes):
        return (planes[:, self.plane] & self.mask) == self.mask

    def emit(self, code):
        code.append((OP_HASBITS, self.plane, self.mask))


@dataclasses.dataclass(frozen=True)
class AnyBits(Expr):
    plane: int
    mask: int

    def to_mask(self, planes):
        return (planes[:, self.plane] & self.mask) != 0

    def emit(self, code):
        code.append((OP_ANYBITS, self.plane, self.mask))


@dataclasses.dataclass(frozen=True)
class Cmp(Expr):
    plane: int
    op: str  # lt|le|gt|ge|eq|ne
    value: int

    def to_mask(self, planes):
        x = planes[:, self.plane]
        v = self.value
        return {"lt": x < v, "le": x <= v, "gt": x > v, "ge": x >= v,
                "eq": x == v, "ne": x != v}[self.op]

    def emit(self, code):
        code.append((_CMP_OPS[self.op], self.plane, self.value))


@dataclasses.dataclass(frozen=True)
class EqPlanes(Expr):
    plane_a: int
    plane_b: int

    def to_mask(self, planes):
        return planes[:, self.plane_a] == planes[:, self.plane_b]

    def emit(self, code):
        code.append((OP_EQP, self.plane_a, self.plane_b))


@dataclasses.dataclass(frozen=True)
class And(Expr):
    a: Expr
    b: Expr

    def to_mask(self, planes):
        return self.a.to_mask(planes) & self.b.to_mask(planes)

    def emit(self, code):
        self.a.emit(code)
        self.b.emit(code)
        code.append((OP_AND, 0, 0))


@dataclasses.dataclass(frozen=True)
class Or(Expr):
    a: Expr
    b: Expr

    def to_mask(self, planes):
        return self.a.to_mask(planes) | self.b.to_mask(planes)

    def emit(self, code):
        self.a.emit(code)
        self.b.emit(code)
        code.append((OP_OR, 0, 0))


@dataclasses.dataclass(frozen=True)
class Not(Expr):
    a: Expr

    def to_mask(self, planes):
        return ~self.a.to_mask(planes)

    def emit(self, code):
        self.a.emit(code)
        code.append((OP_NOT, 0, 0))


# --- Program compilation -----------------------------------------------------

def compile_program(exprs: Sequence[Expr]) -> tuple[tuple[int, int, int], ...]:
    """Compile counters[k] = popcount(exprs[k]) into one bytecode program."""
    code: list[tuple[int, int, int]] = []
    for k, e in enumerate(exprs):
        e.emit(code)
        code.append((OP_EMIT, k, 0))
    return tuple(code)


def program_stack_depth(program) -> int:
    depth = max_depth = 0
    for op, _, _ in program:
        if op in (OP_AND, OP_OR, OP_EMIT):
            depth -= 1
        if op not in (OP_AND, OP_OR, OP_NOT, OP_EMIT):
            depth += 1
        max_depth = max(max_depth, depth)
    assert depth == 0, "unbalanced program"
    return max_depth


VALID_PLANE = 3          # COL_S_FLAGS
VALID_BIT = 1 << 3       # vocab.VALID


def eval_program_torch(planes: torch.Tensor, program,
                       n_counters: int) -> torch.Tensor:
    """Reference stack-machine interpreter (what the CUDA kernels compute) →
    ``(n_counters,)`` int64 counts on ``planes.device``.

    Every EMIT is masked by the row VALID bit — padding rows are invisible
    to every counter by construction, not by predicate discipline."""
    stack = []
    counts = [torch.zeros((), dtype=torch.int64, device=planes.device)
              ] * n_counters
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
            counts[a] = counts[a] + (stack.pop() & valid).sum(
                dtype=torch.int64)
        else:
            raise ValueError(f"bad opcode {op}")
    assert not stack
    if not counts:
        return torch.zeros((0,), dtype=torch.int64, device=planes.device)
    return torch.stack(counts)
