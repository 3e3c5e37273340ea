"""Lower a scan plan to the CUDA source of one plan-specialized kernel.

The JAX kernels take the planner's bytecode as a static argument and unroll
it at trace time, so each plan gets its own straight-line kernel. This
module does the same for the card, in two steps:

1. ``lower`` turns ``(program, n_counters, sketch_specs)`` into a ``Dag``:
   each distinct leaf ``(op, a, b)`` appears once (as does each distinct
   AND/OR/NOT node), every EMIT becomes a root ``(counter, node)``, and the
   sketches' hash chains are listed by column prefix, so sketches that
   share a prefix hash it once (the memoization of
   ``repro/kernels/fused_scan/kernel.py::_sketch_update``).
2. ``generate`` prints that DAG as the CUDA C++ device function
   ``spec_row``: it reads the planes the plan needs from one staged row
   into registers, evaluates the leaves and nodes as ``bool`` values,
   adds each counter's bit (masked by the row's VALID bit) into a
   per-thread register slot fixed at compile time, and hashes the row into
   each sketch's register bank. The source defines the constants of the
   block structure and includes ``csrc/scan_spec.cuh``, the hand-written
   kernel around ``spec_row``; ``kernels._build`` compiles it with NVRTC.

Pure Python, no torch: the CPU tests run every step but the compile, and
``eval_dag_np`` evaluates a DAG with numpy so it can be held to the
interpreters. The output is deterministic: one plan, one source, one
digest.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
from typing import ClassVar, Optional, Sequence

import numpy as np

from .. import tracing

# opcodes, as core/expr.py numbers them (no import: this module stays
# free of torch)
OP_HASBITS, OP_ANYBITS, OP_LT, OP_LE, OP_GT, OP_GE, OP_EQ, OP_NE = range(8)
OP_AND, OP_OR, OP_NOT, OP_EQP, OP_EMIT = 8, 9, 10, 11, 12
LEAF_OPS = frozenset((OP_HASBITS, OP_ANYBITS, OP_LT, OP_LE, OP_GT, OP_GE,
                      OP_EQ, OP_NE, OP_EQP))
VALID_PLANE = 3                # COL_S_FLAGS
VALID_BIT = 1 << 3             # vocab.VALID
N_PLANES = 13
ROW_BYTES = 4 * N_PLANES
# the tracing counter of the wall time spent getting kernels: printing a
# plan here, reading or compiling its cubin and loading it (``_build``)
BUILD_BUSY = "kernel.build_ns"
# the HLL hash of scan_common.cuh, for the numpy oracle only: the generated
# code calls scan_common.cuh's HASH_SEED, hash_step and fmix32
HASH_SALT = 0x9E3779B9
HASH_MUL, HASH_ADD = 5, 0xE6546B64
# register banks up to this size live in a block's shared memory, larger
# ones in the global output (scan_common.cuh::SHARED_BANK_BYTES)
SHARED_BANK_BYTES = 64 * 1024


@dataclasses.dataclass(frozen=True)
class Dag:
    """A plan as a DAG. ``nodes[i]`` is ``(op, a, b)``: for a leaf the
    bytecode's own operands (plane, immediate or second plane); for
    AND/OR the ids of its two children; for NOT ``(OP_NOT, child, -1)``.
    Children precede their parents."""
    nodes: tuple[tuple[int, int, int], ...]
    emits: tuple[tuple[int, int], ...]          # (counter, node), in order
    n_counters: int
    sketches: tuple[tuple[str, tuple[int, ...]], ...]
    prefixes: tuple[tuple[int, ...], ...]       # hash chains, shortest first
    planes: tuple[int, ...]                     # every plane a row read

    @property
    def leaves(self) -> tuple[tuple[int, int, int], ...]:
        return tuple(n for n in self.nodes if n[0] in LEAF_OPS)


def lower(program: Sequence[Sequence[int]], n_counters: int,
          sketch_specs=()) -> Dag:
    """The bytecode as a DAG with common subexpressions merged."""
    index: dict[tuple[int, int, int], int] = {}
    nodes: list[tuple[int, int, int]] = []

    def node(key):
        i = index.get(key)
        if i is None:
            i = index[key] = len(nodes)
            nodes.append(key)
        return i

    stack: list[int] = []
    emits = []
    for op, a, b in program:
        op, a, b = int(op), int(a), int(b)
        if op in LEAF_OPS:
            stack.append(node((op, a, b)))
        elif op in (OP_AND, OP_OR):
            y, x = stack.pop(), stack.pop()
            stack.append(node((op, x, y)))
        elif op == OP_NOT:
            stack.append(node((op, stack.pop(), -1)))
        elif op == OP_EMIT:
            emits.append((a, stack.pop()))
        else:
            raise ValueError(f"bad opcode {op}")
    if stack:
        raise ValueError("unbalanced program")
    planes = set()
    for op, a, b in nodes:
        if op in LEAF_OPS:
            planes.add(a)
            if op == OP_EQP:
                planes.add(b)
    sketches = tuple((str(name), tuple(int(c) for c in cols))
                     for name, cols in sketch_specs)
    prefixes: dict[tuple[int, ...], None] = {}
    for _, cols in sketches:
        for j in range(1, len(cols) + 1):
            prefixes.setdefault(cols[:j])
        planes.update(cols)
    if emits or sketches:
        planes.add(VALID_PLANE)
    return Dag(nodes=tuple(nodes), emits=tuple(emits), n_counters=n_counters,
               sketches=sketches,
               prefixes=tuple(sorted(prefixes, key=lambda c: (len(c), c))),
               planes=tuple(sorted(planes)))


def eval_dag_np(dag: Dag, planes: np.ndarray) -> np.ndarray:
    """The DAG's counters over (N, 13) int32 planes, with numpy."""
    planes = np.asarray(planes)
    vals: list[np.ndarray] = []
    for op, a, b in dag.nodes:
        if op == OP_AND:
            vals.append(vals[a] & vals[b])
        elif op == OP_OR:
            vals.append(vals[a] | vals[b])
        elif op == OP_NOT:
            vals.append(~vals[a])
        else:
            x = planes[:, a]
            vals.append({OP_HASBITS: lambda: (x & b) == b,
                         OP_ANYBITS: lambda: (x & b) != 0,
                         OP_LT: lambda: x < b, OP_LE: lambda: x <= b,
                         OP_GT: lambda: x > b, OP_GE: lambda: x >= b,
                         OP_EQ: lambda: x == b, OP_NE: lambda: x != b,
                         OP_EQP: lambda: x == planes[:, b]}[op]())
    valid = (planes[:, VALID_PLANE] & VALID_BIT) != 0
    counts = np.zeros((dag.n_counters,), np.int64)
    for k, i in dag.emits:
        counts[k] += int((vals[i] & valid).sum())
    return counts


def _fmix32_np(x: np.ndarray) -> np.ndarray:
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x85EBCA6B)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(0xC2B2AE35)
    return x ^ (x >> np.uint32(16))


def sketch_registers_np(dag: Dag, planes: np.ndarray,
                        p: int) -> dict[str, np.ndarray]:
    """Each sketch's (2^p,) int32 registers over (N, 13) int32 planes,
    hashed as the generated code hashes: one chain state per column
    prefix, shared by the sketches that start with it."""
    words = np.asarray(planes).view(np.uint32)
    chain = {(): np.full((words.shape[0],), HASH_SALT, np.uint32)}
    with np.errstate(over="ignore"):
        for pre in dag.prefixes:
            chain[pre] = (_fmix32_np(chain[pre[:-1]] ^ words[:, pre[-1]])
                          * np.uint32(HASH_MUL) + np.uint32(HASH_ADD))
        out = {}
        for name, cols in dag.sketches:
            f = _fmix32_np(chain[cols])
            w = (f << np.uint32(p)).astype(np.uint32)
            bits = np.frexp(w.astype(np.float64))[1]   # bit length of w
            rank = np.where(w == 0, 33 - p, 33 - bits)
            rank = np.where(words[:, VALID_PLANE] == 0, 0, rank)
            regs = np.zeros((1 << p,), np.int32)
            np.maximum.at(regs, (f >> np.uint32(32 - p)).astype(np.int64),
                          rank.astype(np.int32))
            out[name] = regs
    return out


# --- the block structure ------------------------------------------------------
# Threads a block, rows a tile (a multiple of 4 and of THREADS, so a tile is
# whole 16-byte words) and tiles in the ring of shared-memory stages: two
# blocks an SM with two sketches' banks at p = 12 (112,640 B of shared
# memory each). Other structures timed on an H100 were no faster (PERF.md).
THREADS = 256
TILE_ROWS = 512
STAGES = 3


@dataclasses.dataclass(frozen=True)
class KernelSource:
    """The generated source and what the launcher needs to know of it."""
    entry: ClassVar[str] = "scan_spec"      # the kernel's name in the cubin
    threads: ClassVar[int] = THREADS
    source: str
    digest: str                 # sha256 of ``source``
    dag: Dag
    p: int                      # 0 when the plan has no sketches
    shared_banks: bool
    smem_bytes: int             # dynamic shared memory a block
    row_bytes: int              # bytes of a row the kernel stages and reads

    @property
    def n_sketches(self) -> int:
        return len(self.dag.sketches)


def _imm(v: int) -> str:
    v = int(v)
    if not -2**31 <= v < 2**31:
        raise ValueError(f"immediate {v} out of int32")
    return "(-2147483647 - 1)" if v == -2**31 else str(v)


def _leaf(op: int, a: int, b: int) -> str:
    x = f"x{a}"
    if op == OP_HASBITS:
        return f"({x} & {_imm(b)}) == {_imm(b)}"
    if op == OP_ANYBITS:
        return f"({x} & {_imm(b)}) != 0"
    if op == OP_EQP:
        return f"{x} == x{b}"
    cmp = {OP_LT: "<", OP_LE: "<=", OP_GT: ">", OP_GE: ">=", OP_EQ: "==",
           OP_NE: "!="}[op]
    return f"{x} {cmp} {_imm(b)}"


def _row_function(dag: Dag, p: int, shared_banks: bool) -> list[str]:
    out = ["__device__ __forceinline__ void spec_row(",
           "    const int* __restrict__ row, unsigned* __restrict__ cnt,",
           "    int* __restrict__ banks) {"]
    out += [f"  const int x{j} = row[{j}];" for j in dag.planes]
    for i, (op, a, b) in enumerate(dag.nodes):
        if op == OP_AND:
            e = f"t{a} && t{b}"
        elif op == OP_OR:
            e = f"t{a} || t{b}"
        elif op == OP_NOT:
            e = f"!t{a}"
        else:
            e = _leaf(op, a, b)
        out.append(f"  const bool t{i} = {e};")
    if dag.emits:
        out.append(f"  const bool valid = (x{VALID_PLANE} & {VALID_BIT}) "
                   f"!= 0;")
        out += [f"  cnt[{k}] += (unsigned)(valid && t{i});"
                for k, i in dag.emits]
    if dag.sketches:
        chain = {(): "HASH_SEED"}
        for j, pre in enumerate(dag.prefixes):
            out.append(f"  const uint32_t h{j} = hash_step({chain[pre[:-1]]}, "
                       f"(uint32_t)x{pre[-1]});")
            chain[pre] = f"h{j}"
        out.append(f"  if (x{VALID_PLANE} != 0) {{  // not a padding row")
        for s, (name, cols) in enumerate(dag.sketches):
            out += [f"    {{  // sketch {s}: {name} over planes "
                    f"{', '.join(map(str, cols))}",
                    f"      const uint32_t f = fmix32({chain[cols]});",
                    f"      raise_to(banks + {s << p} + (int)(f >> {32 - p}),"
                    f" hll_rank(f, {p}), {str(shared_banks).lower()});",
                    "    }"]
        out.append("  }")
    out.append("}")
    return out


def generate(program: Sequence[Sequence[int]], n_counters: int,
             sketch_specs=(), p: Optional[int] = None) -> KernelSource:
    """The CUDA source of the kernel specialized to one plan: with no
    sketches it computes ``qap_count``'s counters, with sketches
    ``fused_scan``'s counters and register banks (``p`` bits of bucket)."""
    dag = lower(program, n_counters, sketch_specs)
    if dag.sketches:
        if p is None:
            raise ValueError("a plan with sketches needs p")
        bank_bytes = 4 * (len(dag.sketches) << p)
    else:
        p, bank_bytes = 0, 0
    shared_banks = 0 < bank_bytes <= SHARED_BANK_BYTES
    smem = STAGES * TILE_ROWS * ROW_BYTES \
        + (bank_bytes if shared_banks else 0)
    n_leaves = len(dag.leaves)
    lines = [
        "// Generated by repro_torch/kernels/scan_codegen.py: "
        f"{n_counters} counters, {len(dag.emits)} emits, {n_leaves} "
        f"distinct leaves, {len(dag.nodes) - n_leaves} logic nodes,",
        f"// {len(dag.sketches)} sketches"
        + (f" at p = {p} ({'shared' if shared_banks else 'global'} banks)"
           if dag.sketches else "")
        + f", planes read: {', '.join(map(str, dag.planes)) or 'none'}.",
        f"#define SPEC_THREADS {THREADS}",
        f"#define SPEC_TILE_ROWS {TILE_ROWS}",
        f"#define SPEC_STAGES {STAGES}",
        f"#define SPEC_N_COUNTERS {n_counters}",
        f"#define SPEC_N_SKETCHES {len(dag.sketches)}",
        f"#define SPEC_P {p}",
        f"#define SPEC_SHARED_BANKS {int(shared_banks)}",
        '#include "scan_spec.cuh"',
        "",
        "namespace scan {",
        "",
        *_row_function(dag, p, shared_banks),
        "",
        "}  // namespace scan",
        ""]
    source = "\n".join(lines)
    return KernelSource(source=source,
                        digest=hashlib.sha256(source.encode()).hexdigest(),
                        dag=dag, p=p,
                        shared_banks=shared_banks, smem_bytes=smem,
                        row_bytes=ROW_BYTES)


@functools.lru_cache(maxsize=256)
def generate_cached(program: tuple, n_counters: int, sketch_specs: tuple,
                    p: Optional[int]) -> KernelSource:
    """``generate``, cached by plan (the wrappers call it on every
    launch). A miss is a ``BUILD_BUSY`` block (``repro_torch.tracing``)."""
    with tracing.busy(BUILD_BUSY):
        return generate(program, n_counters, sketch_specs, p)
