"""The generator of the plan-specialized scan kernel
(``repro_torch.kernels.scan_codegen``) against the interpreters.

The DAG a program lowers to is evaluated with numpy and held to the port's
numpy interpreter (``qap_count/ref.py::counts_ref_np``) and to the JAX
package's ``fused_count`` kernel in Pallas interpret mode, on random
programs covering all 13 opcodes, up to 128 counters and a stack 16 deep.
The sketches' prefix-shared hash chains are held to the JAX HLL oracle.
Inputs are numpy arrays made from a seed. Tolerance: exact (integer counts
and register maxima). The CUDA source itself compiles only on the card
(``gpu`` tests in ``test_torch_kernels.py``); here its text is checked.
"""
import pathlib

import numpy as np
import pytest

import jax.numpy as jnp

from repro.core import expr as JE
from repro.kernels.hll import ref as j_href
from repro.kernels.qap_count import ops as j_qops

from repro_torch.core import expr as TE
from repro_torch.core.metrics import (ALL_METRICS, PAPER_METRICS,
                                      get_metrics)
from repro_torch.core.planner import plan
from repro_torch.kernels import scan_codegen as sc
from repro_torch.kernels.qap_count import ops as qops, ref as qref
from repro_torch.rdf import synth_encoded
from repro_torch.rdf.triple_tensor import N_PLANES

CSRC = pathlib.Path(sc.__file__).resolve().parent.parent / "csrc"
FULL_PLAN = plan(get_metrics(ALL_METRICS))
PAPER_PLAN = plan(get_metrics(PAPER_METRICS))

_CMP = ["lt", "le", "gt", "ge", "eq", "ne"]


def _planes(n, seed):
    """Half synthetic BSBM-like rows, half rows of small random integers
    and random bits (so every comparison and bit test goes both ways),
    with a few zero rows."""
    rng = np.random.default_rng(seed)
    real = synth_encoded(n, seed=seed).planes[: n // 2]
    noise = rng.integers(-4, 120, size=(n - n // 2, N_PLANES), dtype=np.int32)
    bits = rng.integers(0, 1 << 15, size=noise.shape, dtype=np.int32)
    noise = np.where(rng.random(noise.shape) < 0.5, noise, bits)
    planes = np.concatenate([real, noise]).astype(np.int32)
    planes[rng.integers(0, n, size=max(1, n // 50))] = 0
    return np.ascontiguousarray(planes)


def _rand_expr(rng, E, depth):
    if depth == 0 or rng.random() < 0.25:
        kind = int(rng.integers(4))
        plane = int(rng.integers(N_PLANES))
        if kind == 0:
            return E.HasBits(plane, int(rng.integers(1, 1 << 15)))
        if kind == 1:
            return E.AnyBits(plane, 1 << int(rng.integers(15)))
        if kind == 2:
            return E.Cmp(plane, _CMP[int(rng.integers(6))],
                         int(rng.integers(-4, 120)))
        return E.EqPlanes(plane, int(rng.integers(N_PLANES)))
    kind = int(rng.integers(3))
    if kind == 2:
        return E.Not(_rand_expr(rng, E, depth - 1))
    a = _rand_expr(rng, E, depth - 1)
    b = _rand_expr(rng, E, depth - 1)
    return E.And(a, b) if kind == 0 else E.Or(a, b)


def _cover_exprs(E):
    """Counters whose program uses all 13 opcodes, with repeated leaves."""
    return [E.HasBits(3, 8) & E.AnyBits(5, 3),
            E.Cmp(6, "lt", 40) | E.Cmp(7, "le", 38),
            ~E.Cmp(8, "gt", 80) & E.Cmp(9, "ge", 1),
            E.Cmp(5, "eq", 0) | E.Cmp(9, "ne", 0),
            E.EqPlanes(0, 2) | ~E.EqPlanes(10, 12),
            ~(E.HasBits(3, 8) | (E.AnyBits(5, 3) & ~E.Cmp(6, "lt", 40)))]


def _deep(E, depth):
    """A right-nested chain whose program needs a stack ``depth`` deep."""
    e = E.Cmp(6, "gt", 20)
    for i in range(depth - 1):
        e = (E.And if i % 2 else E.Or)(E.HasBits(3 + i % 6, 1 << i), e)
    return e


def _programs(seed, E):
    """(program, n_counters) of one case: random counters, the
    opcode-cover counters, and for seed 0 a 128-counter program with a
    16-deep stack."""
    rng = np.random.default_rng(seed)
    if seed == 0:
        exprs = [_rand_expr(rng, E, 3) for _ in range(qops.COUNTS_WIDTH - 1)]
        exprs.append(_deep(E, qops.MAX_STACK))
    else:
        exprs = [_rand_expr(rng, E, 4)
                 for _ in range(int(rng.integers(1, 12)))] + _cover_exprs(E)
    return E.compile_program(exprs), len(exprs)


@pytest.mark.parametrize("seed", range(6))
def test_dag_equals_interpreters_on_random_programs(seed):
    program, k = _programs(seed, TE)
    j_program, j_k = _programs(seed, JE)
    assert program == j_program and k == j_k
    assert {op for op, _, _ in program} == set(range(13))
    if seed == 0:
        assert k == qops.COUNTS_WIDTH
        assert qops.check_program(program, k) == qops.MAX_STACK
    planes = _planes(640 + 37 * seed, seed)
    dag = sc.lower(program, k)
    got = sc.eval_dag_np(dag, planes)
    np.testing.assert_array_equal(got, qref.counts_ref_np(planes, program, k))
    want = np.asarray(j_qops.fused_count(jnp.asarray(planes), j_program, k),
                      np.int64)
    np.testing.assert_array_equal(got, want)


def test_dag_repeated_emits_add_up():
    """A program may EMIT into one counter twice: the counts add."""
    program = ((TE.OP_GT, 6, 10), (TE.OP_EMIT, 0, 0),
               (TE.OP_GT, 6, 10), (TE.OP_NOT, 0, 0), (TE.OP_EMIT, 0, 0),
               (TE.OP_EQ, 7, 3), (TE.OP_EMIT, 2, 0))
    planes = _planes(500, 1)
    dag = sc.lower(program, 3)
    assert len(dag.leaves) == 2 and len(dag.emits) == 3
    np.testing.assert_array_equal(sc.eval_dag_np(dag, planes),
                                  qref.counts_ref_np(planes, program, 3))


def test_plans_lower_to_distinct_leaves():
    dag = sc.lower(FULL_PLAN.program, FULL_PLAN.n_counters,
                   FULL_PLAN.sketch_specs)
    assert len(FULL_PLAN.program) == 113
    assert len(dag.leaves) == 28 and len(dag.emits) == 23
    assert sum(op == TE.OP_EMIT for op, _, _ in FULL_PLAN.program) == 23
    assert [k for k, _ in dag.emits] == list(range(23))
    assert dag.planes == (0, 2, 3, 4, 5, 6, 7, 8, 10, 11, 12)
    # spo = (10, 11, 12) and p = (11,): four chain states, none repeated
    assert dag.prefixes == ((10,), (11,), (10, 11), (10, 11, 12))
    paper = sc.lower(PAPER_PLAN.program, PAPER_PLAN.n_counters)
    assert len(PAPER_PLAN.program) == 71
    assert len(paper.leaves) == 19 and len(paper.emits) == 10
    planes = _planes(3000, 5)
    for pln, d in ((FULL_PLAN, dag), (PAPER_PLAN, paper)):
        np.testing.assert_array_equal(
            sc.eval_dag_np(d, planes),
            qref.counts_ref_np(planes, pln.program, pln.n_counters))


@pytest.mark.parametrize("p", [4, 8, 12, 16])
def test_prefix_shared_hash_chains_equal_the_oracle(p):
    """Sketches sharing column prefixes hash each prefix once; every bank
    equals the JAX HLL oracle's for that sketch alone."""
    specs = (("spo", (10, 11, 12)), ("sp", (10, 11)), ("p", (11,)),
             ("ps", (11, 10)), ("o", (12,)))
    dag = sc.lower((), 0, specs)
    assert dag.prefixes == ((10,), (11,), (12,), (10, 11), (11, 10),
                            (10, 11, 12))
    planes = _planes(4001, p)
    regs = sc.sketch_registers_np(dag, planes, p)
    valid = planes[:, 3] != 0
    for name, cols in specs:
        np.testing.assert_array_equal(
            regs[name], j_href.hll_fold_ref(planes, cols, p, valid=valid),
            name)
    src = sc.generate((), 0, specs, p).source
    # the chain is scan_common.cuh's: hash_step per prefix, fmix32 per
    # sketch, no constant of the hash printed
    assert src.count("hash_step(") == len(dag.prefixes)
    assert src.count("hash_step(HASH_SEED, ") == 3
    assert src.count("fmix32(") == len(specs)
    assert "0x9E3779B9" not in src and "0xE6546B64" not in src


def test_source_and_digest_are_deterministic():
    args = (FULL_PLAN.program, FULL_PLAN.n_counters, FULL_PLAN.sketch_specs)
    a, b = sc.generate(*args, 12), sc.generate(*args, 12)
    assert a.source == b.source and a.digest == b.digest
    assert len(a.digest) == 64
    variants = [
        sc.generate(*args, 13),
        sc.generate(FULL_PLAN.program, FULL_PLAN.n_counters,
                    (("spo", (10, 11, 12)), ("p", (12,))), 12),
        sc.generate(FULL_PLAN.program, FULL_PLAN.n_counters,
                    FULL_PLAN.sketch_specs[:1], 12),
        sc.generate(FULL_PLAN.program[:-1] + ((TE.OP_EMIT, 21, 0),),
                    FULL_PLAN.n_counters, FULL_PLAN.sketch_specs, 12),
        sc.generate(FULL_PLAN.program, FULL_PLAN.n_counters,
                    tuple(reversed(FULL_PLAN.sketch_specs)), 12),
        sc.generate(PAPER_PLAN.program, PAPER_PLAN.n_counters),
    ]
    digests = {a.digest} | {v.digest for v in variants}
    assert len(digests) == len(variants) + 1
    assert sc.generate_cached(tuple(FULL_PLAN.program), FULL_PLAN.n_counters,
                              tuple(FULL_PLAN.sketch_specs), 12) == a


def test_no_interpreter_left():
    """The generated source is straight-line code over constant counter
    slots, and the interpreter is gone from the kernel sources."""
    cover = TE.compile_program(_cover_exprs(TE))
    for src in (sc.generate(FULL_PLAN.program, FULL_PLAN.n_counters,
                            FULL_PLAN.sketch_specs, 12),
                sc.generate(PAPER_PLAN.program, PAPER_PLAN.n_counters),
                sc.generate(cover, 6, (("o", (12,)),), 8)):
        text = src.source
        for word in ("run_program", "eval_leaf", "valid_bits", "switch",
                     "prog[", "program", "for (", "while"):
            assert word not in text, word
        for k, _ in src.dag.emits:
            assert f"cnt[{k}] +=" in text
        assert '#include "scan_spec.cuh"' in text
    # and every kernel source is device code alone, for NVRTC: no host
    # launch, runtime API or C entry point, no second compiler to serve
    for f in CSRC.iterdir():
        text = f.read_text()
        for word in ("run_program", "eval_leaf", "valid_bits", "OP_EMIT",
                     "<<<", "cudaError_t", "cuda_runtime.h",
                     'extern "C" int', "__CUDACC_RTC__"):
            assert word not in text, (f.name, word)
    assert sorted(f.name for f in CSRC.iterdir()) == [
        "hll_fold.cu", "scan_common.cuh", "scan_spec.cuh"]
    assert 'extern "C" __global__ void __launch_bounds__(THREADS)\n' \
        "hll_fold_kernel(" in (CSRC / "hll_fold.cu").read_text()


@pytest.mark.parametrize("n_sketches, p, shared", [
    (2, 12, True), (2, 13, True), (1, 14, True), (2, 14, False),
    (2, 16, False), (1, 20, False)])
def test_banks_placed_at_generation(n_sketches, p, shared):
    """Banks up to 64 KiB go in shared memory, larger ones stay global;
    the block's dynamic shared memory holds the stages and shared banks."""
    specs = FULL_PLAN.sketch_specs[:n_sketches]
    src = sc.generate(FULL_PLAN.program, FULL_PLAN.n_counters, specs, p)
    assert src.shared_banks is shared and src.p == p
    assert f"#define SPEC_SHARED_BANKS {int(shared)}" in src.source
    assert f"hll_rank(f, {p}), {'true' if shared else 'false'})" \
        in src.source
    # the block structure meets scan_spec.cuh's static_asserts
    assert sc.THREADS % 32 == 0 and sc.TILE_ROWS % sc.THREADS == 0
    assert sc.TILE_ROWS * 52 % 16 == 0
    stages = sc.STAGES * sc.TILE_ROWS * 52
    assert src.smem_bytes == stages + (4 * (n_sketches << p) if shared
                                       else 0)
    assert src.smem_bytes <= 227 * 1024


def test_generator_rejects_what_it_cannot_print():
    with pytest.raises(ValueError, match="unbalanced"):
        sc.lower(((TE.OP_GT, 6, 1),), 1)
    with pytest.raises(ValueError, match="opcode"):
        sc.lower(((99, 0, 0),), 1)
    with pytest.raises(ValueError, match="needs p"):
        sc.generate((), 0, (("o", (12,)),))
    # the int32 extremes print as valid C
    src = sc.generate(((TE.OP_GE, 6, -2**31), (TE.OP_EMIT, 0, 0),
                       (TE.OP_LT, 6, 2**31 - 1), (TE.OP_EMIT, 1, 0)), 2)
    assert "(-2147483647 - 1)" in src.source and "2147483647" in src.source
