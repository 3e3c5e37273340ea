"""The port's scan-kernel wrappers (``repro_torch.kernels``) against the JAX
package's Pallas kernels.

On the CPU the wrappers run their plain torch versions; the JAX kernels run
in Pallas interpret mode, as the JAX package's own tests run them. Inputs
are numpy arrays made from a seed and handed to both. Tolerance: exact —
counters are integer sums and registers integer maxima, so every value
must be bit-identical.

Tests marked ``gpu`` hold the CUDA kernels to the plain versions on the
card; they skip where there is none.
"""
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import expr as JE
from repro.core.metrics import ALL_METRICS as J_ALL, get_metrics as j_get
from repro.core.planner import plan as j_plan
from repro.kernels.fused_scan import ops as j_fops
from repro.kernels.hll import ops as j_hops, ref as j_href
from repro.kernels.qap_count import ops as j_qops, ref as j_qref

from repro_torch import kernels as K
from repro_torch.kernels import _build, scan_codegen
from repro_torch.core import expr as TE
from repro_torch.core.metrics import (ALL_METRICS, PAPER_METRICS,
                                      get_metrics)
from repro_torch.core.planner import plan
from repro_torch.kernels.fused_scan import ops as fops, ref as fref
from repro_torch.kernels.hll import ops as hops, ref as href
from repro_torch.kernels.qap_count import ops as qops, ref as qref
from repro_torch.rdf import synth_encoded
from repro_torch.rdf.triple_tensor import (COL_P_HASH, COL_S, COL_S_FLAGS,
                                           N_PLANES)

FULL_PLAN = plan(get_metrics(ALL_METRICS))
J_FULL_PLAN = j_plan(j_get(J_ALL))
PAPER_PLAN = plan(get_metrics(PAPER_METRICS))


def _planes(n, seed, pad_rows=0):
    """Synthetic planes with ``pad_rows`` all-zero rows spliced in at the
    front, the middle and the end (invisible to counters and sketches)."""
    planes = synth_encoded(max(n, 1), seed=seed).planes[:n]
    if pad_rows:
        z = np.zeros((pad_rows, N_PLANES), np.int32)
        mid = n // 2
        planes = np.concatenate([z, planes[:mid], z, planes[mid:], z])
    return np.ascontiguousarray(planes)


def _jax_counts(planes, program, n_counters):
    return np.asarray(j_qops.fused_count(jnp.asarray(planes), program,
                                         n_counters), np.int64)


# --- random programs, built from a seed with numpy ---------------------------

_CMP = ["lt", "le", "gt", "ge", "eq", "ne"]


def _rand_expr(rng, E, depth):
    """Random Expr tree over module ``E`` (the port's or the JAX
    package's expr module: both build the same bytecode)."""
    if depth == 0 or rng.random() < 0.3:
        kind = int(rng.integers(4))
        plane = int(rng.integers(N_PLANES))
        if kind == 0:
            return E.HasBits(plane, 1 << int(rng.integers(15)))
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


def _rand_program(seed, E):
    rng = np.random.default_rng(seed)
    exprs = [_rand_expr(rng, E, 4) for _ in range(int(rng.integers(1, 8)))]
    return E.compile_program(exprs), len(exprs)


def _limit_program(which, E):
    """A program at the wrappers' limits. ``wide``: COUNTS_WIDTH random
    counters, the last a chain that needs a MAX_STACK-deep stack.
    ``long``: random counters of 48 or more instructions each, up to
    MAX_INSTR - 1 instructions in all."""
    rng = np.random.default_rng(4096)
    if which == "wide":
        exprs = [_rand_expr(rng, E, 3) for _ in range(qops.COUNTS_WIDTH - 1)]
        e = E.Cmp(6, "gt", 20)
        for i in range(qops.MAX_STACK - 1):
            e = (E.And if i % 2 else E.Or)(E.HasBits(3 + i % 6, 1 << i), e)
        exprs.append(e)
    else:
        exprs, n = [], 0
        while n < qops.MAX_INSTR - 1 and len(exprs) < qops.COUNTS_WIDTH:
            e = _rand_expr(rng, E, 8)
            m, left = len(E.compile_program([e])), qops.MAX_INSTR - n
            if min(48, left) <= m <= left:
                exprs.append(e)
                n += m
    return E.compile_program(exprs), len(exprs)


@pytest.mark.parametrize("which", ["wide", "long"])
def test_limit_programs_reach_the_limits(which):
    """The programs the ``gpu`` tests compile at the limits, on the CPU:
    at the limits, and the plain version equals the JAX package's numpy
    interpreter on them."""
    program, k = _limit_program(which, TE)
    j_program, j_k = _limit_program(which, JE)
    assert program == j_program and k == j_k
    depth = qops.check_program(program, k)
    if which == "wide":
        assert k == qops.COUNTS_WIDTH and depth == qops.MAX_STACK
    else:
        assert qops.MAX_INSTR - 1 <= len(program) <= qops.MAX_INSTR
    planes = _planes(2000, seed=9, pad_rows=3)
    got = qops.fused_count(torch.from_numpy(planes), program, k).numpy()
    np.testing.assert_array_equal(got, j_qref.counts_ref_np(planes,
                                                            j_program, k))


# --- qap_count ------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 8, 100, 4099])
def test_qap_count_plain_matches_jax_kernel(n):
    planes = _planes(n, seed=n)
    got = qops.fused_count(torch.from_numpy(planes), FULL_PLAN.program,
                           FULL_PLAN.n_counters)
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    want = _jax_counts(planes, J_FULL_PLAN.program, J_FULL_PLAN.n_counters)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), qref.counts_ref_np(planes, FULL_PLAN.program,
                                        FULL_PLAN.n_counters))


@pytest.mark.parametrize("seed", range(8))
def test_qap_count_random_programs(seed):
    program, k = _rand_program(seed, TE)
    j_program, j_k = _rand_program(seed, JE)
    assert program == j_program and k == j_k
    planes = _planes(300 + 97 * seed, seed=seed, pad_rows=3)
    got = qops.fused_count(torch.from_numpy(planes), program, k).numpy()
    np.testing.assert_array_equal(got, _jax_counts(planes, j_program, k))
    np.testing.assert_array_equal(got, qref.counts_ref_np(planes, program, k))


def test_qap_count_zero_rows_invisible():
    planes = _planes(500, seed=4)
    padded = _planes(500, seed=4, pad_rows=9)
    a = qops.fused_count(torch.from_numpy(planes), FULL_PLAN.program,
                         FULL_PLAN.n_counters)
    b = qops.fused_count(torch.from_numpy(padded), FULL_PLAN.program,
                         FULL_PLAN.n_counters)
    assert torch.equal(a, b)
    np.testing.assert_array_equal(
        b.numpy(), _jax_counts(padded, J_FULL_PLAN.program,
                               J_FULL_PLAN.n_counters))


# --- fused_scan -------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 8, 100, 4099])
@pytest.mark.parametrize("p", [8, 12, 14])
def test_fused_scan_plain_matches_jax_kernel(n, p):
    """Counters AND every sketch's register bank, padding rows included,
    equal the JAX megakernel's (interpret mode) bit for bit."""
    planes = _planes(n, seed=n + p, pad_rows=5)
    counts, regs = fops.fused_scan(torch.from_numpy(planes),
                                   FULL_PLAN.program, FULL_PLAN.n_counters,
                                   FULL_PLAN.sketch_specs, p)
    j_counts, j_regs = j_fops.fused_scan(
        jnp.asarray(planes), J_FULL_PLAN.program, J_FULL_PLAN.n_counters,
        J_FULL_PLAN.sketch_specs, p)
    np.testing.assert_array_equal(counts.numpy(),
                                  np.asarray(j_counts, np.int64))
    assert set(regs) == set(j_regs) == {"spo", "p"}
    valid = planes[:, COL_S_FLAGS] != 0
    for name, cols in FULL_PLAN.sketch_specs:
        assert regs[name].dtype == torch.int32
        assert regs[name].shape == (1 << p,)
        np.testing.assert_array_equal(regs[name].numpy(),
                                      np.asarray(j_regs[name]), name)
        np.testing.assert_array_equal(
            regs[name].numpy(),
            j_href.hll_fold_ref(planes, cols, p, valid=valid), name)


def test_fused_scan_no_sketches_delegates_to_qap_count():
    """A sketch-free plan goes through qap_count — still one pass, an
    empty register dict — as the JAX wrapper does."""
    assert not PAPER_PLAN.sketch_specs
    planes = torch.from_numpy(_planes(3000, seed=1))
    with K.count_scans() as box:
        counts, regs = fops.fused_scan(planes, PAPER_PLAN.program,
                                       PAPER_PLAN.n_counters, (), 12)
    assert regs == {} and box[0] == 1
    assert torch.equal(counts, qref.counts_ref(planes, PAPER_PLAN.program,
                                               PAPER_PLAN.n_counters))


@pytest.mark.parametrize("seed", range(4))
def test_fused_scan_random_programs_and_sketches(seed):
    """Random counter programs with random sketch column tuples."""
    program, k = _rand_program(100 + seed, TE)
    rng = np.random.default_rng(seed)
    specs = tuple((f"s{i}", tuple(int(c) for c in rng.choice(
        N_PLANES, size=int(rng.integers(1, 4)), replace=False)))
        for i in range(int(rng.integers(1, 4))))
    planes = _planes(777 + seed, seed=seed, pad_rows=4)
    counts, regs = fops.fused_scan(torch.from_numpy(planes), program, k,
                                   specs, 10)
    j_counts, j_regs = j_fops.fused_scan(jnp.asarray(planes), program, k,
                                         specs, 10)
    np.testing.assert_array_equal(counts.numpy(),
                                  np.asarray(j_counts, np.int64))
    for name, _ in specs:
        np.testing.assert_array_equal(regs[name].numpy(),
                                      np.asarray(j_regs[name]), name)


# --- hll_fold -----------------------------------------------------------------------

SKETCH_COLS = [(COL_S,), (10, 11, 12), (COL_P_HASH,)]


@pytest.mark.parametrize("cols", SKETCH_COLS, ids=str)
@pytest.mark.parametrize("p", [8, 12, 14])
@pytest.mark.parametrize("n", [1, 8, 100, 4099])
def test_hll_fold_plain_matches_jax_kernel(n, p, cols):
    """One sketch's registers, padding rows included, equal the JAX HLL
    kernel's (interpret mode) and its numpy oracle bit for bit."""
    planes = _planes(n, seed=3 * n + p, pad_rows=4)
    regs = hops.hll_fold(torch.from_numpy(planes), cols, p)
    assert regs.dtype == torch.int32 and regs.shape == (1 << p,)
    np.testing.assert_array_equal(
        regs.numpy(), np.asarray(j_hops.hll_fold(jnp.asarray(planes), cols,
                                                 p)))
    np.testing.assert_array_equal(
        regs.numpy(), j_href.hll_fold_ref(planes, cols, p,
                                          valid=planes[:, COL_S_FLAGS] != 0))


@pytest.mark.parametrize("p", [8, 12, 14])
def test_fused_scan_banks_equal_hll_fold(p):
    """The cross-kernel invariant: each sketch bank of the one-pass scan
    is the bank the two-pass fold gives for that sketch alone."""
    planes = torch.from_numpy(_planes(2000, seed=p, pad_rows=3))
    _, regs = fops.fused_scan(planes, FULL_PLAN.program, FULL_PLAN.n_counters,
                              FULL_PLAN.sketch_specs, p)
    for name, cols in FULL_PLAN.sketch_specs:
        assert torch.equal(regs[name], hops.hll_fold(planes, cols, p)), name


def test_hll_fold_zero_rows_invisible():
    planes = torch.from_numpy(_planes(700, seed=9))
    padded = torch.from_numpy(_planes(700, seed=9, pad_rows=11))
    assert torch.equal(hops.hll_fold(planes, (10, 11, 12), 12),
                       hops.hll_fold(padded, (10, 11, 12), 12))
    assert torch.equal(hops.hll_fold(planes[:0], (11,), 10),
                       torch.zeros(1 << 10, dtype=torch.int32))


def test_scan_counts_once_per_wrapper_call():
    planes = torch.from_numpy(_planes(64, seed=2))
    with K.count_scans() as box:
        fops.fused_scan(planes, FULL_PLAN.program, FULL_PLAN.n_counters,
                        FULL_PLAN.sketch_specs, 12)
        qops.fused_count(planes, FULL_PLAN.program, FULL_PLAN.n_counters)
        hops.hll_fold(planes, (10, 11, 12), 12)
    assert box[0] == 3


def test_plain_path_launches_nothing():
    K.reset_launches()
    planes = torch.from_numpy(_planes(64, seed=2))
    fops.fused_scan(planes, FULL_PLAN.program, FULL_PLAN.n_counters,
                    FULL_PLAN.sketch_specs, 12)
    qops.fused_count(planes, PAPER_PLAN.program, PAPER_PLAN.n_counters)
    hops.hll_fold(planes, (11,), 12)
    assert K.LAUNCHES == {"qap_count": 0, "fused_scan": 0, "hll_fold": 0}


def test_launch_counts_survive_concurrent_threads():
    """record_launch is a locked read-modify-write: many threads adding
    at once, with the interpreter switching threads as often as it can,
    lose no count."""
    import sys
    import threading
    K.reset_launches()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(
            target=lambda: [K.record_launch("hll_fold") for _ in range(2000)])
            for _ in range(16)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(old)
    assert K.LAUNCHES["hll_fold"] == 16 * 2000
    K.reset_launches()


# --- what the wrappers refuse ----------------------------------------------------

@pytest.mark.parametrize("bad", [
    pytest.param(lambda p: p.to(torch.int64), id="dtype"),
    pytest.param(lambda p: p[:, :12], id="width"),
    pytest.param(lambda p: p.reshape(-1), id="rank"),
])
def test_wrappers_reject_bad_planes(bad):
    planes = bad(torch.from_numpy(_planes(16, seed=0)))
    with pytest.raises((TypeError, ValueError)):
        qops.fused_count(planes, FULL_PLAN.program, FULL_PLAN.n_counters)
    with pytest.raises((TypeError, ValueError)):
        fops.fused_scan(planes, FULL_PLAN.program, FULL_PLAN.n_counters,
                        FULL_PLAN.sketch_specs, 12)
    with pytest.raises((TypeError, ValueError)):
        hops.hll_fold(planes, (10, 11, 12), 12)


def test_wrappers_reject_what_the_kernels_cannot_take():
    planes = torch.from_numpy(_planes(16, seed=0))
    deep = TE.HasBits(3, 8)
    for _ in range(qops.MAX_STACK):          # right-nested: depth grows
        deep = TE.And(TE.HasBits(3, 8), deep)
    with pytest.raises(ValueError, match="stack depth"):
        qops.fused_count(planes, TE.compile_program([deep]), 1)
    many = [TE.Cmp(6, "gt", i) for i in range(qops.COUNTS_WIDTH + 1)]
    with pytest.raises(ValueError, match="counters"):
        qops.fused_count(planes, TE.compile_program(many), len(many))
    with pytest.raises(ValueError, match="opcode"):
        qops.fused_count(planes, ((99, 0, 0), (TE.OP_EMIT, 0, 0)), 1)
    with pytest.raises(ValueError, match="hll p"):
        fops.fused_scan(planes, FULL_PLAN.program, FULL_PLAN.n_counters,
                        FULL_PLAN.sketch_specs, 30)
    with pytest.raises(ValueError, match="columns"):
        fops.fused_scan(planes, FULL_PLAN.program, FULL_PLAN.n_counters,
                        (("bad", (COL_S, 13)),), 12)
    with pytest.raises(ValueError, match="hll p"):
        hops.hll_fold(planes, (11,), 3)
    for bad in ((), (13,), (-1,), tuple(range(N_PLANES)) + (0,)):
        with pytest.raises(ValueError, match="columns"):
            hops.hll_fold(planes, bad, 12)


# the bank's bytes in a block's shared memory (0: raised in place in the
# global output) at each p: 4 << p while it is no more than 64 KiB
HLL_SHARED_BYTES = {4: 64, 12: 16384, 14: 65536, 15: 0, 20: 0}


@pytest.mark.parametrize("p", sorted(HLL_SHARED_BYTES))
def test_hll_fold_launch_geometry(p):
    """hll_fold's launch rule on the CPU: its shared memory and bank
    placement by p, and a grid of a block per 128 rows, at most the
    blocks the card holds at that shared memory and at least one. The
    block is the kernel's own launch bound."""
    src = hops.kernel_source()
    assert f"constexpr int THREADS = {hops.THREADS};" in src.source
    assert (src.entry, src.threads, src.smem_bytes) == (
        "hll_fold_kernel", 128, 64 * 1024)
    asked = []

    def resident(smem):
        asked.append(smem)
        return 132 * 7
    want_smem = HLL_SHARED_BYTES[p]
    for n, grid in ((1, 1), (127, 1), (128, 1), (129, 2),
                    (132 * 7 * 128, 132 * 7), (132 * 7 * 128 + 1, 132 * 7),
                    (81_980_472, 132 * 7)):
        assert hops.launch_geometry(n, p, resident) == (
            want_smem, want_smem > 0, grid), n
    assert set(asked) == {want_smem}


def test_spec_cache_compiles_each_plan_once_in_parallel(monkeypatch):
    """The kernel cache without a card (the compile replaced by a stub
    that waits until three compiles run at once): three plans compile in
    parallel, outside the cache's lock, each once; threads that ask for a
    plan being compiled wait for it and count as hits."""
    # the three compiles and this thread
    started, release = threading.Barrier(4, timeout=30), threading.Event()
    calls = []

    def fake_compile(src):
        calls.append(src.digest)
        started.wait()           # all three compiles are running at once
        release.wait(30)
        return _build.SpecKernel(src, src.digest, b"", "", "compiled", 0.0)

    monkeypatch.setattr(_build, "_load_or_compile", fake_compile)
    monkeypatch.setattr(_build, "_specs", {})
    srcs = [scan_codegen.generate(((TE.OP_GT, 6, i), (TE.OP_EMIT, 0, 0)), 1)
            for i in range(3)]
    before = dict(_build.spec_stats)
    out = {}

    def ask(i, src):
        out[i] = _build.spec_kernel(src)

    threads = [threading.Thread(target=ask, args=(i, srcs[i % 3]))
               for i in range(9)]
    for th in threads:
        th.start()
    started.wait()
    release.set()
    for th in threads:
        th.join(30)
    assert sorted(calls) == sorted(s.digest for s in srcs)
    assert len(out) == 9
    for i, kern in out.items():
        assert kern is out[i % 3] and kern.src is srcs[i % 3]
    delta = {k: _build.spec_stats[k] - before[k] for k in before}
    assert delta == {"compiled": 3, "loaded": 0, "hits": 6}
    assert not _build._pending
    got = _build.compile_scans(srcs)
    assert got == [out[0], out[1], out[2]]
    assert _build.spec_stats["hits"] - before["hits"] == 9


def test_spec_cache_forgets_a_failed_compile(monkeypatch):
    """A compile that fails raises in every thread that waited for it and
    leaves nothing behind: the next call compiles again."""
    def broken(src):
        raise RuntimeError("NVRTC failed")

    monkeypatch.setattr(_build, "_load_or_compile", broken)
    monkeypatch.setattr(_build, "_specs", {})
    src = scan_codegen.generate(((TE.OP_GT, 6, 7), (TE.OP_EMIT, 0, 0)), 1)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="NVRTC failed"):
            _build.spec_kernel(src)
        assert not _build._pending and src.digest not in _build._specs


# --- on the card --------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 511, 512, 513, 8193, 100_003])
def test_gpu_qap_count_matches_plain(cuda, n):
    planes = torch.from_numpy(_planes(n, seed=n, pad_rows=3)).to(cuda)
    for pln in (FULL_PLAN, PAPER_PLAN):
        before = K.LAUNCHES["qap_count"]
        got = qops.fused_count(planes, pln.program, pln.n_counters)
        assert K.LAUNCHES["qap_count"] == before + 1
        assert torch.equal(got, qref.counts_ref(planes, pln.program,
                                                pln.n_counters))


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [*range(6), "wide", "long"])
def test_gpu_qap_count_random_programs(cuda, seed):
    """Random programs, and the programs at the limits: 128 counters and
    a 16-deep stack, and 4,095 instructions."""
    if isinstance(seed, str):
        (program, k), n, data_seed = _limit_program(seed, TE), 100_003, 9
    else:
        (program, k), n, data_seed = _rand_program(seed, TE), 5000 + seed, seed
    planes = torch.from_numpy(_planes(n, seed=data_seed)).to(cuda)
    assert torch.equal(qops.fused_count(planes, program, k),
                       qref.counts_ref(planes, program, k))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 513, 8193, 100_003])
@pytest.mark.parametrize("p", [4, 8, 12, 13, 14, 16])
def test_gpu_fused_scan_matches_plain(cuda, n, p):
    """Shared-memory banks (small p) and global banks (large p) alike."""
    planes = torch.from_numpy(_planes(n, seed=n + p, pad_rows=3)).to(cuda)
    counts, regs = fops.fused_scan(planes, FULL_PLAN.program,
                                   FULL_PLAN.n_counters,
                                   FULL_PLAN.sketch_specs, p)
    want_counts, want_regs = fref.fused_scan_torch(
        planes, FULL_PLAN.program, FULL_PLAN.n_counters,
        FULL_PLAN.sketch_specs, p)
    assert torch.equal(counts, want_counts)
    for name in want_regs:
        assert torch.equal(regs[name], want_regs[name]), name


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["wide", "long"])
@pytest.mark.parametrize("p", [12, 16])
def test_gpu_fused_scan_at_the_limits(cuda, which, p):
    """The programs at the limits with both default sketches, banks in
    shared (p = 12) and global memory (p = 16)."""
    program, k = _limit_program(which, TE)
    specs = FULL_PLAN.sketch_specs
    planes = torch.from_numpy(_planes(100_003, seed=p, pad_rows=3)).to(cuda)
    counts, regs = fops.fused_scan(planes, program, k, specs, p)
    want_counts, want_regs = fref.fused_scan_torch(planes, program, k,
                                                   specs, p)
    assert torch.equal(counts, want_counts)
    for name, cols in specs:
        assert torch.equal(regs[name], want_regs[name]), name
        assert torch.equal(regs[name], hops.hll_fold(planes, cols, p)), name


@pytest.mark.gpu
def test_gpu_unaligned_planes(cuda):
    """A planes view that does not start on a 16-byte boundary takes the
    kernels' scalar load path and gives the same result."""
    base = torch.from_numpy(_planes(9000, seed=5)).to(cuda)
    planes = base.reshape(-1)[N_PLANES:].reshape(-1, N_PLANES)  # 52 B in
    assert planes.data_ptr() % 16 != 0
    counts, regs = fops.fused_scan(planes, FULL_PLAN.program,
                                   FULL_PLAN.n_counters,
                                   FULL_PLAN.sketch_specs, 12)
    want_counts, want_regs = fref.fused_scan_torch(
        planes, FULL_PLAN.program, FULL_PLAN.n_counters,
        FULL_PLAN.sketch_specs, 12)
    assert torch.equal(counts, want_counts)
    for name in want_regs:
        assert torch.equal(regs[name], want_regs[name]), name


@pytest.mark.gpu
def test_gpu_ragged_tail_is_race_free(cuda):
    """The last tile's final row ends mid 16-byte word when 13·N is not a
    multiple of 4: its trailing planes (the hash columns) must be read
    intact on every launch, not raced over by the tile's zero fill."""
    n = 1953 * 512 + 67                      # 13·n % 4 == 3
    planes = torch.from_numpy(_planes(n, seed=7)).to(cuda)
    program = TE.compile_program([TE.EqPlanes(10, 12) | ~TE.EqPlanes(10, 12),
                                  TE.Cmp(12, "ne", 0)])
    specs = (("o", (12,)),)
    want_counts, want_regs = fref.fused_scan_torch(planes, program, 2,
                                                   specs, 12)
    for _ in range(20):
        assert torch.equal(qops.fused_count(planes, program, 2), want_counts)
        counts, regs = fops.fused_scan(planes, program, 2, specs, 12)
        assert torch.equal(counts, want_counts)
        assert torch.equal(regs["o"], want_regs["o"])


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 127, 128, 129, 8193, 100_003])
@pytest.mark.parametrize("p", [4, 8, 12, 14, 15, 16])
def test_gpu_hll_fold_matches_plain(cuda, n, p):
    """Shared-memory banks (p <= 14) and the global bank (p > 14) alike,
    for each sketch's columns; the launch is counted once."""
    planes = torch.from_numpy(_planes(n, seed=n + p, pad_rows=3)).to(cuda)
    for cols in SKETCH_COLS:
        before = K.LAUNCHES["hll_fold"]
        regs = hops.hll_fold(planes, cols, p)
        assert K.LAUNCHES["hll_fold"] == before + 1
        assert torch.equal(regs, href.hll_fold_torch(planes, cols, p)), cols


@pytest.mark.gpu
@pytest.mark.parametrize("p", [8, 12, 14, 16])
def test_gpu_fused_scan_banks_equal_hll_fold(cuda, p):
    planes = torch.from_numpy(_planes(50_001, seed=p, pad_rows=3)).to(cuda)
    _, regs = fops.fused_scan(planes, FULL_PLAN.program, FULL_PLAN.n_counters,
                              FULL_PLAN.sketch_specs, p)
    for name, cols in FULL_PLAN.sketch_specs:
        assert torch.equal(regs[name], hops.hll_fold(planes, cols, p)), name


@pytest.mark.gpu
def test_gpu_hll_fold_unaligned_planes(cuda):
    base = torch.from_numpy(_planes(9000, seed=5)).to(cuda)
    planes = base.reshape(-1)[N_PLANES:].reshape(-1, N_PLANES)  # 52 B in
    assert planes.data_ptr() % 16 != 0
    for cols in SKETCH_COLS:
        assert torch.equal(hops.hll_fold(planes, cols, 12),
                           href.hll_fold_torch(planes, cols, 12)), cols


@pytest.mark.gpu
def test_gpu_hll_fold_through_the_spec_cache(cuda, tmp_path, monkeypatch):
    """hll_fold is built on the scan kernel's path: its first launch in a
    process compiles one cubin (or loads it from the disk cache), later
    launches find it in the process's cache, and the CUDA driver reports the
    kernel's launch bound, the 128 threads a launch gives a block."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_specs", {})
    planes = torch.from_numpy(_planes(20_000, seed=7)).to(cuda)
    cols = SKETCH_COLS[0]
    want = href.hll_fold_torch(planes, cols, 12)
    before = dict(_build.spec_stats)
    for p in (12, 12, 16):
        assert torch.equal(hops.hll_fold(planes, cols, p),
                           href.hll_fold_torch(planes, cols, p)), p
    delta = {k: _build.spec_stats[k] - before[k] for k in before}
    assert delta == {"compiled": 1, "loaded": 0, "hits": 2}
    assert len(list(tmp_path.glob("hll_fold_kernel-*.cubin"))) == 1
    kern = _build._specs[hops.kernel_source().digest]
    assert kern.how == "compiled"
    res = kern.resources[cuda.index or 0]
    assert res["threads"] == res["max_threads"] == 128
    monkeypatch.setattr(_build, "_specs", {})
    assert torch.equal(hops.hll_fold(planes, cols, 12), want)
    assert _build.spec_stats["loaded"] - before["loaded"] == 1


# --- the plan-specialized scan kernel on the card ------------------------------

def _kernel_of(pln, p=12):
    """The generated source and the compiled kernel of a plan's scan."""
    specs = tuple(pln.sketch_specs)
    src = scan_codegen.generate_cached(tuple(pln.program), pln.n_counters,
                                       specs, p if specs else None)
    return src, _build.spec_kernel(src)


def _check_scan(planes, pln, p=12):
    if pln.sketch_specs:
        counts, regs = fops.fused_scan(planes, pln.program, pln.n_counters,
                                       pln.sketch_specs, p)
        want_counts, want_regs = fref.fused_scan_torch(
            planes, pln.program, pln.n_counters, pln.sketch_specs, p)
        for name in want_regs:
            assert torch.equal(regs[name], want_regs[name]), name
    else:
        counts = qops.fused_count(planes, pln.program, pln.n_counters)
        want_counts = qref.counts_ref(planes, pln.program, pln.n_counters)
    assert torch.equal(counts, want_counts)


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["paper", "all"])
def test_gpu_scan_ring_boundaries(cuda, which):
    """Row counts at the edges of a tile and of the ring of stages: one
    tile and one row either side, one full ring of one block and one row
    more, and enough tiles that every block of the persistent grid wraps
    its ring (once, and twice plus a ragged tail)."""
    pln = PAPER_PLAN if which == "paper" else FULL_PLAN
    src, kern = _kernel_of(pln)
    t, s = scan_codegen.TILE_ROWS, scan_codegen.STAGES
    _check_scan(torch.from_numpy(_planes(t, seed=1)).to(cuda), pln)
    res = kern.resources[cuda.index or 0]
    blocks = res["sms"] * res["blocks_per_sm"]
    for n in (t - 1, t, t + 1, s * t, s * t + 1, blocks * s * t,
              blocks * s * t + 1, blocks * (2 * s + 1) * t + 5):
        planes = torch.from_numpy(_planes(n, seed=n)).to(cuda)
        _check_scan(planes, pln)


@pytest.mark.gpu
@pytest.mark.parametrize("offset_rows", [1, 2, 3, 4])
def test_gpu_scan_views_across_stage_boundaries(cuda, offset_rows):
    """Views that start 1-4 rows into their tensor: 52-208 bytes in, so
    only the 4-row offset is 16-byte aligned (bulk copies); the others
    stage word by word. Each spans several stages and ends mid-tile."""
    t, s = scan_codegen.TILE_ROWS, scan_codegen.STAGES
    base = torch.from_numpy(_planes(2 * s * t + 300, seed=offset_rows,
                                    pad_rows=2)).to(cuda)
    planes = base.reshape(-1)[offset_rows * N_PLANES:].reshape(-1, N_PLANES)
    assert (planes.data_ptr() % 16 == 0) == (offset_rows == 4)
    for pln in (FULL_PLAN, PAPER_PLAN):
        _check_scan(planes, pln)


@pytest.mark.gpu
def test_gpu_scan_global_banks_at_p16(cuda):
    """Two sketches at p = 16 (512 KiB of registers) do not fit shared
    memory: the generated kernel raises the global banks in place."""
    src, _ = _kernel_of(FULL_PLAN, p=16)
    assert not src.shared_banks
    planes = torch.from_numpy(_planes(300_001, seed=16, pad_rows=3)).to(cuda)
    _check_scan(planes, FULL_PLAN, p=16)
    _, regs = fops.fused_scan(planes, FULL_PLAN.program, FULL_PLAN.n_counters,
                              FULL_PLAN.sketch_specs, 16)
    for name, cols in FULL_PLAN.sketch_specs:
        assert torch.equal(regs[name], hops.hll_fold(planes, cols, 16)), name


@pytest.mark.gpu
def test_gpu_plan_compiled_once_then_cached(cuda, tmp_path, monkeypatch):
    """A plan no other test uses compiles once; its second launch comes
    from the process's cache, and a process without it loads the cubin
    from the disk cache instead of compiling again."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    program = TE.compile_program([TE.Cmp(6, "gt", 4242),
                                  TE.HasBits(3, 8) & TE.Cmp(7, "ne", 4242)])
    planes = torch.from_numpy(_planes(20_000, seed=42)).to(cuda)
    want = qref.counts_ref(planes, program, 2)
    before = dict(_build.spec_stats)
    launches = K.LAUNCHES["qap_count"]
    for _ in range(2):
        assert torch.equal(qops.fused_count(planes, program, 2), want)
    delta = {k: _build.spec_stats[k] - before[k] for k in before}
    assert delta == {"compiled": 1, "loaded": 0, "hits": 1}
    assert K.LAUNCHES["qap_count"] - launches == 2
    assert len(list(tmp_path.glob("scan_spec-*.cubin"))) == 1
    monkeypatch.setattr(_build, "_specs", {})
    assert torch.equal(qops.fused_count(planes, program, 2), want)
    assert _build.spec_stats["loaded"] - before["loaded"] == 1
    assert _build.spec_stats["compiled"] - before["compiled"] == 1


@pytest.mark.gpu
def test_gpu_scan_launches_from_a_new_thread(cuda):
    """A thread that has made no CUDA call yet launches the kernel into
    torch's context on the card (the scheduler's worker threads do)."""
    planes = torch.from_numpy(_planes(70_001, seed=8)).to(cuda)
    want = fref.fused_scan_torch(planes, FULL_PLAN.program,
                                 FULL_PLAN.n_counters,
                                 FULL_PLAN.sketch_specs, 12)
    out = {}

    def body():
        out["got"] = fops.fused_scan(planes, FULL_PLAN.program,
                                     FULL_PLAN.n_counters,
                                     FULL_PLAN.sketch_specs, 12)
        torch.cuda.synchronize(cuda)

    th = threading.Thread(target=body)
    th.start()
    th.join()
    counts, regs = out["got"]
    assert torch.equal(counts, want[0])
    for name in want[1]:
        assert torch.equal(regs[name], want[1][name]), name
