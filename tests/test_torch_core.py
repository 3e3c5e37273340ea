"""The port's expression, planner and sketch layer (``repro_torch.core``)
against the JAX package's (``repro.core``).

Inputs are numpy arrays made from a seed and handed to both packages.
Tolerances: exact for programs, slots, masks, counters, hashes, buckets,
ranks and registers (all integer). The JAX package sums ``exp2(-regs)`` in
float32 in XLA's order and the port rounds the exact sum once to float32, so
the estimates may differ in the last float32 bits: ``rel=1e-6``. The port's
estimator is also held bit for bit to its earlier torch form (``_torch_*``).
"""
from fractions import Fraction

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import expr as JE
from repro.core import metrics as JM
from repro.core import planner as JP
from repro.core import sketches as JS
from repro.kernels.hll import ref as j_href
from repro.kernels.qap_count import ref as j_qref

from repro_torch.core import expr as TE
from repro_torch.core import metrics as TM
from repro_torch.core import planner as TP
from repro_torch.core import sketches as TS
from repro_torch.kernels.qap_count import ref as t_qref
from repro_torch.rdf import synth_encoded
from repro_torch.rdf.triple_tensor import (COL_O, COL_O_HASH, COL_P,
                                           COL_P_HASH, COL_S, COL_S_FLAGS,
                                           COL_S_HASH, N_PLANES)

ALIASES = {"paper": "PAPER_METRICS", "extended": "EXTENDED_METRICS",
           "sketch": "SKETCH_METRICS", "all": "ALL_METRICS"}


def _same_plan(tp, jp):
    assert tp.program == jp.program
    assert tp.stack_depth == jp.stack_depth
    assert {k: dict(v) for k, v in tp.slots.items()} == \
        {k: dict(v) for k, v in jp.slots.items()}
    assert tp.sketch_specs == jp.sketch_specs
    assert tp.n_counters == jp.n_counters


@pytest.mark.parametrize("alias", sorted(ALIASES))
def test_plan_matches_jax(alias):
    names = getattr(TM, ALIASES[alias])
    assert names == getattr(JM, ALIASES[alias])
    _same_plan(TP.plan(TM.get_metrics(names)),
               JP.plan(JM.get_metrics(names)))


def _builder_metrics(M):
    """One metric from each declarative builder, built alike in ``M``."""
    ratio = M.ratio_metric("T_RATIO", num=M.is_literal("o"),
                           auto_register=False)
    exists = M.exists_metric("T_EXISTS", M.is_blank("s") & M.is_uri("o"),
                             auto_register=False)
    count = M.count_metric("T_COUNT", M.res_too_long("p") | ~M.is_uri("s"),
                           auto_register=False)
    try:
        @M.qap_metric("T_QAP", {"self": M.EqPlanes(COL_S, COL_O),
                                "total": M.valid_triple()},
                      sketches=(("sp", (COL_S_HASH, COL_P_HASH)),))
        def qap(c):
            return c["self"] / max(c["total"], 1)
    finally:
        M.unregister("T_QAP")
    return {"ratio": ratio, "exists": exists, "count": count, "qap": qap}


@pytest.mark.parametrize("kind", ["ratio", "exists", "count", "qap"])
def test_builder_metric_plans_match_jax(kind):
    t, j = _builder_metrics(TM)[kind], _builder_metrics(JM)[kind]
    _same_plan(TP.plan([t]), JP.plan([j]))
    # fused with the built-ins, the shared counters dedupe identically
    _same_plan(TP.plan(TM.get_metrics(TM.ALL_METRICS) + [t]),
               JP.plan(JM.get_metrics(JM.ALL_METRICS) + [j]))


@pytest.fixture(scope="module")
def planes():
    p = synth_encoded(3000, seed=11).planes.copy()
    p[::97] = 0                         # zero (padding) rows inside
    return np.ascontiguousarray(p)


def test_to_mask_matches_jax(planes):
    tp = TP.plan(TM.get_metrics(TM.ALL_METRICS))
    jp = JP.plan(JM.get_metrics(JM.ALL_METRICS))
    t_planes, j_planes = torch.from_numpy(planes), jnp.asarray(planes)
    for te, je in zip(tp.exprs, jp.exprs):
        got = te.to_mask(t_planes)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(je.to_mask(j_planes)))


@pytest.mark.parametrize("alias", ["paper", "all"])
def test_eval_program_torch_matches_jax(planes, alias):
    pl = TP.plan(TM.get_metrics(getattr(TM, ALIASES[alias])))
    got = TE.eval_program_torch(torch.from_numpy(planes), pl.program,
                                pl.n_counters)
    assert got.dtype == torch.int64
    want = np.asarray(JE.eval_program_jnp(jnp.asarray(planes), pl.program,
                                          pl.n_counters), np.int64)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), j_qref.counts_ref_np(planes, pl.program, pl.n_counters))
    np.testing.assert_array_equal(
        got.numpy(), t_qref.counts_ref_np(planes, pl.program, pl.n_counters))


def test_program_stack_depth_matches_jax():
    for names in (TM.PAPER_METRICS, TM.ALL_METRICS):
        prog = TP.plan(TM.get_metrics(names)).program
        assert TE.program_stack_depth(prog) == JE.program_stack_depth(prog)
    assert TE.OP_NAMES == JE.OP_NAMES


# --- sketches ---------------------------------------------------------------------

def _hash_planes(n=4000, seed=5):
    """Planes whose hash columns span the whole int32 range (negative
    values, so uint32 inputs with the top bit set)."""
    rng = np.random.default_rng(seed)
    p = rng.integers(-2**31, 2**31, size=(n, N_PLANES), dtype=np.int64)
    p = p.astype(np.int32)
    p[:, COL_S_FLAGS] = rng.integers(0, 4, size=n)      # some zero = padding
    return p


@pytest.mark.parametrize("cols", [(COL_S,), (COL_P_HASH,),
                                  (COL_S_HASH, COL_P_HASH, COL_O_HASH)])
def test_hash_columns_matches_jax(cols):
    planes = _hash_planes()
    got = TS.hash_columns(torch.from_numpy(planes), cols)
    assert got.dtype == torch.int64
    want = np.asarray(JS.hash_columns(jnp.asarray(planes), cols))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(
        got.numpy(), j_href.hash_columns_np(planes, cols).astype(np.int64))
    assert (got.numpy() >= 2**31).any()     # top bit set in some hashes


@pytest.mark.parametrize("p", [8, 12, 14])
def test_rank_and_bucket_matches_jax(p):
    planes = _hash_planes(seed=p)
    h = TS.hash_columns(torch.from_numpy(planes), (COL_S, COL_P))
    # the corners: 0, all ones, top bit only, and w = h << p == 0
    corners = torch.tensor([0, 2**32 - 1, 2**31, 1 << (32 - p), 1, 3 << 30],
                           dtype=torch.int64)
    h = torch.cat([h, corners])
    bucket, rank = TS.rank_and_bucket(h, p)
    jb, jr = JS.rank_and_bucket(jnp.asarray(h.numpy().astype(np.uint32)), p)
    np.testing.assert_array_equal(bucket.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(rank.numpy(), np.asarray(jr))
    assert rank.dtype == torch.int32
    assert int(rank.max()) <= 33 - p and int(rank.min()) >= 1


@pytest.mark.parametrize("p", [8, 12, 14])
@pytest.mark.parametrize("cols", [(COL_P_HASH,),
                                  (COL_S_HASH, COL_P_HASH, COL_O_HASH)])
def test_hll_update_matches_jax(p, cols):
    planes = _hash_planes(seed=p + len(cols))
    valid = planes[:, COL_S_FLAGS] != 0
    got = TS.hll_update(TS.hll_init(p), torch.from_numpy(planes), cols,
                        valid=torch.from_numpy(valid))
    want = np.asarray(JS.hll_update(JS.hll_init(p), jnp.asarray(planes),
                                    cols, valid=jnp.asarray(valid)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), j_href.hll_fold_ref(planes, cols, p, valid=valid))
    # folding into a non-empty bank is a max-merge
    half = TS.hll_update(TS.hll_init(p), torch.from_numpy(planes[:1000]),
                         cols, valid=torch.from_numpy(valid[:1000]))
    both = TS.hll_update(half, torch.from_numpy(planes[1000:]), cols,
                         valid=torch.from_numpy(valid[1000:]))
    assert torch.equal(both, got)
    assert torch.equal(TS.hll_merge(half, got), got)


@pytest.mark.parametrize("p", [4, 8, 12, 14])
@pytest.mark.parametrize("card", [10, 3000, 200_000])
def test_hll_estimate_matches_jax(p, card):
    """float32 estimator: the same registers give the same value up to
    the float32 summation order (rel=1e-6, see module docstring)."""
    rng = np.random.default_rng(card + p)
    planes = np.zeros((card, N_PLANES), np.int32)
    planes[:, COL_S] = rng.choice(10_000_000, size=card, replace=False)
    regs = j_href.hll_fold_ref(planes, (COL_S,), p)
    got = float(TS.hll_estimate(torch.from_numpy(regs)))
    want = float(JS.hll_estimate(jnp.asarray(regs)))
    assert got == pytest.approx(want, rel=1e-6)
    assert TS.hll_estimate(torch.from_numpy(regs)).dtype == torch.float32


# -- the estimator against its earlier torch form -----------------------------

def _torch_alpha_m2(m):
    return (0.7213 / (1.0 + 1.079 / m) if m >= 128
            else {16: 0.673, 32: 0.697, 64: 0.709}.get(m, 0.7213)) * m * m


def _torch_estimate(registers):
    """The port's estimator as a dozen torch ops, as it was before the
    exact sum: the oracle of the tests below."""
    m = registers.shape[0]
    inv = torch.sum(torch.exp2(-registers.to(torch.float32)))
    raw = _torch_alpha_m2(m) / inv
    zeros = torch.sum(registers == 0)
    small = m * torch.log(m / torch.clamp(zeros, min=1).to(torch.float32))
    return torch.where((raw <= 2.5 * m) & (zeros > 0), small, raw)


def _exact_sum(regs):
    """``sum(2^-reg)`` as a fraction, and the largest register."""
    ranks, counts = np.unique(regs, return_counts=True)
    return (sum(Fraction(int(c), 2 ** int(k)) for k, c in zip(ranks, counts)),
            int(ranks[-1]))


@pytest.mark.parametrize("m", [16, 64, 256, 4096])
def test_linear_counting_is_the_torch_value_for_every_zero_count(m):
    """Banks of ``z`` zeros, the rest 1 or 2, take the linear-counting
    branch for every ``z`` in 1..m and give torch's float32 value."""
    rest = 1 + np.arange(m, dtype=np.int32) % 2
    for z in range(1, m + 1):
        regs = np.where(np.arange(m) < z, 0, rest).astype(np.int32)
        want = float(_torch_estimate(torch.from_numpy(regs)))
        small = float(m * torch.log(torch.tensor(m / z, dtype=torch.float32)))
        assert want == pytest.approx(small, rel=1e-6)   # the branch taken
        assert TS.estimate_bank(regs) == want, z


@pytest.mark.parametrize("m", [16, 4096, 16384])
def test_raw_tail_is_the_torch_value(m):
    rng = np.random.default_rng(m)
    sums = np.float32(m) * np.exp2(rng.uniform(-40, 0, 2000)).astype(
        np.float32)
    for inv in sums:
        want = float(_torch_alpha_m2(m) / torch.tensor(inv))
        assert TS._raw(float(inv), m) == want, inv


@pytest.mark.parametrize("p", [4, 8, 12, 14])
@pytest.mark.parametrize("card", [10, 1000, 100_000, 2_000_000])
def test_estimate_is_the_torch_value_when_the_sum_is_exact(p, card):
    """Below ``2^(24 - kmax)`` every float32 partial sum is exact, so the
    estimate is torch's bit for bit; past it the sum is rounded once,
    within ``rel=1e-6`` of torch's."""
    planes = np.zeros((card, N_PLANES), np.int32)
    planes[:, COL_S] = np.arange(card, dtype=np.int32) * 7 + p
    regs = j_href.hll_fold_ref(planes, (COL_S,), p)
    total, kmax = _exact_sum(regs)
    want = float(_torch_estimate(torch.from_numpy(regs)))
    got = TS.estimate_bank(regs)
    if total < 2 ** (24 - kmax):
        assert got == want
    else:
        assert got == pytest.approx(want, rel=1e-6)
    est = TS.hll_estimate(torch.from_numpy(regs))
    assert est.dtype == torch.float32 and est.dim() == 0
    assert float(est) == got


def _rounded_banks():
    """p = 12 banks on the raw branch whose ``sum(2^-reg)`` needs more
    than float32's 24 bits: 4,095 registers of 3 and one of 20
    (511.875 + 2^-20), and a seeded mix of small and large registers whose
    float32 sums in numpy's and in torch's order (here) both give another
    estimate than the correctly rounded sum."""
    regs = np.full(4096, 3, np.int32)
    regs[7] = 20
    rng = np.random.default_rng(2)
    mix = rng.integers(1, 8, 4096).astype(np.int32)
    mix[rng.integers(0, 4096, 600)] = rng.integers(15, 22, 600)
    return [regs, mix]


@pytest.mark.parametrize("which", [0, 1])
def test_estimate_past_the_exact_range_rounds_the_sum_once(which):
    regs = _rounded_banks()[which]
    total, kmax = _exact_sum(regs)
    assert total >= 2 ** (24 - kmax)
    want = float(_torch_alpha_m2(4096) / torch.tensor(
        np.float32(float(total))))
    assert want > 2.5 * 4096                            # the raw branch
    assert TS.estimate_bank(regs) == want
    assert TS.estimate_bank(regs) == pytest.approx(
        float(_torch_estimate(torch.from_numpy(regs))), rel=1e-6)

