"""``repro_torch.qa`` against ``repro.qa``: the single-shot assessment,
the DQV report, and chunk states carried between the two packages.

The port runs with ``device="cpu"`` (its kernel wrappers then run their
plain torch versions); the JAX package runs its ``jnp`` backend and its
``fused_scan`` Pallas kernel in interpret mode, as its own tests do.

Tolerances: counters, register banks, ``n_triples``, ``passes`` and every
value derived only from counters are exact. ``sketch_estimates``,
``CN2_EXACT`` and ``SCH1`` come from the float32 HLL estimator, whose sum
of ``exp2(-regs)`` XLA and torch add in different orders: ``rel=1e-6``.
"""
import gzip
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro import qa as jqa
from repro.core import report as j_report
from repro.core.evaluator import QualityEvaluator as JEvaluator
from repro.rdf import TripleTensor as JTripleTensor

from repro_torch import kernels as K
from repro_torch import qa
from repro_torch.core import report
from repro_torch.core.evaluator import QualityEvaluator, state_from_numpy
from repro_torch.core.metrics import ALL_METRICS, SKETCH_METRICS
from repro_torch.rdf import bsbm_ntriples, synth_encoded

BASE = ("http://bsbm.example.org/",)
SKETCH_VALUES = set(SKETCH_METRICS)          # CN2_EXACT, SCH1
# the port's backend -> the JAX backend that makes the same passes
JAX_BACKEND = {"torch": "jnp", "fused_scan": "fused_scan"}


@pytest.fixture(scope="module")
def datasets():
    text = bsbm_ntriples(50, seed=1)
    tt = synth_encoded(4096, seed=3)
    return {"bsbm": text, "synth": tt}


def _jax_input(data):
    if isinstance(data, str):
        return data
    return JTripleTensor(data.planes, data.n_valid, data.n_terms)


def assert_same_result(res, ref):
    assert res.n_triples == ref.n_triples
    assert res.passes == ref.passes
    assert res.counts == ref.counts
    assert set(res.registers) == set(ref.registers)
    for k in ref.registers:
        np.testing.assert_array_equal(res.registers[k], ref.registers[k], k)
    assert set(res.values) == set(ref.values)
    for k, v in ref.values.items():
        if k in SKETCH_VALUES:
            assert res.values[k] == pytest.approx(v, rel=1e-6), k
        else:
            assert res.values[k] == v, k
    assert set(res.sketch_estimates) == set(ref.sketch_estimates)
    for k, v in ref.sketch_estimates.items():
        assert res.sketch_estimates[k] == pytest.approx(v, rel=1e-6), k


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per-metric"])
@pytest.mark.parametrize("backend", ["torch", "fused_scan"])
@pytest.mark.parametrize("data", ["bsbm", "synth"])
def test_assess_matches_jax(datasets, data, backend, fused):
    ds = datasets[data]
    res = qa.assess(ds, metrics="all", backend=backend, fused=fused,
                    base=BASE, device="cpu")
    ref = jqa.assess(_jax_input(ds), metrics="all",
                     backend=JAX_BACKEND[backend], fused=fused, base=BASE)
    assert_same_result(res, ref)


def _without_times(dqv):
    """The DQV report with timestamps dropped and sketch values split off."""
    sketch_vals = {}
    for m in dqv["measurements"]:
        del m["http://www.w3.org/ns/prov#generatedAtTime"]
        name = m["http://www.w3.org/ns/dqv#isMeasurementOf"]["@id"]
        if name.rsplit(":", 1)[-1] in SKETCH_VALUES:
            sketch_vals[name] = m.pop("http://www.w3.org/ns/dqv#value")
    return dqv, sketch_vals


def test_dqv_report_matches_jax(datasets):
    text = datasets["bsbm"]
    res = qa.assess(text, metrics="all", base=BASE, device="cpu")
    ref = jqa.assess(text, metrics="all", base=BASE, backend="fused_scan")
    got, got_sk = _without_times(report.to_dqv(res))
    want, want_sk = _without_times(j_report.to_dqv(ref))
    assert got == want
    assert got_sk.keys() == want_sk.keys()
    for k in want_sk:
        assert got_sk[k] == pytest.approx(want_sk[k], rel=1e-6)
    assert json.loads(report.to_json(res))["nTriples"] == ref.n_triples
    ts = "2020-01-01T00:00:00+00:00"
    got_nt = report.to_ntriples(res, computed_on=ts).splitlines()
    want_nt = j_report.to_ntriples(ref, computed_on=ts).splitlines()
    assert len(got_nt) == len(want_nt)
    for g, w in zip(got_nt, want_nt):
        if '#value>' in g and any(f"_:meas_{m} " in g
                                  for m in SKETCH_VALUES):
            continue                         # float32 estimate, see above
        assert g == w


# --- chunk state carried across packages --------------------------------------

@pytest.mark.parametrize("backend", ["torch", "fused_scan"])
def test_state_from_jax_merges_and_finalizes(datasets, backend):
    """Chunk 0 evaluated by the JAX evaluator, chunks 1-2 by the port,
    merged in the port: the same counters, registers and values as the
    JAX single-shot result."""
    tt = datasets["synth"]
    chunks = tt.chunks(3)
    jev = JEvaluator(ALL_METRICS, backend="jnp")
    state = jev.chunk_state_init()
    c0 = chunks[0]
    counts, regs = jev.eval_chunk(JTripleTensor(c0.planes, c0.n_valid,
                                                c0.n_terms))
    state = JEvaluator.merge_chunk(state, 0, counts, regs)

    ev = QualityEvaluator(ALL_METRICS, backend=backend, device="cpu")
    ported = state_from_numpy(state, ev)
    assert ported is not state and ported["chunks_done"] == {0}
    for i in (1, 2):
        counts, regs = ev.eval_chunk(chunks[i])
        ported = ev.merge_chunk(ported, i, counts, regs)
    ported = ev.merge_chunk(ported, 1, counts, regs)   # re-delivery: no-op
    res = ev.finalize_state(ported, len(tt))

    ref = jqa.assess(_jax_input(tt), metrics="all", backend="jnp")
    assert res.counts == ref.counts
    for k in ref.registers:
        np.testing.assert_array_equal(res.registers[k], ref.registers[k])
    for k, v in ref.values.items():
        assert res.values[k] == (pytest.approx(v, rel=1e-6)
                                 if k in SKETCH_VALUES else v), k
    assert res.passes == 3 * ev.passes_per_chunk
    # ... and the port's state goes back the other way as it is
    back = jev.finalize_state(
        {**ported, "chunks_done": set(ported["chunks_done"])}, len(tt))
    assert back.counts == ref.counts


def test_state_from_numpy_rejects_other_engines():
    ev = QualityEvaluator(ALL_METRICS, device="cpu")
    good = ev.chunk_state_init()
    assert state_from_numpy(good, ev)["counts"][0].dtype == np.int64
    bad_counts = {**good, "counts": [np.zeros(3, np.int64)]}
    with pytest.raises(ValueError, match="counters"):
        state_from_numpy(bad_counts, ev)
    with pytest.raises(ValueError, match="counter vectors"):
        state_from_numpy({**good, "counts": []}, ev)
    with pytest.raises(ValueError, match="sketches"):
        state_from_numpy({**good, "sketches": {"spo": good["sketches"]["spo"]}},
                         ev)
    other_p = JEvaluator(ALL_METRICS, hll_p=10).chunk_state_init()
    with pytest.raises(ValueError, match="hll_p=12"):
        state_from_numpy(other_p, ev)
    with pytest.raises(ValueError, match="not a chunk state"):
        state_from_numpy({"counts": []}, ev)


# --- the pipeline surface ----------------------------------------------------------

def test_pipeline_surface(tmp_path, datasets):
    text = datasets["bsbm"]
    p = (qa.pipeline().metrics("paper").base(*BASE).backend("torch")
         .per_metric().hll(10).device("cpu").single_shot())
    assert repr(p) == ("qa.Pipeline[7 metrics | per-metric | torch | "
                       "hll_p=10 | single-shot | cpu]")
    assert p.evaluator() is p.evaluator()            # engine memoized
    assert p.with_exec(p.exec).exec == p.exec
    ref = p.run(text)
    path = tmp_path / "d.nt"
    path.write_text(text)
    gz = tmp_path / "d.nt.gz"
    gz.write_bytes(gzip.compress(text.encode()))
    for ds in (str(path), path, text.encode(), gzip.compress(text.encode()),
               str(gz), p.ingest(text)):
        assert p.run(ds).values == ref.values
    with pytest.raises(FileNotFoundError):
        p.run(str(tmp_path / "missing.nt"))
    with pytest.raises(TypeError):
        p.run([text])
    with pytest.raises(ValueError, match="backend"):
        qa.pipeline().backend("jnp")
    with pytest.raises(ValueError, match="unknown metrics"):
        qa.pipeline().metrics("paper,NOPE")


def test_custom_metric_fuses_with_builtins(datasets):
    m = qa.ratio_metric("T_LIT", num=qa.is_literal("o"))
    try:
        res = qa.assess(datasets["synth"], metrics="paper,T_LIT",
                        device="cpu")
    finally:
        qa.unregister("T_LIT")
    tt = datasets["synth"]
    lit = int(((tt.planes[:, 5] & 2) != 0).sum())   # vocab.KIND_LITERAL
    assert res.counts["T_LIT"]["num"] == lit
    assert res.values["T_LIT"] == lit / res.counts["T_LIT"]["den"]
    assert m.name == "T_LIT"


def test_default_runs_on_the_card_or_raises(datasets):
    """The default entry point asks for the CUDA kernels: on a machine
    without a card that is torch's own error, never a silent CPU run."""
    assert qa.ExecutionConfig().device == "cuda"
    assert qa.ExecutionConfig().backend == "fused_scan"
    K.reset_launches()
    if torch.cuda.is_available():
        qa.assess(datasets["synth"], metrics="all")
        assert K.LAUNCHES["fused_scan"] == 1
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            qa.assess(datasets["synth"], metrics="all")
        assert K.LAUNCHES == {"qap_count": 0, "fused_scan": 0}


def test_import_pulls_in_no_jax():
    code = ("import sys, repro_torch, repro_torch.qa, repro_torch.core, "
            "repro_torch.kernels.fused_scan, repro_torch.kernels._build\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'repro' "
            "or m.startswith('repro.'))\n"
            "print(bad)")
    env = {**os.environ, "PYTHONPATH": "src"}
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True).stdout
    assert out.strip() == "[]"


# --- on the card --------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per-metric"])
@pytest.mark.parametrize("data", ["bsbm", "synth"])
def test_gpu_kernels_match_plain_backend(cuda, datasets, data, fused):
    ds = datasets[data]
    K.reset_launches()
    res = qa.assess(ds, metrics="all", fused=fused, base=BASE)
    launched = dict(K.LAUNCHES)
    plain = qa.assess(ds, metrics="all", fused=fused, base=BASE,
                      backend="torch")
    assert launched["fused_scan"] >= 1
    assert launched["qap_count"] == (0 if fused else len(ALL_METRICS) - 2)
    assert res.counts == plain.counts
    for k in plain.registers:
        np.testing.assert_array_equal(res.registers[k], plain.registers[k])
    assert res.values == plain.values
