"""``repro_torch.qa`` against ``repro.qa``: the single-shot assessment on
every backend, the chunked, pipelined and streamed execution modes, the
DQV report, and chunk states carried between the two packages.

The port runs with ``device="cpu"`` (its kernel wrappers then run their
plain torch versions); the JAX package runs its ``jnp`` backend and its
Pallas kernels in interpret mode, as its own tests do.

Tolerances: counters, register banks, ``n_triples``, ``passes`` and every
value derived only from counters are exact. ``sketch_estimates``,
``CN2_EXACT`` and ``SCH1`` come from the float32 HLL estimator, whose sum
of ``exp2(-regs)`` XLA and torch add in different orders: ``rel=1e-6``.
"""
import dataclasses
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
JAX_BACKEND = {"torch": "jnp", "twopass": "pallas", "fused_scan": "fused_scan"}


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
@pytest.mark.parametrize("backend", ["torch", "twopass", "fused_scan"])
@pytest.mark.parametrize("data", ["bsbm", "synth"])
def test_assess_matches_jax(datasets, data, backend, fused):
    ds = datasets[data]
    res = qa.assess(ds, metrics="all", backend=backend, fused=fused,
                    base=BASE, device="cpu")
    ref = jqa.assess(_jax_input(ds), metrics="all",
                     backend=JAX_BACKEND[backend], fused=fused, base=BASE)
    assert_same_result(res, ref)


def test_twopass_measures_one_plus_s_passes():
    """The counter scan plus one fold per sketch, measured by the scan
    counter, as the JAX pallas backend measures it."""
    ev = QualityEvaluator(ALL_METRICS, backend="twopass", device="cpu")
    assert len(ev._all_sketch_specs()) == 2
    assert ev.passes_per_chunk == 3
    assert JEvaluator(ALL_METRICS, backend="pallas").passes_per_chunk == 3
    paper = QualityEvaluator(("L1", "I2"), backend="twopass", device="cpu")
    assert paper.passes_per_chunk == 1
    per_metric = QualityEvaluator(ALL_METRICS, backend="twopass",
                                  fused=False, device="cpu")
    assert per_metric.passes_per_chunk == JEvaluator(
        ALL_METRICS, backend="pallas", fused=False).passes_per_chunk


# --- execution modes ------------------------------------------------------------

EXEC_MODES = {
    "chunked": lambda p: p.chunked(8),
    "pipelined-1": lambda p: p.chunked(8).pipelined(1),
    "pipelined-2": lambda p: p.chunked(8).pipelined(2),
    "speculative": lambda p: p.chunked(8).speculative(),
}


@pytest.mark.parametrize("backend", ["torch", "twopass", "fused_scan"])
@pytest.mark.parametrize("mode", sorted(EXEC_MODES))
def test_execution_modes_match_jax_and_single_shot(datasets, mode, backend):
    """Chunked runs, sequential or pipelined, give the JAX package's result
    in the same mode and the port's own single-shot result."""
    tt = datasets["synth"]
    pipe = EXEC_MODES[mode](qa.pipeline().metrics("all").backend(backend)
                            .device("cpu"))
    res = pipe.run(tt)
    jpipe = EXEC_MODES[mode](jqa.pipeline().metrics("all").backend(
        JAX_BACKEND[backend]))
    assert_same_result(res, jpipe.run(_jax_input(tt)))
    single = qa.assess(tt, metrics="all", backend=backend, device="cpu")
    assert res.counts == single.counts and res.values == single.values
    for k in single.registers:
        np.testing.assert_array_equal(res.registers[k], single.registers[k])
    st = res.exec_stats
    assert st.chunks_total == 8 and len(st.chunk_eval_seconds) == 8
    assert st.mode == ("pipelined" if pipe.exec.prefetch else "sync")
    assert st.passes_per_chunk == pipe.evaluator().passes_per_chunk
    assert res.passes == 8 * st.passes_per_chunk and st.wall_seconds > 0


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("source", ["text", "bytes", "path", "chunks"])
def test_streamed_ingest_matches_jax_and_single_shot(datasets, tmp_path,
                                                     source, prefetch):
    """N-Triples streamed in blocks of rows, or an iterable of chunks,
    through the scheduler: the same result as the JAX package's streamed
    run and the port's single shot of the same text."""
    text = datasets["bsbm"]
    pipe = qa.pipeline().metrics("all").base(*BASE).device("cpu") \
        .pipelined(prefetch)
    jpipe = jqa.pipeline().metrics("all").base(*BASE).backend(
        "fused_scan").pipelined(prefetch)
    if source == "chunks":
        lines = text.splitlines(keepends=True)
        blocks = ["".join(lines[i:i + 97]) for i in range(0, len(lines), 97)]
        data, jdata = iter(blocks), iter(blocks)
        n_chunks = len(blocks)
    else:
        pipe, jpipe = pipe.streamed(101), jpipe.streamed(101)
        data = {"text": text, "bytes": text.encode()}.get(source)
        if data is None:
            path = tmp_path / "d.nt"
            path.write_text(text)
            data = str(path)
        jdata = data
        n_chunks = None
    res = pipe.run(data)
    assert_same_result(res, jpipe.run(jdata))
    single = qa.pipeline().metrics("all").base(*BASE).device("cpu").run(text)
    assert res.counts == single.counts and res.values == single.values
    assert res.n_triples == single.n_triples
    assert res.exec_stats.chunks_total == (
        n_chunks or -(-single.n_triples // 101))
    if source == "chunks":
        # blocks are encoded one by one: term ids differ from a single
        # encode, but counters and content-hash registers do not
        for k in single.registers:
            np.testing.assert_array_equal(res.registers[k],
                                          single.registers[k])


def test_execution_config_validation():
    """Every construction path validates, as ``repro.qa`` does."""
    with pytest.raises(ValueError, match="backend"):
        qa.pipeline().backend("tpu9000")
    with pytest.raises(ValueError, match="backend"):
        qa.ExecutionConfig(backend="pallas")
    with pytest.raises(ValueError, match="prefetch"):
        qa.ExecutionConfig(prefetch=-1)
    with pytest.raises(ValueError, match="chunks"):
        qa.ExecutionConfig(chunks=-1)
    with pytest.raises(ValueError, match="stream_triples"):
        qa.pipeline().streamed(-5)
    with pytest.raises(ValueError, match="unknown metrics"):
        qa.pipeline().metrics("paper,NOT_A_METRIC")
    with pytest.raises(ValueError, match="no metrics"):
        qa.pipeline().metrics("")
    p1 = qa.pipeline().metrics("paper")
    p2 = p1.backend("twopass").chunked(4, checkpoint_dir="/x").streamed(9)
    assert p1.exec.chunks == 0 and p2.exec.chunks == 4
    assert p2.exec.checkpoint_dir == "/x" and p2.exec.stream_triples == 9
    assert p2.single_shot().exec == dataclasses.replace(
        p2.exec, chunks=0, checkpoint_dir=None, stream_triples=0)
    assert repr(p2.pipelined(2).speculative()) == (
        "qa.Pipeline[7 metrics | fused | twopass | hll_p=12 | chunked×4 "
        "streamed@9 async×2 ckpt=/x | cuda]")
    assert "speculative" in repr(p2.speculative())
    with pytest.warns(RuntimeWarning, match="speculate"):
        p2.pipelined(1).speculative().device("cpu").scheduler()


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
        p.run(3.5)
    with pytest.raises(TypeError):
        p.run([3.5])
    stream = p.run([text])                   # one chunk, through the scheduler
    assert stream.values == ref.values and stream.exec_stats.chunks_total == 1
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
        assert K.LAUNCHES == {"qap_count": 0, "fused_scan": 0, "hll_fold": 0}


def test_import_pulls_in_no_jax():
    code = ("import sys, repro_torch, repro_torch.qa, repro_torch.core, "
            "repro_torch.kernels.fused_scan, repro_torch.kernels._build, "
            "repro_torch.dist, repro_torch.checkpoint, "
            "repro_torch.kernels.hll\n"
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


@pytest.mark.gpu
@pytest.mark.parametrize("data", ["bsbm", "synth"])
def test_gpu_twopass_launches_one_fold_per_sketch(cuda, datasets, data):
    ds = datasets[data]
    K.reset_launches()
    res = qa.assess(ds, metrics="all", backend="twopass", base=BASE)
    assert K.LAUNCHES == {"qap_count": 1, "fused_scan": 0, "hll_fold": 2}
    assert res.passes == 3
    plain = qa.assess(ds, metrics="all", backend="torch", base=BASE)
    assert res.counts == plain.counts and res.values == plain.values
    for k in plain.registers:
        np.testing.assert_array_equal(res.registers[k], plain.registers[k])


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["twopass", "fused_scan"])
@pytest.mark.parametrize("prefetch", [0, 1, 2])
def test_gpu_chunked_and_pipelined_match_single_shot(cuda, datasets, backend,
                                                     prefetch):
    """Chunks of differing sizes through the pinned side-stream copies
    (prefetch > 0) or the plain copies (0): the single-shot result."""
    tt = synth_encoded(300_007, seed=11)
    single = qa.assess(tt, metrics="all", backend=backend)
    sizes = [1, 70_000, 3, 130_000, 0, 100_003]
    starts = np.cumsum([0] + sizes)
    chunks = [tt.take(int(b)).planes[int(a):] for a, b in
              zip(starts[:-1], starts[1:])]
    from repro_torch.rdf import TripleTensor
    stream = [TripleTensor(np.ascontiguousarray(c), len(c)) for c in chunks]
    K.reset_launches()
    res = qa.pipeline().metrics("all").backend(backend).pipelined(
        prefetch).run(iter(stream))
    kernel = "fused_scan" if backend == "fused_scan" else "hll_fold"
    assert K.LAUNCHES[kernel] == (5 if kernel == "fused_scan" else 10)
    assert res.counts == single.counts and res.values == single.values
    for k in single.registers:
        np.testing.assert_array_equal(res.registers[k], single.registers[k])
    assert res.exec_stats.mode == ("pipelined" if prefetch else "sync")
