"""``repro_torch.dist`` and ``repro_torch.checkpoint`` against the JAX
package's scheduler: retries, coordinator crash and resume, the pipelined
executor, straggler detection, speculative re-execution, checkpoints, and
runs that one package begins and the other resumes.

The port runs with ``device="cpu"`` (its kernel wrappers then run their
plain torch versions), the JAX package its ``jnp`` backend, as in its own
scheduler tests (``tests/test_qa.py``, ``tests/test_system.py``).
Tolerances: counters, register banks, ``n_triples`` and every value
derived only from counters are exact; values from the float32 HLL
estimator agree to ``rel=1e-6`` across the packages, since XLA and torch
sum ``exp2(-regs)`` in different orders (within one package they are
exact).
"""
import os
import tempfile
import time

import numpy as np
import pytest
import torch

from repro import qa as jqa
from repro.core.evaluator import QualityEvaluator as JEvaluator
from repro.dist import ChunkScheduler as JScheduler
from repro.dist import FaultInjector as JFaults
from repro.dist import WorkerFailure as JWorkerFailure
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.rdf import TripleTensor as JTripleTensor

from repro_torch import qa
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.evaluator import QualityEvaluator
from repro_torch.core.metrics import ALL_METRICS, PAPER_METRICS, SKETCH_METRICS
from repro_torch.dist import (ChunkScheduler, FaultInjector, WorkerFailure,
                              _fingerprint)
from repro_torch.rdf import synth_encoded

N = 10_000


@pytest.fixture(scope="module")
def tensor():
    return synth_encoded(N, seed=3)


def _evaluator(metrics=PAPER_METRICS, backend="torch"):
    return QualityEvaluator(metrics, fused=True, backend=backend,
                            device="cpu")


def _same(res, ref):
    """Exact equality within the port: counters, registers, values."""
    assert res.n_triples == ref.n_triples
    assert res.counts == ref.counts
    assert res.values == ref.values
    assert set(res.registers) == set(ref.registers)
    for k in ref.registers:
        np.testing.assert_array_equal(res.registers[k], ref.registers[k], k)


# --- the pipelined executor -------------------------------------------------------

def test_pipelined_executor_bit_identical(tensor):
    sync = qa.pipeline().metrics(ALL_METRICS).device("cpu").chunked(8) \
        .run(tensor)
    pipelined = qa.pipeline().metrics(ALL_METRICS).device("cpu").chunked(8) \
        .pipelined().run(tensor)
    _same(pipelined, sync)
    assert pipelined.sketch_estimates == sync.sketch_estimates
    assert pipelined.exec_stats.mode == "pipelined"
    assert sync.exec_stats.mode == "sync"
    assert pipelined.exec_stats.chunks_total == 8
    assert len(pipelined.exec_stats.chunk_eval_seconds) == 8
    assert pipelined.exec_stats.wall_seconds > 0
    # streamed (lazy iterable) ingest through the async executor
    streamed = qa.pipeline().metrics(ALL_METRICS).device("cpu").pipelined() \
        .run(iter(tensor.chunks(6)))
    _same(streamed, sync)
    assert streamed.exec_stats.chunks_total == 6


# --- retries, crash and resume ----------------------------------------------------

@pytest.mark.parametrize("prefetch", [0, 1], ids=["sync", "pipelined"])
@pytest.mark.parametrize("case", [
    # (metrics, rows, seed, n_chunks, every, fail_chunks, crash_after)
    pytest.param((PAPER_METRICS, N, 3, 10, 4, {1: 2}, 7), id="paper"),
    pytest.param((ALL_METRICS, 30_000, 21, 12, 4, {2: 1, 9: 2}, 8),
                 id="all"),
])
def test_crash_and_resume_matches_single_shot(case, prefetch):
    """Flaky workers are retried, the coordinator crashes, and a new
    scheduler resumes from the checkpoint without rescanning the merged
    chunks: the result is the single-shot one, sync and pipelined alike."""
    metrics, rows, seed, n_chunks, every, fails, crash = case
    tt = synth_encoded(rows, seed=seed)
    ev = _evaluator(metrics)
    ref = qa.assess(tt, metrics=metrics, backend="torch", device="cpu")
    with tempfile.TemporaryDirectory() as d:
        sched = ChunkScheduler(ev, n_chunks=n_chunks, checkpoint_dir=d,
                               checkpoint_every=every, prefetch=prefetch)
        faults = FaultInjector(fail_chunks=fails, crash_after_merges=crash)
        with pytest.raises(WorkerFailure, match="coordinator crash"):
            sched.run(tt, faults=faults)
        sched2 = ChunkScheduler(ev, n_chunks=n_chunks, checkpoint_dir=d,
                                checkpoint_every=every, prefetch=prefetch)
        res, stats = sched2.run(tt)
    assert stats.resumed_from is not None
    assert stats.attempts < n_chunks, "resume must skip completed chunks"
    assert stats.mode == ("pipelined" if prefetch else "sync")
    _same(res, ref)


def test_pipelined_retries_materialize_failures(tensor):
    """Launches are async, so real worker failures surface at host sync;
    the pipelined executor must re-dispatch and retry there just like the
    sequential loop retries the whole eval."""
    ev = _evaluator()
    ref = qa.assess(tensor, metrics=PAPER_METRICS, backend="torch",
                    device="cpu")
    boom = {"left": 2}
    orig = ev.materialize_chunk

    def flaky(outs):
        if boom["left"]:
            boom["left"] -= 1
            raise WorkerFailure("host sync died")
        return orig(outs)

    ev.materialize_chunk = flaky  # instance attr shadows the staticmethod
    try:
        res, stats = ChunkScheduler(ev, n_chunks=6, prefetch=1).run(tensor)
        # a chunk that NEVER recovers aborts after the same per-chunk
        # failure budget as the sequential loop (no free extra attempt)
        boom["left"] = 10**9
        with pytest.raises(WorkerFailure):
            ChunkScheduler(ev, n_chunks=6, prefetch=1,
                           max_attempts=4).run(tensor)
        assert boom["left"] == 10**9 - 4
    finally:
        del ev.materialize_chunk
    assert stats.retries == 2
    _same(res, ref)


@pytest.mark.parametrize("prefetch", [0, 1], ids=["sync", "pipelined"])
def test_device_errors_are_not_retried(tensor, prefetch):
    """A CUDA error reaches the host as torch's RuntimeError when the
    chunk's results are copied back. It is not a WorkerFailure: the run
    fails at once, after one attempt, instead of being retried into a
    silent pass."""
    ev = _evaluator()
    calls = {"n": 0}
    orig = ev.materialize_chunk

    def broken(outs):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("CUDA error: an illegal memory access was "
                               "encountered")
        return orig(outs)

    ev.materialize_chunk = broken
    try:
        sched = ChunkScheduler(ev, n_chunks=6, prefetch=prefetch)
        with pytest.raises(RuntimeError, match="illegal memory") as info:
            sched.run(tensor)
    finally:
        del ev.materialize_chunk
    assert not isinstance(info.value, WorkerFailure)
    assert calls["n"] == 2


def test_straggler_detection_flags_slow_chunks(tensor):
    """The scheduler consumes its own chunk_eval_seconds: a chunk slower
    than straggler_factor × the running median is flagged on
    ChunkStats.stragglers and reported in one warning line."""
    ev = _evaluator()
    ref = qa.assess(tensor, metrics=PAPER_METRICS, backend="torch",
                    device="cpu")
    sched = ChunkScheduler(ev, n_chunks=8, straggler_factor=3.0)
    faults = FaultInjector(slow_chunks={5: 0.6})
    with pytest.warns(RuntimeWarning, match="straggler"):
        res, stats = sched.run(tensor, faults=faults)
    assert 5 in stats.stragglers
    assert len(stats.chunk_eval_seconds) == 8
    _same(res, ref)                     # detection never perturbs results
    # factor=0 disables detection
    _, stats2 = ChunkScheduler(ev, n_chunks=8, straggler_factor=0).run(
        tensor, faults=FaultInjector(slow_chunks={5: 0.3}))
    assert stats2.stragglers == []


def test_speculative_reexecution_slow_copy_loses(tensor):
    """speculate=True: a chunk whose primary eval outlives the live
    straggler threshold gets a backup copy dispatched; the backup (not
    slowed — a slow *worker*, not a slow partition) finishes first and
    wins. The merge is idempotent per chunk id, so the abandoned slow
    copy cannot corrupt anything."""
    ev = _evaluator()
    ref = qa.assess(tensor, metrics=PAPER_METRICS, backend="torch",
                    device="cpu")
    sched = ChunkScheduler(ev, n_chunks=8, straggler_factor=3.0,
                           speculate=True)
    faults = FaultInjector(slow_chunks_once={5: 2.0})
    t0 = time.perf_counter()
    with pytest.warns(RuntimeWarning, match="straggler"):
        res, stats = sched.run(tensor, faults=faults)
    assert 5 in stats.speculated
    assert 5 in stats.stragglers          # live-flagged, not just post-hoc
    assert stats.speculation_wins >= 1    # the slow copy lost
    assert time.perf_counter() - t0 < 2.0, "run must not wait out the sleep"
    _same(res, ref)
    # speculation off: the same fault stalls the whole run
    _, stats2 = ChunkScheduler(ev, n_chunks=8, straggler_factor=3.0,
                               speculate=False).run(
        tensor, faults=FaultInjector(slow_chunks_once={5: 0.2}))
    assert stats2.speculated == [] and stats2.speculation_wins == 0


def test_pipelined_ingest_error_propagates(tensor):
    def bad_stream():
        yield tensor.chunks(4)[0]
        raise RuntimeError("exploding tokenizer")
    with pytest.raises(RuntimeError, match="exploding tokenizer"):
        qa.pipeline().metrics("paper").device("cpu").pipelined() \
            .run(bad_stream())


def test_speculative_duplicate_merge_is_idempotent():
    tt = synth_encoded(8_000, seed=4)
    ev = _evaluator(ALL_METRICS)
    state = ev.chunk_state_init()
    for cid, c in enumerate(tt.chunks(4)):
        counts, regs = ev.eval_chunk(c)
        state = QualityEvaluator.merge_chunk(state, cid, counts, regs)
        # duplicate delivery (speculative copy finishing late)
        state = QualityEvaluator.merge_chunk(state, cid, counts, regs)
    _same(ev.finalize_state(state, len(tt)),
          qa.assess(tt, metrics=ALL_METRICS, backend="torch", device="cpu"))


# --- checkpoints -------------------------------------------------------------------

def test_chunked_checkpointing_writes_state(tensor):
    with tempfile.TemporaryDirectory() as d:
        res = qa.assess(tensor, metrics="paper", chunks=8, device="cpu",
                        checkpoint_dir=d, checkpoint_every=4)
        assert res.exec_stats.checkpoints_written >= 1
        assert any(n.startswith("step_") for n in os.listdir(d))


def test_completed_run_always_checkpoints(tensor):
    """Even when n_chunks never aligns with checkpoint_every, a completed
    run must persist its final state (else checkpointing silently no-ops
    and a re-run rescans everything)."""
    with tempfile.TemporaryDirectory() as d:
        res = qa.assess(tensor, metrics="paper", chunks=6, device="cpu",
                        checkpoint_dir=d)  # default checkpoint_every=8 > 6
        assert res.exec_stats.checkpoints_written == 1
        res2 = qa.assess(tensor, metrics="paper", chunks=6, device="cpu",
                         checkpoint_dir=d)
        assert res2.exec_stats.resumed_from == 6
        assert res2.exec_stats.attempts == 0
        assert res2.values == res.values


def test_incompatible_checkpoint_rejected(tensor):
    """Resuming a checkpoint written under different n_chunks or metrics
    would merge stale counts for different data slices — must raise."""
    kw = dict(metrics="paper", device="cpu")
    with tempfile.TemporaryDirectory() as d:
        qa.assess(tensor, chunks=8, checkpoint_dir=d, checkpoint_every=4,
                  **kw)
        with pytest.raises(ValueError, match="incompatible"):
            qa.assess(tensor, chunks=4, checkpoint_dir=d, **kw)
        with pytest.raises(ValueError, match="incompatible"):
            qa.assess(tensor, metrics="L1,I2", chunks=8, checkpoint_dir=d,
                      device="cpu")
        # a different dataset must not resume another dataset's state
        other = synth_encoded(N + 500, seed=99)
        with pytest.raises(ValueError, match="incompatible"):
            qa.assess(other, chunks=8, checkpoint_dir=d, **kw)
        # the matching configuration still resumes
        res = qa.assess(tensor, chunks=8, checkpoint_dir=d, **kw)
        assert res.exec_stats.resumed_from == 8
        assert res.exec_stats.attempts == 0


def test_checkpoint_layout_is_the_jax_packages(tmp_path):
    """The same tree gets the same npz keys and manifest from both
    managers, and each restores what the other wrote."""
    tree = {"sketches": {"spo": np.arange(8, dtype=np.int32),
                         "p": np.ones(8, np.int32)},
            "counts": [np.arange(3, dtype=np.int64), np.zeros(1, np.int64)]}
    meta = {"chunks_done": [0, 2], "n_chunks": 4}
    CheckpointManager(str(tmp_path / "t")).save(5, tree, metadata=meta)
    JCheckpointManager(str(tmp_path / "j")).save(5, tree, metadata=meta)
    t_man = CheckpointManager(str(tmp_path / "t")).manifest(5)
    j_man = JCheckpointManager(str(tmp_path / "j")).manifest(5)
    assert t_man == j_man
    assert t_man["keys"] == ["['counts'][0]", "['counts'][1]",
                             "['sketches']['p']", "['sketches']['spo']"]
    for writer, reader in (("j", CheckpointManager),
                           ("t", JCheckpointManager)):
        mgr = reader(str(tmp_path / writer))
        assert mgr.latest_step() == 5
        got = mgr.restore(5, tree)
        for k in ("spo", "p"):
            np.testing.assert_array_equal(got["sketches"][k],
                                          tree["sketches"][k])
        for a, b in zip(got["counts"], tree["counts"]):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(KeyError, match="missing"):
        CheckpointManager(str(tmp_path / "t")).restore(
            5, {**tree, "extra": np.zeros(1)})


def test_checkpoint_manager_async_keep_and_errors(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        mgr.save_async(step, {"a": np.full(4, step)})
    mgr.wait()
    assert mgr.all_steps() == [2, 3]
    np.testing.assert_array_equal(mgr.restore(3, {"a": 0})["a"],
                                  np.full(4, 3))
    blocker = tmp_path / "step_0000000009"
    blocker.write_text("a file where the step directory goes")
    mgr.save_async(9, {"a": np.zeros(1)})
    with pytest.raises(OSError):
        mgr.wait()                       # the writer's error, re-raised here


def test_fingerprint_is_the_jax_packages(tensor):
    from repro.dist import _fingerprint as j_fingerprint
    assert _fingerprint(tensor.planes) == j_fingerprint(tensor.planes)


# --- a run begun by one package and resumed by the other ----------------------------

def _jax_tensor(tt):
    return JTripleTensor(tt.planes, tt.n_valid, tt.n_terms)


@pytest.mark.parametrize("direction", ["jax-to-torch", "torch-to-jax"])
@pytest.mark.parametrize("prefetch", [0, 1], ids=["sync", "pipelined"])
def test_resume_across_packages(direction, prefetch):
    """One package's scheduler crashes at merge 7 with a checkpoint
    directory; the other package's scheduler resumes from it. The result
    equals the JAX single shot: counters and registers exact."""
    tt = synth_encoded(12_000, seed=5)
    jt = _jax_tensor(tt)
    jev = JEvaluator(ALL_METRICS, fused=True, backend="jnp")
    tev = _evaluator(ALL_METRICS)
    ref = jqa.assess(jt, metrics=ALL_METRICS, backend="jnp")
    with tempfile.TemporaryDirectory() as d:
        kw = dict(n_chunks=12, checkpoint_dir=d, checkpoint_every=4,
                  prefetch=prefetch)
        if direction == "jax-to-torch":
            with pytest.raises(JWorkerFailure):
                JScheduler(jev, **kw).run(
                    jt, faults=JFaults(crash_after_merges=7))
            res, stats = ChunkScheduler(tev, **kw).run(tt)
        else:
            with pytest.raises(WorkerFailure):
                ChunkScheduler(tev, **kw).run(
                    tt, faults=FaultInjector(crash_after_merges=7))
            res, stats = JScheduler(jev, **kw).run(jt)
    assert stats.resumed_from == 4
    assert stats.attempts == 8, "the 4 checkpointed chunks are not rescanned"
    assert res.n_triples == ref.n_triples
    assert res.counts == ref.counts
    for k in ref.registers:
        np.testing.assert_array_equal(np.asarray(res.registers[k]),
                                      np.asarray(ref.registers[k]), k)
    for k, v in ref.values.items():
        assert res.values[k] == (pytest.approx(v, rel=1e-6)
                                 if k in SKETCH_METRICS else v), k


# --- on the card --------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_gpu_speculative_threads_launch_on_the_evaluators_card(cuda,
                                                               tensor):
    """Worker threads start on device 0; the scheduler makes the
    evaluator's card current in each, so a ``cuda:<i>`` evaluator never
    launches on another card."""
    index = torch.cuda.device_count() - 1
    ev = QualityEvaluator(PAPER_METRICS, backend="fused_scan",
                          device=f"cuda:{index}")
    seen = []
    orig = ev.eval_chunk

    def spy(chunk):
        seen.append(torch.cuda.current_device())
        return orig(chunk)

    ev.eval_chunk = spy
    try:
        sched = ChunkScheduler(ev, n_chunks=8, straggler_factor=3.0,
                               speculate=True)
        with pytest.warns(RuntimeWarning, match="straggler"):
            res, stats = sched.run(tensor, faults=FaultInjector(
                slow_chunks_once={5: 1.0}))
    finally:
        del ev.eval_chunk
    assert 5 in stats.speculated
    assert seen and set(seen) == {index}
    _same(res, qa.assess(tensor, metrics=PAPER_METRICS, backend="torch",
                         device=f"cuda:{index}"))


@pytest.mark.gpu
@pytest.mark.parametrize("prefetch", [0, 2], ids=["sync", "pipelined"])
def test_gpu_crash_and_resume_matches_single_shot(cuda, prefetch):
    tt = synth_encoded(200_000, seed=8)
    ev = QualityEvaluator(ALL_METRICS, backend="twopass")
    ref = qa.assess(tt, metrics="all", backend="twopass")
    with tempfile.TemporaryDirectory() as d:
        kw = dict(n_chunks=10, checkpoint_dir=d, checkpoint_every=3,
                  prefetch=prefetch)
        with pytest.raises(WorkerFailure):
            ChunkScheduler(ev, **kw).run(tt, faults=FaultInjector(
                fail_chunks={2: 2}, crash_after_merges=7))
        res, stats = ChunkScheduler(ev, **kw).run(tt)
    assert stats.resumed_from == 6
    _same(res, ref)
