"""Mesh execution of ``repro_torch`` on ``torch.distributed`` against the
JAX package.

Ranks are real processes on one ``gloo`` group over the CPU, started by
``repro_torch.launch.mesh.launch_ranks`` (each case spawns its ranks once,
with a deadline of its own, so a hung collective fails one test and does
not stall the suite). The port runs with ``device="cpu"``: its kernel
wrappers run their plain torch versions on each rank's shard, and the
counters and register banks meet in real collectives. The JAX package is
the reference on one device (its ``jnp`` backend), and, for the chunked
and pipelined report, under a 4-device mesh of fake XLA CPU devices
(``run_subprocess_devices``). The JAX package's own mesh segment batch
fails its test (ROADMAP §C), so the segment batch is held to the JAX
package's single-device ``eval_chunk``.

Tolerances: counters, register banks, ``n_triples`` and ``passes``
exact; values derived only from counters exact; ``sketch_estimates``,
``CN2_EXACT`` and ``SCH1`` come from the float32 HLL estimator, whose sum
of ``exp2(-regs)`` XLA and torch add in different orders: ``rel=1e-6``
across the packages, exact within the port. DQV reports equal except
timestamps.
"""
import functools
import json
import os
import textwrap
import time
import types

import numpy as np
import pytest
import torch

from conftest import run_subprocess_devices
from repro.core.evaluator import QualityEvaluator as JEvaluator
from repro.rdf import TripleTensor as JTripleTensor

from repro_torch import qa
from repro_torch.core.evaluator import QualityEvaluator
from repro_torch.core.metrics import ALL_METRICS, PAPER_METRICS, SKETCH_METRICS
from repro_torch.dist import ChunkScheduler, FaultInjector, WorkerFailure
from repro_torch.launch import mesh as mesh_mod
from repro_torch.rdf import synth_encoded

SKETCH_VALUES = set(SKETCH_METRICS)
METRICS = {"all": ALL_METRICS, "paper": PAPER_METRICS}
BACKENDS = ("torch", "fused_scan", "twopass")
SIZES = (2003, 3)      # 2003 rows divide by no W in 2..4; 3 rows < W = 4
SEED = 11
DEADLINE = 120.0       # seconds a case's ranks may take

# the start of every rank's program: the mesh over all ranks, and the
# result of an assessment as JSON
PRELUDE = textwrap.dedent("""
    import json, sys, warnings
    import numpy as np
    from repro_torch import qa
    from repro_torch.launch.mesh import close_ranks, make_assessment_mesh
    from repro_torch.rdf import synth_encoded

    mesh = make_assessment_mesh(device="cpu")

    def pack(res):
        s = res.exec_stats
        return {"counts": res.counts, "values": res.values,
                "sketch_estimates": res.sketch_estimates,
                "n_triples": res.n_triples, "passes": res.passes,
                "registers": {k: v.tolist()
                              for k, v in res.registers.items()},
                "stats": None if s is None else {
                    "devices": s.devices, "mode": s.mode,
                    "chunks_total": s.chunks_total,
                    "resumed_from": s.resumed_from}}

    def emit(obj):
        print(json.dumps(obj))
""")


def run_ranks(w: int, body: str, timeout: float = DEADLINE) -> list:
    """Run ``PRELUDE + body`` as ``w`` gloo ranks; each rank's last
    stdout line, parsed."""
    code = PRELUDE + textwrap.dedent(body) + "\nclose_ranks()\n"
    results = mesh_mod.launch_ranks(w, ["-c", code], timeout=timeout)
    return [json.loads(r.stdout.strip().splitlines()[-1]) for r in results]


def assert_matches_jax(got: dict, jres) -> None:
    """A packed port result against a JAX ``AssessmentResult``."""
    assert got["n_triples"] == jres.n_triples
    assert got["counts"] == jres.counts
    assert set(got["registers"]) == set(jres.registers)
    for k, v in jres.registers.items():
        np.testing.assert_array_equal(
            np.asarray(got["registers"][k], np.int32), np.asarray(v), k)
    assert set(got["values"]) == set(jres.values)
    for k, v in jres.values.items():
        if k in SKETCH_VALUES:
            assert got["values"][k] == pytest.approx(v, rel=1e-6), k
        else:
            assert got["values"][k] == v, k
    for k, v in jres.sketch_estimates.items():
        assert got["sketch_estimates"][k] == pytest.approx(v, rel=1e-6), k


def assert_same(got: dict, res) -> None:
    """A packed port result against a port ``AssessmentResult``: exact."""
    assert got["n_triples"] == res.n_triples
    assert got["passes"] == res.passes
    assert got["counts"] == res.counts
    assert got["values"] == res.values
    assert got["sketch_estimates"] == res.sketch_estimates
    assert set(got["registers"]) == set(res.registers)
    for k, v in res.registers.items():
        np.testing.assert_array_equal(
            np.asarray(got["registers"][k], np.int32), v, k)


def jax_tensor(tt):
    return JTripleTensor(tt.planes, tt.n_valid, tt.n_terms)


@functools.lru_cache(maxsize=None)
def jax_single(n: int, metrics: str, fused: bool):
    """The JAX package's single-device result on ``synth_encoded(n)``."""
    tt = synth_encoded(n, seed=SEED)
    return JEvaluator(METRICS[metrics], fused=fused,
                      backend="jnp").assess(jax_tensor(tt))


# --- single shot over W ranks: every backend, mode and metric set ------------

@functools.lru_cache(maxsize=None)
def parity_run(w: int) -> list:
    """Every rank's results of single-shot ``.shard(mesh)`` runs over
    ``SIZES`` x metrics x fusion x backends, the ``assess`` shim under the
    mesh, and ``passes_per_chunk`` with and without the mesh."""
    return run_ranks(w, f"""
        from repro_torch.core.evaluator import QualityEvaluator
        out = {{"runs": {{}}, "shim": {{}}, "ppc": {{}}}}
        for n in {SIZES!r}:
            tt = synth_encoded(n, seed={SEED})
            for metrics in ("all", "paper"):
                for fused in (True, False):
                    for backend in {BACKENDS!r}:
                        res = (qa.pipeline().metrics(metrics)
                               .backend(backend).fused(fused)
                               .device("cpu").shard(mesh).run(tt))
                        out["runs"][f"{{n}}/{{metrics}}/{{fused}}/"
                                    f"{{backend}}"] = pack(res)
            ev = QualityEvaluator(device="cpu", mesh=mesh)
            out["shim"][str(n)] = pack(ev.assess(tt))
        for backend in {BACKENDS!r}:
            out["ppc"][backend] = [
                QualityEvaluator(backend=backend, device="cpu",
                                 mesh=mesh).passes_per_chunk,
                QualityEvaluator(backend=backend,
                                 device="cpu").passes_per_chunk]
        emit(out)
    """)


@pytest.mark.slow
@pytest.mark.parametrize("w", [1, 2, 3, 4])
def test_mesh_single_shot_matches_jax_single_device(w):
    """``.shard(mesh)`` over W ranks (2,003 rows, which no W in 2..4
    divides, and 3 rows, fewer than W = 4: empty shards) gives the JAX
    package's single-device counters and registers for ``all`` and
    ``paper``, fused and per metric, on every backend; and exactly the
    port's own single-device result, passes included."""
    out = parity_run(w)[0]
    for key, got in out["runs"].items():
        n, metrics, fused, backend = key.split("/")
        n, fused = int(n), fused == "True"
        assert_matches_jax(got, jax_single(n, metrics, fused))
        local = (qa.pipeline().metrics(metrics).backend(backend)
                 .fused(fused).device("cpu").run(synth_encoded(n, seed=SEED)))
        assert_same(got, local)
        assert got["stats"] is None
    assert len(out["runs"]) == len(SIZES) * 2 * 2 * len(BACKENDS)


@pytest.mark.slow
@pytest.mark.parametrize("w", [1, 2, 3, 4])
def test_mesh_every_rank_returns_the_whole_result(w):
    """Every rank ends with the same, whole result: the all-reduce hands
    each rank the sum and max over all shards."""
    outs = parity_run(w)
    assert len(outs) == w
    for other in outs[1:]:
        assert other == outs[0]


@pytest.mark.slow
@pytest.mark.parametrize("w", [2, 4])
def test_mesh_passes_per_chunk_equal_local(w):
    """Under a mesh ``passes_per_chunk`` counts one rank's pass over its
    shard: the local count, 1 for the one-pass ``fused_scan`` kernels and
    1 + S for the others (the port of the JAX package's
    ``test_mesh_pass_accounting_measured``)."""
    ppc = parity_run(w)[0]["ppc"]
    for backend, (dist_ppc, local_ppc) in ppc.items():
        assert dist_ppc == local_ppc, backend
    assert ppc["fused_scan"] == [1, 1]
    assert ppc["torch"][0] == ppc["twopass"][0] == 3


@pytest.mark.slow
@pytest.mark.parametrize("w", [1, 4])
def test_assess_shim_under_a_mesh_matches_jax(w):
    """``QualityEvaluator(mesh=...).assess(tensor)`` is the JAX method's
    result on one device."""
    for n, got in parity_run(w)[0]["shim"].items():
        assert_matches_jax(got, jax_single(int(n), "all", True))


@pytest.mark.parametrize("backend", BACKENDS)
def test_assess_shim_matches_jax(backend):
    """The ``assess`` shim over ``run_single_shot``, without a mesh, is
    the JAX evaluator's ``assess`` on the same tensor."""
    tt = synth_encoded(2003, seed=SEED)
    res = QualityEvaluator(backend=backend, device="cpu").assess(tt)
    assert_matches_jax({"counts": res.counts, "values": res.values,
                        "sketch_estimates": res.sketch_estimates,
                        "n_triples": res.n_triples,
                        "registers": res.registers},
                       jax_single(2003, "all", True))
    assert res.passes == (1 if backend == "fused_scan" else 3)


# --- shard boundaries (no process group needed) ------------------------------

def fake_mesh(w: int, rank: int):
    """What the evaluator reads of a 1-D mesh of ``w`` ranks, seen from
    ``rank``."""
    return types.SimpleNamespace(
        ndim=1, device_type="cpu", mesh=torch.arange(w),
        size=lambda: w, get_coordinate=lambda: [rank],
        get_local_rank=lambda: rank)


@pytest.mark.parametrize("w", [1, 2, 3, 4, 7])
@pytest.mark.parametrize("n", [0, 3, 4, 2003, 8192, 100_001])
def test_shard_bounds_cover_the_rows_on_aligned_starts(w, n):
    """Shards are contiguous, cover every row once, may be empty, and
    start on multiples of 4 rows (a 16-byte aligned base on the card);
    each rank's ``device_planes`` is its shard, and no row is padded."""
    planes = np.arange(n * 13, dtype=np.int32).reshape(n, 13)
    seen = []
    for r in range(w):
        ev = QualityEvaluator(device="cpu", mesh=fake_mesh(w, r))
        b = ev.shard_bounds(n)
        assert b[0] == 0 and b[-1] == n and len(b) == w + 1
        assert all(x <= y for x, y in zip(b, b[1:]))
        assert all(x % 4 == 0 for x in b[:-1])
        assert all(b[i + 1] - b[i] <= -(-n // w) + 4 for i in range(w))
        part = ev._local_rows(planes)
        np.testing.assert_array_equal(part, planes[b[r]:b[r + 1]])
        seen.append(part)
        assert ev._shard_count() == w and ev._row_multiple() == 4
    np.testing.assert_array_equal(np.concatenate(seen), planes)


def test_mesh_must_match_the_evaluators_device():
    """A mesh of another device type, of two dimensions, or without this
    rank is refused when the evaluator is built."""
    with pytest.raises(ValueError, match="mesh is on cpu"):
        QualityEvaluator(device="cuda", mesh=fake_mesh(2, 0))
    two_d = fake_mesh(4, 0)
    two_d.ndim, two_d.mesh = 2, torch.arange(4).reshape(2, 2)
    with pytest.raises(ValueError, match="1-D"):
        QualityEvaluator(device="cpu", mesh=two_d)
    outside = fake_mesh(2, 0)
    outside.get_coordinate = lambda: None
    with pytest.raises(ValueError, match="not in the mesh"):
        QualityEvaluator(device="cpu", mesh=outside)


def test_mesh_on_cuda_needs_a_card():
    """No fallback: a mesh on ``cuda`` without a card raises before any
    process group forms; with cards the backend follows the layout."""
    if torch.cuda.is_available():
        count = torch.cuda.device_count()
        assert mesh_mod.group_backend("cuda", count) == "nccl"
        assert mesh_mod.group_backend("cuda", count + 1) == "gloo"
    else:
        with pytest.raises(RuntimeError, match="needs a CUDA card"):
            mesh_mod.make_assessment_mesh(1, device="cuda")
    assert mesh_mod.group_backend("cpu", 4) == "gloo"
    assert not torch.distributed.is_initialized()


# --- chunked and pipelined over 4 ranks, against the JAX mesh report ---------

CHUNKED_N = 8003


@pytest.mark.slow
def test_mesh_chunked_pipelined_matches_single_and_jax_mesh_report():
    """``.shard(mesh).chunked(6).pipelined(2)`` over 4 ranks equals single
    shot exactly, with ``exec_stats.devices == 4``, and its DQV report
    equals the JAX package's under a 4-device mesh (``execStats.devices``
    included) except for timestamps."""
    outs = run_ranks(4, f"""
        from repro_torch.core import report
        tt = synth_encoded({CHUNKED_N}, seed=7)
        res = (qa.pipeline().metrics("all").backend("fused_scan")
               .device("cpu").shard(mesh).chunked(6).pipelined(2).run(tt))
        emit({{"res": pack(res), "dqv": report.to_dqv(res)}})
    """)
    jdqv = run_subprocess_devices(4, f"""
import json, jax
from repro import qa
from repro.core import ALL_METRICS, report
from repro.rdf import synth_encoded
tt = synth_encoded({CHUNKED_N}, seed=7)
mesh = jax.make_mesh((4,), ('data',))
res = (qa.pipeline().metrics(ALL_METRICS).backend('fused_scan')
       .shard(mesh).chunked(6).pipelined(2).run(tt))
print(json.dumps(report.to_dqv(res)))
""")
    tt = synth_encoded(CHUNKED_N, seed=7)
    single = qa.pipeline().metrics("all").device("cpu").run(tt)
    got = outs[0]["res"]
    assert got["stats"] == {"devices": 4, "mode": "pipelined",
                            "chunks_total": 6, "resumed_from": None}
    single_packed = dict(got, passes=single.passes)
    assert_same(single_packed, single)
    assert got["passes"] == 6 * single.passes
    assert all(o["res"] == got for o in outs[1:])
    dqv, want = outs[0]["dqv"], jdqv
    assert dqv["execStats"]["devices"] == 4
    assert dqv["execStats"] == want["execStats"]
    assert {k: v for k, v in dqv.items() if k != "measurements"} == \
        {k: v for k, v in want.items() if k != "measurements"}
    ts = "http://www.w3.org/ns/prov#generatedAtTime"
    val = "http://www.w3.org/ns/dqv#value"
    assert len(dqv["measurements"]) == len(want["measurements"])
    for g, w in zip(dqv["measurements"], want["measurements"]):
        g, w = dict(g), dict(w)
        del g[ts], w[ts]
        name = g["http://www.w3.org/ns/dqv#isMeasurementOf"]["@id"]
        if name.rsplit(":", 1)[-1] in SKETCH_VALUES:
            assert g.pop(val) == pytest.approx(w.pop(val), rel=1e-6)
        assert g == w


# --- whole segments over ranks --------------------------------------------------

SEGMENT_ROWS = ((1000, 0), (3000, 1), (500, 2), (2000, 3), (700, 4))


@pytest.mark.slow
def test_eval_segment_batch_matches_per_tensor_and_jax():
    """``eval_segment_batch`` of 5 tensors over 4 ranks (rank 0 scans two,
    the others one) and of 2 (two ranks idle, with zero counters and
    registers) returns each tensor's ``eval_chunk`` state, unreduced and
    in input order, on every rank; it equals the JAX package's
    single-device ``eval_chunk`` (its mesh version fails its own test)."""
    outs = run_ranks(4, f"""
        from repro_torch.core.evaluator import QualityEvaluator
        ev = QualityEvaluator(backend="fused_scan", device="cpu", mesh=mesh)
        local = QualityEvaluator(backend="fused_scan", device="cpu")
        tensors = [synth_encoded(n, seed=s) for n, s in {SEGMENT_ROWS!r}]
        def as_lists(pairs):
            return [[[c.tolist() for c in counts],
                     {{k: v.tolist() for k, v in regs.items()}}]
                    for counts, regs in pairs]
        emit({{"five": as_lists(ev.eval_segment_batch(tensors)),
               "two": as_lists(ev.eval_segment_batch(tensors[:2])),
               "none": ev.eval_segment_batch([]),
               "local": as_lists(local.eval_chunk(t) for t in tensors)}})
    """)
    out = outs[0]
    assert all(o == out for o in outs[1:])
    assert out["none"] == []
    assert out["five"] == out["local"]
    assert out["two"] == out["local"][:2]
    jev = JEvaluator(ALL_METRICS, backend="jnp")
    for (n, s), (counts, regs) in zip(SEGMENT_ROWS, out["five"]):
        jcounts, jregs = jev.eval_chunk(jax_tensor(synth_encoded(n, seed=s)))
        assert counts == [np.asarray(c, np.int64).tolist() for c in jcounts]
        assert set(regs) == set(jregs)
        for k in jregs:
            assert regs[k] == np.asarray(jregs[k]).tolist(), k


# --- checkpoints cross between a mesh and one device --------------------------

RESUME_N = 6001
RESUME_KW = "n_chunks=8, checkpoint_every=2"


@pytest.mark.slow
@pytest.mark.parametrize("direction", ["mesh-to-single", "single-to-mesh"])
def test_mesh_checkpoint_resumes_on_one_device_and_back(tmp_path, direction):
    """A chunked run that crashes under a 2-rank mesh (rank 0 wrote its
    checkpoints) resumes on one device, and the reverse; either resumed
    run equals single shot exactly."""
    ckpt = os.fspath(tmp_path / "ckpt")
    tt = synth_encoded(RESUME_N, seed=5)
    ev = QualityEvaluator(device="cpu")
    kw = dict(n_chunks=8, checkpoint_every=2, checkpoint_dir=ckpt)
    single = ev.assess(tt)
    crash = f"""
        from repro_torch.core.evaluator import QualityEvaluator
        from repro_torch.dist import ChunkScheduler, FaultInjector
        from repro_torch.dist import WorkerFailure
        tt = synth_encoded({RESUME_N}, seed=5)
        ev = QualityEvaluator(device="cpu", mesh=mesh)
        kw = dict({RESUME_KW}, checkpoint_dir={ckpt!r})
    """
    if direction == "mesh-to-single":
        outs = run_ranks(2, crash + """
        try:
            ChunkScheduler(ev, **kw).run(
                tt, faults=FaultInjector(crash_after_merges=5))
            emit({"crashed": False})
        except WorkerFailure:
            emit({"crashed": True})
        """)
        assert [o["crashed"] for o in outs] == [True, True]
        res, stats = ChunkScheduler(ev, **kw).run(tt)
        assert stats.resumed_from == 4 and stats.devices == 1
        assert_same(dict(
            counts=res.counts, values=res.values, n_triples=res.n_triples,
            sketch_estimates=res.sketch_estimates, passes=single.passes,
            registers={k: v.tolist() for k, v in res.registers.items()}),
            single)
    else:
        with pytest.raises(WorkerFailure):
            ChunkScheduler(ev, **kw).run(
                tt, faults=FaultInjector(crash_after_merges=5))
        outs = run_ranks(2, crash + """
        res, stats = ChunkScheduler(ev, **kw).run(tt)
        res.exec_stats = stats
        emit(pack(res))
        """)
        for got in outs:
            assert got["stats"]["resumed_from"] == 4
            assert got["stats"]["devices"] == 2
            assert_same(dict(got, passes=single.passes), single)


# --- the mesh key, the mesh's surface and its errors --------------------------

@functools.lru_cache(maxsize=None)
def surface_run() -> list:
    return run_ranks(2, """
        import torch
        from torch.distributed.device_mesh import DeviceMesh
        from repro_torch.core.evaluator import QualityEvaluator
        from repro_torch.launch.mesh import data_axes
        from repro_torch.qa.pipeline import _evaluator_for, mesh_structural_key
        out = {}
        tt = synth_encoded(3001, seed=2)
        _evaluator_for.cache_clear()
        mesh_b = make_assessment_mesh(device="cpu")
        ev_a = qa.pipeline().metrics("paper").device("cpu").shard(mesh).evaluator()
        ev_b = qa.pipeline().metrics("paper").device("cpu").shard(mesh_b).evaluator()
        out["same_key"] = mesh_structural_key(mesh) == mesh_structural_key(mesh_b)
        out["key"] = list(mesh_structural_key(mesh))
        out["hit"] = ev_a is ev_b
        info = _evaluator_for.cache_info()
        out["misses"], out["hits"] = info.misses, info.hits
        mesh_c = DeviceMesh("cpu", [0, 1], mesh_dim_names=("rows",))
        ev_c = qa.pipeline().metrics("paper").device("cpu").shard(mesh_c).evaluator()
        out["other_engine"] = ev_c is not ev_a
        res = ev_a.assess(tt)
        ref = qa.pipeline().metrics("paper").device("cpu").run(tt)
        out["agrees"] = res.values == ref.values and res.counts == ref.counts
        out["backend"] = torch.distributed.get_backend(mesh.get_group())
        out["size_all"] = make_assessment_mesh(0, device="cpu").size()
        out["axes"] = list(data_axes(mesh))
        out["repr"] = repr(qa.pipeline().device("cpu").shard(mesh))
        try:
            make_assessment_mesh(3, device="cpu")
        except ValueError as e:
            out["range_error"] = str(e)
        try:
            (qa.pipeline().device("cpu").shard(mesh).chunked(4)
             .speculative().run(tt))
        except ValueError as e:
            out["speculate_error"] = str(e)
        sub = make_assessment_mesh(1, device="cpu")
        if torch.distributed.get_rank() == 0:
            out["sub"] = qa.pipeline().device("cpu").shard(sub).run(
                tt).counts == qa.pipeline().device("cpu").run(tt).counts
        else:
            try:
                QualityEvaluator(device="cpu", mesh=sub)
            except ValueError as e:
                out["outside_error"] = str(e)
        emit(out)
    """)


@pytest.mark.slow
def test_mesh_cache_key_is_structural():
    """A rebuilt, structurally equal mesh hits the engine cache; another
    dim name is another engine; the sharded engine agrees with the local
    one (the port of ``tests/test_qa.py``'s mesh cache test)."""
    for out in surface_run():
        assert out["same_key"] and out["hit"]
        assert out["key"] == ["cpu", [2], ["data"], [0, 1]]
        assert out["misses"] == 1 and out["hits"] >= 1
        assert out["other_engine"]
        assert out["agrees"]


@pytest.mark.slow
def test_mesh_surface_and_errors():
    """The group is ``gloo`` on the CPU; ``devices=0`` is every rank; an
    out-of-range count raises the JAX package's ``ValueError``;
    speculation under a mesh raises instead of hanging; a mesh of a subset
    of the ranks runs on its members and refuses the others."""
    outs = surface_run()
    for out in outs:
        assert out["backend"] == "gloo"
        assert out["size_all"] == 2
        assert out["axes"] == ["data"]
        assert "mesh=('data',)x2" in out["repr"]
        assert out["range_error"] == "devices must be in [1, 2], got 3"
        assert "speculate=True cannot run under a mesh" in \
            out["speculate_error"]
    assert outs[0]["sub"] is True
    assert "rank 1 is not in the mesh" in outs[1]["outside_error"]


# --- the launcher: failing and hung ranks end the run ------------------------

@pytest.mark.slow
def test_launcher_fails_the_run_with_the_failing_ranks_error():
    """A rank that raises before a collective ends the run at once with
    its traceback; the ranks left waiting are killed."""
    code = PRELUDE + textwrap.dedent("""
        import torch.distributed as dist
        if dist.get_rank() == 1:
            raise RuntimeError("rank one gives up")
        dist.barrier()
    """)
    t = time.monotonic()
    with pytest.raises(mesh_mod.RankFailure) as e:
        mesh_mod.launch_ranks(3, ["-c", code], timeout=DEADLINE)
    assert time.monotonic() - t < DEADLINE / 2
    msg = str(e.value)
    assert msg.startswith("rank 1 of 3 exited with code 1")
    assert "rank one gives up" in msg


@pytest.mark.slow
def test_launcher_deadline_ends_a_hung_run():
    """A rank that never reaches the collective: the deadline ends the
    run, naming the ranks still running."""
    code = PRELUDE + textwrap.dedent("""
        import time
        import torch.distributed as dist
        if dist.get_rank() == 0:
            time.sleep(600)
        dist.barrier()
    """)
    t = time.monotonic()
    with pytest.raises(mesh_mod.RankFailure, match="did not finish within"):
        mesh_mod.launch_ranks(2, ["-c", code], timeout=5)
    assert time.monotonic() - t < 30
    with pytest.raises(ValueError, match="at least one rank"):
        mesh_mod.launch_ranks(0, ["-c", "pass"])


# --- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


GPU_N = 1_000_003


@pytest.mark.gpu
def test_gpu_single_rank_nccl_mesh_matches_plain(cuda):
    """A one-rank ``nccl`` mesh on the card, in a process of its own:
    ``all`` (fused_scan) and ``paper`` (qap_count) bit-identical to the
    plain backend on the card, one launch each."""
    out = mesh_mod.launch_ranks(1, ["-c", textwrap.dedent(f"""
        import json, numpy as np, torch
        from repro_torch import kernels as K, qa
        from repro_torch.launch.mesh import close_ranks, make_assessment_mesh
        from repro_torch.rdf import synth_encoded
        mesh = make_assessment_mesh(device="cuda")
        tt = synth_encoded({GPU_N}, seed=3)
        out = {{"backend": torch.distributed.get_backend(mesh.get_group())}}
        for metrics, kernel in (("all", "fused_scan"), ("paper", "qap_count")):
            K.reset_launches()
            res = qa.pipeline().metrics(metrics).shard(mesh).run(tt)
            launches = dict(K.LAUNCHES)
            plain = qa.assess(tt, metrics=metrics, backend="torch")
            out[metrics] = (launches[kernel] == 1 and res.counts == plain.counts
                            and res.values == plain.values and all(
                                np.array_equal(res.registers[k], plain.registers[k])
                                for k in plain.registers))
        print(json.dumps(out))
        close_ranks()
    """)], timeout=300)[0]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"backend": "nccl", "all": True, "paper": True}


@pytest.mark.gpu
def test_gpu_two_gloo_ranks_share_the_card(cuda):
    """Two ranks on one card form a ``gloo`` group; each launches the
    kernels over its shard (single shot, then chunked and pipelined), and
    the reduced result is bit-identical to the plain backend."""
    outs = mesh_mod.launch_ranks(2, ["-c", textwrap.dedent(f"""
        import json, numpy as np, torch
        from repro_torch import kernels as K, qa
        from repro_torch.launch.mesh import close_ranks, make_assessment_mesh
        from repro_torch.rdf import synth_encoded
        ndev = torch.cuda.device_count()
        mesh = make_assessment_mesh(device="cuda")
        tt = synth_encoded({GPU_N}, seed=3)
        plain = qa.assess(tt, metrics="all", backend="torch")
        out = {{"backend": torch.distributed.get_backend(mesh.get_group()),
                "ndev": ndev}}
        for label, pipe in (("single", qa.pipeline().shard(mesh)),
                            ("pipelined", qa.pipeline().shard(mesh)
                             .chunked(4).pipelined(2))):
            K.reset_launches()
            res = pipe.run(tt)
            out[label] = [dict(K.LAUNCHES)["fused_scan"],
                          res.counts == plain.counts
                          and res.values == plain.values and all(
                              np.array_equal(res.registers[k],
                                             plain.registers[k])
                              for k in plain.registers)]
        print(json.dumps(out))
        close_ranks()
    """)], timeout=300)
    for r in outs:
        got = json.loads(r.stdout.strip().splitlines()[-1])
        assert got["backend"] == ("nccl" if got["ndev"] >= 2 else "gloo")
        assert got["single"] == [1, True]
        assert got["pipelined"] == [4, True]


@pytest.mark.gpu
@pytest.mark.parametrize("start", [1, 2, 3, 5, 4099])
def test_gpu_unaligned_shard_start_is_exact(cuda, start):
    """A shard whose first row is not a multiple of 4 rows (a base not
    16-byte aligned on the card) is still exact through every kernel."""
    from repro_torch.core.metrics import get_metrics
    from repro_torch.core.planner import plan
    from repro_torch.kernels.fused_scan import ops as fops, ref as fref
    from repro_torch.kernels.hll import ops as hops, ref as href
    from repro_torch.kernels.qap_count import ops as qops, ref as qref
    tt = synth_encoded(300_007, seed=9)
    full = torch.from_numpy(tt.planes).to(cuda)
    shard = full[start:start + 200_001]
    assert shard.data_ptr() % 16 != 0
    host = shard.cpu()
    pln = plan(get_metrics(ALL_METRICS))
    counts, regs = fops.fused_scan(shard, pln.program, pln.n_counters,
                                   pln.sketch_specs, 12)
    want_c, want_r = fref.fused_scan_torch(host, pln.program, pln.n_counters,
                                           pln.sketch_specs, 12)
    assert torch.equal(counts.cpu(), want_c)
    for k in want_r:
        assert torch.equal(regs[k].cpu(), want_r[k])
    assert torch.equal(
        qops.fused_count(shard, pln.program, pln.n_counters).cpu(),
        qref.counts_ref(host, pln.program, pln.n_counters))
    for _, cols in pln.sketch_specs:
        assert torch.equal(hops.hll_fold(shard, cols, 12).cpu(),
                           href.hll_fold_torch(host, cols, 12))
