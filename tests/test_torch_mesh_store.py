"""The incremental segment store and the CLI of ``repro_torch`` under a
mesh of ranks, against the port on one device and the JAX package.

Ranks are real processes on one ``gloo`` group over the CPU
(``repro_torch.launch.mesh.launch_ranks``, each case with a deadline of
its own); the port runs with ``device="cpu"`` (the kernels' plain torch
versions). Under a mesh, rescanned segments go one a rank through
``eval_segment_batch`` and rank 0 alone writes the store. The JAX
package's own mesh store test fails (ROADMAP §C), so mesh runs are held to
the single-device runner of each package: counters, register banks,
``n_triples``, passes and the rescanned segments, bytes and footprints
exact (``sketch_estimates``, ``CN2_EXACT`` and ``SCH1`` to ``rel=1e-6``
across the packages: the float32 HLL estimator sums in another order), and
a store written under a mesh is reused by either package with no segment
rescanned.
"""
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro import qa as jqa
from repro.launch import assess as j_assess
from repro.rdf import synth_encoded as j_synth_encoded

from repro_torch import qa
from repro_torch.core.metrics import ALL_METRICS, SKETCH_METRICS
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.assess import main
from repro_torch.rdf import bsbm_ntriples

BASE = ("http://bsbm.example.org/",)
SEG = 16384
SKETCH_VALUES = set(SKETCH_METRICS)
STATS = ("chunks_total", "segments_reused", "segments_rescanned",
         "bytes_total", "bytes_rescanned", "footprints_replayed")
DEADLINE = 120.0
HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")


def corpus() -> bytes:
    return bsbm_ntriples(300, seed=11).encode()


def mutate(data: bytes) -> bytes:
    """One line in the middle replaced (about 1% of the bytes changes
    segment), as the JAX package's mesh store test edits it."""
    mid = data.find(b"\n", len(data) // 2) + 1
    end = data.find(b"\n", mid) + 1
    return data[:mid] + b"<http://x/s> <http://x/p> <http://x/o> .\n" + \
        data[end:]


def tpipe(store=None):
    p = qa.pipeline().metrics(ALL_METRICS).base(*BASE).device("cpu")
    return p if store is None else p.incremental(os.fspath(store),
                                                 segment_bytes=SEG)


def jpipe(store):
    return jqa.pipeline().metrics(ALL_METRICS).base(*BASE).incremental(
        os.fspath(store), segment_bytes=SEG)


def packed(res) -> dict:
    """An incremental result as the ranks report it."""
    return {"counts": res.counts, "values": res.values,
            "sketch_estimates": res.sketch_estimates,
            "n_triples": res.n_triples, "passes": res.passes,
            "registers": {k: np.asarray(v).tolist()
                          for k, v in res.registers.items()},
            "stats": {k: getattr(res.exec_stats, k) for k in STATS},
            "mode": res.exec_stats.mode,
            "devices": res.exec_stats.devices}


RANK_CODE = textwrap.dedent("""
    import json, sys, warnings
    import numpy as np
    from repro_torch import qa
    from repro_torch.core.metrics import ALL_METRICS
    from repro_torch.launch.mesh import close_ranks, make_assessment_mesh
    from repro_torch.rdf import bsbm_ntriples

    STATS = {stats!r}
    root, single_copy = sys.argv[1], sys.argv[2]
    mesh = make_assessment_mesh(device="cpu")

    def pipe(store):
        return (qa.pipeline().metrics(ALL_METRICS).base(*{base!r})
                .device("cpu").shard(mesh)
                .incremental(store, segment_bytes={seg}))

    def pack(res):
        return {{"counts": res.counts, "values": res.values,
                "sketch_estimates": res.sketch_estimates,
                "n_triples": res.n_triples, "passes": res.passes,
                "registers": {{k: v.tolist()
                              for k, v in res.registers.items()}},
                "stats": {{k: getattr(res.exec_stats, k) for k in STATS}},
                "mode": res.exec_stats.mode,
                "devices": res.exec_stats.devices}}

    data = bsbm_ntriples(300, seed=11).encode()
    mid = data.find(b"\\n", len(data) // 2) + 1
    end = data.find(b"\\n", mid) + 1
    mutated = (data[:mid] + b"<http://x/s> <http://x/p> <http://x/o> .\\n"
               + data[end:])
    store = root + "/mesh"
    out = {{"cold": pack(pipe(store).run(data.decode())),
           "mutated": pack(pipe(store).run(mutated.decode()))}}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out["warm"] = pack(pipe(store).pipelined(1).speculative().run(
            mutated.decode()))
    out["warned"] = [f"{{w.category.__name__}}: {{w.message}}"
                     for w in caught]
    out["single_reused"] = pack(pipe(single_copy).run(mutated.decode()))
    print(json.dumps(out))
    close_ranks()
""").format(stats=STATS, base=BASE, seg=SEG)


@pytest.fixture(scope="module", params=[2, 3], ids=["w2", "w3"])
def mesh_store(request, tmp_path_factory):
    """A cold, a mutated and a warm run over one store under a W-rank
    mesh, and a mesh run over a copy of a store written on one device;
    beside them the same runs of the port on one device and of the JAX
    runner."""
    w = request.param
    root = tmp_path_factory.mktemp(f"mesh_store_w{w}")
    data = corpus()
    mutated = mutate(data)
    single = {"cold": tpipe(root / "single").run(data.decode()),
              "mutated": tpipe(root / "single").run(mutated.decode())}
    jax = {"cold": jpipe(root / "jax").run(data.decode()),
           "mutated": jpipe(root / "jax").run(mutated.decode())}
    shutil.copytree(root / "single", root / "single_copy")
    ranks = mesh_mod.launch_ranks(
        w, ["-c", RANK_CODE, os.fspath(root),
            os.fspath(root / "single_copy")], timeout=DEADLINE)
    outs = [json.loads(r.stdout.strip().splitlines()[-1]) for r in ranks]
    return {"w": w, "root": root, "outs": outs, "single": single,
            "jax": jax, "mutated": mutated}


def assert_same(got: dict, res) -> None:
    want = packed(res)
    for k in ("counts", "values", "sketch_estimates", "n_triples", "passes",
              "registers", "stats"):
        assert got[k] == want[k], k


@pytest.mark.slow
def test_mesh_store_matches_one_device_and_jax(mesh_store):
    """Cold, then after a one-line mutation: every rank's result equals
    the port's single-device runner exactly and the JAX runner's, with the
    same rescanned segments, bytes and footprints; the mode is
    ``incremental+mesh`` over W shards."""
    w = mesh_store["w"]
    for out in mesh_store["outs"]:
        for step in ("cold", "mutated"):
            got = out[step]
            assert got["mode"] == "incremental+mesh" and got["devices"] == w
            assert_same(got, mesh_store["single"][step])
            jres = mesh_store["jax"][step]
            assert got["n_triples"] == jres.n_triples
            assert got["counts"] == jres.counts
            for k, v in jres.registers.items():
                assert got["registers"][k] == np.asarray(v).tolist(), k
            for k, v in jres.values.items():
                if k in SKETCH_VALUES:
                    assert got["values"][k] == pytest.approx(v, rel=1e-6)
                else:
                    assert got["values"][k] == v, k
            assert got["stats"] == {k: getattr(jres.exec_stats, k)
                                    for k in STATS}
        assert out["cold"]["stats"]["segments_reused"] == 0
        assert out["cold"]["stats"]["segments_rescanned"] > 2 * w
        assert 1 <= out["mutated"]["stats"]["segments_rescanned"] <= 2
    assert all(o == mesh_store["outs"][0] for o in mesh_store["outs"][1:])


@pytest.mark.slow
def test_mesh_store_holds_what_one_device_writes(mesh_store):
    """Rank 0 wrote the store: the same segment states, byte for byte, as
    the single-device runner froze, the same manifest segments and one
    history snapshot a run."""
    root = mesh_store["root"]
    seg = lambda d: sorted(os.listdir(root / d / "segments"))
    assert seg("mesh") == seg("single")
    for name in seg("single"):
        assert (root / "mesh" / "segments" / name).read_bytes() == \
            (root / "single" / "segments" / name).read_bytes()
    man = lambda d: json.loads((root / d / "manifest.json").read_text())
    assert man("mesh")["payload"]["segments"] == \
        man("single")["payload"]["segments"]
    hist = (root / "mesh" / "history.jsonl").read_text().splitlines()
    assert len(hist) == 3
    assert not [f for f in os.listdir(root / "mesh" / "segments")
                if f.endswith(".tmp")]


@pytest.mark.slow
def test_mesh_store_reused_by_either_package(mesh_store, tmp_path):
    """A store written under a mesh is reused with no segment rescanned by
    the JAX runner and by the port on one device; a store written on one
    device is reused under the mesh."""
    text = mesh_store["mutated"].decode()
    for label, run in (("jax", jpipe), ("port", tpipe)):
        store = tmp_path / label
        shutil.copytree(mesh_store["root"] / "mesh", store)
        res = run(store).run(text)
        assert res.exec_stats.segments_rescanned == 0, label
        assert res.passes == 0
        assert res.counts == mesh_store["single"]["mutated"].counts
    for out in mesh_store["outs"]:
        got = out["single_reused"]
        assert got["stats"]["segments_rescanned"] == 0
        assert got["passes"] == 0
        assert got["counts"] == mesh_store["single"]["mutated"].counts


@pytest.mark.slow
def test_mesh_store_warns_that_prefetch_and_speculate_do_not_apply(
        mesh_store):
    """Under a mesh the batched segment executor replaces the chunk
    scheduler: ``prefetch``/``speculate`` raise a ``RuntimeWarning`` and
    are ignored; the warm run rescans nothing."""
    for out in mesh_store["outs"]:
        assert any(w.startswith("RuntimeWarning: prefetch/speculate are "
                                "ignored for mesh rescans")
                   for w in out["warned"])
        assert out["warm"]["stats"]["segments_rescanned"] == 0
        assert out["warm"]["mode"] == "incremental+mesh"


# --- the CLI's --mesh ------------------------------------------------------------

def run_cli(argv):
    """The port's CLI in-process; its (stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        main(argv)
    return out.getvalue(), err.getvalue()


def run_cli_process(argv, timeout=DEADLINE):
    env = {**os.environ, "PYTHONPATH": SRC}
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.assess", *argv],
        env=env, capture_output=True, text=True, timeout=timeout)


@pytest.mark.slow
@pytest.mark.parametrize("w", [1, 3])
def test_cli_mesh_prints_the_values_of_one_device(w):
    """``--mesh W --device cpu`` starts W ranks; rank 0 alone prints, and
    it prints what the run without ``--mesh`` prints; the values are the
    JAX package's to the six printed decimals (and ``rel=1e-6`` for the
    HLL estimator's)."""
    argv = ["--synthetic", "3001", "--device", "cpu"]
    proc = run_cli_process(argv + ["--mesh", str(w)])
    assert proc.returncode == 0, proc.stderr
    want, _ = run_cli(argv)
    assert proc.stdout == want
    assert f"mesh=('data',)x{w}" in proc.stderr
    assert proc.stderr.count("# qa.Pipeline") == 1
    jres = jqa.assess(j_synth_encoded(3001, seed=0), metrics="all")
    for line in proc.stdout.splitlines():     # six decimals printed
        name, value = line.split()
        rel = 1e-6 if name in SKETCH_VALUES else 0
        assert float(value) == pytest.approx(jres.values[name], rel=rel,
                                             abs=1e-6), name


@pytest.mark.slow
def test_cli_mesh_chunked_dqv_and_store(tmp_path):
    """``--chunks 4 --dqv --mesh 2``: the report of the run without the
    mesh plus ``execStats.devices == 2``; ``--store --mesh 2`` writes a
    store that the JAX CLI and the port's single-device CLI then reuse
    with 0 segments rescanned."""
    argv = ["--synthetic", "3001", "--device", "cpu", "--chunks", "4",
            "--dqv"]
    proc = run_cli_process(argv + ["--mesh", "2"])
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout)
    want = json.loads(run_cli(argv)[0])
    assert got["execStats"].pop("devices") == 2
    ts = "http://www.w3.org/ns/prov#generatedAtTime"
    for rep in (got, want):
        for m in rep["measurements"]:
            del m[ts]
    assert got == want

    nt = tmp_path / "d.nt"
    nt.write_bytes(corpus())
    store = tmp_path / "st"
    store_argv = ["--nt", os.fspath(nt), "--store", os.fspath(store),
                  "--segment-bytes", str(SEG), "--base", BASE[0]]
    proc = run_cli_process(store_argv + ["--device", "cpu", "--mesh", "2"])
    assert proc.returncode == 0, proc.stderr
    assert "mode=incremental+mesh" in proc.stderr
    assert "0 reused" in proc.stderr
    out, err = run_cli(store_argv + ["--device", "cpu"])
    assert out == proc.stdout
    assert " 0 rescanned" in err
    _, jerr = run_cli_jax(store_argv)
    assert " 0 rescanned" in jerr


def run_cli_jax(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        j_assess.main(argv)
    return out.getvalue(), err.getvalue()


@pytest.mark.parametrize("argv, message", [
    (["--mesh", "100000"], "--mesh: devices must be in [1, "),
    (["--mesh", "-1"], "--mesh: devices must be in [1, "),
    (["--mesh", "2", "--watch", "--store", "s"], "--mesh applies to one-shot"),
    (["--mesh", "2", "--serve", "0", "--store-root", "r"],
     "--mesh applies to one-shot"),
    (["--mesh", "2"], "need --nt or --synthetic"),
], ids=["above", "negative", "watch", "serve", "no-input"])
def test_cli_mesh_argument_errors(argv, message, capsys):
    """Out-of-range rank counts and flags a mesh does not take are
    refused before any rank starts."""
    with pytest.raises(SystemExit) as e:
        main(argv + ["--device", "cpu"])
    assert e.value.code == 2
    assert message in capsys.readouterr().err


@pytest.mark.slow
def test_cli_mesh_failing_rank_fails_the_run(tmp_path):
    """A rank that fails fails the run: a nonzero exit with the rank's
    error, and nothing printed as a result."""
    proc = run_cli_process(["--nt", os.fspath(tmp_path / "missing.nt"),
                            "--device", "cpu", "--mesh", "2"])
    assert proc.returncode == 1
    assert proc.stdout == ""
    assert "# mesh run failed: rank" in proc.stderr
    assert "FileNotFoundError" in proc.stderr
