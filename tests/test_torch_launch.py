"""``python -m repro_torch.launch.assess`` (the port's CLI) against
``python -m repro.launch.assess``: the ``--watch`` loop (change detection
by one ``stat``, the ``max_assessments`` bound, deltas, a file missing
mid-poll, a same-size atomic replace), incremental runs through
``--store``, ``--compact``, ``--dqv`` and the argument errors.

The port runs with ``--device cpu`` (its kernel wrappers then run their
plain torch versions), the JAX package its default ``jnp`` backend.
Tolerances: the printed values of counter-derived metrics are equal as
text; ``CN2_EXACT`` and ``SCH1`` come from the float32 HLL estimator,
whose sum XLA and torch add in different orders (``rel=1e-6`` on the
value), so their six printed decimals may differ by one in the last
place: ``abs=2e-6``.
"""
import contextlib
import io
import json
import os
import subprocess
import sys
import threading
import time

import pytest
import torch

from repro.launch import assess as j_assess

from repro_torch import kernels as K
from repro_torch import qa
from repro_torch.core.metrics import ALL_METRICS, SKETCH_METRICS
from repro_torch.launch.assess import file_signature, main, watch
from repro_torch.rdf import bsbm_ntriples

BASE = ("http://bsbm.example.org/",)
SEG = 8192


def make_pipe(tmp_path):
    return (qa.pipeline().metrics("paper").base(*BASE).device("cpu")
            .incremental(os.fspath(tmp_path / "store"), segment_bytes=SEG))


def wait_for(cond, timeout=30.0, interval=0.02):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return False


def run_watch(pipe, path, out, max_assessments, interval=0.05,
              timeout=60.0):
    """Run watch() on a daemon thread with a deadline so a regression in
    change detection fails the test instead of hanging the suite."""
    result = {}

    def target():
        result["runs"] = watch(pipe, os.fspath(path), interval=interval,
                               max_assessments=max_assessments, out=out)

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), (
        f"watch() did not terminate within {timeout}s "
        f"(max_assessments={max_assessments}); output so far:\n"
        + out.getvalue())
    return result["runs"]


def run_cli(fn, argv):
    """Run a CLI ``main`` in-process; its (stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        fn(argv)
    return out.getvalue(), err.getvalue()


def printed_values(stdout: str) -> dict:
    values = {}
    for line in stdout.splitlines():
        name, value = line.split()
        values[name] = value
    return values


# -- the signature helper ------------------------------------------------------

def test_file_signature_one_stat_fields(tmp_path):
    p = tmp_path / "d.nt"
    p.write_text("x\n")
    st = os.stat(p)
    assert file_signature(p) == (st.st_mtime_ns, st.st_size, st.st_ino)
    assert file_signature(p) == j_assess.file_signature(p)
    with pytest.raises(OSError):
        file_signature(tmp_path / "missing.nt")


def test_file_signature_catches_same_size_atomic_replace(tmp_path):
    """A same-length atomic replace with a forced identical mtime still
    changes the signature, because tmp + ``os.replace`` swaps the inode."""
    p = tmp_path / "d.nt"
    a = '<http://e/s1> <http://e/p> "x" .\n'
    b = '<http://e/s2> <http://e/p> "x" .\n'
    p.write_text(a)
    sig_a = file_signature(p)
    st = os.stat(p)
    tmp = tmp_path / "d.nt.tmp"
    tmp.write_text(b)
    os.utime(tmp, ns=(st.st_atime_ns, st.st_mtime_ns))
    os.replace(tmp, p)
    assert file_signature(p) != sig_a
    assert (os.path.getmtime(p), os.path.getsize(p)) == (st.st_mtime,
                                                         st.st_size)


# -- the loop ------------------------------------------------------------------

def test_watch_reassesses_on_edit_and_prints_deltas(tmp_path):
    nt = tmp_path / "d.nt"
    nt.write_text(bsbm_ntriples(40, seed=0))
    hist = tmp_path / "store" / "history.jsonl"
    out = io.StringIO()

    def editor():
        assert wait_for(lambda: hist.exists()
                        and len(hist.read_text().splitlines()) >= 1)
        with open(nt, "a") as f:
            f.write(bsbm_ntriples(8, seed=9))

    t = threading.Thread(target=editor, daemon=True)
    t.start()
    runs = run_watch(make_pipe(tmp_path), nt, out, max_assessments=2)
    t.join(10)
    assert runs == 2
    text = out.getvalue()
    assert text.count("change detected") == 2
    assert "# deltas:" in text
    assert "# segments:" in text and "rescanned" in text
    assert len(hist.read_text().splitlines()) == 2


def test_watch_max_assessments_bounds_the_loop(tmp_path):
    nt = tmp_path / "d.nt"
    nt.write_text(bsbm_ntriples(20, seed=1))
    out = io.StringIO()
    runs = run_watch(make_pipe(tmp_path), nt, out, max_assessments=1)
    assert runs == 1
    assert out.getvalue().count("change detected") == 1


def test_watch_tolerates_file_missing_mid_poll(tmp_path):
    nt = tmp_path / "appears-later.nt"
    out = io.StringIO()

    def creator():
        time.sleep(0.3)                  # a few polls see OSError first
        nt.write_text(bsbm_ntriples(20, seed=2))

    t = threading.Thread(target=creator, daemon=True)
    t.start()
    runs = run_watch(make_pipe(tmp_path), nt, out, max_assessments=1)
    t.join(10)
    assert runs == 1
    assert "change detected" in out.getvalue()


def test_watch_detects_same_size_replace_end_to_end(tmp_path):
    nt = tmp_path / "d.nt"
    a = '<http://e/s1> <http://e/p> "x" .\n'
    b = '<http://e/s2> <http://e/p> "x" .\n'
    nt.write_text(a)
    hist = tmp_path / "store" / "history.jsonl"
    out = io.StringIO()

    def replacer():
        assert wait_for(lambda: hist.exists()
                        and len(hist.read_text().splitlines()) >= 1)
        st = os.stat(nt)
        tmp = tmp_path / "repl.tmp"
        tmp.write_text(b)
        os.utime(tmp, ns=(st.st_atime_ns, st.st_mtime_ns))
        os.replace(tmp, nt)

    t = threading.Thread(target=replacer, daemon=True)
    t.start()
    runs = run_watch(make_pipe(tmp_path), nt, out, max_assessments=2)
    t.join(10)
    assert runs == 2


# -- main ----------------------------------------------------------------------

@pytest.fixture
def nt_file(tmp_path):
    path = tmp_path / "d.nt"
    path.write_text(bsbm_ntriples(150, seed=4))
    return path


def _store_argv(nt_file, store, *extra):
    return ["--nt", os.fspath(nt_file), "--store", os.fspath(store),
            "--base", BASE[0], "--segment-bytes", str(SEG), *extra]


def test_store_twice_rescans_nothing_and_prints_the_jax_values(
        tmp_path, nt_file):
    store = tmp_path / "st"
    argv = _store_argv(nt_file, store, "--device", "cpu")
    out1, err1 = run_cli(main, argv)
    assert "0 reused" in err1 and "| fused_scan |" in err1
    out2, err2 = run_cli(main, argv)
    assert "0 rescanned" in err2 and "bytes rescanned 0/" in err2
    assert "0 pass(es)" in err2
    assert out2 == out1
    j_out, _ = run_cli(j_assess.main, ["--nt", os.fspath(nt_file),
                                       "--base", BASE[0]])
    ours, jax = printed_values(out2), printed_values(j_out)
    assert set(ours) == set(jax) == set(ALL_METRICS)
    for name, text in jax.items():
        if name in SKETCH_METRICS:
            assert float(ours[name]) == pytest.approx(float(text), abs=2e-6)
        else:
            assert ours[name] == text, name
    # the JAX CLI reuses the store the port's CLI wrote
    _, j_err = run_cli(j_assess.main, _store_argv(nt_file, store))
    assert "0 rescanned" in j_err


def test_compact_and_max_history(tmp_path, nt_file):
    store = tmp_path / "st"
    for i in range(3):
        with open(nt_file, "a") as f:
            f.write(bsbm_ntriples(2, seed=100 + i))
        run_cli(main, _store_argv(nt_file, store, "--device", "cpu"))
    _, err = run_cli(main, ["--store", os.fspath(store), "--compact",
                            "--max-history", "1"])
    assert "# compacted" in err and "2 history snapshot(s) dropped" in err
    with open(store / "history.jsonl") as f:
        assert len(f.read().splitlines()) == 1
    _, err = run_cli(main, _store_argv(nt_file, store, "--device", "cpu",
                                       "--max-history", "1"))
    assert "0 rescanned" in err


def test_dqv_and_synthetic_chunked_resume(tmp_path, nt_file):
    out, _ = run_cli(main, ["--nt", os.fspath(nt_file), "--base", BASE[0],
                            "--device", "cpu", "--dqv"])
    doc = json.loads(out)
    assert len(doc["measurements"]) == len(ALL_METRICS)
    assert doc["nTriples"] > 0
    ckpt = os.fspath(tmp_path / "ckpt")
    argv = ["--synthetic", "5000", "--metrics", "paper", "--device", "cpu",
            "--backend", "twopass", "--chunks", "4", "--checkpoint-dir",
            ckpt]
    out1, err1 = run_cli(main, argv)
    assert "resumed_from=None" in err1 and "mode=sync" in err1
    out2, err2 = run_cli(main, argv)
    assert "attempts=0 resumed_from=4" in err2
    assert out2 == out1
    j_out, _ = run_cli(j_assess.main, ["--synthetic", "5000", "--metrics",
                                       "paper"])
    assert out1 == j_out          # paper metrics: counter-derived only


@pytest.mark.parametrize("argv,message", [
    (["--nt", "d.nt", "--store", "s", "--synthetic", "10"], "--synthetic"),
    (["--nt", "d.nt", "--store", "s", "--chunks", "2"], "supersedes"),
    (["--nt", "d.nt", "--store", "s", "--stream", "100"], "supersedes"),
    (["--nt", "d.nt", "--store", "s", "--checkpoint-dir", "c"],
     "supersedes"),
    (["--nt", "d.nt", "--watch"], "--watch needs"),
    (["--store", "s", "--watch"], "--watch needs"),
    (["--compact"], "--compact needs --store"),
    ([], "need --nt or --synthetic"),
    (["--backend", "jnp"], "invalid choice"),
    (["--mesh", "2"], "need --nt or --synthetic"),   # checked before ranks
    (["--serve", "8080"], "--serve needs --store-root"),
], ids=["store+synthetic", "store+chunks", "store+stream", "store+ckpt",
        "watch-no-store", "watch-no-nt", "compact-no-store", "no-input",
        "backend", "mesh", "serve"])
def test_argument_errors(tmp_path, argv, message):
    argv = argv + ["--device", "cpu"]
    err = io.StringIO()
    with contextlib.redirect_stderr(err), pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code == 2
    assert message in err.getvalue()
    assert not os.path.exists("s")


def test_watch_flag_runs_bounded_assessments(tmp_path, nt_file, capfd):
    main(_store_argv(nt_file, tmp_path / "st", "--device", "cpu", "--watch",
                     "--watch-max", "1", "--watch-interval", "0.05"))
    out, err = capfd.readouterr()
    assert "# watching" in err and err.count("change detected") == 1
    assert set(printed_values(out)) == set(ALL_METRICS)


def test_default_device_without_a_card_fails(tmp_path, nt_file):
    """``--device cuda`` is the default; without a card the CLI fails, on a
    warm store too, rather than carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("there is a card here")
    store = tmp_path / "st"
    run_cli(main, _store_argv(nt_file, store, "--device", "cpu"))
    K.reset_launches()
    for argv in (_store_argv(nt_file, store),
                 ["--nt", os.fspath(nt_file), "--base", BASE[0]]):
        with pytest.raises((RuntimeError, AssertionError)):
            run_cli(main, argv)
    assert sum(K.LAUNCHES.values()) == 0


def test_module_runs_and_imports_no_jax(tmp_path, nt_file):
    """``python -m repro_torch.launch.assess`` in a process of its own:
    the same values, and neither JAX nor the JAX package is imported (nor
    by the registry of every arch, nor by the dry-run's launcher)."""
    code = ("import sys, runpy\n"
            "sys.argv = ['assess'] + sys.argv[1:]\n"
            "runpy.run_module('repro_torch.launch.assess',"
            " run_name='__main__')\n"
            "import repro_torch.launch.dryrun\n"
            "from repro_torch.configs import REGISTRY\n"
            "assert len(REGISTRY) == 11, sorted(REGISTRY)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'repro' "
            "or m.startswith('repro.'))\n"
            "print('modules', bad, file=sys.stderr)")
    env = {**os.environ, "PYTHONPATH": "src"}
    proc = subprocess.run(
        [sys.executable, "-c", code, "--nt", os.fspath(nt_file), "--base",
         BASE[0], "--store", os.fspath(tmp_path / "st"), "--device", "cpu"],
        env=env, capture_output=True, text=True, check=True)
    assert "modules []" in proc.stderr
    out, _ = run_cli(main, ["--nt", os.fspath(nt_file), "--base", BASE[0],
                            "--device", "cpu"])
    assert proc.stdout == out


def test_quickstart_example_runs_on_the_cpu():
    """``examples/quickstart_torch.py --device cpu``: a single shot, the DQV
    report, and an incremental re-run equal to a cold assessment."""
    env = {**os.environ, "PYTHONPATH": "src"}
    proc = subprocess.run(
        [sys.executable, "examples/quickstart_torch.py", "--device", "cpu"],
        env=env, capture_output=True, text=True, check=True)
    assert "16 metrics from 1 data pass" in proc.stdout
    assert "incremental result identical to a cold assessment" in proc.stdout


def test_assess_restart_example_runs_on_the_cpu():
    """``examples/assess_restart_torch.py --device cpu`` (the analog of
    ``examples/assess_restart.py``): 24 chunks with failed and slow
    chunks, a coordinator crash after 12 merges, and a resume from the
    checkpoint equal to the single-pass result, values and registers."""
    env = {**os.environ, "PYTHONPATH": "src"}
    proc = subprocess.run(
        [sys.executable, "examples/assess_restart_torch.py", "--device",
         "cpu"], env=env, capture_output=True, text=True, check=True)
    assert "crashed as injected: injected coordinator crash" in proc.stdout
    assert "resumed from merge 12; attempts after restart: 12/24" in (
        proc.stdout)
    assert "identical to the single-pass reference on cpu" in proc.stdout
