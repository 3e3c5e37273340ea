"""``repro_torch.serve`` (the assessment service) and its launchers
against the JAX package's ``repro.serve``, ``repro.launch.qa_serve`` and
``repro.launch.assess --serve``.

The contract under test: the job engine, journal, metrics, fault
injector, alerts and registry carry no JAX and are copies of the
originals; a port daemon given the same registrations and uploads as a
JAX daemon returns the same jobs (values, ``n_triples``, exec stats,
fired alerts), history, reports, ranking and Prometheus counters; a port
daemon job and a JAX CLI ``--store`` run share one store; a journal
written by either daemon up to a crash point is replayed by the other
with no accepted job lost; the launchers take the JAX flags and error
rules and shut down cleanly on SIGTERM; the default device, ``cuda``,
fails a job where there is no card instead of assessing on the CPU; and
importing the service, the catalog, the fetch plane and the launchers
imports neither JAX nor the JAX package, nor starts CUDA.

The port runs with ``device="cpu"`` (its kernel wrappers then run their
plain torch versions), the JAX package its default ``jnp`` backend.
Tolerances: counts, segment and byte counts, ``passes`` and
counter-derived values exact; ``CN2_EXACT``, ``SCH1`` and the sketch
estimates come from the float32 HLL estimator, whose sum XLA and torch
add in different orders: ``rel=1e-6`` across the packages (ROADMAP §C).
DQV reports are compared without their timestamps.
"""
import contextlib
import io
import json
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from repro import qa as jqa
from repro.launch import assess as j_assess
from repro.launch import qa_serve as j_qa_serve
from repro.serve import QAServer as JQAServer
from repro.serve import ServerConfig as JServerConfig

from repro_torch import kernels as K
from repro_torch import qa
from repro_torch.core.metrics import SKETCH_METRICS
from repro_torch.launch import assess as t_assess
from repro_torch.launch import qa_serve
from repro_torch.rdf import bsbm_ntriples
from repro_torch.serve import JobJournal, QAServer, ServerConfig

BASE = ("http://bsbm.example.org/",)
SEG = 4096
HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
COUNTERS = ("repro_assessments_total", "repro_triples_assessed_total",
            "repro_bytes_rescanned_total", "repro_segments_reused_total",
            "repro_segments_rescanned_total", "repro_alerts_fired_total",
            "repro_upload_bytes_total", "repro_jobs_replayed_total",
            "repro_datasets_deleted_total")


def as_port(text: str) -> str:
    return (text.replace("repro.", "repro_torch.")
            .replace("from repro import", "from repro_torch import"))


def req(port, method, path, body=None):
    """(status, parsed-or-raw body); 4xx/5xx don't raise."""
    r = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                               method=method)
    try:
        with urllib.request.urlopen(r, timeout=30) as resp:
            raw, status = resp.read(), resp.status
            ctype = resp.headers.get("Content-Type", "")
    except urllib.error.HTTPError as e:
        raw, status = e.read(), e.code
        ctype = e.headers.get("Content-Type", "")
    if ctype.startswith("application/json"):
        return status, json.loads(raw)
    return status, raw


def wait_job(port, name, job_id, timeout=60.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        st, job = req(port, "GET", f"/datasets/{name}/jobs/{job_id}")
        assert st == 200, job
        if job["state"] in ("done", "failed"):
            return job
        time.sleep(0.02)
    raise AssertionError(f"job {job_id} still {job['state']} after "
                         f"{timeout}s")


def upload(port, name, text):
    st, doc = req(port, "PUT", f"/datasets/{name}/data", body=text.encode())
    assert st == 202, doc
    return doc["job"]["id"]


def assert_values_match(got: dict, want: dict):
    assert set(got) == set(want)
    for k, v in want.items():
        if k in SKETCH_METRICS or k.startswith("sketch:"):
            assert got[k] == pytest.approx(v, rel=1e-6), k
        else:
            assert got[k] == v, k


def counter_lines(prom: bytes) -> dict:
    out = {}
    for line in prom.decode().splitlines():
        name = line.split("{", 1)[0].split(" ", 1)[0]
        if name in COUNTERS:
            key, value = line.rsplit(" ", 1)
            out[key] = float(value)
    return out


def server(cls, cfg_cls, root, **kw):
    cfg = dict(store_root=os.fspath(root), metrics="all", base=BASE,
               workers=2, segment_bytes=SEG, watch=False, retry_base=0.01,
               poll_interval=0.1)
    cfg.update(kw)
    return cls(cfg_cls(**cfg), port=0).start()


def tserver(root, **kw):
    kw.setdefault("device", "cpu")
    return server(QAServer, ServerConfig, root, **kw)


def jserver(root, **kw):
    return server(JQAServer, JServerConfig, root, **kw)


# -- the copied modules ----------------------------------------------------------

@pytest.mark.parametrize("name", ["jobs.py", "journal.py", "obs.py",
                                  "faults.py", "alerts.py", "registry.py"])
def test_copied_modules_equal_the_originals(name):
    with open(os.path.join(SRC, "repro", "serve", name)) as f:
        original = f.read()
    with open(os.path.join(SRC, "repro_torch", "serve", name)) as f:
        assert f.read() == as_port(original)


# -- one daemon of each package, the same traffic --------------------------------

def _drive(port, clean, doctored, other, metric):
    """Register an alerting tenant and a plain one, upload to both, then
    re-upload the first with a regression; the jobs in order."""
    st, doc = req(port, "PUT", "/datasets/al", body=json.dumps(
        {"alerts": [f"delta({metric}) < 0", f"{metric} > 2"]}).encode())
    assert st == 201, doc
    jobs = [wait_job(port, "al", upload(port, "al", clean))]
    jobs.append(wait_job(port, "ds", upload(port, "ds", other)))
    jobs.append(wait_job(port, "al", upload(port, "al", doctored)))
    return jobs


@pytest.mark.parametrize("backend", ["fused_scan", "torch"])
def test_daemons_given_the_same_uploads_agree(tmp_path, backend):
    clean = bsbm_ntriples(80, seed=6)
    doctored = clean + bsbm_ntriples(10, seed=66)
    other = bsbm_ntriples(50, seed=7)
    v1 = jqa.assess(clean, metrics="paper", base=BASE).values
    v2 = jqa.assess(doctored, metrics="paper", base=BASE).values
    metric = sorted(n for n in v1 if v2[n] < v1[n])[0]
    srv = {"torch": tserver(tmp_path / "t", backend=backend),
           "jax": jserver(tmp_path / "j")}
    try:
        got = {k: _drive(s.port, clean, doctored, other, metric)
               for k, s in srv.items()}
        for job, jjob in zip(got["torch"], got["jax"]):
            assert job["state"] == jjob["state"] == "done", job["error"]
            for k in ("id", "dataset", "trigger", "attempts", "n_triples",
                      "alerts_fired"):
                assert job[k] == jjob[k], k
            assert_values_match(job["values"], jjob["values"])
            es = {k: v for k, v in job["exec_stats"].items()
                  if k != "wall_seconds"}
            jes = {k: v for k, v in jjob["exec_stats"].items()
                   if k != "wall_seconds"}
            if backend == "torch":              # torch <-> jnp, pass for pass
                assert job["passes"] == jjob["passes"]
            else:
                assert job["passes"] == es["segments_rescanned"]
                assert es.pop("passes_per_chunk") == 1
                jes.pop("passes_per_chunk")
            assert es == jes
        assert [j["alerts_fired"] for j in got["torch"]] == [0, 0, 1]
        docs = {}
        for k, s in srv.items():
            _, alerts = req(s.port, "GET", "/datasets/al/alerts")
            _, hist = req(s.port, "GET", "/datasets/al/history")
            _, rep = req(s.port, "GET", "/datasets/al/report")
            _, rank = req(s.port, "GET", "/catalog/ranking")
            _, info = req(s.port, "GET", "/datasets/al")
            _, prom = req(s.port, "GET", "/metrics")
            docs[k] = dict(alerts=alerts["alerts"], hist=hist, rep=rep,
                           rank=rank, info=info, prom=counter_lines(prom))
        t, j = docs["torch"], docs["jax"]
        strip = ("firedAt",)
        assert [{k: v for k, v in a.items() if k not in strip}
                for a in t["alerts"]] == [
            {k: v for k, v in a.items() if k not in strip}
            for a in j["alerts"]]
        assert t["hist"]["snapshots"] == j["hist"]["snapshots"] == 2
        assert_values_match(
            {m: d["latest"] for m, d in t["hist"]["metrics"].items()},
            {m: d["latest"] for m, d in j["hist"]["metrics"].items()})
        assert t["rep"]["nTriples"] == j["rep"]["nTriples"]
        assert_values_match(
            {m["http://www.w3.org/ns/dqv#isMeasurementOf"]["@id"]: m[
                "http://www.w3.org/ns/dqv#value"]
             for m in t["rep"]["measurements"]},
            {m["http://www.w3.org/ns/dqv#isMeasurementOf"]["@id"]: m[
                "http://www.w3.org/ns/dqv#value"]
             for m in j["rep"]["measurements"]})
        assert [(r["rank"], r["name"]) for r in t["rank"]["ranking"]] \
            == [(r["rank"], r["name"]) for r in j["rank"]["ranking"]]
        for a, b in zip(t["rank"]["ranking"], j["rank"]["ranking"]):
            assert a["score"] == pytest.approx(b["score"], rel=1e-6)
        for k in ("jobs", "snapshots", "store", "has_report", "rules"):
            assert t["info"].get(k) == j["info"].get(k), k
        assert t["prom"] == j["prom"]
        assert t["prom"]['repro_assessments_total{dataset="al",'
                         'state="done"}'] == 2
    finally:
        for s in srv.values():
            s.close()


def test_watched_source_and_delete(tmp_path):
    """A registered server-side source is assessed by the watcher on
    registration and again after an edit, each equal to the JAX
    package's assessment of the file; DELETE reclaims the store."""
    src = tmp_path / "watched.nt"
    src.write_text(bsbm_ntriples(40, seed=4))
    srv = tserver(tmp_path / "root", watch=True)
    try:
        st, _ = req(srv.port, "PUT", "/datasets/wds",
                    body=json.dumps({"source": os.fspath(src)}).encode())
        assert st == 201

        def done():
            _, jl = req(srv.port, "GET", "/datasets/wds/jobs")
            return [j for j in jl["jobs"]
                    if j["state"] == "done" and j["trigger"] == "watch"]

        deadline = time.time() + 60
        while len(done()) < 1:
            assert time.time() < deadline, "the watcher never assessed"
            time.sleep(0.05)
        with open(src, "a") as f:
            f.write(bsbm_ntriples(5, seed=44))
        while len(done()) < 2:
            assert time.time() < deadline, "the watcher missed the edit"
            time.sleep(0.05)
        last = done()[-1]
        want = jqa.assess(src.read_text(), base=BASE)
        assert last["n_triples"] == want.n_triples
        assert_values_match(last["values"], dict(want.values))
        assert 0 < last["exec_stats"]["bytes_rescanned"] \
            < last["exec_stats"]["bytes_total"]
        st, doc = req(srv.port, "DELETE", "/datasets/wds")
        assert st == 200 and doc["bytes_reclaimed"] > 0
        assert not os.path.exists(tmp_path / "root" / "wds")
    finally:
        srv.close()


def test_port_daemon_job_races_a_jax_cli_store_run(tmp_path):
    """Port daemon jobs and a ``python -m repro.launch.assess --store`` run
    of the JAX package on the same store, at once: both succeed, agree,
    and leave a store that either package reuses."""
    data = bsbm_ntriples(120, seed=5)
    nt_path = tmp_path / "race.nt"
    nt_path.write_text(data)
    srv = tserver(tmp_path / "root", metrics="paper")
    try:
        first = wait_job(srv.port, "race", upload(srv.port, "race", data))
        assert first["state"] == "done", first["error"]
        store_dir = srv.registry.store_dir("race")
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro.launch.assess", "--nt",
             os.fspath(nt_path), "--store", store_dir, "--segment-bytes",
             str(SEG), "--metrics", "paper", "--base", BASE[0]],
            env={**os.environ, "PYTHONPATH": SRC}, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        raced = 0
        try:
            while proc.poll() is None or raced == 0:
                st, doc = req(srv.port, "POST", "/datasets/race/assess")
                assert st == 202, doc
                job = wait_job(srv.port, "race", doc["job"]["id"])
                assert job["state"] == "done", job["error"]
                raced += 1
            out, err = proc.communicate(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
        assert proc.returncode == 0, err[-3000:]
        cold = qa.assess(data, metrics="paper", base=BASE, device="cpu")
        assert {k: float(v) for k, v in (ln.split() for ln in
                                         out.strip().splitlines())} \
            == {k: float(f"{v:.6f}") for k, v in cold.values.items()}
        for pkg_assess, kw in ((qa.assess, {"device": "cpu"}),
                               (jqa.assess, {})):
            after = pkg_assess(data, metrics="paper", base=BASE,
                               store=store_dir, segment_bytes=SEG, **kw)
            assert after.exec_stats.segments_rescanned == 0
            assert after.values == cold.values
    finally:
        srv.close()


# -- the journal across packages -------------------------------------------------

_CRASHER = textwrap.dedent("""\
    import os, sys
    pkg, root, portfile = sys.argv[1], sys.argv[2], sys.argv[3]
    serve = __import__(pkg + ".serve", fromlist=["serve"])
    kw = {"device": "cpu"} if pkg == "repro_torch" else {}
    faults = serve.ServiceFaultInjector(slow_jobs={"c1": 1.0},
                                        crash_after_journal={"start#2"})
    srv = serve.QAServer(serve.ServerConfig(
        store_root=root, metrics="paper",
        base=("http://bsbm.example.org/",), workers=1,
        segment_bytes=4096, watch=False, retry_base=0.05, **kw),
        port=0, faults=faults).start()
    with open(portfile + ".tmp", "w") as f:
        f.write(str(srv.port))
    os.replace(portfile + ".tmp", portfile)
    srv.wait()
""")


@pytest.mark.parametrize("crashes,replays", [("repro", "repro_torch"),
                                             ("repro_torch", "repro")],
                         ids=["jax-journal-port-replays",
                              "port-journal-jax-replays"])
def test_journal_replayed_across_packages(tmp_path, crashes, replays):
    """A daemon of one package accepts three uploads and dies at the
    crash point after journaling the second job's start; a daemon of the
    other package replays the journal and completes every accepted job
    under its original id, equal to a direct assessment."""
    runner = tmp_path / "crasher.py"
    runner.write_text(_CRASHER)
    root = tmp_path / "root"
    portfile = tmp_path / "port"
    data = {f"c{i}": bsbm_ntriples(40, seed=10 + i) for i in (1, 2, 3)}
    proc = subprocess.Popen(
        [sys.executable, os.fspath(runner), crashes, os.fspath(root),
         os.fspath(portfile)], env={**os.environ, "PYTHONPATH": SRC},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        deadline = time.time() + 120
        while not os.path.exists(portfile):
            assert proc.poll() is None, proc.communicate()[1][-3000:]
            assert time.time() < deadline, "the daemon never came up"
            time.sleep(0.05)
        with open(portfile) as f:
            port = int(f.read())
        ids = {name: upload(port, name, text) for name, text in data.items()}
        assert proc.wait(timeout=60) == 17
    finally:
        if proc.poll() is None:
            proc.kill()
    unfinished, _ = JobJournal.replay(os.fspath(root / "jobs.jsonl"))
    assert {r["dataset"] for r in unfinished} == {"c2", "c3"}
    srv = (tserver if replays == "repro_torch" else jserver)(
        root, metrics="paper", workers=1)
    try:
        for name in ("c2", "c3"):
            job = wait_job(srv.port, name, ids[name])
            assert job["state"] == "done", job["error"]
            want = jqa.assess(data[name], metrics="paper", base=BASE)
            assert job["values"] == {k: float(v) for k, v in
                                     sorted(want.values.items())}
            assert job["n_triples"] == want.n_triples
        _, prom = req(srv.port, "GET", "/metrics")
        replayed = counter_lines(prom)
        assert sum(v for k, v in replayed.items()
                   if k.startswith("repro_jobs_replayed_total")) == 2
        st, rep = req(srv.port, "GET", "/datasets/c1/report")
        assert st == 200 and rep["measurements"]
    finally:
        srv.close()


# -- the launchers ---------------------------------------------------------------

@pytest.mark.parametrize("entry", [
    ["-m", "repro_torch.launch.qa_serve", "--port", "0", "--no-watch"],
    ["-m", "repro_torch.launch.assess", "--serve", "0"]],
    ids=["qa_serve", "assess-serve"])
def test_launcher_serves_and_exits_zero_on_sigterm(tmp_path, entry):
    root = tmp_path / "root"
    proc = subprocess.Popen(
        [sys.executable, *entry, "--store-root", os.fspath(root),
         "--device", "cpu", "--metrics", "paper", "--base", BASE[0]],
        env={**os.environ, "PYTHONPATH": SRC}, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    lines, banner = [], threading.Event()

    def read_stderr():
        for line in proc.stderr:
            lines.append(line)
            if line.startswith("# repro_torch.serve on http://"):
                banner.set()

    t = threading.Thread(target=read_stderr, daemon=True)
    t.start()
    try:
        assert banner.wait(120), "".join(lines)
        head = next(ln for ln in lines if "serve on http://" in ln)
        assert "backend fused_scan, device cpu" in head
        port = int(head.split("http://", 1)[1].split(" ", 1)[0]
                   .rsplit(":", 1)[1])
        data = bsbm_ntriples(30, seed=2)
        job = wait_job(port, "cli", upload(port, "cli", data))
        assert job["state"] == "done", job["error"]
        want = qa.assess(data, metrics="paper", base=BASE, device="cpu")
        assert job["values"] == {k: float(v) for k, v in
                                 sorted(want.values.items())}
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=60)
        t.join(timeout=10)
        err = "".join(lines)
        assert proc.returncode == 0, err
        assert "SIGTERM" in err and "clean shutdown" in err
    finally:
        if proc.poll() is None:
            proc.kill()


def _exit_message(fn, argv):
    err = io.StringIO()
    with contextlib.redirect_stderr(err), pytest.raises(SystemExit) as e:
        fn(argv)
    return e.value.code, err.getvalue()


@pytest.mark.parametrize("which,argv,message", [
    ("qa_serve", [], "required: --store-root"),
    ("qa_serve", ["--store-root", "d", "--workers", "x"],
     "invalid int value"),
    ("qa_serve", ["--store-root", "d", "--port", "http"],
     "invalid int value"),
    ("assess", ["--serve", "8080"], "--serve needs --store-root"),
    ("assess", ["--serve", "x", "--store-root", "d"], "invalid int value"),
], ids=["no-root", "workers", "port", "serve-no-root", "serve-port"])
def test_argument_errors_equal_jax(which, argv, message):
    fns = {"qa_serve": (qa_serve.main, j_qa_serve.main),
           "assess": (t_assess.main, j_assess.main)}[which]
    for fn in fns:
        code, err = _exit_message(fn, argv)
        assert code == 2 and message in err
    assert not os.path.exists("d")


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_backend_choices_are_the_ports(backend):
    code, err = _exit_message(qa_serve.main, ["--store-root", "d",
                                              "--backend", backend])
    assert code == 2 and "invalid choice" in err


def test_default_device_without_a_card_fails_the_job(tmp_path):
    """``ServerConfig`` defaults to the ``fused_scan`` kernels on
    ``cuda``; without a card a job fails once (a missing device is not
    transient) with an error that names the device, and nothing is
    launched or assessed on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("there is a card here")
    cfg = ServerConfig(store_root=os.fspath(tmp_path / "root"))
    assert (cfg.backend, cfg.device) == ("fused_scan", "cuda")
    K.reset_launches()
    srv = server(QAServer, ServerConfig, tmp_path / "root")
    try:
        job = wait_job(srv.port, "nocard",
                       upload(srv.port, "nocard", bsbm_ntriples(20, seed=1)))
        assert job["state"] == "failed" and job["attempts"] == 1
        assert "device cuda is not available" in job["error"]
        assert job["values"] is None
        _, prom = req(srv.port, "GET", "/metrics")
        assert counter_lines(prom) == {
            'repro_assessments_total{dataset="nocard",state="failed"}': 1.0,
            'repro_upload_bytes_total{dataset="nocard"}':
                float(len(bsbm_ntriples(20, seed=1)))}
        st, _ = req(srv.port, "GET", "/datasets/nocard/report")
        assert st == 404
    finally:
        srv.close()
    assert sum(K.LAUNCHES.values()) == 0


def test_modules_import_no_jax_and_start_no_cuda():
    code = ("import sys\n"
            "import repro_torch.serve, repro_torch.catalog, "
            "repro_torch.fetch\n"
            "import repro_torch.launch.qa_serve, "
            "repro_torch.launch.qa_catalog\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'repro' "
            "or m.startswith('repro.'))\n"
            "cuda = 'torch' in sys.modules and "
            "sys.modules['torch'].cuda.is_initialized()\n"
            "print(bad, cuda)")
    proc = subprocess.run([sys.executable, "-c", code],
                          env={**os.environ, "PYTHONPATH": SRC},
                          capture_output=True, text=True, check=True)
    assert proc.stdout.strip() == "[] False"


# -- on the card -----------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["fused_scan", "twopass"])
def test_gpu_two_workers_launch_at_once_bit_identical(tmp_path, backend):
    """Two daemon workers assess two tenants on the card at once: every
    job equals the plain backend on the card, the launches are the sum
    of the jobs' rescanned segments, and a warm run over each store
    reproduces the plain registers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    texts = {f"g{i}": bsbm_ntriples(1500, seed=i) for i in (1, 2)}
    srv = server(QAServer, ServerConfig, tmp_path / "root",
                 backend=backend, device="cuda")
    try:
        K.reset_launches()
        ids = {n: upload(srv.port, n, t) for n, t in texts.items()}
        jobs = {n: wait_job(srv.port, n, i, timeout=300)
                for n, i in ids.items()}
        launches = dict(K.LAUNCHES)
    finally:
        srv.close()
    segs = 0
    for name, job in jobs.items():
        assert job["state"] == "done", job["error"]
        plain = qa.assess(texts[name], base=BASE, backend="torch")
        assert job["values"] == {k: float(v) for k, v in
                                 sorted(plain.values.items())}
        assert job["n_triples"] == plain.n_triples
        segs += job["exec_stats"]["segments_rescanned"]
        warm = qa.assess(texts[name], base=BASE, backend="torch",
                         store=os.path.join(tmp_path, "root", name,
                                            "store"), segment_bytes=SEG)
        assert warm.exec_stats.segments_rescanned == 0
        for k in plain.registers:
            assert np.array_equal(warm.registers[k], plain.registers[k])
    a, b = jobs.values()
    assert a["started_at"] < b["finished_at"] and \
        b["started_at"] < a["finished_at"], "the two jobs did not overlap"
    want = ({"fused_scan": segs, "qap_count": 0, "hll_fold": 0}
            if backend == "fused_scan" else
            {"fused_scan": 0, "qap_count": segs, "hll_fold": 2 * segs})
    assert launches == want
