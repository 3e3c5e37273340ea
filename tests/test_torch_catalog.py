"""``repro_torch.catalog`` (the fleet crawler, ranking and regression
report) and ``python -m repro_torch.launch.qa_catalog`` against the JAX
package's ``repro.catalog`` and ``repro.launch.qa_catalog``.

The contract under test: discovery, ranking and regression carry no JAX
and are copies of the originals; a crawl by the port gives, dataset for
dataset, the JAX crawl's records (status, ``n_triples``, segment and
byte counts) and values, with registers equal to the port's own plain
backend; a catalog root crawled by either package is re-crawled warm by
the other with 0 bytes rescanned, and both rank and report it alike; a
remote catalog goes through the fetch plane (all 304s warm); the
launchers print what the JAX launchers print; and the default device,
``cuda``, fails each dataset's record where there is no card instead of
assessing on the CPU.

The port runs with ``device="cpu"`` (its kernel wrappers then run their
plain torch versions), the JAX package its default ``jnp`` backend.
Tolerances: counts, registers and counter-derived values exact;
``CN2_EXACT``, ``SCH1`` and the sketch estimates come from the float32
HLL estimator, whose sum XLA and torch add in different orders:
``rel=1e-6`` across the packages (ROADMAP §C).
"""
import contextlib
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch

from repro import catalog as jcatalog
from repro import qa as jqa
from repro.fetch import FlakyOriginServer as JFlakyOriginServer
from repro.launch import qa_catalog as j_qa_catalog

from repro_torch import catalog, qa
from repro_torch import kernels as K
from repro_torch.core.metrics import SKETCH_METRICS
from repro_torch.fetch import FlakyOriginServer, HttpFaultInjector
from repro_torch.launch import qa_catalog
from repro_torch.rdf import bsbm_ntriples

BASE = ("http://bsbm.example.org/",)
SEG = 4096
SPECS = {"p": 60, "q": 40, "r": 25}
HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
RECORD_KEYS = ("name", "status", "attempts", "error", "n_triples",
               "bytes_total", "bytes_rescanned", "segments_reused",
               "segments_rescanned", "footprints_replayed", "stale")


def as_port(text: str) -> str:
    return (text.replace("repro.", "repro_torch.")
            .replace("from repro import", "from repro_torch import"))


def make_catalog(root, specs=SPECS):
    os.makedirs(root, exist_ok=True)
    for i, (name, n) in enumerate(sorted(specs.items())):
        with open(os.path.join(root, f"{name}.nt"), "w") as f:
            f.write(bsbm_ntriples(n, seed=10 + i))
    return os.fspath(root)


def crawl(src, root, **kw):
    kw.setdefault("base", BASE)
    kw.setdefault("segment_bytes", SEG)
    kw.setdefault("workers", 2)
    kw.setdefault("device", "cpu")
    return catalog.crawl_catalog(src, root, **kw)


def jcrawl(src, root, **kw):
    kw.setdefault("base", BASE)
    kw.setdefault("segment_bytes", SEG)
    kw.setdefault("workers", 2)
    return jcatalog.crawl_catalog(src, root, **kw)


def assert_values_match(got: dict, want: dict):
    assert set(got) == set(want)
    for k, v in want.items():
        if k in SKETCH_METRICS:
            assert got[k] == pytest.approx(v, rel=1e-6), k
        else:
            assert got[k] == v, k


def assert_summaries_match(got: dict, want: dict):
    """Two crawl summaries of one catalog: the same records."""
    for k in ("n_datasets", "n_ok", "n_failed", "bytes_total",
              "bytes_rescanned", "segments_reused", "segments_rescanned"):
        assert got[k] == want[k], k
    assert len(got["datasets"]) == len(want["datasets"])
    for g, w in zip(got["datasets"], want["datasets"]):
        for k in RECORD_KEYS:
            assert g.get(k) == w.get(k), (g["name"], k)
        if "values" in w:
            assert_values_match(g["values"], w["values"])
        if "fetch" in w:
            assert {k: v for k, v in g["fetch"].items() if k != "url"} \
                == {k: v for k, v in w["fetch"].items() if k != "url"}


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """One catalog and the JAX package's cold crawl of it."""
    tmp = tmp_path_factory.mktemp("fleet")
    src = make_catalog(tmp / "cat")
    jroot = tmp / "jroot"
    return src, jroot, jcrawl(src, jroot, keep_results=True)


@pytest.mark.parametrize("name", ["discovery.py", "regression.py",
                                  "ranking.py", "__init__.py"])
def test_copied_modules_equal_the_originals(name):
    with open(os.path.join(SRC, "repro", "catalog", name)) as f:
        original = f.read()
    with open(os.path.join(SRC, "repro_torch", "catalog", name)) as f:
        assert f.read() == as_port(original)


@pytest.mark.parametrize("backend", ["fused_scan", "twopass", "torch"])
def test_crawl_equals_the_jax_crawl(fleet, tmp_path, backend):
    """Every backend of the port crawls the fleet into the JAX crawl's
    records; the registers equal the JAX crawl's and the port's plain
    single-shot assessment's."""
    src, _, jsum = fleet
    summary = crawl(src, tmp_path / "root", backend=backend,
                    keep_results=True)
    assert summary["n_ok"] == len(SPECS)
    assert_summaries_match(summary, jsum)
    for ref in catalog.discover(src):
        got = summary["results"][ref.name]
        plain = qa.assess(ref.path, base=BASE, backend="torch",
                          device="cpu")
        assert got.values == plain.values and got.counts == plain.counts
        jres = jsum["results"][ref.name]
        rec = {d["name"]: d for d in summary["datasets"]}[ref.name]
        # torch <-> jnp pass for pass; the kernels in 1 or 1 + S passes
        assert got.passes == (jres.passes if backend == "torch" else
                              rec["segments_rescanned"] * (
                                  1 + len(got.registers)
                                  if backend == "twopass" else 1))
        assert set(got.registers) == set(jres.registers)
        for k in jres.registers:
            np.testing.assert_array_equal(got.registers[k],
                                          plain.registers[k])
            np.testing.assert_array_equal(got.registers[k],
                                          np.asarray(jres.registers[k]))


@pytest.mark.parametrize("first", ["jax", "torch"])
def test_root_crawled_by_one_package_is_warm_for_the_other(tmp_path,
                                                            first):
    """A catalog root crawled cold by one package: the other re-crawls it
    with 0 bytes rescanned and 0 footprints replayed, rescans only an
    edited dataset, and both packages rank and report the root alike."""
    src = make_catalog(tmp_path / "cat")
    root = tmp_path / "root"
    crawls = {"jax": jcrawl, "torch": crawl}
    second = "torch" if first == "jax" else "jax"
    cold = crawls[first](src, root)
    assert cold["n_ok"] == len(SPECS)
    warm = crawls[second](src, root)
    assert warm["n_ok"] == len(SPECS)
    assert warm["bytes_rescanned"] == 0 and warm["segments_rescanned"] == 0
    assert all(d["footprints_replayed"] == 0 for d in warm["datasets"])
    with open(os.path.join(src, "q.nt"), "a") as f:
        f.write(bsbm_ntriples(3, seed=77))
    edit = crawls[second](src, root, keep_results=True)
    per = {d["name"]: d for d in edit["datasets"]}
    assert per["q"]["bytes_rescanned"] > 0
    assert per["p"]["bytes_rescanned"] == per["r"]["bytes_rescanned"] == 0
    # the edit crawl's result equals a cold assessment of the edited file
    # in the package that made it
    edited = os.path.join(src, "q.nt")
    want = (qa.assess(edited, base=BASE, device="cpu") if second == "torch"
            else jqa.assess(edited, base=BASE))
    assert edit["results"]["q"].values == want.values
    ranked = catalog.rank_catalog(root)
    assert ranked == jcatalog.rank_catalog(root)
    assert ranked["n_datasets"] == len(SPECS)
    assert catalog.ranking_markdown(ranked) \
        == jcatalog.ranking_markdown(ranked)
    rules = ["delta(no_bogus_uris) < -0.5", "L1 < 2"]
    report = catalog.report_catalog(root, rules=rules)
    assert report == jcatalog.report_catalog(root, rules=rules)
    assert report["n_with_previous"] == len(SPECS)
    assert len(report["fired"]) == len(SPECS)      # "L1 < 2" fires on all
    assert catalog.regression_markdown(report) \
        == jcatalog.regression_markdown(report)
    assert len(catalog.load_crawls(root)) == 3


def _remote_catalog(origin_dir, specs):
    entries, texts = [], {}
    for i, (name, n) in enumerate(sorted(specs.items())):
        texts[name] = bsbm_ntriples(n, seed=30 + i)
        with open(os.path.join(origin_dir, f"{name}.nt"), "w") as f:
            f.write(texts[name])
        entries.append({"title": name,
                        "distribution": [{"downloadURL": f"{name}.nt"}]})
    with open(os.path.join(origin_dir, "catalog.json"), "w") as f:
        json.dump({"dataset": entries}, f)
    return texts


def test_remote_catalog_through_the_fetch_plane(tmp_path):
    """A DCAT manifest served over HTTP: the port's cold crawl fetches
    and assesses like the JAX crawl; its warm crawl and then the JAX
    package's, over the same root and download cache, revalidate every
    distribution with a 304 and rescan nothing."""
    origin_dir = tmp_path / "origin"
    origin_dir.mkdir()
    texts = _remote_catalog(origin_dir, {"ra": 40, "rb": 25})
    with FlakyOriginServer(origin_dir, HttpFaultInjector()) as origin, \
            JFlakyOriginServer(origin_dir) as jorigin:
        url = origin.url_for("catalog.json")
        root = tmp_path / "root"
        cold = crawl(url, root, keep_results=True, max_fetch_attempts=2)
        jcold = jcrawl(jorigin.url_for("catalog.json"), tmp_path / "jroot",
                       max_fetch_attempts=2)
        assert cold["n_ok"] == 2
        assert_summaries_match(cold, jcold)
        assert cold["fetch"] == jcold["fetch"]
        for name, text in texts.items():
            want = qa.assess(text, base=BASE, backend="torch", device="cpu")
            assert cold["results"][name].values == want.values
        for crawler in (crawl, jcrawl):
            warm = crawler(url, root)
            assert warm["n_ok"] == 2
            assert warm["fetch"]["not_modified"] == 2
            assert warm["fetch"]["bytes_fetched"] == 0
            assert warm["bytes_rescanned"] == 0
        assert {s for _, p, s in origin.request_log() if p != "/catalog.json"
                } >= {200, 304}


def test_default_device_without_a_card_fails_each_record(tmp_path):
    """``crawl_catalog`` defaults to the ``fused_scan`` kernels on
    ``cuda``; without a card every dataset's record fails once (a
    missing device is not transient) with an error that names the
    device, nothing is launched, and the crawl is still journaled."""
    if torch.cuda.is_available():
        pytest.skip("there is a card here")
    src = make_catalog(tmp_path / "cat", {"p": 30, "q": 20})
    K.reset_launches()
    summary = catalog.crawl_catalog(src, tmp_path / "root", base=BASE,
                                    segment_bytes=SEG, retry_base=0.01)
    assert summary["n_ok"] == 0 and summary["n_failed"] == 2
    for rec in summary["datasets"]:
        assert rec["status"] == "failed" and rec["attempts"] == 1
        assert "device cuda is not available" in rec["error"]
    assert sum(K.LAUNCHES.values()) == 0
    assert catalog.load_crawls(tmp_path / "root")[-1]["n_failed"] == 2


# -- the launcher ----------------------------------------------------------------

def run_cli(fn, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(argv)
    return rc, out.getvalue(), err.getvalue()


def test_crawl_subcommand_prints_the_jax_summary(fleet, tmp_path):
    src, _, _ = fleet
    argv = ["crawl", "--source", src, "--segment-bytes", str(SEG),
            "--base", BASE[0]]
    rc, out, err = run_cli(qa_catalog.main, argv + [
        "--root", os.fspath(tmp_path / "t"), "--device", "cpu"])
    jrc, jout, jerr = run_cli(j_qa_catalog.main, argv + [
        "--root", os.fspath(tmp_path / "j")])
    assert rc == jrc == 0
    assert_summaries_match(json.loads(out), json.loads(jout))
    assert "(fused_scan on cpu)" in err.splitlines()[-1]
    # the per-dataset lines, less their wall times
    strip = [ln.rsplit(" (", 1)[0] for ln in err.splitlines()]
    jstrip = [ln.rsplit(" (", 1)[0] for ln in jerr.splitlines()]
    assert strip[:-1] == jstrip[:-1]


@pytest.fixture(scope="module")
def crawled_root(fleet):
    _, jroot, _ = fleet
    return jroot


@pytest.mark.parametrize("argv", [
    ["rank"], ["rank", "--format", "md"],
    ["report", "--rule", "L1 < 2"], ["report", "--format", "md"],
    ["compact", "--max-history", "1"], ["fsck"]],
    ids=["rank", "rank-md", "report-fired", "report-md", "compact",
         "fsck"])
def test_read_and_maintenance_subcommands_equal_jax(crawled_root, tmp_path,
                                                     argv):
    """rank, report, compact and fsck on copies of one crawled root: the
    same exit code, output and resulting files as the JAX launcher."""
    roots = {}
    for k in ("torch", "jax"):
        roots[k] = tmp_path / k
        shutil.copytree(crawled_root, roots[k])
    rc, out, err = run_cli(qa_catalog.main,
                           [argv[0], "--root", os.fspath(roots["torch"]),
                            *argv[1:]])
    jrc, jout, jerr = run_cli(j_qa_catalog.main,
                              [argv[0], "--root", os.fspath(roots["jax"]),
                               *argv[1:]])
    assert rc == jrc
    assert out == jout
    assert err.replace(os.fspath(roots["torch"]), "R") \
        == jerr.replace(os.fspath(roots["jax"]), "R")
    if argv[0] == "compact":
        for name in SPECS:
            with open(catalog.store_dir(roots["torch"], name)
                      + "/history.jsonl") as f, \
                    open(catalog.store_dir(roots["jax"], name)
                         + "/history.jsonl") as g:
                assert f.read() == g.read()


@pytest.mark.parametrize("argv,message", [
    ([], "required: cmd"),
    (["crawl", "--root", "r"], "required: --source"),
    (["rank"], "required: --root"),
    (["rank", "--root", "r", "--format", "xml"], "invalid choice"),
    (["crawl", "--source", "s", "--root", "r", "--workers", "x"],
     "invalid int value"),
], ids=["no-command", "crawl-no-source", "rank-no-root", "format",
        "workers"])
def test_argument_errors_equal_jax(argv, message):
    for fn in (qa_catalog.main, j_qa_catalog.main):
        err = io.StringIO()
        with contextlib.redirect_stderr(err), \
                pytest.raises(SystemExit) as e:
            fn(argv)
        assert e.value.code == 2
        assert message in err.getvalue()
    assert not os.path.exists("r")


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_backend_choices_are_the_ports(backend):
    """``--backend`` takes ``torch|twopass|fused_scan``; the JAX names
    are refused."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err), pytest.raises(SystemExit) as e:
        qa_catalog.main(["crawl", "--source", "s", "--root", "r",
                         "--backend", backend])
    assert e.value.code == 2 and "invalid choice" in err.getvalue()
