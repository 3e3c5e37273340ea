"""The benchmark's LinkedGeoData configuration (``qabench/configs/
linkedgeodata.json``) and its cell ``linkedgeodata.report_all``: the cell
loads, its source is its own, its profile is what the generator reads,
rows drawn from it on the CPU have its shares, and the port agrees with
the plain reference on them, through the evaluator and through the
harness's own request path."""
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from qabench import reference  # noqa: E402
from qabench.harness import cell as cell_mod  # noqa: E402
from qabench.harness import planes as gen  # noqa: E402
from qabench.harness import spec  # noqa: E402
from qabench.reference import rdf as R  # noqa: E402

CELL = "linkedgeodata.report_all"
TRIPLES = 1_292_933_812                 # arXiv 2001.11100, Table 3
N = 20_000
SEED = 2**31 + 4242
ALL = ("L1", "L2", "I2", "U1", "RC1", "SV3", "CN2", "I1", "SV1", "SV2",
       "V1", "IO1", "CS1", "CM1", "CN2_EXACT", "SCH1")


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture(scope="module")
def config():
    return dict(spec.load_cell(CELL).config, triples=N)


@pytest.fixture(scope="module")
def rows(config):
    return gen.make_planes(config, SEED, "cpu", block_rows=1 << 13)


def test_cell_loads():
    cell = spec.load_cell(CELL)
    cfg = cell.config
    assert cell.chips == 1 and cfg["name"] == "linkedgeodata"
    assert cfg["triples"] == TRIPLES and cfg["planes"] == R.N_PLANES
    assert cfg["resident_bytes"] == TRIPLES * 4 * R.N_PLANES
    assert (cfg["backend"], cfg["fused"], cfg["hll_p"]) == (
        "fused_scan", True, 12)
    assert [sorted(s) for s in cell.mix["sets"]] == [sorted(ALL)]
    entry, = [c for c in _bench()["configs"] if c["name"] == "linkedgeodata"]
    assert entry["reduced"] == [] and entry["source"] == cfg["source"]
    assert (ROOT / cfg["reference"]).resolve() == pathlib.Path(
        reference.__file__).resolve().parent


def test_source_is_its_own():
    bench = _bench()
    sources = {c["name"]: c["source"] for c in bench["configs"]}
    files = {c["name"]: json.loads((ROOT / c["file"]).read_text())["source"]
             for c in bench["configs"]}
    assert files == sources
    lgd = sources.pop("linkedgeodata")
    assert lgd not in sources.values() and len(sources) >= 2
    assert lgd.startswith("http://linkedgeodata.org") and len(lgd) <= 200


class _Reads(dict):
    """A profile that records the keys read from it."""

    def __init__(self, *a):
        super().__init__(*a)
        self.read = set()

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)


@pytest.mark.parametrize("name", ["linkedgeodata", "bsbm_200gb",
                                  "bsbm_20gb"])
def test_profile_has_the_keys_the_generator_reads(name):
    entry, = [c for c in _bench()["configs"] if c["name"] == name]
    prof = _Reads(json.loads((ROOT / entry["file"]).read_text())["profile"])
    gen._block(torch.Generator().manual_seed(1), 64, 10_000, prof, "cpu")
    assert prof.read == set(prof)


def test_every_profile_value_is_assumed_with_its_reason():
    cfg = spec.load_cell(CELL).config
    assumed = " ".join(cfg["assumed"])
    for key in cfg["profile"]:
        assert f"{key} " in assumed, key
    # the ids of subjects, predicates and objects fit the int32 id planes
    prof = cfg["profile"]
    ids = (TRIPLES // prof["subject_pool_divisor"] + prof["predicate_pool"]
           + TRIPLES // prof["object_pool_divisor"])
    assert ids == 808_084_632 and ids < 2**31
    assert f"{ids:,}" in assumed


@pytest.mark.parametrize("name", ["linkedgeodata", "bsbm_200gb",
                                  "bsbm_20gb"])
def test_the_id_space_fits_the_id_planes(name):
    entry, = [c for c in _bench()["configs"] if c["name"] == name]
    cfg = json.loads((ROOT / entry["file"]).read_text())
    prof, n = cfg["profile"], cfg["triples"]
    ids = (n // prof["subject_pool_divisor"] + prof["predicate_pool"]
           + n // prof["object_pool_divisor"])
    assert ids < 2**31
    assert cfg["resident_bytes"] == n * 4 * R.N_PLANES


def _near(share, want, n):
    # five standard errors of a binomial share; a share of 0 is exact
    assert abs(share - want) <= 5 * np.sqrt(want * (1 - want) / n), (
        share, want)


def test_shares_match_the_profile(config, rows):
    prof = config["profile"]
    x = rows.numpy()
    assert x.shape == (N, R.N_PLANES)
    o, p, s = x[:, R.O_FLAGS], x[:, R.P_FLAGS], x[:, R.S_FLAGS]
    lit = (o & R.KIND_LITERAL) != 0
    typed = lit & ((o & R.HAS_DATATYPE) != 0)
    untyped = lit & ~typed
    iri_o = (o & R.KIND_IRI) != 0
    _near(lit.mean(), prof["literal_obj"], N)
    _near(((o & R.KIND_BLANK) != 0).mean(), prof["blank_obj"], N)
    _near(typed.sum() / lit.sum(), prof["typed_literal"], lit.sum())
    _near((typed & ((o & R.LEXICAL_OK) == 0)).sum() / typed.sum(),
          prof["malformed_literal"], typed.sum())
    _near((untyped & ((o & R.HAS_LANG) != 0)).sum() / untyped.sum(),
          prof["lang_literal"], untyped.sum())
    _near((iri_o & ((o & R.INTERNAL) == 0)).sum() / iri_o.sum(),
          prof["external_obj"], iri_o.sum())
    _near(((s & R.INTERNAL) == 0).mean(), prof["external_subj"], N)
    _near(((p & R.IS_LABEL_PRED) != 0).mean(), prof["label_triple"], N)
    _near(((p & R.IS_LICENSE_PRED) != 0).mean(), prof["license_triple"], N)
    _near(((o & R.IS_LICENSE_STATEMENT) != 0).mean(),
          prof["license_stmt_literal"], N)
    _near(((p & R.IS_SAMEAS) != 0).mean(), prof["sameas"], N)
    _near(((p & R.IS_RDFTYPE) != 0).mean(), prof["rdftype"], N)
    _near((x[:, R.S_LEN] > 80).mean(), prof["long_uri"], N)
    assert ((s & R.VALID) != 0).all() and ((o & R.VALID) != 0).all()


def test_predicates_span_the_pool(config, rows):
    prof = config["profile"]
    pool = prof["predicate_pool"]
    first = N // prof["subject_pool_divisor"]
    ids = rows[:, R.P].numpy() - first
    assert ids.min() == 0 and ids.max() == pool - 1
    # Zipf(1.2) clipped to the pool: its head, a long tail of rare
    # properties, and the clipped draws on the last id
    counts = np.bincount(ids, minlength=pool)
    assert (counts > 0).sum() >= pool // 2
    assert counts[0] / N > 0.1 and counts[-1] / N > 0.1


def _port(rows, names):
    from repro_torch.core.evaluator import QualityEvaluator
    from repro_torch.rdf.triple_tensor import TripleTensor
    ev = QualityEvaluator(list(names), backend="torch", device="cpu")
    return ev.assess(TripleTensor(rows.numpy(), N))


@pytest.mark.parametrize("names", [(m,) for m in ALL] + [ALL],
                         ids=list(ALL) + ["report_all"])
def test_port_agrees_with_the_reference(rows, names):
    ref = reference.for_set(reference.assess(rows, names, 12,
                                             block_rows=1 << 12), names)
    got = _port(rows, names)
    assert got.counts == ref.counts
    assert set(got.registers) == set(ref.registers)
    for s, r in ref.registers.items():
        assert np.array_equal(got.registers[s], r)
    for m, v in ref.values.items():
        assert np.isfinite(v) and got.values[m] == pytest.approx(
            v, rel=1e-5, abs=0)


def test_the_zero_fractions_give_zero_values(rows):
    ref = reference.for_set(reference.assess(rows, ALL, 12), ALL)
    assert ref.values["L1"] == ref.values["L2"] == 0.0    # no licence
    assert ref.values["IO1"] == 0.0                       # no blank node
    assert ref.values["I2"] > 0.0 and ref.values["SV3"] > 0


def test_harness_request_path_is_correct_on_the_cpu():
    """The cell through the harness's own steps (planes from the seed, the
    evaluator built by the port's fluent API, its warm request, the closed
    loop, the check against the reference), at N rows on the CPU."""
    from qabench.harness import check
    cell = spec.load_cell(CELL)
    cell.config["triples"] = N
    planes, evs, _ = cell_mod.set_up(cell, SEED, "cpu")
    requests, answers, *_ = cell_mod.window(cell, evs, planes, SEED, 0.3)
    verdict = check.judge(answers, cell_mod.reference_answers(cell, planes),
                          N, cell.limits)
    assert verdict["correct"] and verdict["failed"] == 0
    assert len(requests) == len(answers) > 0
    numbers = verdict["numbers"]
    assert (numbers["counters_off"], numbers["registers_off"],
            numbers["report_off"]) == (0, 0, 0)
    assert numbers["value_gap"] <= 1e-5 and numbers["report_gap"] <= 1e-5
