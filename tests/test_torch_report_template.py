"""``report.to_json``'s templates against the encoder they replace: every
case requires ``to_json(result, **kw)`` to equal ``json.dumps(to_dqv(result,
**kw), indent=2)`` byte for byte, and names the one counter the call moved
(``report.template_build``, ``_hit`` or ``_fallback``)."""
import json

import numpy as np
import pytest

from repro_torch import qa, tracing
from repro_torch.core import report
from repro_torch.core.evaluator import (AssessmentResult, QualityEvaluator,
                                        run_single_shot)
from repro_torch.core.metrics import ALL_METRICS
from repro_torch.dist import ChunkStats
from repro_torch.rdf import synth_encoded

TS = "2026-10-18T12:00:00.123456+00:00"
USER = "TEMPLATE_USER_METRIC"


@pytest.fixture
def fresh():
    """No template cached and no counter kept, before and after."""
    report._TEMPLATES.clear()
    tracing.drain()
    yield
    report._TEMPLATES.clear()
    tracing.drain()
    qa.unregister(USER)


def _result(values, n_triples=81_980_472, passes=1, exec_stats=None):
    return AssessmentResult(values=dict(values), counts={},
                            sketch_estimates={}, n_triples=n_triples,
                            passes=passes, exec_stats=exec_stats)


def _values(names, seed=0):
    rng = np.random.default_rng(seed)
    return {m: float(rng.random()) for m in names}


def _check(result, counter, **kw):
    """The text of one ``to_json`` call, held to the reference encoder,
    and the counter it moved."""
    kw.setdefault("computed_on", TS)
    text = report.to_json(result, **kw)
    assert text == json.dumps(report.to_dqv(result, **kw), indent=2)
    counters = {k: v for k, v in tracing.drain().counters.items()
                if k.startswith("report.")}
    assert counters == {counter: 1}
    return text


@pytest.mark.parametrize("names", [ALL_METRICS]
                         + [(m,) for m in ALL_METRICS],
                         ids=["all"] + list(ALL_METRICS))
def test_a_metric_set_builds_once_then_hits_with_new_text(fresh, names):
    first = _check(_result(_values(names, 1)), "report.template_build")
    second = _check(_result(_values(names, 2), n_triples=5, passes=3),
                    "report.template_hit")
    assert first != second
    assert len(report._TEMPLATES) == 1


def test_a_user_metric_registered_redescribed_and_unregistered(fresh):
    result = _result({USER: 0.25, "L1": 1.0})
    qa.ratio_metric(USER, qa.is_blank("s"), description="first")
    _check(result, "report.template_build")
    _check(result, "report.template_hit")
    qa.register(qa.ratio_metric(USER, qa.is_blank("s"), description="second",
                                auto_register=False), overwrite=True)
    assert '"second"' in _check(result, "report.template_build")
    qa.unregister(USER)
    assert "no longer registered" in _check(result, "report.template_build")
    _check(result, "report.template_hit")


@pytest.mark.parametrize("kw", [
    {"dataset_uri": 'http://example.org/"quoted"\\back\\slash/Dä✓'},
    {"dataset_uri": "urn:x", "computed_on": 'T"\\ä'},
], ids=["uri", "timestamp"])
def test_escaped_uri_and_timestamp(fresh, kw):
    _check(_result(_values(ALL_METRICS)), "report.template_build", **kw)
    _check(_result(_values(ALL_METRICS, 3)), "report.template_hit", **kw)


def test_a_non_ascii_description(fresh):
    qa.ratio_metric(USER, qa.is_blank("s"),
                    description='Qualität "der" Daten — ✓ \\ 質')
    _check(_result({USER: 0.5}), "report.template_build")
    _check(_result({USER: 0.75}), "report.template_hit")


@pytest.mark.parametrize("stats", [
    ChunkStats(chunks_total=8, devices=4, mode="pipelined",
               passes_per_chunk=1),
    ChunkStats(chunks_total=0, mode="incremental", passes_per_chunk=1,
               segments_reused=6, segments_rescanned=2, bytes_total=4096,
               bytes_rescanned=1024),
], ids=["mesh", "incremental"])
def test_exec_stats(fresh, stats):
    result = _result(_values(ALL_METRICS), exec_stats=stats)
    assert '"execStats"' in _check(result, "report.template_build")
    stats.chunks_total += 1
    _check(result, "report.template_hit")
    _check(_result(_values(ALL_METRICS)), "report.template_build")


@pytest.mark.parametrize("value,counter", [
    (0.0, "report.template_hit"),
    (-0.0, "report.template_hit"),
    (1e-300, "report.template_hit"),
    (1e22, "report.template_hit"),
    (7, "report.template_hit"),
    (np.float64(0.1), "report.template_hit"),
    (True, "report.template_fallback"),
    (float("nan"), "report.template_fallback"),
    (float("inf"), "report.template_fallback"),
    (float("-inf"), "report.template_fallback"),
    (None, "report.template_fallback"),
], ids=repr)
def test_values(fresh, value, counter):
    _check(_result({"L1": 0.5, "L2": 0.5}), "report.template_build")
    _check(_result({"L1": value, "L2": 0.5}), counter)


def test_a_value_json_rejects_raises_as_json_does(fresh):
    result = _result({"L1": np.float32(0.5)})
    with pytest.raises(TypeError, match="float32"):
        json.dumps(report.to_dqv(result), indent=2)
    with pytest.raises(TypeError, match="float32"):
        report.to_json(result)
    assert tracing.drain().counters == {"report.template_fallback": 1}
    assert len(report._TEMPLATES) == 1      # the shape's, value-free


def test_a_sentinel_in_the_static_text_caches_nothing(fresh):
    result = _result({"L1": 0.5})
    _check(result, "report.template_fallback",
           dataset_uri=report._SLOT.format(0))
    assert not report._TEMPLATES


def test_the_65th_key_clears_the_cache(fresh):
    result = _result({"L1": 0.5})
    for i in range(report._TEMPLATES_MAX):
        _check(result, "report.template_build", dataset_uri=f"urn:d{i}")
    assert len(report._TEMPLATES) == report._TEMPLATES_MAX
    _check(result, "report.template_hit", dataset_uri="urn:d0")
    _check(result, "report.template_build", dataset_uri="urn:d64")
    assert len(report._TEMPLATES) == 1
    _check(result, "report.template_build", dataset_uri="urn:d0")


def test_single_shot_reports_build_once_then_hit(fresh):
    """The real path on the CPU: the evaluator's results, each report
    equal to the reference encoder's, one build and then hits."""
    ev = QualityEvaluator(ALL_METRICS, device="cpu")
    for seed, counter in [(1, "report.template_build"),
                          (2, "report.template_hit"),
                          (3, "report.template_hit")]:
        result = run_single_shot(ev, synth_encoded(3_000, seed=seed))
        _check(result, counter)
