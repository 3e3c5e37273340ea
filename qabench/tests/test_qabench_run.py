"""A run of a cell on the CPU at a small size: its result line, the
import check, a cell added as files, and the faults a run must catch."""
import json
import shutil
import subprocess
import sys
import time

import pytest

from qabench.harness import cell as cell_mod
from qabench.harness import check, control, spec

from conftest import ROOT

LINE_KEYS = {"correct", "attempted", "failed", "metrics", "device",
             "checks"}


def run(cell, trace=False, seconds=0.3, root=spec.ROOT):
    return cell_mod.run(cell, 2**31 + 9, seconds, trace, device="cpu",
                        t_start=time.perf_counter(), root=root)


@pytest.mark.parametrize("name", ["bsbm_20gb.report_all",
                                  "bsbm_200gb.per_metric"])
def test_line_has_its_keys(small_cell, name):
    out = run(small_cell(name))
    assert set(out) == LINE_KEYS and list(out)[-1] == "checks"
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"assessed_triples_per_s",
                                   "assess_ms_p95", "setup_s"}
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes", "window_core"}
    assert set(out["checks"]) == set(check.NUMBERS)
    json.dumps(out, allow_nan=False)


def test_traced_line(small_cell):
    out = run(small_cell("bsbm_20gb.per_metric"), trace=True)
    assert set(out) == LINE_KEYS | {"breakdown"}
    assert list(out)[-1] == "checks"
    assert {"busy_s", "window_s"} <= set(out["device"])
    # no card here: no scan kernel in the trace, so no roofline share
    assert set(out["metrics"]) == {"device_idle_share", "evaluator_host_ms",
                                   "report_host_ms", "kernel_build_s"}
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_no_card_no_result():
    proc = subprocess.run(
        [sys.executable, "qabench/run.py", "--workload",
         "bsbm_20gb.report_all", "--seed", "1", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_only_the_benchmark_files_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "qabench", tmp_path / "qabench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "qabench/run.py", "--workload",
         "bsbm_20gb.report_all", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_import_check_compares_whole_names(monkeypatch):
    assert cell_mod.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro_torch_extra", sys)
    assert cell_mod.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert cell_mod.forbidden_modules() == ["repro"]
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert cell_mod.forbidden_modules() == ["jax", "repro"]


def test_cell_added_as_files(tmp_path):
    """A configuration, a mix, a layer metric and a cell added as new files
    and entries in a copy are found and run."""
    shutil.copytree(ROOT / "qabench", tmp_path / "qabench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "qabench/configs/bsbm_20gb.json").read_text())
    cfg.update(name="tiny", triples=5_000)
    (tmp_path / "qabench/configs/tiny.json").write_text(json.dumps(cfg))
    (tmp_path / "qabench/mixes/paper_pair.json").write_text(json.dumps(
        {"clients": 1, "sets": [["L1", "I2"], ["SCH1"]]}))
    (tmp_path / "qabench/layer_metrics/requests_seen.py").write_text(
        "def read(run):\n    return float(len(run.requests))\n")
    bench["configs"].append({"name": "tiny", "source": "x",
                             "file": "qabench/configs/tiny.json",
                             "reduced": ["triples"], "why": "test"})
    bench["workloads"].append({"name": "tiny.paper_pair", "config": "tiny",
                               "traffic": "paper_pair", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "requests_seen", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "device", "moves": "setup_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    c = spec.load_cell("tiny.paper_pair", root=tmp_path)
    assert c.config["triples"] == 5_000
    out = run(c, trace=True, root=tmp_path)
    assert out["correct"]
    assert out["metrics"]["requests_seen"]["value"] == out["attempted"]


def _state_unchanged(state, chunk_id, counts, regs):
    return state


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_rows",
                                   "counter_altered", "report_altered"])
def test_faults_are_caught(small_cell, monkeypatch, fault):
    from repro_torch.core import report
    from repro_torch.core.evaluator import QualityEvaluator
    if fault == "state_unchanged":
        monkeypatch.setattr(QualityEvaluator, "merge_chunk",
                            staticmethod(_state_unchanged))
    elif fault == "half_the_rows":
        orig = QualityEvaluator.dispatch_chunk
        monkeypatch.setattr(QualityEvaluator, "dispatch_chunk",
                            lambda self, arr: orig(self,
                                                   arr[:arr.shape[0] // 2]))
    elif fault == "counter_altered":
        orig = QualityEvaluator.materialize_chunk

        def altered(self, outs):
            counts, regs = orig(self, outs)
            counts[0][-1] += 1
            return counts, regs
        monkeypatch.setattr(QualityEvaluator, "materialize_chunk", altered)
    else:
        orig = report.to_json

        def altered(result, **kw):
            text = orig(result, **kw)
            rep = json.loads(text)
            rep["measurements"][0][check.DQV + "value"] += 1e-3
            return json.dumps(rep)
        monkeypatch.setattr(report, "to_json", altered)
    out = run(small_cell("bsbm_20gb.report_all"))
    assert out["correct"] is False and out["failed"] == out["attempted"]


@pytest.mark.parametrize("name", ["bsbm_20gb.report_all",
                                  "bsbm_20gb.per_metric"])
def test_control_fails_and_program_passes(small_cell, name):
    c = small_cell(name, triples=30_000)
    lines = list(control.readings(c, [11, 12], [11, 13], 0.5, "cpu"))
    for line in lines:
        if "program" in line:
            assert line["program"]["correct"]
        if "control" in line:
            assert not line["control"]["correct"]
            assert line["control"]["value_gap"] > c.limits["value_gap"]
