"""The frozen plane table equals the planes the port's planner and scan
code generator read for each metric at this commit."""
import json

import pytest

from conftest import ROOT

TABLE = json.loads((ROOT / "qabench" / "plane_table.json").read_text())


@pytest.mark.parametrize("metric", sorted(TABLE["planes"]))
def test_planes_of_metric(metric):
    from repro_torch.core.metrics import get_metrics
    from repro_torch.core.planner import plan_single
    from repro_torch.kernels.scan_codegen import lower
    pln = plan_single(get_metrics([metric])[0])
    dag = lower(pln.program, pln.n_counters, pln.sketch_specs)
    assert list(dag.planes) == TABLE["planes"][metric]


def test_full_set_reads_eleven_planes():
    from repro_torch.core.metrics import ALL_METRICS, get_metrics
    from repro_torch.core.planner import plan
    from repro_torch.kernels.scan_codegen import lower
    pln = plan(get_metrics(ALL_METRICS))
    dag = lower(pln.program, pln.n_counters, pln.sketch_specs)
    union = sorted({p for m in ALL_METRICS for p in TABLE["planes"][m]})
    assert list(dag.planes) == union and len(union) == 11
    assert TABLE["bytes_per_plane"] * 13 == TABLE["row_bytes"] == 52
