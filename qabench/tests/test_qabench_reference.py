"""The reference against the port's plain torch backend, metric by metric
and for the full report: counters and HLL registers exactly, values to
float32 rounding of the port's estimator. The test imports the port; the
reference does not."""
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from qabench import reference
from qabench.harness import planes as gen
from qabench.harness import spec
from qabench.reference import hll

from conftest import ROOT

ALL = ("L1", "L2", "I2", "U1", "RC1", "SV3", "CN2", "I1", "SV1", "SV2",
       "V1", "IO1", "CS1", "CM1", "CN2_EXACT", "SCH1")
N, PAD = 40_000, 37


@pytest.fixture(scope="module")
def rows():
    cfg = dict(spec.load_cell("bsbm_20gb.report_all").config, triples=N)
    x = gen.make_planes(cfg, 12345, "cpu", block_rows=1 << 14)
    # zero rows are padding: invisible to every counter and sketch
    return torch.cat([x, torch.zeros((PAD, 13), dtype=torch.int32)])


def port(rows, names):
    from repro_torch.core.evaluator import QualityEvaluator
    from repro_torch.rdf.triple_tensor import TripleTensor
    ev = QualityEvaluator(list(names), backend="torch", device="cpu")
    return ev.assess(TripleTensor(rows.numpy(), N))


def held(names, rows, block_rows):
    ref = reference.for_set(reference.assess(rows, names, 12,
                                             block_rows=block_rows), names)
    got = port(rows, names)
    assert got.counts == ref.counts
    assert set(got.registers) == set(ref.registers)
    for s, r in ref.registers.items():
        assert np.array_equal(got.registers[s], r)
    for m, v in ref.values.items():
        assert got.values[m] == pytest.approx(v, rel=1e-5, abs=0)


@pytest.mark.parametrize("metric", ALL)
def test_each_metric(rows, metric):
    held((metric,), rows, 1 << 13)


def test_report_all(rows):
    held(ALL, rows, 1 << 15)


def test_estimator_is_the_ports():
    from repro_torch.core import sketches
    rng = np.random.default_rng(3)
    for regs in (np.zeros(4096, np.int32),
                 rng.integers(0, 3, 4096).astype(np.int32),
                 rng.integers(0, 20, 4096).astype(np.int32)):
        want = float(sketches.hll_estimate(torch.from_numpy(regs)))
        assert hll.estimate(regs) == pytest.approx(want, rel=1e-5)


def test_reference_imports_no_port():
    code = ("import sys; sys.path.insert(0, %r); import qabench.reference;"
            " import qabench.reference.hll, qabench.reference.metrics;"
            " print(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'repro', 'repro_torch', 'jax', 'jaxlib', 'flax'}))"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    assert json.loads(out.stdout.strip().replace("'", '"')) == []


def test_control_is_coarser(rows):
    ctl = reference.assess(rows, ALL, 12, control=True)
    assert ctl["SCH1"].registers["p"].shape == (2048,)
