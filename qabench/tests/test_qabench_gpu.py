"""On the card: the reference against the port's scan kernels, and a
traced run of each cell cut to a few million rows. Run them there with
``python -m pytest -q -m gpu qabench/tests``."""
import time

import numpy as np
import pytest

from qabench import reference
from qabench.harness import cell as cell_mod
from qabench.harness import planes as gen

ALL = ("L1", "L2", "I2", "U1", "RC1", "SV3", "CN2", "I1", "SV1", "SV2",
       "V1", "IO1", "CS1", "CM1", "CN2_EXACT", "SCH1")


@pytest.mark.gpu
@pytest.mark.parametrize("sets", ["all", "each"])
def test_gpu_reference_matches_kernels(cuda, small_cell, sets):
    from repro_torch.core.evaluator import QualityEvaluator, run_single_shot
    from repro_torch.rdf.triple_tensor import TripleTensor
    cfg = small_cell("bsbm_20gb.report_all", 3_000_001).config
    planes = gen.make_planes(cfg, 2**31 + 3, cuda)
    ref = reference.assess(planes, ALL, 12, block_rows=1 << 20)
    tt = TripleTensor(planes.cpu().numpy(), planes.shape[0])
    for names in ([ALL] if sets == "all" else [(m,) for m in ALL]):
        got = run_single_shot(QualityEvaluator(list(names), device=cuda), tt)
        want = reference.for_set(ref, names)
        assert got.counts == want.counts
        for s, r in want.registers.items():
            assert np.array_equal(got.registers[s], r)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["bsbm_200gb.report_all",
                                  "bsbm_20gb.per_metric"])
def test_gpu_traced_run(cuda, small_cell, name):
    out = cell_mod.run(small_cell(name, 4_000_000), 2**31 + 5, 1.0, True,
                       device=cuda, t_start=time.perf_counter())
    assert out["correct"]
    assert 0 < out["metrics"]["scan_bw_share"]["value"] <= 100
    share = out["metrics"]["scan_bw_share"]["value"]
    assert 0 < share <= 100
    assert out["device"]["busy_s"] > 0
