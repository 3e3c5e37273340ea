"""gemma3-12b's and deepseek-v2-236b's ``_smoke`` against the JAX smokes'
losses on the CPU, with the JAX smokes' weights and tokens carried across
(``test_torch_dryrun_smoke.py::check_lm_smoke``), at ``rtol=1e-5``. (A
file of its own: these two JAX smokes take over a minute on the CPU.)
"""
import pytest

from test_torch_dryrun_smoke import check_lm_smoke


@pytest.mark.parametrize("arch", ["gemma3-12b", "deepseek-v2-236b"])
def test_lm_smoke_matches_jax(arch, monkeypatch):
    check_lm_smoke(arch, monkeypatch)
