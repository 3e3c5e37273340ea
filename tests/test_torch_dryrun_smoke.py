"""The LM archs', DIN's and the paper's ``_smoke`` against the JAX
smokes' returned values on the CPU, with the JAX smoke's own weights and
inputs carried across: each JAX smoke runs with its init (and, for the
LMs, ``jax.random.randint``) recorded, and the port's smoke is fed what
they returned (``weights=``, ``tokens=``); DIN's batches and the paper's
triples come from the same numpy generators in both. Losses at the train
tests' ``rtol=1e-5``; the paper's values at ``rel=1e-6`` (the HLL
estimates, ROADMAP §C). (The JAX smokes run op by op and take minutes on
the CPU, so they are spread over files: gemma3's and deepseek's in
``test_torch_dryrun_smoke_lm.py``, the GNNs' in
``test_torch_dryrun_smoke_gnn.py`` and ``..._equiformer.py``.)
"""
import jax
import numpy as np
import pytest

from repro.configs import REGISTRY as J_REGISTRY
from repro.core.evaluator import QualityEvaluator as JQE
from repro.models import din as JDIN
from repro.models import transformer as jtf

from repro_torch.configs import REGISTRY

LOSS_RTOL = 1e-5


def recorded(monkeypatch, owner, name: str) -> list:
    """Every value ``owner.name(...)`` returns from now on, in a list."""
    real, seen = getattr(owner, name), []

    def record(*args, **kwargs):
        seen.append(real(*args, **kwargs))
        return seen[-1]
    monkeypatch.setattr(owner, name, record)
    return seen


def check_lm_smoke(arch: str, monkeypatch) -> None:
    """``arch``'s smoke in the port, with the weights and tokens the JAX
    smoke drew, against the JAX smoke's loss."""
    inits = recorded(monkeypatch, jtf, "init_transformer")
    tokens = recorded(monkeypatch, jax.random, "randint")
    want = J_REGISTRY[arch].smoke()
    monkeypatch.undo()
    assert len(inits) == 1 and len(tokens) == 1
    got = REGISTRY[arch].smoke(
        device="cpu", weights=jax.tree.map(np.asarray, inits[0][0]),
        tokens=np.asarray(tokens[0]))
    assert set(got) == set(want) == {"loss"}
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "internlm2-20b",
                                  "granite-moe-1b-a400m"])
def test_lm_smoke_matches_jax(arch, monkeypatch):
    check_lm_smoke(arch, monkeypatch)


def test_lm_smoke_draws_its_own_weights():
    """Without ``weights`` the smoke draws seeded weights and tokens: the
    same loss twice, finite."""
    smoke = REGISTRY["granite-moe-1b-a400m"].smoke
    a, b = smoke(device="cpu"), smoke(device="cpu")
    assert a == b and np.isfinite(a["loss"])


def test_din_smoke_matches_jax(monkeypatch):
    """DIN's ``_smoke`` with the JAX smoke's weights (its ``init_din``
    recorded; the batches from the same numpy generator): the loss at
    ``rtol=1e-5``."""
    inits = recorded(monkeypatch, JDIN, "init_din")
    want = J_REGISTRY["din"].smoke()
    monkeypatch.undo()
    got = REGISTRY["din"].smoke(
        device="cpu", weights=jax.tree.map(np.asarray, inits[0][0]))
    assert set(got) == set(want) == {"loss"}
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)


def test_paper_smoke_matches_jax(monkeypatch):
    """The paper's ``_smoke``: ``{"metrics": 16}`` as JAX's, one pass, and
    the values of the JAX smoke's assessment (recorded), the HLL estimates
    at ``rel=1e-6`` (ROADMAP §C)."""
    results = recorded(monkeypatch, JQE, "assess")
    want = J_REGISTRY["dist-quality-assessment"].smoke()
    monkeypatch.undo()
    got = REGISTRY["dist-quality-assessment"].smoke(device="cpu")
    assert got["metrics"] == want["metrics"] == 16
    assert got["values"] == pytest.approx(results[0].values, rel=1e-6)
