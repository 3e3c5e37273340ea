"""GatedGCN's, DimeNet's and GraphCast's ``_smoke`` against the JAX
smoke's returned values on the CPU, with the JAX smoke's weights carried
across: each JAX smoke runs with its model's ``init_*`` recorded, and the
port's smoke is fed what it returned (``weights=``); the inputs come from
the same numpy generators in both. Losses at the GNN tests' ``rtol=1e-5``
(``test_torch_gnn.py``). EquiformerV2's is in
``test_torch_dryrun_smoke_equiformer.py``: the JAX smokes run op by op,
and the four together take over a minute on one worker.
"""
import jax
import numpy as np
import pytest

from repro.configs import REGISTRY as J_REGISTRY
from repro.models.gnn import dimenet as JD
from repro.models.gnn import equiformer_v2 as JE
from repro.models.gnn import gatedgcn as JG
from repro.models.gnn import graphcast as JGC

from repro_torch.configs import REGISTRY

LOSS_RTOL = 1e-5
EQUIVARIANCE_TOL = 2e-3        # the JAX smoke's bound
INITS = {"gatedgcn": (JG, "init_gatedgcn"), "dimenet": (JD, "init_dimenet"),
         "equiformer-v2": (JE, "init_equiformer"),
         "graphcast": (JGC, "init_graphcast")}


def recorded(monkeypatch, owner, name: str) -> list:
    """Every value ``owner.name(...)`` returns from now on, in a list."""
    real, seen = getattr(owner, name), []

    def record(*args, **kwargs):
        seen.append(real(*args, **kwargs))
        return seen[-1]
    monkeypatch.setattr(owner, name, record)
    return seen


def check_gnn_smoke(arch: str, monkeypatch) -> None:
    """``arch``'s smoke in the port, with the weights the JAX smoke drew,
    against the JAX smoke's returned values."""
    inits = recorded(monkeypatch, *INITS[arch])
    want = J_REGISTRY[arch].smoke()
    monkeypatch.undo()
    assert len(inits) == 1
    got = REGISTRY[arch].smoke(
        device="cpu", weights=jax.tree.map(np.asarray, inits[0][0]))
    assert set(got) == set(want)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    if "equivariance_rel_err" in want:
        assert max(got["equivariance_rel_err"],
                   want["equivariance_rel_err"]) < EQUIVARIANCE_TOL


@pytest.mark.parametrize("arch", ["gatedgcn", "dimenet", "graphcast"])
def test_gnn_smoke_matches_jax(arch, monkeypatch):
    check_gnn_smoke(arch, monkeypatch)
