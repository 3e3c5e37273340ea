"""EquiformerV2's ``_smoke`` against the JAX smoke's returned values on
the CPU, with the JAX smoke's weights carried across
(``test_torch_dryrun_smoke_gnn.py::check_gnn_smoke``): the loss at
``rtol=1e-5``; the equivariance error, a ratio of float32 noise, under
the smoke's bound in both. (A file of its own: the JAX smoke runs op by
op and takes over half a minute on the CPU.)
"""
from test_torch_dryrun_smoke_gnn import check_gnn_smoke


def test_equiformer_smoke_matches_jax(monkeypatch):
    check_gnn_smoke("equiformer-v2", monkeypatch)
