"""The port's EquiformerV2 (``repro_torch.models.gnn.equiformer_v2``)
against the JAX package's: the SMOKE config with ``edge_chunks`` 1 and 4
(forward, loss, every gradient leaf, remat ``full`` against ``none``),
three train steps, bf16; and the port's own properties: the m-block path
against the dense ``_rotate`` / ``_so2_conv``, rotation and translation
invariance. The cases, helpers and tolerances are ``test_torch_gnn.py``'s
(its docstring states them).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.models.gnn import equiformer_v2 as TE
from repro_torch.models.gnn.common import (block_diagonal_batch, layer_of,
                                           scatter_sum, to_device)
from repro_torch.models.gnn.wigner import wigner_stack

from test_torch_gnn import (BF16_FWD_REL_L2, BF16_GRAD_REL_L2,
                            bf16_against_jax, bf16_jax_references,
                            check_against_jax, check_train_steps, flat,
                            rand_rotations, rel_l2)


@pytest.mark.parametrize("name", ["equiformer-v2", "equiformer-v2-chunks-4"])
def test_smoke_config_matches_jax(name):
    check_against_jax(name)


def test_train_steps_match_jax():
    check_train_steps("equiformer-v2")


def test_bf16_smoke_matches_jax():
    (out, loss, grads), (j_out, j_loss, j_grads) = bf16_against_jax(
        "equiformer-v2", bf16_jax_references(("equiformer-v2",)))
    assert rel_l2(out, j_out) <= BF16_FWD_REL_L2
    np.testing.assert_allclose(loss, j_loss, rtol=BF16_FWD_REL_L2)
    assert rel_l2(flat(grads), flat(j_grads)) <= BF16_GRAD_REL_L2


def small_config(**kw):
    return TE.EquiformerV2Config(n_layers=2, d_hidden=16, l_max=3, m_max=2,
                                 n_heads=2, d_feat=8, **kw)


def test_mblock_path_matches_the_dense_rotation_and_conv():
    """``_rotate_to_mblocks`` → ``_so2_conv_mblocks`` →
    ``_scatter_back_rotated`` (what ``forward`` runs) against the dense
    rotation of every (l, m), ``_so2_conv`` and the transposed rotation,
    summed to the nodes."""
    cfg = small_config()
    rng = np.random.default_rng(11)
    n, e, C = 10, 40, cfg.d_hidden
    model, _ = TE.init_equiformer(cfg, torch.Generator().manual_seed(0))
    so2 = layer_of(model["layers"], 1)["so2"]
    z = torch.from_numpy(rng.normal(size=(e, cfg.K, 2 * C)).astype(
        np.float32))
    rad = torch.from_numpy(rng.normal(size=(e, 2 * C)).astype(np.float32))
    D = wigner_stack(torch.from_numpy(rand_rotations(e, rng).astype(
        np.float32)), cfg.l_max)
    dst = torch.from_numpy(rng.integers(0, n, e))
    ev = torch.from_numpy((rng.random(e) < 0.9).astype(np.float32))
    with torch.no_grad():
        zb = TE._rotate_to_mblocks(z, D, cfg)
        rotated = TE._rotate(z, D, cfg)
        for m in range(cfg.m_max + 1):
            ip, im = cfg.m_indices(m)
            torch.testing.assert_close(zb[m][0], rotated[:, ip],
                                       rtol=1e-5, atol=1e-5)
            if m:
                torch.testing.assert_close(zb[m][1], rotated[:, im],
                                           rtol=1e-5, atol=1e-5)
        got = TE._scatter_back_rotated(
            TE._so2_conv_mblocks(zb, so2, rad, cfg), D, dst, n, ev, cfg)
        y = TE._rotate(TE._so2_conv(rotated, so2, rad, cfg), D, cfg,
                       transpose=True)
        want = scatter_sum(y * ev[:, None, None], dst, n)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        z0 = TE._rotate_m0(z, D, cfg)
        torch.testing.assert_close(z0, zb[0][0], rtol=0, atol=0)


def test_rotation_translation_invariance():
    rng = np.random.default_rng(3)
    cfg = TE.EquiformerV2Config(n_layers=2, d_hidden=16, l_max=4, m_max=2,
                                n_heads=4, d_feat=8)
    model, _ = TE.init_equiformer(cfg, torch.Generator().manual_seed(0))
    b = block_diagonal_batch(3, 8, 20, 8, rng, n_classes=1, with_pos=True)

    def run(positions):
        with torch.no_grad():
            return TE.forward(cfg, model, to_device(
                dataclasses.replace(b, positions=positions), "cpu"))
    out = run(b.positions)
    Q = rand_rotations(1, rng)[0]
    for moved in ((b.positions @ Q.T).astype(np.float32),
                  b.positions + np.float32([1, -2, 3])):
        rel = float((out - run(moved)).abs().max()
                    / (out.abs().max() + 1e-9))
        assert rel < 2e-3, rel


def test_edge_chunks_must_divide_the_edges():
    cfg = small_config(edge_chunks=7)
    model, _ = TE.init_equiformer(cfg, torch.Generator().manual_seed(0))
    b = block_diagonal_batch(3, 8, 20, 8, np.random.default_rng(0),
                             n_classes=1, with_pos=True)
    with pytest.raises(ValueError, match="60 edges"):
        TE.forward(cfg, model, to_device(b, "cpu"))
