"""Training and bf16 of the port's GNN family against the JAX package's:
three steps of each config's train step (``repro_torch.configs.*_cfg.
train_step``) against JAX's ``value_and_grad`` and ``repro.optim.AdamW(
lr=1e-3, weight_decay=0.0).update`` (the losses, both moments and the
weights), GraphCast's SMOKE in bf16, and the JAX init's overflow of
GraphCast's BASE. The cases, helpers and
tolerances are ``test_torch_gnn.py``'s (its docstring states them);
EquiformerV2's are in ``test_torch_gnn_equiformer.py``.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import graphcast_cfg as j_graphcast_cfg
from repro.models.gnn import graphcast as JGC

from repro_torch.models.convert import gnn_from_numpy
from repro_torch.models.gnn import graphcast as TGC
from repro_torch.models.gnn.common import to_device

from test_torch_gnn import (BF16_BIAS_REL_L2, BF16_FWD_REL_L2,
                            BF16_GRAD_REL_L2, bf16_against_jax,
                            bf16_jax_references, check_train_steps, flat,
                            port_config, rel_l2)


@pytest.mark.parametrize("name", ["gatedgcn", "dimenet", "graphcast"])
def test_train_steps_match_jax(name):
    check_train_steps(name)


def test_bf16_graphcast_one_message_a_node_is_bit_identical():
    """GraphCast in bf16 where no scatter adds two messages: the same
    roundings at the same points, so the forward, the loss and every
    weight's gradient are bit-identical; a bias's gradient (a sum over
    rows: XLA's in bf16, the port's in float32) within
    ``BF16_BIAS_REL_L2``."""
    name = "graphcast-one-message"
    (out, loss, grads), (j_out, j_loss, j_grads) = bf16_against_jax(
        name, bf16_jax_references((name, "graphcast")))
    assert np.array_equal(out, j_out)
    assert loss == j_loss
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(j_grads),
                            jax.tree.leaves(grads)):
        if path[-1].idx == 1:                    # a bias: a sum over rows
            assert rel_l2(g, w) <= BF16_BIAS_REL_L2, path
        else:
            assert np.array_equal(g, w), path


def test_bf16_graphcast_smoke_matches_jax():
    (out, loss, grads), (j_out, j_loss, j_grads) = bf16_against_jax(
        "graphcast", bf16_jax_references(("graphcast-one-message",
                                          "graphcast")))
    assert rel_l2(out, j_out) <= BF16_FWD_REL_L2
    np.testing.assert_allclose(loss, j_loss, rtol=BF16_FWD_REL_L2)
    assert rel_l2(flat(grads), flat(j_grads)) <= BF16_GRAD_REL_L2


def test_jax_init_makes_base_graphcast_overflow_in_both_packages():
    """GraphCast's BASE (16 layers, d 512) with the JAX init as drawn, in
    float32, on a mesh of 42 nodes with ~49 edges each: each interaction
    layer multiplies the mesh state ~10-20×, the predictions reach 1.7e19
    and the loss overflows, in the JAX package and in the port alike (the
    reference's property: ``chip_smoke.py`` trains GraphCast with each
    processor MLP's last weight at 1/L of that scale); so scaled, the
    port's loss is finite."""
    jcfg = dataclasses.replace(j_graphcast_cfg.BASE, dtype=jnp.float32)
    jp, _ = JGC.init_graphcast(jcfg, jax.random.key(0))
    b = JGC.synth_batch(jcfg, 256, 2048, np.random.default_rng(0))
    j_out = np.asarray(jax.jit(lambda p: JGC.forward(jcfg, p, b))(jp))
    j_loss = float(jax.jit(lambda p: JGC.loss_fn(jcfg, p, b))(jp))
    cfg = port_config(jcfg)
    model = gnn_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
    tb = to_device(b, "cpu")
    with torch.no_grad():
        out = TGC.forward(cfg, model, tb).numpy()
        loss = TGC.loss_fn(cfg, model, tb).item()
        assert np.abs(j_out).max() > 1e15 and np.abs(out).max() > 1e15
        assert np.isinf(j_loss) and np.isinf(loss)
        # the same predictions, to 1e-3 of the largest
        np.testing.assert_allclose(out, j_out, rtol=1e-3,
                                   atol=1e-3 * np.abs(j_out).max())
        for k in ("proc_edge", "proc_node"):
            model[k][-1]["w"].mul_(1.0 / cfg.n_layers)
        assert np.isfinite(TGC.loss_fn(cfg, model, tb).item())
