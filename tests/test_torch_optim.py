"""The port's AdamW and cosine schedule (``repro_torch.optim``) against the
JAX package's (``repro.optim``) on seeded random trees of dicts and lists.

Both sides compute in float32 with the same operations in the same order;
XLA's and ATen's transcendentals (``pow``, ``sqrt``, ``cos``) may differ in
the last bit, so parameters, moments and learning rates are held to
``rtol=1e-6``. Moments stored in bf16 are compared as float32.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.optim import AdamW as JAdamW, cosine_schedule as j_cosine

from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.tree import tree_leaves, tree_map

RTOL = 1e-6
SHAPES = {"a": (3, 4), "b": {"c": (5,), "d": (2, 3, 2)},
          "e": [(4,), (2, 2)]}


def random_tree(rng, scale):
    def draw(shape):
        if isinstance(shape, dict):
            return {k: draw(v) for k, v in shape.items()}
        if isinstance(shape, list):
            return [draw(v) for v in shape]
        return (scale * rng.normal(size=shape)).astype(np.float32)
    return draw(SHAPES)


def to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def assert_tree_close(got, want, what):
    got = [t.float().numpy() for t in tree_leaves(got)]
    want = [np.asarray(a, np.float32) for a in jax.tree.leaves(want)]
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=0,
                                   err_msg=f"{what} leaf {i}")


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", ["active", "inactive"])
@pytest.mark.parametrize("lr", ["constant", "cosine"])
def test_adamw_matches_jax(state_dtype, clip, lr):
    """Three updates from the same parameters and gradients: parameters,
    both moments and the count after each. Gradients of norm ~10 are
    clipped to 1; of norm ~0.1 they are not."""
    rng = np.random.default_rng(7)
    kw = dict(weight_decay=0.1, grad_clip=1.0)
    if lr == "cosine":
        kw_j = dict(kw, lr=j_cosine(1e-2, warmup=1, total=4))
        kw_t = dict(kw, lr=cosine_schedule(1e-2, warmup=1, total=4))
    else:
        kw_j = kw_t = dict(kw, lr=1e-2)
    jopt = JAdamW(**kw_j, state_dtype=getattr(jnp, state_dtype))
    topt = AdamW(**kw_t, state_dtype=getattr(torch, state_dtype))
    params = random_tree(rng, 1.0)
    jp = jax.tree.map(jnp.asarray, params)
    tp = to_torch(params)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    for i in range(3):
        grads = random_tree(rng, 3.0 if clip == "active" else 0.02)
        gnorm = np.sqrt(sum(float(np.sum(np.square(g)))
                            for g in jax.tree.leaves(grads)))
        assert (gnorm > 1.0) == (clip == "active")
        jp, jstate = jopt.update(jp, jax.tree.map(jnp.asarray, grads),
                                 jstate)
        tp, tstate = topt.update(tp, to_torch(grads), tstate)
        assert int(tstate["count"]) == int(jstate["count"]) == i + 1
        assert tstate["count"].dtype == torch.int32
        assert_tree_close(tp, jp, f"params after step {i + 1}")
        for k in ("m", "v"):
            assert all(t.dtype == getattr(torch, state_dtype)
                       for t in tree_leaves(tstate[k]))
            assert_tree_close(tstate[k], jstate[k],
                              f"{k} after step {i + 1}")


def test_adamw_state_has_the_jax_layout():
    """``init`` gives {"m": tree, "v": tree, "count": int32 0} shaped like
    the parameters, as the JAX optimizer's state."""
    params = random_tree(np.random.default_rng(0), 1.0)
    tstate = AdamW().init(to_torch(params))
    jstate = JAdamW().init(jax.tree.map(jnp.asarray, params))
    assert set(tstate) == set(jstate) == {"m", "v", "count"}
    assert tstate["count"].shape == () and int(tstate["count"]) == 0
    for k in ("m", "v"):
        got = [tuple(t.shape) for t in tree_leaves(tstate[k])]
        assert got == [a.shape for a in jax.tree.leaves(jstate[k])]


@pytest.mark.parametrize("peak,warmup,total", [(3e-4, 5, 40), (1e-2, 0, 1),
                                               (1.0, 10, 10)])
def test_cosine_schedule_matches_jax(peak, warmup, total):
    """The learning rate at counts 1..total+10 (past the end it stays at
    the floor)."""
    j, t = j_cosine(peak, warmup, total), cosine_schedule(peak, warmup, total)
    for c in range(1, total + 11):
        want = float(j(jnp.int32(c)))
        got = t(torch.tensor(c, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=RTOL, atol=0,
                                   err_msg=f"count {c}")
