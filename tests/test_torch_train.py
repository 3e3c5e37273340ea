"""The port's LM training (``repro_torch.models.transformer.
make_train_step``, ``repro_torch.optim``) against the JAX package's
(``repro.models.transformer.make_train_step``, ``repro.optim``): the
loss, the router's aux loss and every gradient leaf of the first step
(JAX's from ``jax.value_and_grad`` of its ``loss_fn``, read through an
optimizer that records the gradients it is given), and AdamW's first
moment after three steps, for the five in-repo ``SMOKE`` configs and
variants of them that cover ``remat`` none/full/dots, ``grad_accum`` 1/2
and ``loss_chunk`` 0/8 (a 12-token sequence: the chunked loss pads 12
labels to 16).

JAX weights reach the port through ``transformer_from_numpy(...,
trainable=True)``; the norms, zero at init, are set to seeded noise.
Both run in float32 on the CPU; JAX compiled. Tolerances: loss and aux
``rtol=1e-5``; gradients and moments ``rtol=1e-4`` and an ``atol`` of
1e-6 plus 3e-5 times the leaf's largest magnitude. The second term is the
float32 noise of a gradient summed from terms much larger than it: the
embedding's gradient comes back through RMSNorms of entries of 0.02, and
on these inputs the JAX package's own compiled and op-by-op
(``jax.disable_jit()``) gradients differ by up to 1.35e-5 of the leaf's
largest magnitude (6.1e-5 on deepseek's ``embed``, largest 4.51; 1.3e-5
on qwen's, largest 4.47), more than ``atol=1e-6`` alone allows. The first
moment after three steps is compared, not the weights: Adam's g/sqrt(v)
makes a tiny gradient's sign decide its weight's step
(``tests/test_transformer.py::test_grad_accumulation_equivalent``).

Tests marked ``gpu`` hold the card to the port on the CPU.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.optim import AdamW as JAdamW
from repro.models import transformer as jtf

from repro_torch.models import transformer as tf
from repro_torch.models.convert import (train_state_from_numpy,
                                        train_state_to_numpy,
                                        transformer_from_numpy,
                                        transformer_to_numpy)
from repro_torch.optim import AdamW
from repro_torch.tree import tree_map

from test_torch_models import SMOKES, jax_params, port_config

LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4
GRAD_LEAF_ATOL = 3e-5          # times the leaf's largest magnitude
BATCH, SEQ, STEPS, LR = 4, 12, 3, 1e-3

# (config, remat, grad_accum, loss_chunk): each of the five SMOKE configs
# twice, every value of each knob at least twice across them
CASES = {
    "qwen-none-1-0": ("qwen2.5-14b", "none", 1, 0),
    "qwen-full-2-8": ("qwen2.5-14b", "full", 2, 8),
    "internlm-dots-1-8": ("internlm2-20b", "dots", 1, 8),
    "internlm-none-2-0": ("internlm2-20b", "none", 2, 0),
    "gemma-full-1-0": ("gemma3-12b", "full", 1, 0),
    "gemma-dots-2-8": ("gemma3-12b", "dots", 2, 8),
    "deepseek-none-1-8": ("deepseek-v2-236b", "none", 1, 8),
    "deepseek-full-2-0": ("deepseek-v2-236b", "full", 2, 0),
    "granite-dots-2-0": ("granite-moe-1b-a400m", "dots", 2, 0),
    "granite-full-1-8": ("granite-moe-1b-a400m", "full", 1, 8),
}


class JaxRecording:
    """A JAX optimizer whose state also keeps the gradients of its last
    update (jit-able: they travel in the state)."""

    def __init__(self, inner):
        self.inner = inner

    def init(self, params):
        return {"inner": self.inner.init(params),
                "grads": jax.tree.map(jnp.zeros_like, params)}

    def update(self, params, grads, state):
        params, inner = self.inner.update(params, grads, state["inner"])
        return params, {"inner": inner, "grads": grads}


class PortRecording:
    """The port's counterpart: keeps copies of the gradients of each
    update."""

    def __init__(self, inner):
        self.inner = inner
        self.grads = []

    def init(self, params):
        return self.inner.init(params)

    def update(self, params, grads, state):
        self.grads.append(tree_map(lambda g: g.detach().clone(), grads))
        return self.inner.update(params, grads, state)


def batches(vocab, n=STEPS, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32)
            for _ in range(n)]


def case_configs(case):
    arch, remat, accum, chunk = CASES[case]
    jcfg = dataclasses.replace(SMOKES[arch][0], remat=remat,
                               grad_accum=accum, loss_chunk=chunk)
    return jcfg, port_config(jcfg)


def jax_run(jcfg, tree, toks):
    """STEPS JAX train steps: per step (loss, aux, grads); the final m."""
    opt = JaxRecording(JAdamW(lr=LR))
    jp = jax.tree.map(jnp.asarray, tree)
    state = {"params": jp, "opt": opt.init(jp), "step": jnp.int32(0)}
    step = jax.jit(jtf.make_train_step(jcfg, opt))
    out = []
    for t in toks:
        state, m = step(state, {"tokens": jnp.asarray(t)})
        out.append((float(m["loss"]), float(m["aux_loss"]),
                    jax.tree.map(np.asarray, state["opt"]["grads"])))
    assert int(state["step"]) == len(toks)
    return out, jax.tree.map(np.asarray, state["opt"]["inner"]["m"])


def port_run(cfg, tree, toks, device="cpu"):
    """The same through the port, on ``device``."""
    opt = PortRecording(AdamW(lr=LR))
    model = transformer_from_numpy(cfg, tree, device, trainable=True)
    state = {"params": model, "opt": opt.init(model.tree()),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    step = tf.make_train_step(cfg, opt)
    out = []
    for i, t in enumerate(toks):
        state, m = step(state, {"tokens": torch.from_numpy(t).to(device)})
        out.append((float(m["loss"]), float(m["aux_loss"]),
                    transformer_to_numpy(cfg, opt.grads[i])))
    assert int(state["step"]) == len(toks)
    return out, transformer_to_numpy(cfg, state["opt"]["m"]), state


def assert_trees_close(got, want, what):
    """Same leaf names and shapes, then each leaf within tolerance (see
    the module docstring)."""
    gl = jax.tree_util.tree_leaves_with_path(got)
    wl = jax.tree_util.tree_leaves_with_path(want)
    assert [(jax.tree_util.keystr(p), a.shape) for p, a in gl] == \
        [(jax.tree_util.keystr(p), a.shape) for p, a in wl], what
    for (path, g), (_, w) in zip(gl, wl):
        w = np.asarray(w, np.float32)
        atol = GRAD_ATOL + GRAD_LEAF_ATOL * float(np.abs(w).max(initial=0))
        np.testing.assert_allclose(
            g, w, atol=atol, rtol=GRAD_RTOL,
            err_msg=f"{what} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("case", list(CASES))
def test_train_steps_match_jax(case):
    jcfg, cfg = case_configs(case)
    tree = jax_params(jcfg)
    toks = batches(cfg.vocab_size)
    want, want_m = jax_run(jcfg, tree, toks)
    got, got_m, _ = port_run(cfg, tree, toks)
    # the first step: loss, aux and every gradient leaf at JAX's weights
    (gl, ga, gg), (wl, wa, wg) = got[0], want[0]
    np.testing.assert_allclose(gl, wl, rtol=LOSS_RTOL, err_msg="loss")
    np.testing.assert_allclose(ga, wa, rtol=LOSS_RTOL, atol=1e-7,
                               err_msg="aux")
    assert_trees_close(gg, wg, "gradient")
    # every step's loss, then the first moment after the last
    for i, ((gl, ga, _), (wl, wa, _)) in enumerate(zip(got, want)):
        np.testing.assert_allclose(gl, wl, rtol=LOSS_RTOL,
                                   err_msg=f"loss of step {i}")
    assert_trees_close(got_m, want_m, "first moment after 3 steps")


@pytest.mark.parametrize("arch", list(SMOKES))
def test_gradient_tree_has_the_jax_names_and_shapes(arch):
    """Every master weight gets a gradient, and the gradient tree, stacked
    by ``transformer_to_numpy``, has the JAX parameter tree's leaf names
    and shapes."""
    jcfg, cfg = SMOKES[arch]
    jp, _ = jtf.init_transformer(jcfg, jax.random.key(0))
    model, _ = tf.init_transformer(cfg, torch.Generator().manual_seed(0),
                                   trainable=True)
    assert all(p.requires_grad and p.dtype == torch.float32
               for p in model.parameters())
    tf.accumulate_grads(cfg, model, torch.from_numpy(
        batches(cfg.vocab_size, 1)[0]))
    assert all(p.grad is not None for p in model.parameters())
    grads = transformer_to_numpy(cfg, model.tree(lambda p: p.grad))
    got = [(jax.tree_util.keystr(p), a.shape)
           for p, a in jax.tree_util.tree_leaves_with_path(grads)]
    want = [(jax.tree_util.keystr(p), a.shape)
            for p, a in jax.tree_util.tree_leaves_with_path(jp)]
    assert got == want


def test_remat_leaves_gradients_unchanged():
    """remat full and dots recompute the same graph: the gradients of
    granite's SMOKE (MoE) equal remat none's."""
    base = dataclasses.replace(SMOKES["granite-moe-1b-a400m"][1],
                               loss_chunk=8)
    toks = torch.from_numpy(batches(base.vocab_size, 1)[0])
    grads = {}
    for remat in ("none", "full", "dots"):
        cfg = dataclasses.replace(base, remat=remat)
        model, _ = tf.init_transformer(
            cfg, torch.Generator().manual_seed(0), trainable=True)
        tf.accumulate_grads(cfg, model, toks)
        grads[remat] = [p.grad for p in model.parameters()]
    for remat in ("full", "dots"):
        for g, w in zip(grads[remat], grads["none"]):
            torch.testing.assert_close(g, w, atol=1e-7, rtol=1e-6)


def test_masters_stay_float32_under_bf16_compute():
    """granite's layout (float32 parameters, bf16 compute): the step casts
    the masters to bf16 where autograd sees it, the gradients and the
    moments are float32, and an update below bf16's resolution still
    moves the float32 masters."""
    cfg = dataclasses.replace(SMOKES["granite-moe-1b-a400m"][1],
                              dtype=torch.bfloat16)
    model, _ = tf.init_transformer(cfg, torch.Generator().manual_seed(0),
                                   trainable=True)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = AdamW(lr=1e-6)
    state = {"params": model, "opt": opt.init(model.tree()),
             "step": torch.zeros((), dtype=torch.int32)}
    seen = []
    real = opt.update

    class Spy:
        def update(self, params, grads, st):
            seen.extend(grads[k].dtype for k in ("embed", "unembed"))
            return real(params, grads, st)
    state, m = tf.make_train_step(cfg, Spy())(
        state, {"tokens": torch.from_numpy(batches(cfg.vocab_size, 1)[0])})
    assert np.isfinite(float(m["loss"]))
    assert seen == [torch.float32, torch.float32]
    for n, p in model.named_parameters():
        assert p.dtype == torch.float32, n
        assert (p.detach() != before[n]).any(), n
    # a step of ~1e-6 is below bf16's resolution of these weights: stored
    # in bf16, nearly every one would read as before
    w, w0 = model["blocks"][0]["attn"]["wq"].detach(), before[
        "blocks.0.attn.wq"]
    assert (w != w0).float().mean() > 0.95
    assert (w.bfloat16() == w0.bfloat16()).float().mean() > 0.95


def test_train_state_round_trips_through_the_jax_layout():
    """A state after a step, to numpy (the JAX launcher's keys, layer
    stacks leading) and back, bit for bit; the JAX state tree has the same
    structure."""
    jcfg, cfg = SMOKES["gemma3-12b"]
    tree = jax_params(jcfg)
    _, _, state = port_run(cfg, tree, batches(cfg.vocab_size, 1))
    flat = train_state_to_numpy(cfg, state)
    jp = jax.tree.map(jnp.asarray, tree)
    jstate = {"params": jp, "opt": JAdamW().init(jp), "step": jnp.int32(0)}
    assert jax.tree.structure(flat) == jax.tree.structure(
        jax.tree.map(np.asarray, jstate))
    assert flat["step"].dtype == flat["opt"]["count"].dtype == np.int32
    back = train_state_from_numpy(cfg, flat, "cpu")
    for a, b in zip(jax.tree.leaves(flat),
                    jax.tree.leaves(train_state_to_numpy(cfg, back))):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert all(p.requires_grad for p in back["params"].parameters())


def test_trainable_weights_own_their_memory():
    """Training writes the masters and moments in place: those read from
    numpy arrays (a JAX tree, a checkpoint) are copies, so the arrays stay
    as they were."""
    jcfg, cfg = SMOKES["qwen2.5-14b"]
    tree = jax_params(jcfg)
    before = jax.tree.map(np.copy, tree)
    _, _, state = port_run(cfg, tree, batches(cfg.vocab_size, 1))
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(before)):
        assert np.array_equal(a, b)
    flat = train_state_to_numpy(cfg, state)
    kept = jax.tree.map(np.copy, flat)
    back = train_state_from_numpy(cfg, flat, "cpu")
    tf.make_train_step(cfg, AdamW(lr=LR))(back, {"tokens": torch.from_numpy(
        batches(cfg.vocab_size, 1)[0])})
    for a, b in zip(jax.tree.leaves(flat), jax.tree.leaves(kept)):
        assert np.array_equal(a, b)


def test_import_pulls_in_no_jax():
    code = ("import sys, repro_torch.optim, repro_torch.launch.train, "
            "repro_torch.models.convert\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'repro' "
            "or m.startswith('repro.'))\n"
            "print(bad)")
    env = {**os.environ, "PYTHONPATH": "src"}
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True).stdout
    assert out.strip() == "[]"


def test_num_active_params_matches_jax():
    """granite FULL: 504,159,232 of its 1,410,128,896 parameters touch a
    token (8 of 32 experts)."""
    for jcfg, cfg in SMOKES.values():
        assert cfg.num_active_params() == jcfg.num_active_params()
    from repro.configs import granite_moe_1b as jg
    from repro_torch.configs import granite_moe_1b as g
    assert g.FULL.num_active_params() == jg.FULL.num_active_params() \
        == 504_159_232


# --- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_gpu_train_steps_match_the_cpu(cuda, case):
    """Float32 steps on the card and on the CPU from the same weights (TF32
    off, PyTorch's default for matmuls): the first step's gradients and
    first moment, and the losses of three steps. The moments after three
    steps are not held here: a weight whose gradient is rounding noise
    steps by ±lr either way (Adam's g/sqrt(v)), and deepseek's embedding,
    read through RMSNorms of entries of 0.02, turns that into third-step
    moments several times the tolerance apart."""
    assert not torch.backends.cuda.matmul.allow_tf32
    jcfg, cfg = case_configs(case)
    tree = jax_params(jcfg)
    toks = batches(cfg.vocab_size)
    want, want_m, _ = port_run(cfg, tree, toks[:1])
    got, got_m, _ = port_run(cfg, tree, toks[:1], device=cuda)
    assert_trees_close(got[0][2], want[0][2], "gradient")
    assert_trees_close(got_m, want_m, "first moment after 1 step")
    want, _, _ = port_run(cfg, tree, toks)
    got, _, _ = port_run(cfg, tree, toks, device=cuda)
    for (gl, ga, _), (wl, wa, _) in zip(got, want):
        np.testing.assert_allclose(gl, wl, rtol=LOSS_RTOL)
        np.testing.assert_allclose(ga, wa, rtol=LOSS_RTOL, atol=1e-7)
