"""The port's sharded LM (``repro_torch.models.transformer`` under
``mesh=``/``policy=``: FSDP, tensor- and expert-parallel) against the
port on one device and against the JAX package on one device.

Each case runs its four ranks once (gloo over the CPU, ``launch_ranks``)
on a ``(data, model)`` mesh of ``make_host_mesh`` with
``ShardingPolicy(fsdp=True)``, for each of the five SMOKE configs on
(2, 2) and (1, 4) (the MoE configs, granite and deepseek, in
``tests/test_torch_mesh_moe.py``): ``forward`` of a 4 × 12 batch, ``prefill`` and three
``decode_step``s (past 2,048 positions, so that the cache's sequence
shards over "model" and decode runs split-KV, for gemma on (2, 2) and
deepseek's MLA on (1, 4)), the gradient of the first training batch, and
three AdamW steps. The ranks write their outputs, gathered whole, to a
file; the references run here.

The JAX package's sharded transformer fails its own test on the
installed JAX (ROADMAP §C), so both references are single-device. MoE
capacity counts each data shard's tokens: the configs run at a capacity
of E/top_k slots an expert, which drops nothing, so the sharded logits
equal the one-device run's on the whole batch. The aux loss is each data
shard's, averaged over the data shards: it is held to the mean of the
one-device aux over the shards' rows, and a train step to the one-device
step with ``grad_accum`` multiplied by the data shards (each shard's rows
its microbatches).

Tolerances. Against the port on one device: logits, caches, aux and the
losses of the three steps within 1e-5 relative (``rtol=1e-5`` and an
``atol`` of 1e-5 of the tensor's largest magnitude: other reduction
orders of the same float32 sums); every gradient leaf of the first batch
no farther from the same gradient computed in float64 (the port on one
device, ``dtype`` and weights float64) than the one-device float32
gradient is, plus 1e-5 relative L2, and each of its elements within
``tests/test_torch_train.py``'s tolerance of the one-device gradient. The
float32 gradients are themselves up to 2.9e-5 relative L2 from float64
(deepseek's ``wq_b``, where the sharded one is 2.1e-5 from it), so two
float32 orders of the same sums cannot be held to 1e-5 of each other. AdamW's first moment after three steps, and everything against
JAX, at ``tests/test_torch_models.py``'s and ``tests/test_torch_train.py``'s
tolerances: Adam's g/sqrt(v) turns a last-bit difference of a tiny
gradient into a different step; the first moment is held to the port on
one device only, which ``tests/test_torch_train.py`` holds to JAX, since
against JAX the two packages' sign flips add up (deepseek on (1, 4): one
element of ``embed``'s 8,192 off by 1.72e-6 against an ``atol`` of
1.53e-6, while the port on one device is within it). Against JAX the
test holds the losses of the three steps and every gradient leaf of the
first batch. The 2,050-token prompts' prefill and
decode logits and caches are held to JAX at an ``atol`` of 5e-5 of the
largest magnitude (``LONG_ATOL``): there the port on one device differs
from JAX by up to 2.0e-5 of it already (deepseek's logits: 1.01e-4 of
4.97, three elements past the 1e-5 of short prompts), float32 rounding
of attention over 2,050 positions in XLA's and ATen's orders.
"""
import dataclasses
import functools
import os
import pickle
import tempfile
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import transformer as jtf

from repro_torch.launch.mesh import launch_ranks
from repro_torch.models import transformer as tf
from repro_torch.models.convert import (cache_to_numpy,
                                        transformer_from_numpy,
                                        transformer_to_numpy)
from repro_torch.optim import AdamW

from test_torch_models import SMOKES, assert_close, jax_params, port_config
from test_torch_train import (GRAD_ATOL, GRAD_LEAF_ATOL, GRAD_RTOL,
                              assert_trees_close, jax_run)

BATCH, SEQ, STEPS, LR = 4, 12, 3, 1e-3
LONG_PROMPT = 2050            # > 2,048: the cache's sequence shards
LONG_ATOL = 5e-5              # of the largest magnitude, long prompts vs JAX
DEADLINE = 300.0

# each config's overrides (covering remat, grad_accum and loss_chunk) and
# prompt length; every config runs on both meshes, in one launch of ranks
ARCHS = {
    "qwen2.5-14b": (dict(remat="full", grad_accum=2), 8),
    "internlm2-20b": (dict(loss_chunk=0), 8),
    "gemma3-12b": (dict(remat="dots"), LONG_PROMPT),
    "deepseek-v2-236b": (dict(grad_accum=2), LONG_PROMPT),
    "granite-moe-1b-a400m": (dict(remat="full"), 8),
}
MESHES = {"2x2": 2, "1x4": 4}          # name: size of the model axis

RANK = textwrap.dedent("""
    import pickle, sys
    import torch
    from repro_torch.dist.collectives import full_tensor
    from repro_torch.dist.sharding import ShardingPolicy, distribute_tree
    from repro_torch.launch.mesh import close_ranks, make_host_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import ParamTree
    from repro_torch.models.convert import (cache_to_numpy,
                                            transformer_from_numpy,
                                            transformer_to_numpy)
    from repro_torch.optim import AdamW
    from repro_torch.tree import tree_leaves, tree_map

    d = sys.argv[1]
    torch.set_num_threads(1)      # four ranks on the host's cores
    with open(d + "/in.pkl", "rb") as f:
        spec = pickle.load(f)
    cfg, tree = spec["cfg"], spec["tree"]
    dev = spec.get("device", "cpu")
    pol = ShardingPolicy(("data", "model"), fsdp=True)
    _, logical = tf.init_transformer(cfg, None)

    def T(a):
        return torch.from_numpy(a).to(dev)

    def full(x):
        return full_tensor(x).cpu()
    outs = {}
    for n_model in spec["meshes"]:
        mesh = make_host_mesh(n_model, device=dev)
        out = outs[n_model] = {}
        with torch.no_grad():
            sp = distribute_tree(transformer_from_numpy(cfg, tree, dev),
                                 logical, mesh, pol)
            lg, aux = tf.forward(cfg, sp, T(spec["toks"]), mesh=mesh,
                                 policy=pol)
            out["forward"] = full(lg).numpy()
            out["aux"] = float(aux)
            p = spec["prompt"]
            lg, cache = tf.prefill(cfg, sp, T(p), spec["s_max"], mesh=mesh,
                                   policy=pol, logits_last_only=False)
            out["prefill"] = full(lg).numpy()
            out["seq_sharded"] = [t.placements[1].is_shard()
                                  for e in cache.values() for t in e.values()]
            out["decode"] = []
            for i, t in enumerate(spec["steps"]):
                lg, cache = tf.decode_step(cfg, sp, cache, T(t), p.shape[1] + i,
                                           mesh=mesh, policy=pol)
                out["decode"].append(full(lg).numpy())
            out["cache"] = cache_to_numpy(tree_map(full, cache))
        masters = transformer_from_numpy(cfg, tree, dev, trainable=True)
        sm = ParamTree(distribute_tree(masters, logical, mesh, pol),
                       requires_grad=True)
        del masters
        tf.accumulate_grads(cfg, sm, T(spec["train"][0]), mesh=mesh, policy=pol)
        out["grads"] = transformer_to_numpy(
            cfg, sm.tree(lambda q: full(q.grad)))
        sm.zero_grad(set_to_none=True)
        opt = AdamW(lr=spec["lr"])
        state = {"params": sm, "opt": opt.init(sm.tree()),
                 "step": torch.zeros((), dtype=torch.int32, device=dev)}
        step = tf.make_train_step(cfg, opt, mesh=mesh, policy=pol)
        out["losses"] = []
        for t in spec["train"]:
            state, m = step(state, {"tokens": T(t)})
            out["losses"].append((float(m["loss"]), float(m["aux_loss"])))
        out["m"] = transformer_to_numpy(cfg, tree_map(full,
                                                      state["opt"]["m"]))
        # the moments are placed like their weights
        out["m_placed"] = all(
            m.placements == q.placements for m, q in zip(
                tree_leaves(state["opt"]["m"]), tree_leaves(sm.tree(lambda q: q))))
    if torch.distributed.get_rank() == 0:
        with open(d + "/out.pkl", "wb") as f:
            pickle.dump(outs, f)
    close_ranks()
""")


def configs(arch):
    extra, prompt = ARCHS[arch]
    jcfg = dataclasses.replace(SMOKES[arch][0], **extra)
    if jcfg.moe:      # a capacity that drops nothing (module docstring)
        jcfg = dataclasses.replace(
            jcfg, capacity_factor=jcfg.n_experts / jcfg.top_k)
    return jcfg, port_config(jcfg), prompt


def inputs(cfg, prompt):
    """The batches (a long prompt in 2 rows: one a data shard on (2, 2))."""
    rng = np.random.default_rng(7)
    ints = lambda *s: rng.integers(0, cfg.vocab_size, s).astype(np.int32)
    rows = 2 if prompt == LONG_PROMPT else BATCH
    return {"toks": ints(BATCH, SEQ), "prompt": ints(rows, prompt),
            "steps": [ints(rows, 1) for _ in range(3)],
            "s_max": prompt + 6, "train": [ints(BATCH, SEQ)
                                           for _ in range(STEPS)]}


def run_ranks(spec) -> dict:
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "in.pkl"), "wb") as f:
            pickle.dump(spec, f)
        launch_ranks(4, ["-c", RANK, d], timeout=DEADLINE)
        with open(os.path.join(d, "out.pkl"), "rb") as f:
            return pickle.load(f)


def serve_references(jcfg, cfg, tree, spec):
    """forward (aux by number of data shards), prefill, decode and the
    final cache through the port and the JAX package on one device."""
    T = torch.from_numpy
    port, jx = {"aux": {}}, {"aux": {}}
    model = transformer_from_numpy(cfg, tree, "cpu")
    jp = jax.tree.map(jnp.asarray, tree)
    prompt = spec["prompt"].shape[1]
    with torch.no_grad():
        port["forward"] = tf.forward(cfg, model, T(spec["toks"]))[0].numpy()
        jx["forward"] = np.asarray(jtf.forward(
            jcfg, jp, jnp.asarray(spec["toks"]))[0])
        for n_data in (1, 2):
            port["aux"][n_data] = float(np.mean([
                float(tf.forward(cfg, model, t)[1])
                for t in T(spec["toks"]).chunk(n_data)]))
            jx["aux"][n_data] = float(np.mean([
                float(jtf.forward(jcfg, jp, jnp.asarray(t))[1])
                for t in np.split(spec["toks"], n_data)]))
        lg, cache = tf.prefill(cfg, model, T(spec["prompt"]), spec["s_max"],
                               logits_last_only=False)
        jl, jcache = jtf.prefill(jcfg, jp, jnp.asarray(spec["prompt"]),
                                 s_max=spec["s_max"], logits_last_only=False)
        port["prefill"], jx["prefill"] = lg.numpy(), np.asarray(jl)
        port["decode"], jx["decode"] = [], []
        for i, t in enumerate(spec["steps"]):
            lg, cache = tf.decode_step(cfg, model, cache, T(t), prompt + i)
            jl, jcache = jtf.decode_step(jcfg, jp, jcache, jnp.asarray(t),
                                         jnp.int32(prompt + i))
            port["decode"].append(lg.numpy())
            jx["decode"].append(np.asarray(jl))
        port["cache"] = cache_to_numpy(cache)
        jx["cache"] = jax.tree.map(np.asarray, jcache)
    return port, jx


def train_reference(cfg, tree, spec, n_data):
    """The first batch's gradient and three AdamW steps through the port
    on one device, with ``grad_accum`` times ``n_data``."""
    T = torch.from_numpy
    out = {}
    acfg = dataclasses.replace(cfg, grad_accum=cfg.grad_accum * n_data)
    masters = transformer_from_numpy(acfg, tree, "cpu", trainable=True)
    tf.accumulate_grads(acfg, masters, T(spec["train"][0]))
    out["grads"] = transformer_to_numpy(cfg, masters.tree(lambda p: p.grad))
    masters.zero_grad(set_to_none=True)
    f64 = dataclasses.replace(acfg, dtype=torch.float64,
                              param_dtype=torch.float64)
    exact = transformer_from_numpy(f64, tree, "cpu", trainable=True)
    for p in exact.parameters():
        p.data = p.data.double()
    tf.accumulate_grads(f64, exact, T(spec["train"][0]))
    out["grads_f64"] = transformer_to_numpy(cfg, exact.tree(lambda p: p.grad))
    opt = AdamW(lr=LR)
    state = {"params": masters, "opt": opt.init(masters.tree()),
             "step": torch.zeros((), dtype=torch.int32)}
    step = tf.make_train_step(acfg, opt)
    out["losses"] = []
    for t in spec["train"]:
        state, m = step(state, {"tokens": T(t)})
        out["losses"].append((float(m["loss"]), float(m["aux_loss"])))
    out["m"] = transformer_to_numpy(cfg, state["opt"]["m"])
    return out


def close_1e5(got, want, what):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        np.asarray(got, np.float32), want, rtol=1e-5,
        atol=1e-5 * max(float(np.abs(want).max(initial=0.0)), 1e-30),
        err_msg=what)


def grads_close(got, want, exact, what):
    """A gradient leaf against the port's on one device (``want``) and in
    float64 (``exact``): no farther from ``exact`` than ``want`` is, plus
    1e-5 relative L2; each element within ``tests/test_torch_train.py``'s
    tolerance of ``want``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    exact = np.asarray(exact, np.float64)
    err, own = (np.linalg.norm(got - exact), np.linalg.norm(want - exact))
    assert err <= own + 1e-5 * np.linalg.norm(exact), (what, err, own)
    np.testing.assert_allclose(
        got, want, rtol=GRAD_RTOL,
        atol=GRAD_ATOL + GRAD_LEAF_ATOL * float(np.abs(want).max(initial=0)),
        err_msg=what)


def _at(tree, path):
    for key in path:
        tree = tree[key.key if hasattr(key, "key") else key.idx]
    return tree


def trees_close(got, want, what, close):
    gl = jax.tree_util.tree_leaves_with_path(got)
    wl = jax.tree_util.tree_leaves_with_path(want)
    assert [jax.tree_util.keystr(p) for p, _ in gl] == \
        [jax.tree_util.keystr(p) for p, _ in wl], what
    for (path, g), (_, w) in zip(gl, wl):
        assert np.shape(g) == np.shape(w), (what, path)
        close(g, w, f"{what} {jax.tree_util.keystr(path)}")


@functools.lru_cache(maxsize=1)
def mesh_runs(arch):
    """One config on both meshes: (JAX config, port config, weights,
    inputs, the ranks' outputs by model axis size, the port's and JAX's
    one-device serving outputs)."""
    jcfg, cfg, prompt = configs(arch)
    tree = jax_params(jcfg)
    spec = {"cfg": cfg, "tree": tree, "meshes": list(MESHES.values()),
            "lr": LR, **inputs(cfg, prompt)}
    return (jcfg, cfg, tree, spec, run_ranks(spec),
            *serve_references(jcfg, cfg, tree, spec))


def check_arch_on_mesh(arch: str, mesh: str) -> None:
    """The ranks' outputs of ``arch`` on ``mesh`` against the port and
    JAX on one device (see the module docstring)."""
    jcfg, cfg, tree, spec, outs, port, jx = mesh_runs(arch)
    prompt = spec["prompt"].shape[1]
    n_data = 4 // MESHES[mesh]
    got = outs[MESHES[mesh]]
    ref = train_reference(cfg, tree, spec, n_data)

    # against the port on one device: 1e-5 relative
    for k in ("forward", "prefill"):
        close_1e5(got[k], port[k], k)
    np.testing.assert_allclose(got["aux"], port["aux"][n_data], rtol=1e-5,
                               atol=1e-7)
    for i, (g, w) in enumerate(zip(got["decode"], port["decode"])):
        close_1e5(g, w, f"decode {i}")
    trees_close(got["cache"], port["cache"], "cache", close_1e5)
    for path, g in jax.tree_util.tree_leaves_with_path(got["grads"]):
        grads_close(g, _at(ref["grads"], path), _at(ref["grads_f64"], path),
                    f"gradient {jax.tree_util.keystr(path)}")
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5,
                               atol=1e-7, err_msg="loss, aux of each step")
    assert_trees_close(got["m"], ref["m"], "first moment after 3 steps")
    # the long prompt's cache shards its sequence over "model"; the
    # moments are placed like their weights
    assert any(got["seq_sharded"]) == (prompt == LONG_PROMPT)
    assert got["m_placed"]

    # against the JAX package on one device
    assert_close(got["forward"], jx["forward"], "forward logits vs JAX")
    np.testing.assert_allclose(got["aux"], jx["aux"][n_data], rtol=1e-5,
                               atol=1e-7)
    close = (functools.partial(assert_close, atol=LONG_ATOL)
             if prompt == LONG_PROMPT else assert_close)
    close(got["prefill"], jx["prefill"], "prefill logits vs JAX")
    for i, w in enumerate(jx["decode"]):
        close(got["decode"][i], w, f"decode {i} vs JAX")
    trees_close(got["cache"], jx["cache"], "cache vs JAX", close)
    acfg = dataclasses.replace(jcfg, grad_accum=jcfg.grad_accum * n_data)
    want, _ = jax_run(acfg, tree, spec["train"])
    assert_trees_close(got["grads"], want[0][2], "gradient vs JAX")
    for i, ((gl, ga), (wl, wa, _)) in enumerate(zip(got["losses"], want)):
        np.testing.assert_allclose(gl, wl, rtol=1e-5,
                                   err_msg=f"loss {i} vs JAX")
        np.testing.assert_allclose(ga, wa, rtol=1e-5, atol=1e-7,
                                   err_msg=f"aux {i} vs JAX")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ["qwen2.5-14b", "internlm2-20b",
                                  "gemma3-12b"])
def test_sharded_lm_matches_one_device_and_jax(arch, mesh):
    check_arch_on_mesh(arch, mesh)


# --- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2.5-14b", "deepseek-v2-236b",
                                  "granite-moe-1b-a400m"])
def test_gpu_sharded_lm_on_the_card_matches_the_cpu(cuda, arch):
    """Four gloo ranks sharing the card on (2, 2) and (1, 4): the logits,
    cache, first gradient and first loss of the port on one CPU device,
    at ``tests/test_torch_models.py``'s and ``tests/test_torch_train.py``'s
    tolerances (the card's kernels add in other orders than the CPU's).
    The later steps' losses are not compared: Adam's sign steps carry the
    card's last-bit differences into the weights (deepseek's third loss
    1.5e-4 from the CPU's)."""
    jcfg, cfg, prompt = configs(arch)
    tree = jax_params(jcfg)
    spec = {"cfg": cfg, "tree": tree, "meshes": list(MESHES.values()),
            "lr": LR, "device": "cuda", **inputs(cfg, 8)}
    outs = run_ranks(spec)
    port, _ = serve_references(jcfg, cfg, tree, spec)
    for mesh, n_model in MESHES.items():
        got, n_data = outs[n_model], 4 // n_model
        ref = train_reference(cfg, tree, spec, n_data)
        for k in ("forward", "prefill"):
            assert_close(got[k], port[k], f"{mesh} {k}")
        for i, (g, w) in enumerate(zip(got["decode"], port["decode"])):
            assert_close(g, w, f"{mesh} decode {i}")
        trees_close(got["cache"], port["cache"], f"{mesh} cache",
                    assert_close)
        assert_trees_close(got["grads"], ref["grads"], f"{mesh} gradient")
        np.testing.assert_allclose(got["losses"][0], ref["losses"][0],
                                   rtol=1e-5, atol=1e-7,
                                   err_msg=f"{mesh} first loss, aux")
