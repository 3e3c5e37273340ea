"""The port's LM transformer (``repro_torch.models``) against the JAX
package's (``repro.models``): ``forward``, ``prefill`` (logits and caches)
and ``decode_step`` for the five in-repo ``SMOKE`` configs as they are
(padded heads included) and the variants of ``tests/test_transformer.py``,
``attend``'s chunked path, the MoE dispatch with dropped tokens, a JAX
cache continued by the port, and the building blocks.

JAX parameter trees are carried across with ``repro_torch.models.convert``;
the norms and biases, zero at init, are first set to seeded noise so that
they matter. The port runs on the CPU; JAX on the CPU, eagerly.

Tolerance (float32 on both sides, the same operations in different
kernels: XLA's and ATen's matmuls and transcendentals round differently
in the last bits, and a few layers carry it on): ``rtol=1e-4`` and an
``atol`` of 1e-5 times the compared tensor's largest magnitude (at least
1e-5), unless a test states otherwise.

Tests marked ``gpu`` hold the card to the port on the CPU with the same
weights; they skip where there is none.
"""
import copy
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import (deepseek_v2_236b as j_deepseek,
                           gemma3_12b as j_gemma, granite_moe_1b as j_granite,
                           internlm2_20b as j_internlm,
                           qwen2_5_14b as j_qwen)
from repro.dist.sharding import split_params as j_split_params
from repro.models import common as jc
from repro.models import transformer as jtf

from repro_torch import configs
from repro_torch.configs import (deepseek_v2_236b, gemma3_12b,
                                 granite_moe_1b, internlm2_20b, qwen2_5_14b)
from repro_torch.dist.sharding import split_params
from repro_torch.models import common as tc
from repro_torch.models import transformer as tf
from repro_torch.models.convert import (cache_from_numpy, cache_to_numpy,
                                        tensor_from_numpy, tensor_to_numpy,
                                        transformer_from_numpy)

ATOL, RTOL = 1e-5, 1e-4

SMOKES = {
    "qwen2.5-14b": (j_qwen.SMOKE, qwen2_5_14b.SMOKE),
    "internlm2-20b": (j_internlm.SMOKE, internlm2_20b.SMOKE),
    "gemma3-12b": (j_gemma.SMOKE, gemma3_12b.SMOKE),
    "deepseek-v2-236b": (j_deepseek.SMOKE, deepseek_v2_236b.SMOKE),
    "granite-moe-1b-a400m": (j_granite.SMOKE, granite_moe_1b.SMOKE),
}
FULLS = {
    "qwen2.5-14b": (j_qwen.FULL, qwen2_5_14b.FULL),
    "internlm2-20b": (j_internlm.FULL, internlm2_20b.FULL),
    "gemma3-12b": (j_gemma.FULL, gemma3_12b.FULL),
    "deepseek-v2-236b": (j_deepseek.FULL, deepseek_v2_236b.FULL),
    "granite-moe-1b-a400m": (j_granite.FULL, granite_moe_1b.FULL),
}

# tests/test_transformer.py's BASE and its variants
BASE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab_size=96, param_dtype=jnp.float32,
            dtype=jnp.float32, remat="none")
VARIANTS = {
    "qkv_bias": dict(BASE, qkv_bias=True),
    "gemma_local_global": dict(
        BASE, n_layers=6, local_global_ratio=2, local_window=8,
        qk_norm=True, post_norm=True, embed_scale=True, rope_theta=1e6,
        rope_theta_local=1e4),
    "mla_absorbed": dict(
        BASE, n_layers=3, attn_type="mla", q_lora_rank=32, kv_lora_rank=32,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
    "padded_heads": dict(BASE, n_heads=6, n_kv_heads=3, d_model=48,
                         head_dim=8, pad_heads_multiple=4),
    "moe": dict(BASE, moe=True, n_experts=8, top_k=2, d_ff_expert=32,
                capacity_factor=8.0),
}


def port_config(jcfg) -> tf.TransformerConfig:
    """The port's config with a JAX config's fields, dtypes mapped."""
    kw = {}
    for f in dataclasses.fields(jcfg):
        v = getattr(jcfg, f.name)
        if f.name in ("dtype", "param_dtype", "opt_state_dtype"):
            v = getattr(torch, np.dtype(v).name)
        kw[f.name] = v
    return tf.TransformerConfig(**kw)


def jax_params(jcfg, seed=0):
    """JAX weights as numpy, with the zero-initialized norms and biases set
    to seeded noise."""
    params, _ = jtf.init_transformer(jcfg, jax.random.key(seed))
    rng = np.random.default_rng(seed)

    def fill(a):
        a = np.asarray(a)
        if not a.any():
            a = (0.1 * rng.normal(size=a.shape)).astype(a.dtype)
        return a
    return jax.tree.map(fill, params)


def assert_close(got, want, what, atol=ATOL, rtol=RTOL):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               atol=atol * scale, rtol=rtol, err_msg=what)


def assert_caches_close(port_cache, jax_cache, what, close=assert_close):
    got = cache_to_numpy(port_cache)
    want = jax.tree.map(np.asarray, jax_cache)
    assert jax.tree.structure(got) == jax.tree.structure(want), what
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree.leaves(want)):
        assert g.shape == w.shape, (what, path)
        close(g, w, f"{what} {jax.tree_util.keystr(path)}")


def run_both(jcfg, cfg, n_steps=3, s0=12, batch=2, seed=0,
             close=assert_close):
    """forward, prefill and n_steps decode steps through both packages,
    each output held to JAX's by ``close(got, want, what)``."""
    tree = jax_params(jcfg, seed)
    jp = jax.tree.map(jnp.asarray, tree)
    model = transformer_from_numpy(cfg, tree, device="cpu")
    rng = np.random.default_rng(100 + seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, s0)).astype(np.int32)
    steps = [rng.integers(0, cfg.vocab_size, (batch, 1)).astype(np.int32)
             for _ in range(n_steps)]
    s_max = s0 + n_steps

    jf, jaux = jtf.forward(jcfg, jp, jnp.asarray(toks))
    tf_, taux = tf.forward(cfg, model, torch.from_numpy(toks))
    close(tf_, jf, "forward logits")
    close(taux, jaux, "forward aux")

    jl, jcache = jtf.prefill(jcfg, jp, jnp.asarray(toks), s_max=s_max,
                             logits_last_only=False)
    tl, tcache = tf.prefill(cfg, model, torch.from_numpy(toks), s_max=s_max,
                            logits_last_only=False)
    close(tl, jl, "prefill logits")
    assert_caches_close(tcache, jcache, "prefill cache", close)
    tlast, _ = tf.prefill(cfg, model, torch.from_numpy(toks), s_max=s_max)
    assert tlast.shape == (batch, 1, cfg.vocab_size)
    close(tlast, jl[:, -1:], "prefill last logits")

    for i, nt in enumerate(steps):
        jd, jcache = jtf.decode_step(jcfg, jp, jcache, jnp.asarray(nt),
                                     jnp.int32(s0 + i))
        td, tcache = tf.decode_step(cfg, model, tcache, torch.from_numpy(nt),
                                    s0 + i)
        close(td, jd, f"decode {i} logits")
        assert_caches_close(tcache, jcache, f"decode {i} cache", close)


# --- configs ------------------------------------------------------------------

@pytest.mark.parametrize("name", list(SMOKES))
@pytest.mark.parametrize("which", ["SMOKE", "FULL"])
def test_configs_equal_the_jax_configs(name, which):
    jcfg, cfg = (SMOKES if which == "SMOKE" else FULLS)[name]
    assert port_config(jcfg) == cfg
    assert configs.LM_ARCHS[name].FULL == FULLS[name][1]


@pytest.mark.parametrize("name", list(SMOKES))
def test_parameter_counts_equal_the_jax_counts(name):
    """The port's layout holds the JAX package's parameters, FULL counted
    on the meta device; Qwen2.5-14B with its padded heads is
    15,776,814,080."""
    for jcfg, cfg in (SMOKES[name], FULLS[name]):
        assert cfg.num_params() == jcfg.num_params()
    if name == "qwen2.5-14b":
        assert qwen2_5_14b.FULL.num_params() == 15_776_814_080


def test_lm_shapes_equal_the_jax_shapes():
    from repro.configs.lm_common import LM_SHAPES
    assert configs.LM_SHAPES == LM_SHAPES


# --- the model against JAX ----------------------------------------------------

@pytest.mark.parametrize("name", list(SMOKES))
def test_smoke_config_matches_jax(name):
    jcfg, cfg = SMOKES[name]
    run_both(jcfg, cfg)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_base_variant_matches_jax(variant):
    jcfg = jtf.TransformerConfig(name=variant, **VARIANTS[variant])
    run_both(jcfg, port_config(jcfg))


def test_gemma_prefill_shorter_than_the_window_matches_jax():
    """A prompt shorter than the local window (the ring's zero-padded
    branch), decoded past the window so the ring wraps."""
    jcfg, cfg = SMOKES["gemma3-12b"]
    run_both(jcfg, cfg, n_steps=6, s0=5, batch=1, seed=3)


def test_port_decodes_a_jax_prefill_cache():
    jcfg, cfg = SMOKES["gemma3-12b"]
    tree = jax_params(jcfg, 1)
    jp = jax.tree.map(jnp.asarray, tree)
    model = transformer_from_numpy(cfg, tree, device="cpu")
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    _, jcache = jtf.prefill(jcfg, jp, jnp.asarray(toks), s_max=13)
    tcache = cache_from_numpy(cfg, jax.tree.map(np.asarray, jcache), "cpu")
    for i in range(3):
        nt = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        jd, jcache = jtf.decode_step(jcfg, jp, jcache, jnp.asarray(nt),
                                     jnp.int32(10 + i))
        td, tcache = tf.decode_step(cfg, model, tcache, torch.from_numpy(nt),
                                    10 + i)
        assert_close(td, jd, f"decode {i} logits")
    assert_caches_close(tcache, jcache, "continued cache")


def test_jax_init_makes_a_deep_decode_disagree_in_both_packages():
    """Why ``chip_smoke.py`` serves its random LMs with q/k/v at fan-in
    scale (``fan_in_qkv``): the JAX init scales them by 1/sqrt(heads), so
    in a wide model the attention scores have a standard deviation of
    d/sqrt(H·Hkv) (90 here: d_model 1024, 16 and 8 heads), every softmax
    is about one key, and through 48 layers float32 rounding decides which.
    The JAX package's own decode then disagrees with its own forward as
    much as the port's does (0.2-0.4 relative L2 on this input), while at
    fan-in scale both agree to about 1e-6."""
    jcfg = jtf.TransformerConfig(
        name="deep", **dict(BASE, n_layers=48, d_model=1024, n_heads=16,
                            n_kv_heads=8, head_dim=16, d_ff=64,
                            vocab_size=128))
    cfg = port_config(jcfg)
    params, _ = jtf.init_transformer(jcfg, jax.random.key(0))
    tree = jax.tree.map(np.asarray, params)
    seq = np.random.default_rng(0).integers(0, 128, (1, 22)).astype(np.int32)

    def rel_l2(got, want):
        got, want = np.asarray(got), np.asarray(want)
        return float(np.linalg.norm(got - want) / np.linalg.norm(want))

    def decode_against_forward(tree):
        jp = jax.tree.map(jnp.asarray, tree)
        model = transformer_from_numpy(cfg, tree, device="cpu")
        jref, _ = jtf.forward(jcfg, jp, jnp.asarray(seq))
        tref, _ = tf.forward(cfg, model, torch.from_numpy(seq))
        _, jcache = jtf.prefill(jcfg, jp, jnp.asarray(seq[:, :16]), s_max=22)
        _, tcache = tf.prefill(cfg, model, torch.from_numpy(seq[:, :16]),
                               s_max=22)
        jerr, terr = [], []
        for pos in range(16, 22):
            nt = seq[:, pos:pos + 1]
            jd, jcache = jtf.decode_step(jcfg, jp, jcache, jnp.asarray(nt),
                                         jnp.int32(pos))
            td, tcache = tf.decode_step(cfg, model, tcache,
                                        torch.from_numpy(nt), pos)
            jerr.append(rel_l2(jd[:, 0], jref[:, pos]))
            terr.append(rel_l2(td[:, 0], tref[:, pos]))
        return max(jerr), max(terr)

    jax_err, port_err = decode_against_forward(tree)
    assert jax_err > 0.1 and port_err > 0.1, (jax_err, port_err)
    attn = dict(tree["blocks"]["attn"])
    for w in ("wq", "wk", "wv"):                 # (L, d, heads, head_dim)
        a = attn[w]
        attn[w] = a * np.float32(np.sqrt(a.shape[2] / a.shape[1]))
    jax_err, port_err = decode_against_forward(
        {**tree, "blocks": {**tree["blocks"], "attn": attn}})
    assert jax_err < 1e-4 and port_err < 1e-4, (jax_err, port_err)


def test_decode_past_the_cache_raises():
    cfg = qwen2_5_14b.SMOKE
    model, _ = tf.init_transformer(cfg, torch.Generator().manual_seed(0))
    cache, _ = tf.init_cache(cfg, 1, 4, device="cpu")
    with pytest.raises(ValueError, match="outside the cache"):
        tf.decode_step(cfg, model, cache, torch.zeros((1, 1), dtype=torch.int32),
                       4)


# --- attention, MoE and the building blocks ----------------------------------

@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("padded", [False, True])
def test_attend_chunked_matches_jax_chunked(window, padded):
    rng = np.random.default_rng(5)
    B, S, H, Hkv, D = 2, 96, 6, 2, 8
    q = rng.normal(size=(B, S, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    kv_map = np.array([0, 0, 0, 1, 1, 1], np.int32) if padded else None
    pos = np.arange(S)
    want = jc.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     kv_map=kv_map, q_pos=jnp.asarray(pos),
                     k_pos=jnp.asarray(pos), window=window, chunk=16)
    tpos = torch.from_numpy(pos)
    got = tc.attend(torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(v),
                    kv_map=None if kv_map is None
                    else torch.from_numpy(kv_map).long(),
                    q_pos=tpos, k_pos=tpos, window=window, chunk=16)
    assert_close(got, want, "chunked attend")
    dense = tc.attend(torch.from_numpy(q), torch.from_numpy(k),
                      torch.from_numpy(v),
                      kv_map=None if kv_map is None
                      else torch.from_numpy(kv_map).long(),
                      q_pos=tpos, k_pos=tpos, window=window)
    assert float((dense - got).abs().max()) < 1e-5


def test_attend_dense_mask_matches_jax():
    rng = np.random.default_rng(6)
    q = rng.normal(size=(2, 1, 4, 8)).astype(np.float32)
    k = rng.normal(size=(2, 20, 2, 8)).astype(np.float32)
    v = rng.normal(size=(2, 20, 2, 8)).astype(np.float32)
    mask = np.arange(20)[None, :] <= 13
    want = jc.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     jnp.asarray(mask), scale=0.3)
    got = tc.attend(torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(v), torch.from_numpy(mask), scale=0.3)
    assert_close(got, want, "masked attend")


@pytest.mark.parametrize("capacity_factor", [0.5, 1.0])
def test_moe_dispatch_with_drops_matches_jax(capacity_factor):
    """A capacity low enough that tokens are dropped: the port drops the
    same assignments (stable ranks) and gives the same y and aux."""
    jcfg = jtf.TransformerConfig(
        name="moe", **dict(BASE, moe=True, n_experts=8, top_k=2,
                           d_ff_expert=32, capacity_factor=capacity_factor))
    cfg = port_config(jcfg)
    rng = np.random.default_rng(0)
    T, d = 96, cfg.d_model
    x = rng.normal(size=(T, d)).astype(np.float32)
    router = (rng.normal(size=(d, 8)) * 0.3).astype(np.float32)
    # skewed routing: expert 0 oversubscribed
    router[:, 0] += 0.2
    wg = (rng.normal(size=(8, d, 32)) / 8).astype(np.float32)
    wu = (rng.normal(size=(8, d, 32)) / 8).astype(np.float32)
    wd = (rng.normal(size=(8, 32, d)) / 8).astype(np.float32)
    jy, jaux = jtf._moe_dispatch_local(
        jcfg, *map(jnp.asarray, (x, router, wg, wu, wd)), 0, 1)
    ty, taux = tf._moe_dispatch_local(
        cfg, *map(torch.from_numpy, (x, router, wg, wu, wd)))
    # tokens were dropped: some rows of y miss one of their two experts
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), -1)
    _, idx = jax.lax.top_k(probs, 2)
    counts = np.bincount(np.asarray(idx).reshape(-1), minlength=8)
    C = max(8, -(-int(np.ceil(T * 2 / 8 * capacity_factor)) // 8) * 8)
    assert counts.max() > C
    assert_close(ty, jy, "moe y")
    assert_close(taux, jaux, "moe aux")


def test_building_blocks_match_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 5, 16)).astype(np.float32)
    w = (0.1 * rng.normal(size=(16,))).astype(np.float32)
    assert_close(tc.rmsnorm(torch.from_numpy(x), torch.from_numpy(w)),
                 jc.rmsnorm(jnp.asarray(x), jnp.asarray(w)), "rmsnorm")
    pos = np.arange(7)
    for theta in (1e4, 1e6):
        jcos, jsin = jc.rope_freqs(16, theta, jnp.asarray(pos))
        tcos, tsin = tc.rope_freqs(16, theta, torch.from_numpy(pos))
        assert tcos.dtype == torch.float32
        assert_close(tcos, jcos, "rope cos")
        assert_close(tsin, jsin, "rope sin")
    xr = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    assert_close(tc.apply_rope(torch.from_numpy(xr), tcos[None, :, None],
                               tsin[None, :, None]),
                 jc.apply_rope(jnp.asarray(xr), jcos[None, :, None],
                               jsin[None, :, None]), "apply_rope")
    g, u = x, x[::-1].copy()
    for act in ("silu", "gelu"):
        assert_close(tc.swiglu(torch.from_numpy(g), torch.from_numpy(u), act),
                     jc.swiglu(jnp.asarray(g), jnp.asarray(u), act), act)
    logits = rng.normal(size=(2, 6, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 6))
    labels[0, :2] = -100
    for z in (0.0, 1e-3):
        assert_close(tc.softmax_xent(torch.from_numpy(logits),
                                     torch.from_numpy(labels), z),
                     jc.softmax_xent(jnp.asarray(logits),
                                     jnp.asarray(labels), z), "xent")
    qp, kp = np.arange(4, 10), np.arange(10)
    for window in (None, 3):
        assert np.array_equal(
            tc.causal_mask(torch.from_numpy(qp), torch.from_numpy(kp),
                           window).numpy(),
            np.asarray(jc.causal_mask(jnp.asarray(qp), jnp.asarray(kp),
                                      window)))


def test_bf16_weights_cross_bit_for_bit():
    a = np.asarray(jax.random.normal(jax.random.key(0), (5, 7), jnp.bfloat16))
    t = tensor_from_numpy(a, "cpu")
    assert t.dtype == torch.bfloat16
    assert np.array_equal(tensor_to_numpy(t), a.astype(np.float32))
    cfg = dataclasses.replace(qwen2_5_14b.SMOKE, dtype=torch.bfloat16,
                              param_dtype=torch.bfloat16)
    cache = {"blocks": {"k": np.asarray(a.astype(np.float32))}}
    back = cache_from_numpy(cfg, cache, "cpu")
    assert back["blocks"]["k"].dtype == torch.bfloat16
    assert np.array_equal(tensor_to_numpy(back["blocks"]["k"]),
                          a.astype(np.float32))


def test_granite_weights_are_stored_in_the_compute_dtype():
    """param_dtype float32, dtype bf16: weights are cast once at load; the
    norms keep float32 (rmsnorm reads them so) and the router float32."""
    cfg = dataclasses.replace(granite_moe_1b.FULL, n_layers=1, d_model=64,
                              n_heads=4, n_kv_heads=2, head_dim=16,
                              vocab_size=128, n_experts=4, top_k=2,
                              d_ff_expert=32)
    model, _ = tf.init_transformer(cfg, torch.Generator().manual_seed(0))
    dtypes = {n: p.dtype for n, p in model.named_parameters()}
    assert dtypes["embed"] == dtypes["blocks.0.attn.wq"] == torch.bfloat16
    assert dtypes["blocks.0.mlp.we_g"] == torch.bfloat16
    assert dtypes["blocks.0.mlp.router"] == torch.float32
    assert dtypes["blocks.0.ln1"] == dtypes["final_norm"] == torch.float32


def test_parameter_names_follow_the_jax_keys():
    cfg = gemma3_12b.SMOKE
    model, logical = tf.init_transformer(cfg, torch.Generator().manual_seed(0))
    names = dict(model.named_parameters())
    assert {"embed", "unembed", "final_norm", "blocks_local.1.0.attn.wq",
            "blocks_global.1.attn.qn", "blocks_global.0.ln2_post"} <= set(names)
    assert isinstance(model["blocks_local"], torch.nn.ModuleList)
    assert logical["blocks_local"][1][0]["attn"]["wq"] == (
        "embed", "q_heads", None)
    assert logical["embed"] == ("vocab", "embed")
    # the port's tree and the JAX tree, unstacked, hold the same keys
    jp, _ = jtf.init_transformer(j_gemma.SMOKE, jax.random.key(0))
    assert set(model.tree()) == set(jp)
    assert set(model.tree()["blocks_local"][0][0]["attn"]) == set(
        jp["blocks_local"]["attn"])


def test_split_params_matches_jax():
    tree = {"a": (np.zeros(2), ("x", None)),
            "b": [{"w": (np.ones(3), ()), "c": (np.ones(1), (None,))}],
            "t": ((np.zeros(1), ("y",)), (np.ones(1), ("z",)))}
    params, logical = split_params(tree)
    jparams, jlogical = j_split_params(tree)
    assert logical == jlogical
    assert jax.tree.structure(params) == jax.tree.structure(jparams)
    with pytest.raises(TypeError):
        split_params({"a": np.zeros(2)})


def test_import_pulls_in_no_jax():
    code = ("import sys, repro_torch.models.transformer, "
            "repro_torch.models.din, repro_torch.models.convert, "
            "repro_torch.launch.serve, repro_torch.configs, "
            "repro_torch.models.gnn.common, repro_torch.dist.sharding, "
            "repro_torch.models.gnn.gatedgcn, repro_torch.models.gnn.dimenet, "
            "repro_torch.models.gnn.equiformer_v2, "
            "repro_torch.models.gnn.graphcast, repro_torch.models.gnn.wigner, "
            "repro_torch.data.sampler, repro_torch.configs.gnn_common, "
            "repro_torch.configs.gatedgcn_cfg, repro_torch.configs.dimenet_cfg, "
            "repro_torch.configs.equiformer_v2_cfg, "
            "repro_torch.configs.graphcast_cfg, repro_torch.configs.base, "
            "repro_torch.configs.lm_common, repro_torch.configs.din_cfg, "
            "repro_torch.configs.paper_qa, repro_torch.launch.dryrun, "
            "repro_torch.launch.mesh\n"
            "from repro_torch.configs import ALL_ARCHS\n"
            "assert len(ALL_ARCHS) == 11, ALL_ARCHS\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'repro' "
            "or m.startswith('repro.'))\n"
            "print(bad)")
    env = {**os.environ, "PYTHONPATH": "src"}
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True).stdout
    assert out.strip() == "[]"


# --- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def card_against_cpu(cfg, cuda, n_steps=3, s0=12):
    """prefill and decode on the card and on the CPU with the same weights:
    (logits pairs, cache pairs)."""
    model, _ = tf.init_transformer(cfg, torch.Generator().manual_seed(0))
    on_card = copy.deepcopy(model).to(cuda)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (2, s0)).astype(np.int32))
    steps = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 1)))
             for _ in range(n_steps)]
    pairs = []
    lc, cc = tf.prefill(cfg, model, toks, s0 + n_steps,
                        logits_last_only=False)
    lg, cg = tf.prefill(cfg, on_card, toks.to(cuda), s0 + n_steps,
                        logits_last_only=False)
    pairs.append((lg, lc))
    for i, nt in enumerate(steps):
        lc, cc = tf.decode_step(cfg, model, cc, nt, s0 + i)
        lg, cg = tf.decode_step(cfg, on_card, cg, nt.to(cuda), s0 + i)
        pairs.append((lg, lc))
    return pairs, (cache_to_numpy(cg), cache_to_numpy(cc))


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(SMOKES))
def test_gpu_smoke_config_matches_the_cpu(cuda, name):
    """float32 on both; TF32 stays off (PyTorch's default for matmuls)."""
    assert not torch.backends.cuda.matmul.allow_tf32
    pairs, (cg, cc) = card_against_cpu(SMOKES[name][1], cuda)
    for i, (g, c) in enumerate(pairs):
        assert_close(g.cpu(), c, f"step {i}")
    for g, c in zip(jax.tree.leaves(cg), jax.tree.leaves(cc)):
        assert_close(g, c, "cache")


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(SMOKES))
def test_gpu_smoke_config_in_bf16_matches_the_cpu(cuda, name):
    """bf16 weights and activations on both: the card and the CPU round
    differently (bf16 keeps 8 bits), so the logits agree to a relative L2
    error of 2e-2 a step."""
    cfg = dataclasses.replace(SMOKES[name][1], dtype=torch.bfloat16,
                              param_dtype=torch.bfloat16)
    pairs, _ = card_against_cpu(cfg, cuda)
    for i, (g, c) in enumerate(pairs):
        g, c = g.cpu().float(), c.float()
        assert float((g - c).norm() / c.norm()) < 2e-2, i
