"""The port's DIN (``repro_torch.models.din``), its GNN substrate
(``models.gnn.common``) and the serving launcher
(``repro_torch.launch.serve``) against the JAX package's.

JAX parameter trees are carried across with ``repro_torch.models.convert``;
inputs come from numpy generators, and ``synth_batch`` must give the same
arrays from the same generator. The port runs on the CPU.

Tolerance: float32 on both sides, the same operations in other kernels:
``atol=1e-5, rtol=1e-4`` on scores and losses; integer and index arrays,
and the greedy ids of ``serve_lm``, are equal.

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

from repro.configs import din_cfg as j_din_cfg, qwen2_5_14b as j_qwen
from repro.models import din as JDIN
from repro.models import transformer as jtf
from repro.models.gnn import common as jg

from repro_torch.configs import din_cfg, qwen2_5_14b
from repro_torch.launch import serve
from repro_torch.models import din as DIN
from repro_torch.models import transformer as tf
from repro_torch.models.convert import din_from_numpy, transformer_from_numpy
from repro_torch.models.gnn import common as tg

ATOL, RTOL = 1e-5, 1e-4
ENV = {**os.environ, "PYTHONPATH": "src"}


def small(n_items=200, n_cats=8):
    return (dataclasses.replace(JDIN.DINConfig(), n_items=n_items,
                                n_cats=n_cats),
            dataclasses.replace(DIN.DINConfig(), n_items=n_items,
                                n_cats=n_cats))


def both_models(jcfg, cfg, seed=1):
    jp, _ = JDIN.init_din(jcfg, jax.random.key(seed))
    tree = jax.tree.map(np.asarray, jp)
    # the biases, zero at init, set to seeded noise so that they matter
    rng = np.random.default_rng(seed)
    for part in ("attn", "final"):
        tree[part] = [(w, (0.1 * rng.normal(size=b.shape)).astype(b.dtype))
                      for w, b in tree[part]]
    return (jax.tree.map(jnp.asarray, tree),
            din_from_numpy(cfg, tree, device="cpu"))


def batch_of(jcfg, b, c, seed):
    return JDIN.synth_batch(jcfg, b, c, np.random.default_rng(seed),
                            reduced={"n_items": jcfg.n_items,
                                     "n_cats": jcfg.n_cats})


# --- configs and data ---------------------------------------------------------

@pytest.mark.parametrize("which", ["FULL", "SMOKE"])
def test_din_configs_equal_the_jax_configs(which):
    jcfg, cfg = getattr(j_din_cfg, which), getattr(din_cfg, which)
    for f in dataclasses.fields(jcfg):
        a, b = getattr(jcfg, f.name), getattr(cfg, f.name)
        if f.name.endswith("dtype"):
            assert b == getattr(torch, np.dtype(a).name)
        else:
            assert a == b, f.name
    assert din_cfg.DIN_SHAPES == j_din_cfg.DIN_SHAPES


def test_din_parameter_count():
    """FULL on the meta device: 10M × 18 + 10k × 18 table rows and the two
    MLPs, 180,232,842 parameters, as the JAX package counts."""
    assert din_cfg.FULL.num_params() == 180_232_842
    assert j_din_cfg.FULL.num_params() == 180_232_842
    assert din_cfg.SMOKE.num_params() == j_din_cfg.SMOKE.num_params()


@pytest.mark.parametrize("b,c,reduced", [(8, 1, None), (3, 17, None),
                                         (5, 2, {"n_items": 50})])
def test_synth_batch_equals_the_jax_arrays(b, c, reduced):
    jcfg, cfg = small()
    want = JDIN.synth_batch(jcfg, b, c, np.random.default_rng(4), reduced)
    got = DIN.synth_batch(cfg, b, c, np.random.default_rng(4), reduced)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k


# --- the model against JAX ----------------------------------------------------

@pytest.mark.parametrize("b,c", [(8, 1), (4, 6)])
def test_din_forward_and_loss_match_jax(b, c):
    jcfg, cfg = small()
    jp, model = both_models(jcfg, cfg)
    batch = batch_of(jcfg, b, c, seed=b)
    want = JDIN.forward(jcfg, jp, batch)
    got = DIN.forward(cfg, model, DIN.to_device(batch, "cpu"))
    assert got.shape == (b, c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(
        float(DIN.loss_fn(cfg, model, DIN.to_device(batch, "cpu"))),
        float(JDIN.loss_fn(jcfg, jp, batch)), atol=ATOL, rtol=RTOL)


def test_din_retrieval_matches_jax_and_per_candidate():
    jcfg, cfg = small()
    jp, model = both_models(jcfg, cfg, seed=2)
    batch = batch_of(jcfg, 1, 64, seed=2)
    want = np.asarray(JDIN.forward(jcfg, jp, batch))
    got = DIN.forward(cfg, model, DIN.to_device(batch, "cpu")).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    for c in range(0, 64, 9):
        one = {**batch, "cand_item": batch["cand_item"][:, c:c + 1],
               "cand_cat": batch["cand_cat"][:, c:c + 1],
               "labels": batch["labels"][:, c:c + 1]}
        single = DIN.forward(cfg, model, DIN.to_device(one, "cpu")).numpy()
        np.testing.assert_allclose(got[0, c], single[0, 0], atol=ATOL)


def test_din_masked_history_does_not_change_scores():
    jcfg, cfg = small(100, 10)
    _, model = both_models(jcfg, cfg)
    batch = batch_of(jcfg, 4, 1, seed=0)
    out1 = DIN.forward(cfg, model, DIN.to_device(batch, "cpu"))
    hist = batch["hist_items"].copy()
    masked = batch["hist_mask"] == 0
    hist[masked] = (hist[masked] + 7) % 100
    out2 = DIN.forward(cfg, model,
                       DIN.to_device({**batch, "hist_items": hist}, "cpu"))
    assert torch.equal(out1, out2)


def test_din_init_layout_and_logical_axes():
    cfg = din_cfg.SMOKE
    model, logical = DIN.init_din(cfg, torch.Generator().manual_seed(0))
    names = {n: tuple(p.shape) for n, p in model.named_parameters()}
    d = cfg.d_item
    assert names["item_table"] == (cfg.n_items, cfg.embed_dim)
    assert names["attn.0.w"] == (4 * d, 80) and names["attn.2.b"] == (1,)
    assert names["final.1.w"] == (200, 80)
    assert logical["item_table"] == ("table_rows", None)
    assert logical["attn"][1]["w"] == ("mlp", "mlp")
    _, jlogical = JDIN.init_din(JDIN.DINConfig(n_items=10, n_cats=5), None)
    assert [(lw, lb) for lw, lb in jlogical["final"]] == [
        (layer["w"], layer["b"]) for layer in logical["final"]]


# --- the GNN substrate --------------------------------------------------------

def test_scatter_ops_match_jax():
    rng = np.random.default_rng(3)
    msgs = rng.normal(size=(40, 5)).astype(np.float32)
    dst = rng.integers(0, 12, 40).astype(np.int32)
    dst[dst == 7] = 8              # node 7 receives nothing
    scores = rng.normal(size=(40,)).astype(np.float32)
    tm, td = torch.from_numpy(msgs), torch.from_numpy(dst)
    for jfn, tfn in ((jg.scatter_sum, tg.scatter_sum),
                     (jg.scatter_mean, tg.scatter_mean),
                     (jg.scatter_max, tg.scatter_max)):
        np.testing.assert_allclose(tfn(tm, td, 12).numpy(),
                                   np.asarray(jfn(msgs, dst, 12)),
                                   atol=ATOL, rtol=RTOL)
    ints = rng.integers(-5, 5, (40,)).astype(np.int32)
    assert np.array_equal(tg.scatter_max(torch.from_numpy(ints), td,
                                         12).numpy(),
                          np.asarray(jg.scatter_max(ints, dst, 12)))
    np.testing.assert_allclose(
        tg.segment_softmax(torch.from_numpy(scores), td, 12).numpy(),
        np.asarray(jg.segment_softmax(jnp.asarray(scores), dst, 12)),
        atol=ATOL, rtol=RTOL)
    h = rng.normal(size=(12, 3)).astype(np.float32)
    src = rng.integers(0, 12, 9)
    assert np.array_equal(tg.gather_src(torch.from_numpy(h),
                                        torch.from_numpy(src)).numpy(),
                          np.asarray(jg.gather_src(h, src)))


def test_mlp_matches_jax_and_init_mlp_layout():
    rng = np.random.default_rng(4)
    dims = (6, 5, 4, 2)
    pairs = [((rng.normal(size=(a, b))).astype(np.float32),
              rng.normal(size=(b,)).astype(np.float32))
             for a, b in zip(dims[:-1], dims[1:])]
    x = rng.normal(size=(3, 6)).astype(np.float32)
    layers = [{"w": torch.from_numpy(w), "b": torch.from_numpy(b)}
              for w, b in pairs]
    for final_act in (False, True):
        np.testing.assert_allclose(
            tg.mlp(layers, torch.from_numpy(x), final_act=final_act).numpy(),
            np.asarray(jg.mlp(pairs, x, final_act=final_act)),
            atol=ATOL, rtol=RTOL)
    got = tg.init_mlp(torch.Generator().manual_seed(0), dims, lead=(2,),
                      lead_logical=("layers",))
    want = jg.init_mlp(jax.random.key(0), dims, lead=(2,),
                       lead_logical=("layers",))
    for layer, ((jw, jlw), (jb, jlb)) in zip(got, want):
        assert tuple(layer["w"][0].shape) == jw.shape
        assert tuple(layer["b"][0].shape) == jb.shape
        assert (layer["w"][1], layer["b"][1]) == (jlw, jlb)
        assert not layer["b"][0].any()
    meta = tg.init_mlp(None, dims)
    assert meta[0]["w"][0].device.type == "meta"


@pytest.mark.parametrize("with_pos", [False, True])
def test_synthetic_graphs_equal_the_jax_arrays(with_pos):
    for fn in ("block_diagonal_batch", "random_graph"):
        args = (3, 5, 7, 4) if fn == "block_diagonal_batch" else (9, 20, 4)
        want = getattr(jg, fn)(*args, np.random.default_rng(8),
                               with_pos=with_pos)
        got = getattr(tg, fn)(*args, np.random.default_rng(8),
                              with_pos=with_pos)
        for f in dataclasses.fields(want):
            a, b = getattr(want, f.name), getattr(got, f.name)
            if isinstance(a, np.ndarray):
                assert np.array_equal(a, b), (fn, f.name)
            else:
                assert a == b, (fn, f.name)


# --- the serving launcher -----------------------------------------------------

def test_serve_lm_greedy_ids_equal_the_jax_loop():
    """The JAX launcher's weights (``init_transformer(SMOKE, key(0))``)
    carried across: the port's ``serve_lm`` picks the ids that
    ``repro.launch.serve.serve_lm``'s loop picks, from logits within the
    float32 tolerance."""
    jcfg, n_tokens = j_qwen.SMOKE, 12
    jp, _ = jtf.init_transformer(jcfg, jax.random.key(0))
    model = transformer_from_numpy(qwen2_5_14b.SMOKE,
                                   jax.tree.map(np.asarray, jp), "cpu")
    got = serve.serve_lm(n_tokens, params=model, device="cpu")

    prompt = jnp.asarray(
        np.random.default_rng(0).integers(0, jcfg.vocab_size, (1, 16)),
        jnp.int32)
    logits, cache = jtf.prefill(jcfg, jp, prompt, s_max=16 + n_tokens)
    tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
    ids, steps = [int(tok[0, 0])], [logits[:, -1:]]
    for i in range(n_tokens - 1):
        logits, cache = jtf.decode_step(jcfg, jp, cache, tok,
                                        jnp.int32(16 + i))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        ids.append(int(tok[0, 0]))
        steps.append(logits)
    assert got["ids"] == ids
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(jnp.concatenate(steps, 1)),
                               atol=ATOL, rtol=RTOL)
    assert len(got["decode_s"]) == n_tokens - 1 and got["prefill_s"] > 0


def test_serve_din_scores_the_jax_batches():
    jcfg, cfg = small(300, 9)
    jp, model = both_models(jcfg, cfg, seed=3)
    out = serve.serve_din(16, 3, 2, cfg=cfg, params=model, device="cpu")
    assert len(out["latencies_s"]) == 2
    want = JDIN.forward(jcfg, jp, out["batch"])
    np.testing.assert_allclose(out["scores"].numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("argv,line", [
    (["--model", "lm", "--tokens", "6"], "lm decode: 6 tokens in "),
    (["--model", "din", "--batch", "8", "--requests", "3"],
     "din: batch=8 cands=1 reqs=3  p50="),
])
def test_serve_module_runs_on_the_cpu_and_imports_no_jax(argv, line):
    code = ("import runpy, sys\n"
            f"sys.argv = ['serve'] + {argv!r} + ['--device', 'cpu']\n"
            "runpy.run_module('repro_torch.launch.serve', "
            "run_name='__main__')\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'repro' "
            "or m.startswith('repro.'))\n"
            "print(bad)")
    out = subprocess.run([sys.executable, "-c", code], env=ENV, check=True,
                         capture_output=True, text=True).stdout
    lines = out.strip().splitlines()
    assert lines[-1] == "[]"
    assert lines[0].startswith(line)


def test_serve_default_device_without_a_card_fails():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--model", "din",
         "--batch", "4", "--requests", "1"],
        env=ENV, capture_output=True, text=True)
    assert proc.returncode != 0
    assert "din:" not in proc.stdout


def test_serve_din_example_runs_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "examples/serve_din_torch.py", "--device", "cpu",
         "--cands", "2000", "--tokens", "4"],
        env=ENV, capture_output=True, text=True, check=True)
    assert proc.stdout.count("din: batch=") == 2
    assert "lm decode: 4 tokens" in proc.stdout


# --- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,c", [(512, 1), (1, 4096)])
def test_gpu_din_matches_the_cpu(cuda, b, c):
    """float32 on both (TF32 off, PyTorch's default for matmuls)."""
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = din_cfg.SMOKE
    model, _ = DIN.init_din(cfg, torch.Generator().manual_seed(0))
    on_card = copy.deepcopy(model).to(cuda)
    batch = DIN.synth_batch(cfg, b, c, np.random.default_rng(0))
    want = DIN.forward(cfg, model, DIN.to_device(batch, "cpu"))
    got = DIN.forward(cfg, on_card, DIN.to_device(batch, cuda))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.gpu
def test_gpu_serve_lm_matches_the_cpu(cuda):
    model, _ = tf.init_transformer(qwen2_5_14b.SMOKE,
                                   torch.Generator().manual_seed(0))
    on_card = copy.deepcopy(model).to(cuda)
    want = serve.serve_lm(8, params=model, device="cpu")
    got = serve.serve_lm(8, params=on_card, device=cuda)
    assert got["ids"] == want["ids"]
    np.testing.assert_allclose(got["logits"].cpu().numpy(),
                               want["logits"].numpy(), atol=ATOL, rtol=RTOL)
