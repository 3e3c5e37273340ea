"""Shared dry-run/smoke plumbing of the five LM architectures, the port's
counterpart of ``repro.configs.lm_common``.

Shape set: train_4k (train_step), prefill_32k (prefill), decode_32k +
long_500k (serve_step: 1 new token against a KV cache). long_500k is only
built for hybrid/sub-quadratic archs; pure full-attention archs return
``Skip``.

A bundle's ``args`` are meta tensors (``transformer.init_abstract``:
the master weights in the JAX init's dtypes) and its shardings the JAX
bundle's, placed by the port's ``ShardingPolicy``; its ``fn`` is the
port's ``make_train_step`` / ``prefill`` / ``decode_step`` under
``mesh=``/``policy=``: the weights and the optimizer state ``DTensor``s
placed as ``in_shardings`` say, the tokens whole on every rank (each rank
takes its data shard's rows). The cache is the exception: the bundles
(and so the dry-run's bytes) give it the JAX layout, the batch over the
data axes and the kv heads over "model" where they divide, while the
port's sharded ``prefill`` and ``decode_step`` keep the batch there and
put the sequence over "model" past 2,048 positions (split-KV decode).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..dist.sharding import ShardingPolicy, axis_sizes, named_sharding
from ..models import transformer as tf
from ..models.common import ParamTree, require_device
from ..models.convert import tensor_from_numpy, transformer_from_numpy
from ..optim import AdamW
from .base import Bundle, Skip

LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1, seq_shard=True),
}


def _policy(mesh, cfg) -> ShardingPolicy:
    return ShardingPolicy(mesh_axes=tuple(mesh.mesh_dim_names),
                          fsdp=cfg.fsdp)


def _vocab_tp(cfg, mesh):
    """'model' if the vocab divides the model axis, else replicated."""
    return ("model" if cfg.vocab_size % axis_sizes(mesh)["model"] == 0
            else None)


def _batch_sharding(mesh, policy, *tail):
    return named_sharding(mesh, policy.data_axes, *tail)


def _served(cfg, params):
    """Master weights as the served model's (``compute_dtypes``)."""
    return ParamTree(tf.compute_dtypes(cfg, params.tree()))


def lm_bundle(cfg: tf.TransformerConfig, shape_name: str, mesh,
              sub_quadratic: bool = False):
    info = LM_SHAPES[shape_name]
    if shape_name == "long_500k" and not sub_quadratic:
        return Skip("pure full-attention arch — 500k-token dense decode "
                    "cache is the regime the assignment excludes "
                    "(DESIGN.md §7)")
    policy = _policy(mesh, cfg)
    params, logical = tf.init_abstract(cfg)
    pshard = policy.shardings_for_tree(mesh, logical, params.tree())
    B, S = info["batch"], info["seq"]
    repl = named_sharding(mesh)
    meta_i32 = dict(dtype=torch.int32, device="meta")

    if info["kind"] == "train":
        # microbatches must still cover the data-parallel axes
        sizes = axis_sizes(mesh)
        n_data = math.prod(sizes[a] for a in policy.data_axes)
        k = max(1, min(cfg.grad_accum, B // n_data))
        cfg = dataclasses.replace(cfg, grad_accum=k)
        opt = AdamW(lr=1e-4, state_dtype=cfg.opt_state_dtype)
        state = {"params": params, "opt": opt.init_abstract(params.tree()),
                 "step": torch.empty((), **meta_i32)}
        state_shard = {"params": pshard,
                       "opt": {"m": pshard, "v": pshard, "count": repl},
                       "step": repl}
        batch = {"tokens": torch.empty((B, S), **meta_i32)}
        batch_shard = {"tokens": _batch_sharding(mesh, policy)}
        fn = tf.make_train_step(cfg, opt, mesh=mesh, policy=policy)
        return Bundle(fn=fn, args=(state, batch),
                      in_shardings=(state_shard, batch_shard), donate=(0,),
                      description=f"train_step {B}x{S}")

    if info["kind"] == "prefill":
        tokens = torch.empty((B, S), **meta_i32)
        # the emitted cache lands in the decode layout
        cache_abs, cache_logical = tf.init_cache(cfg, B, S, device="meta",
                                                 seq_tp=True)
        cshard = policy.shardings_for_tree(mesh, cache_logical, cache_abs)
        logits_shard = _batch_sharding(mesh, policy, None,
                                       _vocab_tp(cfg, mesh))

        def prefill(p, t):
            return tf.prefill(cfg, _served(cfg, p), t, S, mesh=mesh,
                              policy=policy)
        return Bundle(fn=prefill, args=(params, tokens),
                      in_shardings=(pshard, _batch_sharding(mesh, policy)),
                      out_shardings=(logits_shard, cshard),
                      description=f"prefill {B}x{S}")

    # decode: one token against an S-token cache
    seq_shard = info.get("seq_shard", False)
    cache, cache_logical = tf.init_cache(cfg, B, S, device="meta",
                                         seq_shard=seq_shard,
                                         seq_tp=not seq_shard)
    cshard = policy.shardings_for_tree(mesh, cache_logical, cache)
    tokens = torch.empty((B, 1), **meta_i32)
    pos = torch.empty((), **meta_i32)
    tok_shard = _batch_sharding(mesh, policy) if B > 1 else repl
    vtp = _vocab_tp(cfg, mesh)
    logits_shard = (_batch_sharding(mesh, policy, None, vtp) if B > 1
                    else named_sharding(mesh, None, None, vtp))

    def decode(p, c, t, cp):
        return tf.decode_step(cfg, _served(cfg, p), c, t, int(cp),
                              mesh=mesh, policy=policy)
    return Bundle(fn=decode, args=(params, cache, tokens, pos),
                  in_shardings=(pshard, cshard, tok_shard, repl),
                  out_shardings=(logits_shard, cshard),
                  donate=(1,),  # in-place KV-cache update
                  description=f"serve_step B={B} cache={S}")


def lm_smoke(cfg_small: tf.TransformerConfig, vocab: int = 128, *,
             device="cuda", weights=None, tokens=None):
    """One train step, a prefill and a decode step on the reduced config
    (the JAX ``lm_smoke``): the step's loss finite, the logits' shapes
    right and free of NaN. ``weights`` (a JAX parameter tree of numpy
    arrays) and ``tokens`` ((2, 16) integers) replace the seeded draws,
    so that a test can feed the JAX smoke's own; the prefill reads the
    weights before the step, as the JAX smoke's does."""
    device = require_device(device)
    if weights is None:
        masters, _ = tf.init_transformer(
            cfg_small, torch.Generator(device).manual_seed(0),
            trainable=True)
        served = ParamTree(tf.compute_dtypes(cfg_small, masters.tree(
            lambda p: p.detach().clone())))
    else:
        masters = transformer_from_numpy(cfg_small, weights, device,
                                         trainable=True)
        served = transformer_from_numpy(cfg_small, weights, device)
    if tokens is None:
        toks = torch.randint(0, vocab, (2, 16), device=device,
                             generator=torch.Generator(device).manual_seed(1))
    else:
        toks = tensor_from_numpy(np.asarray(tokens, np.int32), device)
    opt = AdamW(lr=1e-3)
    state = {"params": masters, "opt": opt.init(masters.tree()),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    state, metrics = tf.make_train_step(cfg_small, opt)(
        state, {"tokens": toks})
    loss = float(metrics["loss"])
    assert np.isfinite(loss), loss
    with torch.no_grad():
        logits, cache = tf.prefill(cfg_small, served, toks, 24,
                                   logits_last_only=False)
        assert logits.shape == (2, 16, cfg_small.vocab_size)
        assert not bool(torch.isnan(logits).any())
        ld, _ = tf.decode_step(cfg_small, served, cache, toks[:, :1], 16)
    assert ld.shape == (2, 1, cfg_small.vocab_size)
    assert not bool(torch.isnan(ld).any())
    return {"loss": loss}


def lm_flops_info(cfg: tf.TransformerConfig, shape_name: str) -> dict:
    info = LM_SHAPES[shape_name]
    n = cfg.num_params()
    n_active = cfg.num_active_params()
    # the JAX roofline's static structure factor (XLA's cost_analysis
    # counts a scan body once)
    if info["kind"] == "train":
        tokens = info["batch"] * info["seq"]
        model_flops = 6 * n_active * tokens
        scan_factor = cfg.n_layers * max(cfg.grad_accum, 1)
    elif info["kind"] == "prefill":
        tokens = info["batch"] * info["seq"]
        model_flops = 2 * n_active * tokens
        scan_factor = cfg.n_layers
    else:  # decode: 1 token/seq + attention over cache
        tokens = info["batch"]
        model_flops = 2 * n_active * tokens
        scan_factor = cfg.n_layers
    return {"n_params": n, "n_active": n_active, "tokens": tokens,
            "model_flops": model_flops, "kind": info["kind"],
            "scan_factor": scan_factor}
