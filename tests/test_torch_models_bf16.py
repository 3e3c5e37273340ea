"""The port's LM transformer against the JAX package's in bfloat16, the
dtype every FULL config serves in: each ``SMOKE`` config with its
``dtype`` and ``param_dtype`` set to bf16, and granite's ``SMOKE`` with
float32 parameters and bf16 compute (its FULL layout, which the port
casts once at load and JAX at every use), through ``forward``,
``prefill`` (logits and caches) and 3 ``decode_step``s.

JAX runs under ``jax.disable_jit()``: op by op, as the port runs. Its
compiled ``lax.scan`` bodies may keep fused bf16 intermediates in float32
(XLA's excess precision), which moves the logits by about 1% relative L2,
as much as one missing or extra rounding to bf16 does, so the compiled
path could not tell a wrong cast from noise. Op by op, the two packages
round at the same points and agree bit for bit on this CPU. Tolerance:
relative L2 error ``REL_L2`` (1e-3) of each compared tensor, which leaves
room for a stray last-bit difference between XLA's and ATen's kernels; a
cast dropped or added (probabilities kept float32 before the PV product,
RoPE in bf16, MoE gates applied in float32) gives 2.3e-3 to 1.4e-2 on
these inputs. The port runs on the CPU.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro_torch.models.convert import tensor_to_numpy

from test_torch_models import SMOKES, port_config, run_both

REL_L2 = 1e-3


def assert_rel_l2(got, want, what, tol=REL_L2):
    if isinstance(got, torch.Tensor):
        got = tensor_to_numpy(got)
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = float(np.linalg.norm(got - want)
                / max(float(np.linalg.norm(want)), 1e-30))
    assert err <= tol, f"{what}: relative L2 error {err} > {tol}"


BF16_CASES = {name: dataclasses.replace(jcfg, dtype=jnp.bfloat16,
                                        param_dtype=jnp.bfloat16)
              for name, (jcfg, _) in SMOKES.items()}
BF16_CASES["granite-float32-params"] = dataclasses.replace(
    SMOKES["granite-moe-1b-a400m"][0], dtype=jnp.bfloat16,
    param_dtype=jnp.float32)


@pytest.mark.parametrize("name", list(BF16_CASES))
def test_smoke_config_in_bf16_matches_jax(name):
    jcfg = BF16_CASES[name]
    cfg = port_config(jcfg)
    assert cfg.dtype == torch.bfloat16
    with jax.disable_jit():
        run_both(jcfg, cfg, close=assert_rel_l2)
