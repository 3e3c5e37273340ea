"""Architecture configs of the port: the JAX package's ``FULL`` (the GNNs'
``BASE``) and ``SMOKE`` configurations (``repro.configs``) with torch
dtypes, and the shape sets they are served and trained at.

``LM_ARCHS`` maps each LM architecture's name to its module, and
``lm_config`` gives the train launcher's config of one at a scale;
``GNN_ARCHS`` maps each GNN architecture's name to its module (``BASE``,
``SMOKE``, ``train_step``, ``_smoke``, ``_flops``, and but for graphcast,
which trains ``BASE`` on every shape, ``_cfg_for``; dimenet,
equiformer-v2 and graphcast also ``local_loss`` and the partition-parallel
``partitioned_train_step``). The registry of dry-run bundles waits for the
dry-run slice.
"""
import dataclasses

from . import (deepseek_v2_236b, dimenet_cfg, din_cfg, equiformer_v2_cfg,
               gatedgcn_cfg, gemma3_12b, granite_moe_1b, graphcast_cfg,
               internlm2_20b, qwen2_5_14b)
from .gnn_common import GNN_SHAPES

# the JAX package's LM shape set (repro/configs/lm_common.py)
LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1, seq_shard=True),
}
DIN_SHAPES = din_cfg.DIN_SHAPES

LM_ARCHS = {m.FULL.name: m for m in (qwen2_5_14b, internlm2_20b, gemma3_12b,
                                      deepseek_v2_236b, granite_moe_1b)}

GNN_ARCHS = {m.BASE.name: m for m in (gatedgcn_cfg, dimenet_cfg,
                                      equiformer_v2_cfg, graphcast_cfg)}


def lm_config(arch: str, scale: str):
    """``arch``'s config at the train launcher's ``scale`` (as
    ``repro.launch.train``): ``smoke`` its SMOKE, ``full`` its FULL, and
    ``small`` a ~100M-class config of the same family."""
    mod = LM_ARCHS[arch]
    if scale == "small":
        return dataclasses.replace(
            mod.SMOKE, n_layers=8, d_model=512, n_heads=8, n_kv_heads=4,
            head_dim=64, d_ff=1536, vocab_size=32768)
    return {"smoke": mod.SMOKE, "full": mod.FULL}[scale]


__all__ = ["LM_SHAPES", "DIN_SHAPES", "GNN_SHAPES", "LM_ARCHS", "GNN_ARCHS",
           "lm_config", "din_cfg"]
