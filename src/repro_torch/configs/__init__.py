"""Architecture configs of the port: the JAX package's ``FULL`` and
``SMOKE`` configurations (``repro.configs``) with torch dtypes, and the
shape sets they are served and trained at.

``LM_ARCHS`` maps each LM architecture's name to its module; the registry
of dry-run bundles waits for the training and dry-run slices.
"""
from . import (deepseek_v2_236b, din_cfg, gemma3_12b, granite_moe_1b,
               internlm2_20b, qwen2_5_14b)

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

__all__ = ["LM_SHAPES", "DIN_SHAPES", "LM_ARCHS", "din_cfg"]
