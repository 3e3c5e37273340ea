"""Architecture configs of the port — importing this package registers
all archs, as ``repro.configs`` does.

``--arch <id>`` values: qwen2.5-14b, internlm2-20b, gemma3-12b,
deepseek-v2-236b, granite-moe-1b-a400m, gatedgcn, dimenet, equiformer-v2,
graphcast, din (+ the paper's own quality-assessment config in paper_qa).
Each registers an ``ArchSpec``: its ``smoke(device=)``, its dry-run
``bundle(shape, mesh, multi_pod)`` (``Bundle`` or ``Skip``) and
``flops_info(shape)``; ``launch/dryrun.py`` runs every cell.

Each config module holds the JAX package's ``FULL`` (the GNNs' ``BASE``)
and ``SMOKE`` configurations with torch dtypes. For the launchers,
``LM_ARCHS`` maps each LM architecture's name to its module and
``lm_config`` gives the train launcher's config of one at a scale;
``GNN_ARCHS`` maps each GNN architecture's name to its module (``BASE``,
``SMOKE``, ``train_step``, ``_smoke``, ``_flops``, and but for graphcast,
which trains ``BASE`` on every shape, ``_cfg_for``; dimenet,
equiformer-v2 and graphcast also ``local_loss`` and the partition-parallel
``partitioned_train_step``).
"""
import dataclasses

from .base import REGISTRY, ArchSpec, Bundle, Skip, get_arch

from . import qwen2_5_14b      # noqa: F401
from . import internlm2_20b    # noqa: F401
from . import gemma3_12b       # noqa: F401
from . import deepseek_v2_236b  # noqa: F401
from . import granite_moe_1b   # noqa: F401
from . import gatedgcn_cfg     # noqa: F401
from . import dimenet_cfg      # noqa: F401
from . import equiformer_v2_cfg  # noqa: F401
from . import graphcast_cfg    # noqa: F401
from . import din_cfg          # noqa: F401
from . import paper_qa         # noqa: F401
from .gnn_common import GNN_SHAPES
from .lm_common import LM_SHAPES

ALL_ARCHS = tuple(REGISTRY)
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


__all__ = ["REGISTRY", "ALL_ARCHS", "ArchSpec", "Bundle", "Skip", "get_arch",
           "LM_SHAPES", "DIN_SHAPES", "GNN_SHAPES", "LM_ARCHS", "GNN_ARCHS",
           "lm_config", "din_cfg"]
