"""Arch registry of the port: every architecture is a selectable config
(``--arch <id>``) with a smoke step and dry-run bundles, the counterpart
of ``repro.configs.base``.

A ``Bundle`` is one (arch × shape × mesh) cell of the dry-run: ``fn`` is
the step the JAX bundle would ``jit`` (the port's step, on real tensors),
``args`` a tree of meta tensors with the global shapes and dtypes of its
arguments, and ``in_shardings``/``out_shardings`` trees of
``dist.sharding.NamedSharding`` of the same structure: the JAX bundle's
layout, from which the dry-run computes each rank's shard. The port has
no compiler, so the dry-run builds every cell, calls no ``fn`` and reads
neither ``out_shardings`` nor ``donate`` (kept as the JAX bundle states
them; ``configs/lm_common.py`` says where the port lays its LM cache out
otherwise). The paper cells' ``fn`` runs on one rank's rows in
``chip_smoke.py``; the LM, DIN, GatedGCN, DimeNet and EquiformerV2
bundles' at small sizes in tests/test_torch_dryrun_bundles.py; the steps
of GraphCast's and the partition-parallel bundles in
tests/test_torch_mesh_gnn.py.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

REGISTRY: dict[str, "ArchSpec"] = {}


@dataclasses.dataclass
class Bundle:
    """Everything the dry-run needs of one (arch × shape × mesh) cell."""
    fn: Callable                    # the step, on real tensors
    args: tuple                     # meta tensors, global shapes
    in_shardings: Any               # matching tree of NamedSharding
    out_shardings: Any = None       # optional output shardings
    donate: tuple = ()              # arguments the step updates in place
    description: str = ""


@dataclasses.dataclass
class Skip:
    reason: str


@dataclasses.dataclass
class ArchSpec:
    name: str
    family: str                     # 'lm' | 'gnn' | 'recsys' | 'paper'
    shape_names: tuple[str, ...]
    smoke: Callable[..., dict]      # reduced-config smoke step (device=)
    bundle: Callable[..., Any]      # (shape_name, mesh, multi_pod) -> Bundle|Skip
    notes: str = ""
    # MODEL_FLOPS inputs for the roofline (6·N·D etc.)
    flops_info: Callable[[str], dict] | None = None


def register(spec: ArchSpec) -> ArchSpec:
    REGISTRY[spec.name] = spec
    return spec


def get_arch(name: str) -> ArchSpec:
    return REGISTRY[name]


def pad_to(n: int, multiple: int) -> int:
    """``n`` rounded up to a multiple of ``multiple``."""
    return ((n + multiple - 1) // multiple) * multiple
