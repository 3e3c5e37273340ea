"""Everything a cell is, found by name from the checkout's files.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``: its configuration
file (``configs/<config>.json``, named by the ``configs`` entry's ``file``),
its traffic mix (``mixes/<traffic>.json``), its end-to-end metrics and the
per-layer metrics it reports, each read by ``layer_metrics/<name>.py``.
The limits of the numbers that decide ``correct`` are
``limits/default.json``. A per-layer metric whose reader finds nothing to
read in a cell returns ``None`` and is left out of its line. Adding a configuration, a mix, a layer metric or
a cell is adding files and entries; nothing here names one.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent.parent     # qabench/
ROOT = HERE.parent                                        # the checkout


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    limits: dict


def _load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``; raises KeyError if
    there is none."""
    bench = _load_json(root / "BENCHMARK.json")
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                       f"{sorted(work)}")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(root / configs[w["config"]]["file"])
    mix = _load_json(root / "qabench" / "mixes" / f"{w['traffic']}.json")
    limits = _load_json(root / "qabench" / "limits" / "default.json")
    return Cell(name=name, chips=int(w["chips"]), config=config, mix=mix,
                end_to_end=bench["end_to_end"], per_layer=bench["per_layer"],
                limits=limits)


def layer_reader(name: str, root: pathlib.Path = ROOT):
    """The ``read`` function of ``layer_metrics/<name>.py``."""
    path = root / "qabench" / "layer_metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"qabench_layer_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
