"""The readings that the limits of ``check.py`` are set from.

For each seed: the planes, a short window of the program at the cell's
own size and load, and the check of its answers against the reference
(the lower readings); for each control seed, the control put in the
program's place and checked the same way over the same requests (the
upper readings). The control is the reference one step below the
precision the configuration states (``reference.assess(...,
control=True)``): counters tallied in float32 instead of exact int64, and
HLL banks at ``p - 1``. The evaluators and their kernels are made once for
all the seeds.
"""
from __future__ import annotations

import json

from . import cell as cell_mod, check, spec

DQV = check.DQV


def report_text(values: dict, n_triples: int) -> str:
    """A DQV report of ``values``, shaped as the port's ``to_json``."""
    return json.dumps({"nTriples": n_triples, "passes": 1, "measurements": [
        {DQV + "isMeasurementOf": {"@id": check.METRIC_URN + m},
         DQV + "value": v} for m, v in sorted(values.items())]})


def readings(cell: spec.Cell, seeds, control_seeds, seconds: float,
             device: str):
    """One dict a seed: ``program`` and/or ``control``, each the check's
    numbers and ``correct``."""
    import torch
    n = int(cell.config["triples"])
    evs = None
    for seed in list(dict.fromkeys(list(seeds) + list(control_seeds))):
        planes, evs, _ = cell_mod.set_up(cell, seed, device, evs)
        _, answers, *_ = cell_mod.window(cell, evs, planes, seed,
                                              seconds)
        refs = cell_mod.reference_answers(cell, planes)
        line = {"seed": seed, "requests": len(answers)}
        if seed in seeds:
            v = check.judge(answers, refs, n, cell.limits)
            line["program"] = {**v["numbers"], "correct": v["correct"]}
        if seed in control_seeds:
            ctrl = cell_mod.reference_answers(cell, planes, control=True)
            fake = [(k, ctrl[k].counts, ctrl[k].registers, ctrl[k].values,
                     report_text(ctrl[k].values, n))
                    for k, *_ in answers]
            v = check.judge(fake, refs, n, cell.limits)
            line["control"] = {**v["numbers"], "correct": v["correct"]}
        del planes
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        yield line


def main(argv) -> int:
    import argparse
    import sys
    import torch
    ap = argparse.ArgumentParser(prog="qabench/control.py", description=(
        "Print the readings the correctness limits are set from: one JSON "
        "line a seed."))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("the readings are taken on a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    for line in readings(cell, args.seeds, args.control_seeds, args.seconds,
                         "cuda"):
        print(json.dumps(line, default=str), flush=True)
    return 0
