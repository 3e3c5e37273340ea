"""Dry-run of every (architecture × input-shape × mesh) cell on the
production meshes, the port's counterpart of ``repro.launch.dryrun``.

Each cell builds its ``Bundle`` on ``launch.mesh.make_production_mesh``
(16×16, or 2×16×16 for ``multi``): torch's ``fake`` process group, in
which this process is rank 0. Nothing is allocated and no card is
touched: a bundle's arguments are meta tensors. A cell records ``arch``,
``shape``, ``mesh``, ``mesh_shape``, ``status`` (``OK``, ``SKIP`` with its
``reason``, or ``FAIL`` with its ``error``) and ``description``; for each
argument its key path, global shape, dtype and rank 0's shard shape and
bytes (``NamedSharding.shard_shape`` of its ``DTensor`` placements); the
arguments' bytes a rank (``memory.argument_bytes``) and ``flops_info``.

The port has no compiler, so what the JAX dry-run reads off XLA's compile
(``memory_analysis``'s output and temp bytes, ``cost_analysis``'s FLOPs
and bytes, the partitioned HLO's collective bytes) is recorded as
``null``, with ``absent`` saying why; nothing estimates it.

Usage:
  python -m repro_torch.launch.dryrun                  # all cells, both meshes
  python -m repro_torch.launch.dryrun --mesh single    # 16×16 only
  python -m repro_torch.launch.dryrun --arch din --shape train_batch
  python -m repro_torch.launch.dryrun --cell din train_batch single  # one
                                                  # cell, JSON on stdout
Results stream to build/dryrun_torch.jsonl (resumable: done cells skip).
By default each cell runs in a process of its own; ``--no-subprocess``
runs them in this one, each with a fake group destroyed after it.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

ABSENT = ("no compiler in the port: XLA's memory_analysis (output and "
          "temp bytes), cost_analysis and the partitioned HLO's "
          "collective bytes have no counterpart; not estimated")
SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def flat_leaves(tree, path: str = "") -> list:
    """``(key path, leaf)`` of every leaf of ``tree`` (dicts, lists,
    tuples and ``ParamTree``s), the key path written as JAX's
    ``keystr``: ``[0]['params']['blocks'][3]['attn']['wq']``."""
    from ..models.common import ParamTree

    if isinstance(tree, ParamTree):
        tree = tree.tree(lambda p: p)
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in flat_leaves(v, f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in flat_leaves(v, f"{path}[{i}]")]
    return [(path, tree)]


def arguments(bundle) -> list[dict]:
    """Each argument of ``bundle``: key path, global shape, dtype, and
    rank 0's shard shape and bytes under its sharding."""
    shardings = dict(flat_leaves(bundle.in_shardings))
    out = []
    for path, t in flat_leaves(bundle.args):
        shard = shardings[path].shard_shape(tuple(t.shape))
        n = 1
        for d in shard:
            n *= d
        out.append({"path": path, "shape": list(t.shape),
                    "dtype": str(t.dtype).removeprefix("torch."),
                    "shard_shape": list(shard),
                    "shard_bytes": n * t.element_size()})
    return out


def run_cell(arch: str, shape: str, mesh_kind: str) -> dict:
    from ..configs import REGISTRY, Skip
    from .mesh import close_ranks, make_production_mesh

    spec = REGISTRY[arch]
    multi = mesh_kind == "multi"
    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind}
    t0 = time.time()
    try:
        mesh = make_production_mesh(multi_pod=multi)
        rec["mesh_shape"] = list(mesh.mesh.shape)
        bundle = spec.bundle(shape, mesh, multi_pod=multi)
        if isinstance(bundle, Skip):
            rec.update(status="SKIP", reason=bundle.reason)
            return rec
        args = arguments(bundle)
    finally:
        close_ranks()
    rec.update(
        status="OK", description=bundle.description,
        build_s=round(time.time() - t0, 2),
        arguments=args,
        memory={"argument_bytes": sum(a["shard_bytes"] for a in args),
                "output_bytes": None, "temp_bytes": None,
                "alias_bytes": None, "total_per_device": None},
        flops_per_device=None, bytes_accessed_per_device=None,
        collectives=None, absent=ABSENT)
    if spec.flops_info is not None:
        rec["flops_info"] = spec.flops_info(shape)
    return rec


def failed(arch: str, shape: str, mesh_kind: str, error: str) -> dict:
    return {"arch": arch, "shape": shape, "mesh": mesh_kind,
            "status": "FAIL", "error": error}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--out", default="build/dryrun_torch.jsonl")
    ap.add_argument("--cell", nargs=3, metavar=("ARCH", "SHAPE", "MESH"),
                    default=None, help="run one cell, print JSON to stdout")
    ap.add_argument("--no-subprocess", action="store_true",
                    help="run cells in-process (default: one subprocess "
                         "per cell for crash isolation)")
    args = ap.parse_args(argv)

    if args.cell:
        print(json.dumps(run_cell(*args.cell)))
        return 0

    from ..configs import REGISTRY

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    done = set()
    if os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if r.get("status") in ("OK", "SKIP"):
                    done.add((r["arch"], r["shape"], r["mesh"]))

    meshes = {"single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[args.mesh]
    cells = [(name, shape, mk) for name, spec in REGISTRY.items()
             if not args.arch or name == args.arch
             for shape in spec.shape_names
             if not args.shape or shape == args.shape
             for mk in meshes if (name, shape, mk) not in done]

    print(f"dry-run: {len(cells)} cells to go ({len(done)} already done)",
          flush=True)
    for i, (name, shape, mk) in enumerate(cells):
        t0 = time.time()
        if args.no_subprocess:
            try:
                rec = run_cell(name, shape, mk)
            except Exception as e:  # noqa: BLE001 — a cell's failure is data
                rec = failed(name, shape, mk, f"{type(e).__name__}: {e}")
                rec["traceback"] = traceback.format_exc()[-2000:]
        else:
            env = {**os.environ, "PYTHONPATH": os.pathsep.join(
                p for p in (SRC, os.environ.get("PYTHONPATH")) if p)}
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--cell", name, shape, mk],
                capture_output=True, text=True, env=env)
            try:
                rec = json.loads(proc.stdout.strip().splitlines()[-1])
            except (json.JSONDecodeError, IndexError):
                rec = failed(name, shape, mk,
                             (proc.stderr or proc.stdout)[-2000:])
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        status = rec.get("status")
        if status == "OK":
            extra = (f"args/rank="
                     f"{rec['memory']['argument_bytes'] / 2**30:.3f}GiB")
        elif status == "SKIP":
            extra = rec.get("reason", "")[:60]
        else:
            extra = rec.get("error", "")[:100].replace("\n", " ")
        print(f"[{i + 1}/{len(cells)}] {name} × {shape} × {mk}: {status} "
              f"({time.time() - t0:.1f}s) {extra}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
