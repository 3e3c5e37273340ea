"""Dry-run of every (architecture × input-shape × mesh) cell on the
production meshes, the port's counterpart of ``repro.launch.dryrun``.

Each cell builds its ``Bundle`` on ``launch.mesh.make_production_mesh``
(16×16, or 2×16×16 for ``multi``): torch's ``fake`` process group, in
which this process is rank 0. A cell records ``arch``, ``shape``,
``mesh``, ``mesh_shape``, ``status`` (``OK``, ``SKIP`` with its
``reason``, or ``FAIL`` with its ``error``) and ``description``; for each
argument its key path, global shape, dtype and rank 0's shard shape and
bytes (``NamedSharding.shard_shape`` of its ``DTensor`` placements); and
``flops_info``.

Then it traces rank 0's step (``launch/trace.py``, the counterpart of
XLA's ``lower().compile()``): ``bundle.fn`` runs once on fake tensors of
rank 0's shard shapes on ``--device`` (default ``cuda``; nothing is
allocated, no card is touched, but the fake tensors need a torch built
for CUDA), DTensor partitioning the DIN and whole-graph steps. A step
that does not trace is ``FAIL``. The record gets the JAX record's keys:
``memory`` (``argument_bytes``, ``output_bytes``, ``temp_bytes``,
``alias_bytes`` and ``total_per_device``, the JAX formula), ``peak_bytes``,
``flops_per_device``, ``bytes_accessed_per_device``, ``collectives``
(bytes and counts by op) and ``trace_s`` in place of ``compile_s``;
``absent`` names what has no counterpart: XLA's fusion and scheduling.
``--no-trace`` builds the cells and leaves those fields ``null``.

Usage:
  python -m repro_torch.launch.dryrun                  # all cells, both meshes
  python -m repro_torch.launch.dryrun --mesh single    # 16×16 only
  python -m repro_torch.launch.dryrun --arch din --shape train_batch
  python -m repro_torch.launch.dryrun --cell din train_batch single  # one
                                                  # cell, JSON on stdout
  python -m repro_torch.launch.dryrun --device cpu     # fake CPU tensors
Results stream to build/dryrun_torch.jsonl (resumable: done cells skip).
By default each cell runs in a process of its own (``--jobs`` of them at
once); ``--no-subprocess`` runs them in this one, each with a fake group
destroyed after it.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys
import time
import traceback

ABSENT = ("XLA's fusion and scheduling: the trace runs the step op by op, "
          "so temp_bytes is an eager program's peak and "
          "bytes_accessed_per_device an unfused program's traffic; FLOPs "
          "count the matmul, bmm, convolution and attention families only")
UNTRACED = "--no-trace: the step was not traced"
SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def arguments(bundle) -> list[dict]:
    """Each argument of ``bundle``: key path, global shape, dtype, and
    rank 0's shard shape and bytes under its sharding."""
    from .trace import flat_leaves

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


def run_cell(arch: str, shape: str, mesh_kind: str, device="cuda",
             trace: bool = True) -> dict:
    from ..configs import REGISTRY, Skip
    from .mesh import close_ranks, make_production_mesh
    from .trace import trace_bundle

    spec = REGISTRY[arch]
    multi = mesh_kind == "multi"
    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind}
    t0 = time.time()
    try:
        mesh = make_production_mesh(multi_pod=multi, device=device)
        rec["mesh_shape"] = list(mesh.mesh.shape)
        bundle = spec.bundle(shape, mesh, multi_pod=multi)
        if isinstance(bundle, Skip):
            rec.update(status="SKIP", reason=bundle.reason)
            return rec
        args = arguments(bundle)
        rec.update(description=bundle.description,
                   build_s=round(time.time() - t0, 2), arguments=args)
        if spec.flops_info is not None:
            rec["flops_info"] = spec.flops_info(shape)
        arg_bytes = sum(a["shard_bytes"] for a in args)
        if not trace:
            rec.update(status="OK", memory={
                "argument_bytes": arg_bytes, "output_bytes": None,
                "temp_bytes": None, "alias_bytes": None,
                "total_per_device": None}, flops_per_device=None,
                bytes_accessed_per_device=None, collectives=None,
                absent=UNTRACED)
            return rec
        try:
            traced = trace_bundle(bundle, device)
        except Exception as e:  # noqa: BLE001 — a cell's failure is data
            rec.update(status="FAIL", error=f"{type(e).__name__}: {e}",
                       traceback=traceback.format_exc()[-2000:])
            return rec
    finally:
        close_ranks()
    mem = traced.pop("memory")
    mem = {"argument_bytes": arg_bytes, **mem,
           "total_per_device": arg_bytes + mem["output_bytes"]
           + mem["temp_bytes"] - mem["alias_bytes"]}
    rec.update(status="OK", memory=mem, **traced, absent=ABSENT)
    if bundle.trace_values:
        rec["trace_values"] = {f"[{i}]": v
                               for i, v in bundle.trace_values.items()}
    return rec


def check_device(device) -> None:
    """A trace on fake ``cuda`` tensors needs a torch built for CUDA (in
    a CPU-only build it ends the process, not with an exception)."""
    import torch

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda traces on fake CUDA tensors, which "
                           "need a torch built for CUDA and a card; pass "
                           "--device cpu")


def failed(arch: str, shape: str, mesh_kind: str, error: str) -> dict:
    return {"arch": arch, "shape": shape, "mesh": mesh_kind,
            "status": "FAIL", "error": error}


# one H100 80GB HBM3's memory (torch.cuda.get_device_properties), the
# card the printed line holds a rank's total against
CARD_BYTES = 85_017_493_504


def cell_process(cell, device, trace: bool) -> dict:
    """One cell in a process of its own (a crash is the cell's ``FAIL``)."""
    name, shape, mk = cell
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": os.pathsep.join(
        p for p in (SRC, os.environ.get("PYTHONPATH")) if p)}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun",
         "--cell", name, shape, mk, "--device", str(device)]
        + ([] if trace else ["--no-trace"]),
        capture_output=True, text=True, env=env)
    try:
        return json.loads(proc.stdout.strip().splitlines()[-1])
    except (json.JSONDecodeError, IndexError):
        return failed(name, shape, mk, (proc.stderr or proc.stdout)[-2000:])


def cell_line(rec: dict) -> str:
    status = rec.get("status")
    if status == "OK":
        mem = rec["memory"]
        if mem["total_per_device"] is None:
            return (f"args/rank={mem['argument_bytes'] / 2**30:.3f}GiB "
                    f"(not traced)")
        return (f"total/rank={mem['total_per_device'] / 2**30:.3f}GiB of "
                f"{CARD_BYTES / 2**30:.2f}GiB (peak "
                f"{rec['peak_bytes'] / 2**30:.3f}) "
                f"flops={rec['flops_per_device']:.4g} coll="
                f"{rec['collectives']['total_bytes'] / 2**20:.1f}MiB "
                f"trace={rec['trace_s']}s")
    if status == "SKIP":
        return rec.get("reason", "")[:60]
    return rec.get("error", "")[:100].replace("\n", " ")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--select", nargs="+", metavar="ARCH:SHAPE[:MESH]",
                    default=None, help="only these cells (SHAPE '*' for "
                    "every shape of ARCH), on the meshes of --mesh or on "
                    "MESH")
    ap.add_argument("--out", default="build/dryrun_torch.jsonl")
    ap.add_argument("--cell", nargs=3, metavar=("ARCH", "SHAPE", "MESH"),
                    default=None, help="run one cell, print JSON to stdout")
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device (default cuda)")
    ap.add_argument("--no-trace", action="store_true",
                    help="build the cells' arguments only")
    ap.add_argument("--no-subprocess", action="store_true",
                    help="run cells in-process (default: one subprocess "
                         "per cell for crash isolation)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cell processes at once (default 1)")
    args = ap.parse_args(argv)
    trace = not args.no_trace
    if trace:
        check_device(args.device)

    if args.cell:
        print(json.dumps(run_cell(*args.cell, device=args.device,
                                  trace=trace)))
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
    select = None if args.select is None else [
        (x.split(":") + ["*"])[:3] for x in args.select]

    def wanted(name, shape, mk):
        if args.arch and name != args.arch:
            return False
        if args.shape and shape != args.shape:
            return False
        return select is None or any(
            a == name and s in ("*", shape) and m in ("*", mk)
            for a, s, m in select)
    cells = [(name, shape, mk) for name, spec in REGISTRY.items()
             for shape in spec.shape_names for mk in meshes
             if wanted(name, shape, mk) and (name, shape, mk) not in done]

    print(f"dry-run: {len(cells)} cells to go ({len(done)} already done)",
          flush=True)
    t_all = time.time()

    def run(cell):
        t0 = time.time()
        if not args.no_subprocess:
            return cell_process(cell, args.device, trace), time.time() - t0
        try:
            rec = run_cell(*cell, device=args.device, trace=trace)
        except Exception as e:  # noqa: BLE001 — a cell's failure is data
            rec = failed(*cell, f"{type(e).__name__}: {e}")
            rec["traceback"] = traceback.format_exc()[-2000:]
        return rec, time.time() - t0

    jobs = 1 if args.no_subprocess else max(1, args.jobs)
    with concurrent.futures.ThreadPoolExecutor(jobs) as pool:
        for i, (rec, dt) in enumerate(pool.map(run, cells)):
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
            print(f"[{i + 1}/{len(cells)}] {rec['arch']} × {rec['shape']} × "
                  f"{rec['mesh']}: {rec.get('status')} ({dt:.1f}s) "
                  f"{cell_line(rec)}", flush=True)
    print(f"dry-run: {len(cells)} cells in {time.time() - t_all:.1f}s",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
