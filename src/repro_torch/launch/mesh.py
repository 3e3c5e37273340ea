"""Device meshes of the port, on ``torch.distributed``.

The JAX package's ``make_assessment_mesh`` is a 1-D ``jax.sharding.Mesh``
named ``("data",)`` over the visible devices, driven by one controller.
Here the same mesh is a 1-D ``torch.distributed.device_mesh.DeviceMesh``
named ``("data",)`` over the ranks of a process group: one process per
rank, each running the same program (multi-controller SPMD, as under
``jax.distributed``). Each rank scans its own row shard, and counters and
register banks meet in collectives (``QualityEvaluator`` under ``mesh=``).

The collective backend follows from the layout:

* ``nccl`` when every rank has a card of its own (rank r drives
  ``cuda:r % device_count``);
* ``gloo`` when ranks share a card, or when the device is ``cpu``.

Ranks are processes, started by ``launch_ranks`` (the CLI's ``--mesh N``
and the tests use it): each gets ``RANK``/``WORLD_SIZE`` and a ``file://``
rendezvous in a temporary directory, so no TCP port is picked and nothing
touches the network. ``make_host_mesh`` builds the models' 2-D
``("data", "model")`` mesh over the same ranks; ``make_production_mesh``
the dry-run's 256- or 512-rank mesh on torch's ``fake`` group, in one
process. A process that was not started by ``launch_ranks``
forms a group of one rank. Every group is created with an explicit
``timeout``, and the launcher fails the whole run when any rank exits
nonzero or outlives its deadline: a rank that dies before a collective
ends the run with its traceback instead of leaving the others waiting.

Importing this module starts nothing.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

RDZV_ENV = "REPRO_TORCH_RDZV"            # file:// rendezvous of the ranks
TIMEOUT_ENV = "REPRO_TORCH_DIST_TIMEOUT"  # seconds a collective may wait
DEFAULT_TIMEOUT = 600.0

_own_rdzv: list = []     # temporary rendezvous dirs of single-rank groups


def group_backend(device, world: int) -> str:
    """The collective backend for ``world`` ranks scanning on ``device``:
    ``nccl`` when every rank has a card of its own, else ``gloo``. Raises
    when a card is asked for and there is none: the port does not carry
    on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return "gloo"
    if dev.type != "cuda":
        raise ValueError(f"a mesh runs on cuda or cpu, not {dev.type}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"a mesh on {device} needs a CUDA card, and "
                           f"torch sees none")
    return "nccl" if world <= torch.cuda.device_count() else "gloo"


def init_ranks(device="cuda") -> str:
    """Join this process's rank to the process group (a no-op when it is
    already initialized) and return the group's backend.

    Rank, world size and rendezvous come from ``launch_ranks``'s
    environment; without it the process forms a group of one rank over a
    ``file://`` rendezvous of its own (``close_ranks`` removes it). On a
    CUDA device the rank's card, ``cuda:rank % device_count``, becomes the
    current device.
    """
    if dist.is_initialized():
        return dist.get_backend()
    rank = int(os.environ.get("RANK", "0"))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    backend = group_backend(device, world)
    init = os.environ.get(RDZV_ENV)
    if init is None:
        if world != 1:
            raise RuntimeError(
                f"WORLD_SIZE={world} but no {RDZV_ENV}: start the ranks "
                f"with repro_torch.launch.mesh.launch_ranks")
        d = tempfile.mkdtemp(prefix="repro_torch_rdzv_")
        _own_rdzv.append(d)
        init = "file://" + os.path.join(d, "rdzv")
    timeout = float(os.environ.get(TIMEOUT_ENV, DEFAULT_TIMEOUT))
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=init, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout))
    return backend


def close_ranks() -> None:
    """Destroy the process group, if any, and remove a single-rank
    group's rendezvous directory."""
    if dist.is_initialized():
        dist.destroy_process_group()
    while _own_rdzv:
        shutil.rmtree(_own_rdzv.pop(), ignore_errors=True)


def make_assessment_mesh(devices: int = 0, *, device="cuda"):
    """1-D data-parallel mesh for quality assessment (row sharding only):
    a ``DeviceMesh`` named ``("data",)`` over ranks ``0 .. devices-1`` of
    the process group, which ``init_ranks`` joins first if needed.
    ``devices=0`` uses every rank; a count outside ``[1, world size]``
    raises ``ValueError``. ``mesh.get_group()``'s backend is the one
    ``group_backend`` chose."""
    from torch.distributed.device_mesh import DeviceMesh

    init_ranks(device)
    avail = dist.get_world_size()
    n = devices or avail
    if not 1 <= n <= avail:
        raise ValueError(f"devices must be in [1, {avail}], got {n}")
    return DeviceMesh(torch.device(device).type, list(range(n)),
                      mesh_dim_names=("data",))


def make_host_mesh(model: int = 1, *, device="cuda"):
    """Small 2-D mesh over every rank of the process group (the models'
    mesh in tests and examples): a ``DeviceMesh`` named ``("data",
    "model")`` of shape ``(world // model, model)``, rank ``r`` at
    ``(r // model, r % model)``. ``init_ranks`` joins the group first if
    needed; a world size that ``model`` does not divide raises
    ``ValueError``."""
    from torch.distributed.device_mesh import DeviceMesh

    init_ranks(device)
    n = dist.get_world_size()
    if model < 1 or n % model:
        raise ValueError(f"model={model} does not divide {n} ranks")
    return DeviceMesh(torch.device(device).type,
                      torch.arange(n).reshape(n // model, model),
                      mesh_dim_names=("data", "model"))


def make_production_mesh(*, multi_pod: bool = False):
    """The JAX package's production mesh for the dry-run: (16, 16) over
    ``("data", "model")`` (256 ranks), or (2, 16, 16) over ``("pod",
    "data", "model")`` (512), a ``DeviceMesh`` on torch's ``fake`` process
    group, in which this process is rank 0 and no collective moves data.
    It starts the fake group when the process has none, reuses one of the
    same world size, and raises ``RuntimeError`` when the process is in a
    real group (or a fake one of another size); ``close_ranks`` destroys
    it."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = int(np.prod(shape))
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() != world:
            raise RuntimeError(
                f"the production mesh needs a fake process group of "
                f"{world} ranks; this process is in a "
                f"{dist.get_backend()} group of {dist.get_world_size()}")
    else:
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def data_axes(mesh) -> tuple[str, ...]:
    """Axes used for batch/data parallelism (everything except 'model')."""
    return tuple(a for a in mesh.mesh_dim_names if a != "model")


# -- the rank launcher --------------------------------------------------------

class RankFailure(RuntimeError):
    """A rank exited nonzero or did not finish before the deadline."""


@dataclasses.dataclass
class RankResult:
    rank: int
    returncode: int
    stdout: str      # "" for a rank whose output went to the parent's
    stderr: str


def _tail(text: str, n: int = 4000) -> str:
    return text if len(text) <= n else "..." + text[-n:]


def launch_ranks(n: int, argv: Sequence[str], *,
                 timeout: float = DEFAULT_TIMEOUT,
                 inherit: Sequence[int] = ()) -> list[RankResult]:
    """Run ``python <argv>`` as ``n`` ranks of one process group and wait
    for all of them; returns each rank's exit code and output.

    ``argv`` is what follows ``python``: ``["-m", module, ...]``,
    ``["-c", code]`` or a script and its arguments. Each rank gets
    ``RANK``, ``WORLD_SIZE``, a ``file://`` rendezvous under a temporary
    directory and a collective timeout a little under ``timeout``, at
    most ``DEFAULT_TIMEOUT`` (``init_ranks`` reads them). Ranks listed in
    ``inherit`` write to this process's stdout and stderr; the others'
    output is captured.

    Raises ``RankFailure`` with the failing rank's stderr as soon as any
    rank exits nonzero, or when ``timeout`` seconds pass first; the other
    ranks are killed either way.
    """
    if n < 1:
        raise ValueError(f"need at least one rank, got {n}")
    # the directory holding this package, first on the ranks' path, so
    # that ``-m repro_torch...`` imports this very checkout
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.pathsep.join(p for p in (src, os.environ.get("PYTHONPATH"))
                           if p)
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    procs: list[subprocess.Popen] = []
    files: list = []
    try:
        for r in range(n):
            out = err = None
            if r not in inherit:
                out = open(os.path.join(tmp, f"rank{r}.out"), "w+")
                err = open(os.path.join(tmp, f"rank{r}.err"), "w+")
            files.append((out, err))
            rank_env = {**os.environ,
                        "RANK": str(r), "WORLD_SIZE": str(n),
                        "LOCAL_RANK": str(r), "LOCAL_WORLD_SIZE": str(n),
                        "PYTHONPATH": path,
                        RDZV_ENV: "file://" + os.path.join(tmp, "rdzv"),
                        TIMEOUT_ENV: str(min(DEFAULT_TIMEOUT,
                                             max(1.0, 0.9 * timeout)))}
            procs.append(subprocess.Popen(
                [sys.executable, *argv], env=rank_env, stdout=out,
                stderr=err, stdin=subprocess.DEVNULL))
        deadline = time.monotonic() + timeout
        exited: list[int] = []         # ranks in the order they were seen
        while True:                    # to exit
            exited += [r for r, p in enumerate(procs)
                       if r not in exited and p.poll() is not None]
            failed = [r for r in exited if procs[r].returncode != 0]
            if failed or len(exited) == n or time.monotonic() > deadline:
                break
            time.sleep(0.02)
        late = [r for r in range(n) if r not in exited]
        _kill(procs)

        def read(f) -> str:
            if f is None:
                return ""
            f.flush()
            f.seek(0)
            return f.read()

        results = [RankResult(r, p.returncode, read(o), read(e))
                   for r, (p, (o, e)) in enumerate(zip(procs, files))]
        if failed:
            # the first rank seen to fail first: the others usually fail
            # because it left their collectives
            raise RankFailure("".join(
                f"rank {r} of {n} exited with code "
                f"{results[r].returncode}"
                + (f":\n{_tail(results[r].stderr)}\n" if results[r].stderr
                   else " (its stderr went to the launcher's)\n")
                for r in failed).rstrip())
        if late:
            raise RankFailure(
                f"ranks {late} of {n} did not finish within {timeout:g} s"
                + "".join(f"\n-- rank {r} stderr:\n{_tail(results[r].stderr)}"
                          for r in late if results[r].stderr))
        return results
    finally:
        _kill(procs)
        for pair in files:
            for f in pair:
                if f is not None:
                    f.close()
        shutil.rmtree(tmp, ignore_errors=True)


def _kill(procs: Sequence[subprocess.Popen]) -> None:
    """Stop every rank still running, and reap all of them."""
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()
