"""The port's dry-run registry (``repro_torch.configs``, ``launch/
dryrun.py``, ``launch/mesh.py::make_production_mesh``) against the JAX
package's on both production meshes, (16, 16) and (2, 16, 16).

JAX builds every bundle in a process of its own with 512 host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=512``, as
``repro/launch/dryrun.py`` sets it) and reports each argument's
``in_shardings[i].shard_shape``; the port's dry-run runs in a process of
its own too (``python -m repro_torch.launch.dryrun --no-subprocess``), so
that no fake process group reaches this one. Arguments are matched by
key path, not by leaf order (JAX sorts dict keys). The port holds a layer
stack's weights one ``ParamTree`` a layer where JAX stacks them (``blocks``
(L, ...), gemma's ``blocks_local`` (nb, r, ...)), and an MLP's layers as
``{"w", "b"}`` where JAX has ``(w, b)`` pairs (``models/convert.py``): a
JAX leaf of a stack matches the port's layers of it, each with the JAX
shard shape less its stacking dims. Shard shapes, dtypes, global shapes,
``argument_bytes`` and ``flops_info`` are equal, exactly. The smokes are
held to the JAX smokes in ``test_torch_dryrun_smoke.py`` (LM, DIN, the
paper's) and ``test_torch_dryrun_smoke_gnn.py``.
"""
import functools
import json
import math
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as J_REGISTRY
from repro.models import din as JDIN

from repro_torch.configs import REGISTRY, paper_qa
from repro_torch.rdf import synth_encoded

ENV = {**os.environ, "PYTHONPATH": "src"}
MESHES = ("single", "multi")
# the JAX stacks and their stacking dims (models/convert.py::_STACKS)
STACKS = {"blocks": 1, "dense_layers": 1, "blocks_global": 1,
          "blocks_local": 2}

JAX_CELLS = r'''
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax
import numpy as np
from repro.configs import REGISTRY, Skip
from repro.launch.mesh import make_production_mesh

out = []
for mk in ("single", "multi"):
    mesh = make_production_mesh(multi_pod=mk == "multi")
    for name, spec in REGISTRY.items():
        for shape in spec.shape_names:
            rec = {"arch": name, "shape": shape, "mesh": mk,
                   "mesh_shape": list(mesh.devices.shape),
                   "flops_info": spec.flops_info(shape)}
            b = spec.bundle(shape, mesh, multi_pod=mk == "multi")
            if isinstance(b, Skip):
                rec.update(status="SKIP", reason=b.reason)
            else:
                leaves = jax.tree_util.tree_flatten_with_path(b.args)[0]
                shards = jax.tree_util.tree_leaves(b.in_shardings)
                assert len(leaves) == len(shards)
                args = []
                for (path, leaf), s in zip(leaves, shards):
                    ss = s.shard_shape(leaf.shape)
                    args.append({
                        "path": jax.tree_util.keystr(path),
                        "shape": list(leaf.shape), "dtype": str(leaf.dtype),
                        "shard_shape": list(ss),
                        "shard_bytes": int(np.prod(ss))
                        * np.dtype(leaf.dtype).itemsize})
                rec.update(status="OK", description=b.description,
                           arguments=args)
            out.append(rec)
print(json.dumps(out))
'''


@functools.lru_cache(maxsize=None)
def jax_cells() -> dict:
    proc = subprocess.run([sys.executable, "-c", JAX_CELLS], env=ENV,
                          capture_output=True, text=True, check=False)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return {(r["arch"], r["shape"], r["mesh"]): r
            for r in json.loads(proc.stdout.strip().splitlines()[-1])}


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """``python -m repro_torch.launch.dryrun --no-subprocess`` over every
    cell: its output and the cells it wrote."""
    out = tmp_path_factory.mktemp("dryrun") / "cells.jsonl"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun",
         "--no-subprocess", "--out", os.fspath(out)],
        env=ENV, capture_output=True, text=True, check=False)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out) as f:
        cells = [json.loads(line) for line in f]
    return proc.stdout, {(r["arch"], r["shape"], r["mesh"]): r
                         for r in cells}


def components(path: str) -> list:
    """A ``keystr`` path as its keys (str) and indices (int)."""
    return [int(i) if i else k
            for i, k in re.findall(r"\[(\d+)\]|\['([^']*)'\]", path)]


def jax_path(path: str) -> tuple[str, int]:
    """A port key path as the JAX leaf's it belongs to, and how many
    stacking dims the JAX leaf has beyond the port's: a layer stack's
    indices dropped, an MLP layer's ``w``/``b`` as the pair's 0/1."""
    keys, out, depth, i = components(path), [], 0, 0
    while i < len(keys):
        k = keys[i]
        out.append(k)
        i += 1
        if (k in STACKS and i < len(keys) and isinstance(keys[i], int)):
            i += STACKS[k]
            depth += STACKS[k]
        elif k in ("w", "b") and len(out) > 1 and isinstance(out[-2], int):
            out[-1] = 0 if k == "w" else 1
    return "".join(f"[{k}]" if isinstance(k, int) else f"[{k!r}]"
                   for k in out), depth


def test_registry_matches_jax():
    """The same archs in the same order, families and shape names."""
    assert list(REGISTRY) == list(J_REGISTRY)
    for name, spec in REGISTRY.items():
        j = J_REGISTRY[name]
        assert (spec.family, spec.shape_names, spec.notes) == (
            j.family, j.shape_names, j.notes), name


def test_dryrun_writes_every_cell_and_the_jax_skips(port_run):
    """88 cells, 80 ``OK`` and 8 ``SKIP`` (long_500k of the four pure
    full-attention LMs) and no ``FAIL``; the same cells skip in JAX, for
    the same reason; the same mesh shapes and descriptions."""
    stdout, cells = port_run
    assert "88 cells to go (0 already done)" in stdout
    jax = jax_cells()
    assert set(cells) == set(jax)
    status = [r["status"] for r in cells.values()]
    assert (status.count("OK"), status.count("SKIP"), len(status)) == (
        80, 8, 88), [r for r in cells.values() if r["status"] == "FAIL"]
    for key, r in cells.items():
        j = jax[key]
        assert r["status"] == j["status"], key
        assert r["mesh_shape"] == j["mesh_shape"], key
        if r["status"] == "SKIP":
            assert key[1] == "long_500k" and r["reason"] == j["reason"]
        else:
            assert r["description"] == j["description"], key
            assert r["memory"]["temp_bytes"] is None
            assert r["collectives"] is None and r["absent"]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", list(J_REGISTRY))
def test_shard_shapes_match_jax(port_run, arch, mesh):
    """Every argument of every cell: rank 0's shard shape, the global
    shape and the dtype equal the JAX bundle's, leaf by leaf by key path,
    and the bytes a rank (``argument_bytes``) too."""
    _, cells = port_run
    for shape in J_REGISTRY[arch].shape_names:
        j = jax_cells()[(arch, shape, mesh)]
        if j["status"] != "OK":
            continue
        got = cells[(arch, shape, mesh)]
        want = {a["path"]: a for a in j["arguments"]}
        groups: dict = {}
        for a in got["arguments"]:
            path, depth = jax_path(a["path"])
            assert path in want, (shape, a["path"], path)
            groups.setdefault(path, []).append((depth, a))
        assert set(groups) == set(want), (shape, set(want) ^ set(groups))
        for path, layers in groups.items():
            w = want[path]
            for depth, a in layers:
                where = (shape, mesh, a["path"])
                assert a["dtype"] == w["dtype"], where
                assert a["shard_shape"] == w["shard_shape"][depth:], where
                assert a["shape"] == w["shape"][depth:], where
                assert w["shard_shape"][:depth] == w["shape"][:depth]
            assert len(layers) == math.prod(w["shape"][:layers[0][0]]), path
        assert got["memory"]["argument_bytes"] == sum(
            a["shard_bytes"] for a in j["arguments"]), shape


def test_flops_info_matches_jax(port_run):
    """``flops_info`` of every (arch, shape), the dry-run's records and
    the registry's, equals JAX's."""
    _, cells = port_run
    for key, j in jax_cells().items():
        arch, shape, _ = key
        assert REGISTRY[arch].flops_info(shape) == j["flops_info"], key
        if cells[key]["status"] == "OK":
            assert cells[key]["flops_info"] == j["flops_info"], key


def test_largest_cells_per_rank(port_run):
    """The readings chip_smoke.py prints: deepseek-v2-236b train_4k's
    arguments take 79.377 GiB a rank on (16, 16), Qwen2.5-14B
    decode_32k's 48.116 GiB."""
    _, cells = port_run
    gib = {k: r["memory"]["argument_bytes"] / 2**30
           for k, r in cells.items() if r["status"] == "OK"}
    assert round(gib[("deepseek-v2-236b", "train_4k", "single")], 3) == 79.377
    assert round(gib[("qwen2.5-14b", "decode_32k", "single")], 3) == 48.116
    assert max(gib, key=gib.get) == ("deepseek-v2-236b", "train_4k",
                                      "single")


def test_launcher_one_cell_and_resume(tmp_path):
    """``--cell`` prints one JSON line; a second run over the same
    ``--out`` finds nothing left to do."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--cell", "din",
         "train_batch", "single"], env=ENV, capture_output=True, text=True,
        check=True)
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert (rec["status"], rec["mesh_shape"]) == ("OK", [16, 16])
    out = os.fspath(tmp_path / "c.jsonl")
    argv = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
            "din", "--shape", "train_batch", "--out", out]
    first = subprocess.run(argv, env=ENV, capture_output=True, text=True,
                           check=True).stdout
    assert "2 cells to go (0 already done)" in first
    again = subprocess.run(argv, env=ENV, capture_output=True, text=True,
                           check=True).stdout
    assert "0 cells to go (2 already done)" in again
    with open(out) as f:
        assert [json.loads(x)["mesh"] for x in f] == ["single", "multi"]


def test_production_mesh_refuses_a_real_group():
    """In a process that is in a real (gloo) group, the production mesh
    refuses; with none, it starts a fake group of 256 or 512 ranks that
    ``close_ranks`` destroys."""
    code = (
        "import torch.distributed as dist\n"
        "from repro_torch.launch.mesh import (close_ranks, init_ranks,\n"
        "    make_production_mesh)\n"
        "m = make_production_mesh(multi_pod=True)\n"
        "assert tuple(m.mesh.shape) == (2, 16, 16)\n"
        "assert m.mesh_dim_names == ('pod', 'data', 'model')\n"
        "assert dist.get_backend() == 'fake'\n"
        "close_ranks()\n"
        "assert not dist.is_initialized()\n"
        "init_ranks('cpu')\n"
        "try:\n"
        "    make_production_mesh()\n"
        "except RuntimeError as e:\n"
        "    print('refused:', e)\n"
        "close_ranks()\n")
    out = subprocess.run([sys.executable, "-c", code], env=ENV,
                         capture_output=True, text=True, check=True).stdout
    assert "refused: the production mesh needs a fake process group" in out


def test_paper_bundle_fn_scans_a_ranks_rows():
    """The ``dist-quality-assessment`` bundle's ``fn`` on one rank of a
    one-rank gloo mesh (in a process of its own): the ``fused_scan`` pass
    over the rows (its plain version on the CPU), counters and registers
    equal to the evaluator's on the same rows."""
    code = (
        "import json, torch\n"
        "from repro_torch.configs import paper_qa\n"
        "from repro_torch.launch.mesh import close_ranks, make_host_mesh\n"
        "from repro_torch.rdf import synth_encoded\n"
        "mesh = make_host_mesh(1, device='cpu')\n"
        "b = paper_qa._bundle('bsbm_2gb', mesh)\n"
        "tt = synth_encoded(20_000, seed=3)\n"
        "counts, regs = b.fn(torch.from_numpy(tt.planes))\n"
        "close_ranks()\n"
        "print(json.dumps({'counts': counts.tolist(), 'regs': "
        "{k: v.tolist() for k, v in regs.items()}}))\n")
    out = json.loads(subprocess.run(
        [sys.executable, "-c", code], env=ENV, capture_output=True,
        text=True, check=True).stdout.strip().splitlines()[-1])
    from repro_torch.core import ALL_METRICS, QualityEvaluator
    ev = QualityEvaluator(ALL_METRICS, backend="torch", device="cpu")
    tt = synth_encoded(20_000, seed=3)
    counts, regs = ev.dispatch_chunk(torch.from_numpy(tt.planes))[0]
    assert out["counts"] == counts.tolist()
    assert out["regs"] == {k: v.tolist() for k, v in regs.items()}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_gpu_paper_smoke(cuda):
    """The paper's smoke on the card: one pass through ``fused_scan``, its
    values those of the plain backend on the CPU."""
    got = paper_qa._smoke(device=cuda)
    assert got["metrics"] == 16
    from repro_torch.core import ALL_METRICS, QualityEvaluator
    want = QualityEvaluator(ALL_METRICS, backend="torch", device="cpu"
                            ).assess(synth_encoded(5000, seed=0))
    assert got["values"] == pytest.approx(want.values, rel=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", list(J_REGISTRY))
def test_gpu_smoke_every_arch(cuda, arch):
    """Each arch's ``_smoke`` on the card: finite losses."""
    got = REGISTRY[arch].smoke(device=cuda)
    assert all(np.isfinite(v) for k, v in got.items() if k != "values")


def test_din_train_step_matches_jax():
    """The DIN bundle's train step (``din_cfg.train_step``: the loss's
    gradients, ``AdamW(lr=1e-3, weight_decay=0.0)``, ``step + 1``) at
    SMOKE on the JAX smoke's batch: the loss at ``rtol=1e-5`` and the
    first moment after it (a tenth of the clipped gradient) at the train
    tests' gradient rule, against JAX's ``value_and_grad`` and AdamW."""
    from repro.models.din import synth_batch
    from repro.optim import AdamW as JAdamW
    from repro_torch.configs import din_cfg
    from repro_torch.configs.gnn_common import gnn_train_state
    from repro_torch.models import din as DIN
    from repro_torch.models.common import ParamTree
    from repro_torch.models.convert import din_from_numpy

    cfg = din_cfg.SMOKE
    jcfg = JDIN.DINConfig(n_items=cfg.n_items, n_cats=cfg.n_cats)
    jparams = jax.jit(lambda k: JDIN.init_din(jcfg, k)[0])(
        jax.random.key(0))
    batch = synth_batch(jcfg, 8, 1, np.random.default_rng(0))
    jopt = JAdamW(lr=1e-3, weight_decay=0.0)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: JDIN.loss_fn(jcfg, p, batch)))(jparams)
    _, jstate = jopt.update(jparams, grads, jopt.init(jparams))

    npar = jax.tree.map(np.asarray, jparams)
    model = ParamTree(din_from_numpy(cfg, npar, "cpu").tree(),
                      requires_grad=True)
    state = gnn_train_state(model)
    state, metrics = din_cfg.train_step(cfg)(state, DIN.to_device(batch,
                                                                  "cpu"))
    np.testing.assert_allclose(float(metrics["loss"]), float(loss),
                               rtol=1e-5)
    assert int(state["step"]) == 1 and int(state["opt"]["count"]) == 1
    want = jax.tree.map(np.asarray, jstate["m"])
    got = {"item_table": state["opt"]["m"]["item_table"],
           "cat_table": state["opt"]["m"]["cat_table"],
           "attn": [(x["w"], x["b"]) for x in state["opt"]["m"]["attn"]],
           "final": [(x["w"], x["b"]) for x in state["opt"]["m"]["final"]]}
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree.leaves(jax.tree.map(
                                lambda t: t.numpy(), got))):
        np.testing.assert_allclose(
            g, w, rtol=1e-4, atol=1e-6 + 3e-5 * float(np.abs(w).max()),
            err_msg=jax.tree_util.keystr(path))
