"""The port's ``compressed_psum`` and sharded checkpoints against the JAX
package, over eight ranks.

One launch of eight gloo ranks on the CPU (``launch_ranks``) runs the
port's side; the JAX package runs on eight fake XLA CPU devices
(``run_subprocess_devices``), as ``tests/test_multidevice.py`` does.

* ``compressed_psum``: the same ``x`` (64 × 32) and a nonzero carried
  ``error``, split over the eight ranks as JAX's ``shard_map`` splits
  them over ``P("data")``: the mean equals JAX's to ``rtol=1e-6`` with an
  ``atol`` of 1e-6 of its largest magnitude (the eight decoded values are
  added in gloo's order and XLA's, and on elements that cancel the
  float32 sums differ by up to 2.2e-8: 5e-6 of an element of 4.4e-3, the
  largest being 0.53), and every rank's new error to ``rtol=1e-6`` with an
  ``atol`` of one float32 epsilon of the compensated values' largest
  magnitude: XLA fuses ``compensated - q * scale`` into one multiply-add,
  where the port rounds the product first, so a residual of ~1e-3 differs
  by up to one rounding of a value of ~1 (1.19e-7).
  Then JAX's own test of error feedback (one call within 5%, twenty calls
  averaging closer) on the port.
* checkpoints: a tree written by JAX under a (4, 2) mesh restores in the
  port onto a (2, 4) mesh of ``DTensor``s (``restore(...,
  shardings=)``), and a tree of ``DTensor``s the port saves from (2, 4)
  restores in JAX onto (4, 2), in the port onto (4, 2) and onto one
  process: bit for bit each time, and each rank's shard the slice its
  placements name.
"""
import json
import os
import tempfile
import textwrap

import numpy as np

from conftest import run_subprocess_devices
from repro_torch.launch.mesh import launch_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tree_values():
    rng = np.random.default_rng(5)
    return {"w": rng.normal(size=(8, 8)).astype(np.float32),
            "b": np.arange(16, dtype=np.int32),
            "opt": {"m": rng.normal(size=(8, 4)).astype(np.float32),
                    "count": np.int32(7)}}


def psum_inputs():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 32)).astype(np.float32)
    err = (1e-3 * rng.normal(size=(64, 32))).astype(np.float32)
    return x, err


JAX_WRITE = textwrap.dedent("""
    import json, sys
    import jax, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro import compat
    from repro.checkpoint import CheckpointManager
    from repro.dist import compressed_psum
    d = sys.argv[1]
    x, err = np.load(d + "/psum.npy", allow_pickle=True)
    mesh = jax.make_mesh((8,), ("data",))
    g = jax.jit(compat.shard_map(
        lambda x, e: compressed_psum(x, "data", e), mesh=mesh,
        in_specs=(P("data"), P("data")), out_specs=(P(), P("data"))))
    r, e = g(x, err)
    np.save(d + "/jax_psum.npy", np.stack([np.asarray(e)]))
    np.save(d + "/jax_mean.npy", np.asarray(r))
    tree = np.load(d + "/tree.npy", allow_pickle=True).item()
    mesh_a = jax.make_mesh((4, 2), ("data", "model"))
    specs = {"w": P("data", "model"), "b": P("data"),
             "opt": {"m": P(None, "model"), "count": P()}}
    placed = jax.tree.map(lambda a, s: jax.device_put(
        a, NamedSharding(mesh_a, s)), tree, specs,
        is_leaf=lambda s: isinstance(s, P))
    CheckpointManager(d + "/from_jax").save(3, placed)
    print(json.dumps({"ok": True}))
""")

JAX_READ = textwrap.dedent("""
    import json, sys
    import jax, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.checkpoint import CheckpointManager
    d = sys.argv[1]
    tree = np.load(d + "/tree.npy", allow_pickle=True).item()
    mesh_b = jax.make_mesh((4, 2), ("data", "model"))
    specs = {"w": P("data", "model"), "b": P("data"),
             "opt": {"m": P(None, "model"), "count": P()}}
    sh = jax.tree.map(lambda s: NamedSharding(mesh_b, s), specs,
                      is_leaf=lambda s: isinstance(s, P))
    tmpl = jax.tree.map(np.zeros_like, tree)
    out = CheckpointManager(d + "/from_port").restore(4, tmpl, shardings=sh)
    same = all(np.array_equal(np.asarray(a), b) and a.sharding == s
               for a, b, s in zip(jax.tree.leaves(out), jax.tree.leaves(tree),
                                  jax.tree.leaves(sh)))
    print(json.dumps({"same": bool(same)}))
""")

RANKS = textwrap.dedent("""
    import json, sys
    import numpy as np, torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.dist import compressed_psum
    from repro_torch.dist.collectives import all_gather, full_tensor
    from repro_torch.dist.sharding import ShardingPolicy, distribute_tree
    from repro_torch.launch.mesh import close_ranks, make_host_mesh
    from repro_torch.tree import tree_leaves
    d = sys.argv[1]
    mesh_b = make_host_mesh(4, device="cpu")          # (2, 4)
    r = dist.get_rank()
    out = {}
    # -- compressed_psum over the eight ranks (one 1-D group) -------------
    x, err = np.load(d + "/psum.npy", allow_pickle=True)
    xs, es = torch.from_numpy(x[8 * r:8 * r + 8]), torch.from_numpy(
        err[8 * r:8 * r + 8])
    world = dist.group.WORLD
    mean, new_err = compressed_psum(xs, world, es)
    out["mean"] = mean.tolist()
    out["err"] = all_gather(new_err, 0, world).tolist()
    true = x.reshape(8, 8, 32).mean(0)
    m1, _ = compressed_psum(xs, world, torch.zeros_like(xs))
    out["rel1"] = float(np.abs(m1.numpy() - true).max() / np.abs(true).max())
    acc, e = np.zeros_like(true), torch.zeros_like(xs)
    for _ in range(20):
        m, e = compressed_psum(xs, world, e)
        acc = acc + m.numpy()
    out["rel20"] = float(np.abs(acc - 20 * true).max()
                         / np.abs(20 * true).max())
    # -- checkpoints ---------------------------------------------------------
    tree = np.load(d + "/tree.npy", allow_pickle=True).item()
    logical = {"w": ("embed", "mlp"), "b": ("embed",),
               "opt": {"m": (None, "mlp"), "count": ()}}
    pol = ShardingPolicy(("data", "model"), fsdp=True)

    def same_tree(got, want):
        ok = True
        for g, w in zip(tree_leaves(got), tree_leaves(want)):
            ok &= isinstance(g, DTensor) and np.array_equal(
                full_tensor(g).numpy(), np.asarray(w))
            loc, full = g.to_local().numpy(), np.asarray(w)
            # the shard each placement names
            for i, pl in enumerate(g.placements):
                if pl.is_shard():
                    n = g.device_mesh.size(i)
                    c = g.device_mesh.get_coordinate()[i]
                    full = np.split(full, n, axis=pl.dim)[c]
            ok &= np.array_equal(loc, full)
        return bool(ok)
    tmpl = {"w": np.zeros((8, 8), np.float32), "b": np.zeros(16, np.int32),
            "opt": {"m": np.zeros((8, 4), np.float32),
                    "count": np.int32(0)}}
    shard_b = pol.shardings_for_tree(mesh_b, logical, tmpl)
    got = CheckpointManager(d + "/from_jax").restore(3, tmpl,
                                                     shardings=shard_b)
    out["jax_to_port"] = same_tree(got, tree)
    out["specs"] = [list(s.spec) for s in tree_leaves(shard_b)]
    placed = distribute_tree({k: (torch.from_numpy(np.asarray(v))
                                  if not isinstance(v, dict) else
                                  {kk: torch.from_numpy(np.asarray(vv))
                                   for kk, vv in v.items()})
                              for k, v in tree.items()}, logical, mesh_b, pol)
    mgr = CheckpointManager(d + "/from_port")
    mgr.save(4, placed, metadata={"mesh": [2, 4]})
    dist.barrier()
    mesh_a = make_host_mesh(2, device="cpu")          # (4, 2)
    again = mgr.restore(4, tmpl, shardings=pol.shardings_for_tree(
        mesh_a, logical, tmpl))
    out["port_to_port"] = same_tree(again, tree)
    host = mgr.restore(4, tmpl)
    out["port_to_host"] = all(
        np.array_equal(np.asarray(a), np.asarray(b))
        for a, b in zip(tree_leaves(host), tree_leaves(tree)))
    out["files"] = sorted(os.listdir(d + "/from_port")) if r == 0 else None
    if r == 0:
        print(json.dumps(out))
    close_ranks()
""").replace("import json, sys", "import json, os, sys")


def test_compressed_psum_and_checkpoints_cross_packages_and_meshes():
    x, err = psum_inputs()
    tree = tree_values()
    with tempfile.TemporaryDirectory() as d:
        np.save(os.path.join(d, "psum.npy"), np.stack([x, err]))
        np.save(os.path.join(d, "tree.npy"), np.array(tree, dtype=object))
        run_subprocess_devices(8, JAX_WRITE.replace(
            "sys.argv[1]", repr(d)))
        res = launch_ranks(8, ["-c", RANKS, d], timeout=240)
        out = json.loads(res[0].stdout.strip().splitlines()[-1])
        back = run_subprocess_devices(8, JAX_READ.replace(
            "sys.argv[1]", repr(d)))
        jmean = np.load(os.path.join(d, "jax_mean.npy"))
        jerr = np.load(os.path.join(d, "jax_psum.npy"))[0]
    np.testing.assert_allclose(
        np.array(out["err"]), jerr, rtol=1e-6,
        atol=np.finfo(np.float32).eps * np.abs(x + err).max())
    np.testing.assert_allclose(np.array(out["mean"]), jmean, rtol=1e-6,
                               atol=1e-6 * np.abs(jmean).max())
    assert out["rel1"] < 0.05
    assert out["rel20"] < out["rel1"], "error feedback must debias"
    assert out["specs"] == [["data"], [], [None, "model"], ["data", "model"]]
    assert out["jax_to_port"] and out["port_to_port"] and out["port_to_host"]
    assert out["files"] == ["step_0000000004"]
    assert back["same"]
