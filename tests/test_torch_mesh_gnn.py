"""The partition-parallel (cd-0) GNN train step of the port
(``configs.gnn_common.gnn_partitioned_step`` and each config's
``partitioned_train_step``) against the same step run block by block on
one device.

DimeNet, EquiformerV2 (in two edge chunks a partition, its edge rows a
multiple of the partitions times the chunks) and GraphCast at SMOKE width, float32, on node
classification (GraphCast: regression on the grid) over a seeded random
graph, split into four contiguous blocks of nodes. Each partition keeps
the edges between its own nodes, renumbered from 0, in a block of rows of
the whole graph's arrays; an edge between partitions is dropped and its
row becomes an edge between the block's first nodes (the arrays' shapes
are static, as in the JAX bundles). Four gloo ranks on the CPU
(``launch_ranks``) on a (2, 2) ``make_host_mesh`` run three steps, each
rank its block; the reference runs each block's ``local_loss`` on one
device and averages the losses and the gradients, then applies the same
AdamW. Tolerances: each step's loss ``rtol=1e-5``; the first moment after
the first step (0.1 × the averaged gradient) and after the third at
``tests/test_torch_train.py``'s tolerances (the gradients are summed over
the ranks in another order; Adam amplifies a tiny gradient's difference).
"""
import dataclasses
import os
import pickle
import tempfile
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import (dimenet_cfg, equiformer_v2_cfg,
                                 graphcast_cfg)
from repro_torch.configs.gnn_common import (OPTIMIZER, gnn_train_state,
                                           pad_to)
from repro_torch.launch.mesh import launch_ranks
from repro_torch.models.common import ParamTree
from repro_torch.models.gnn import dimenet, equiformer_v2, graphcast

from test_torch_train import assert_trees_close

PARTS, STEPS = 4, 3
NODES, EDGES = 64, 512

ARCHS = {
    "dimenet": (dimenet_cfg, dimenet.init_dimenet, dataclasses.replace(
        dimenet_cfg.SMOKE, task="node", n_classes=5)),
    "equiformer-v2": (equiformer_v2_cfg, equiformer_v2.init_equiformer,
                      dataclasses.replace(
                          equiformer_v2_cfg.SMOKE, task="node", n_classes=5,
                          edge_chunks=2)),
    "graphcast": (graphcast_cfg, graphcast.init_graphcast,
                  graphcast_cfg.SMOKE),
}


def regroup(src, dst, n_src, n_dst, rows):
    """Each partition's edges (both ends in its blocks of ``n_src /
    PARTS`` and ``n_dst / PARTS`` nodes), renumbered locally, in a block
    of ``rows`` rows, and the original index of each row's edge (-1 for a
    padding row, an edge between the block's first nodes)."""
    bs, bd = n_src // PARTS, n_dst // PARTS
    out_s, out_d, out_i = [], [], []
    for r in range(PARTS):
        keep = np.nonzero((src // bs == r) & (dst // bd == r))[0][:rows]
        pad = rows - len(keep)
        out_s.append(np.concatenate([src[keep] - r * bs, np.zeros(pad)]))
        out_d.append(np.concatenate([dst[keep] - r * bd, np.zeros(pad)]))
        out_i.append(np.concatenate([keep, -np.ones(pad)]))
    return (np.concatenate(out_s).astype(np.int64),
            np.concatenate(out_d).astype(np.int64),
            np.concatenate(out_i).astype(np.int64))


def rows_of(a, idx):
    """``a``'s rows at ``idx``, zero where ``idx`` is -1."""
    out = a[np.maximum(idx, 0)].copy()
    out[idx < 0] = 0
    return out


def node_batch(cfg, rng, with_triplets: bool):
    n, e = NODES, EDGES
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    rows = e // PARTS
    if getattr(cfg, "edge_chunks", 1) > 1:
        rows = pad_to(e, PARTS * cfg.edge_chunks) // PARTS
    s, d, _ = regroup(src, dst, n, n, rows)
    b = {"node_feat": rng.normal(size=(n, cfg.d_feat)).astype(np.float32),
         "positions": rng.normal(size=(n, 3)).astype(np.float32),
         "labels": rng.integers(0, cfg.n_classes, n).astype(np.int64),
         "label_mask": (rng.random(n) < 0.75).astype(np.float32),
         "src": s, "dst": d}
    if with_triplets:
        tri = [dimenet.build_triplets(s[r * rows:(r + 1) * rows],
                                      d[r * rows:(r + 1) * rows],
                                      cfg.max_in_per_edge)
               for r in range(PARTS)]
        for k, name in enumerate(("t_kj", "t_ji", "t_mask")):
            b[name] = np.concatenate([t[k] for t in tri])
        b["t_kj"] = b["t_kj"].astype(np.int64)
        b["t_ji"] = b["t_ji"].astype(np.int64)
    return b


def graphcast_batch(cfg, rng):
    g = graphcast.synth_batch(cfg, NODES, EDGES, rng)
    n_mesh = -(-g.n_mesh // PARTS) * PARTS
    pos = np.zeros((n_mesh, 3), np.float32)
    pos[:g.n_mesh] = g.mesh_pos
    gs, gd, gi = regroup(g.g2m_src, g.g2m_dst, NODES, n_mesh, NODES // PARTS)
    ms, md, _ = regroup(g.mesh_src, g.mesh_dst, n_mesh, n_mesh,
                        EDGES // PARTS)
    ns, nd, ni = regroup(g.m2g_src, g.m2g_dst, n_mesh, NODES,
                         NODES // PARTS)
    return {"grid_feat": g.grid_feat, "mesh_pos": pos, "target": g.target,
            "g2m_src": gs, "g2m_dst": gd, "g2m_feat": rows_of(g.g2m_feat, gi),
            "mesh_src": ms, "mesh_dst": md, "m2g_src": ns, "m2g_dst": nd,
            "m2g_feat": rows_of(g.m2g_feat, ni)}


def batch_of(arch, cfg):
    rng = np.random.default_rng(11)
    if arch == "graphcast":
        return graphcast_batch(cfg, rng)
    return node_batch(cfg, rng, with_triplets=arch == "dimenet")


RANK = textwrap.dedent("""
    import pickle, sys
    import torch
    from repro_torch.configs import GNN_ARCHS
    from repro_torch.configs.gnn_common import gnn_train_state
    from repro_torch.launch.mesh import close_ranks, make_host_mesh
    from repro_torch.models.common import ParamTree
    from repro_torch.tree import tree_map

    d, dev = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)      # four ranks on the host's cores
    with open(d + "/in.pkl", "rb") as f:
        spec = pickle.load(f)
    mesh = make_host_mesh(2, device=dev)
    outs = {}
    for arch, (cfg, tree, batch) in spec.items():
        module = GNN_ARCHS[arch]
        model = ParamTree(tree_map(lambda a: torch.from_numpy(a).to(dev),
                                   tree), requires_grad=True)
        state = gnn_train_state(model)
        step = module.partitioned_train_step(cfg, mesh)
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        losses, ms = [], []
        for _ in range(%d):
            state, m = step(state, b)
            losses.append(float(m["loss"]))
            ms.append(tree_map(lambda t: t.detach().to("cpu", copy=True)
                               .numpy(), state["opt"]["m"]))
        outs[arch] = {"losses": losses, "m1": ms[0], "m3": ms[-1]}
    if torch.distributed.get_rank() == 0:
        with open(d + "/out.pkl", "wb") as f:
            pickle.dump(outs, f)
    close_ranks()
""" % STEPS)


def weights(arch, cfg):
    module, init, _ = ARCHS[arch]
    model = init(cfg, torch.Generator().manual_seed(0))[0]
    return model.tree(lambda p: p.detach().clone().numpy())


def run_ranks(device: str):
    spec = {}
    for arch, (_, _, cfg) in ARCHS.items():
        spec[arch] = (cfg, weights(arch, cfg), batch_of(arch, cfg))
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "in.pkl"), "wb") as f:
            pickle.dump(spec, f)
        launch_ranks(PARTS, ["-c", RANK, d, device], timeout=240)
        with open(os.path.join(d, "out.pkl"), "rb") as f:
            return spec, pickle.load(f)


@pytest.fixture(scope="module")
def mesh_runs():
    return run_ranks("cpu")


def blockwise(arch, cfg, tree, batch):
    """STEPS steps of each block's local loss on one device, the losses
    and gradients averaged over the blocks, then the same AdamW."""
    module = ARCHS[arch][0]
    model = ParamTree(_tensors(tree), requires_grad=True)
    state = gnn_train_state(model)
    loss_of = module.local_loss(cfg)
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses, ms = [], []
    for _ in range(STEPS):
        total = 0.0
        for r in range(PARTS):
            blk = {k: v.chunk(PARTS)[r] for k, v in b.items()}
            loss = loss_of(model, blk)
            (loss / PARTS).backward()
            total += loss.item() / PARTS
        grads = model.tree(lambda p: p.grad)
        state["opt"] = OPTIMIZER.update(model.tree(), grads, state["opt"])[1]
        model.zero_grad(set_to_none=True)
        losses.append(total)
        ms.append(_numpy(state["opt"]["m"]))
    return {"losses": losses, "m1": ms[0], "m3": ms[-1]}


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tensors(v) for v in tree]
    return torch.from_numpy(tree.copy())


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy(v) for v in tree]
    return tree.detach().clone().numpy()


@pytest.mark.parametrize("arch", list(ARCHS))
def test_partitioned_step_matches_blockwise_reference(arch, mesh_runs):
    spec, outs = mesh_runs
    cfg, tree, batch = spec[arch]
    got, want = outs[arch], blockwise(arch, cfg, tree, batch)
    assert all(np.isfinite(got["losses"]))
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5,
                               err_msg="loss of each step")
    assert_trees_close(got["m1"], want["m1"],
                       "first moment after one step (0.1 x the gradient)")
    assert_trees_close(got["m3"], want["m3"], "first moment after 3 steps")


def test_partitioned_step_needs_rows_that_split():
    """A batch whose rows do not split into the mesh's partitions is
    refused, not cut."""
    launch = textwrap.dedent("""
        import torch
        from repro_torch.configs.gnn_common import (gnn_partitioned_step,
                                                    padded_dims, gnn_policy)
        from repro_torch.launch.mesh import close_ranks, make_host_mesh
        mesh = make_host_mesh(1, device="cpu")
        assert gnn_policy(mesh).data_axes == ("data", "model")
        assert padded_dims({"n_nodes": 5, "n_edges": 9}, mesh) == (6, 10)
        from repro_torch.models.common import ParamTree
        step = gnn_partitioned_step(lambda p, b: b["x"].sum(), mesh)
        try:
            step({"params": ParamTree({"w": torch.zeros(1)})},
                 {"x": torch.zeros(5)})
        except ValueError as e:
            print("refused:", e)
        close_ranks()
    """)
    res = launch_ranks(2, ["-c", launch], timeout=120)
    assert "refused: 5 rows do not split into 2 partitions" in res[0].stdout


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_gpu_partitioned_step_on_the_card_matches_the_cpu(cuda):
    """The three architectures' partition-parallel steps on four gloo
    ranks sharing the card, against the blockwise reference on the CPU:
    the losses ``rtol=1e-5``, the first moments at the train tests'
    tolerances."""
    spec, outs = run_ranks("cuda")
    for arch, (cfg, tree, batch) in spec.items():
        got, want = outs[arch], blockwise(arch, cfg, tree, batch)
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=1e-5, err_msg=arch)
        assert_trees_close(got["m1"], want["m1"], f"{arch} first moment")
        assert_trees_close(got["m3"], want["m3"], f"{arch} after 3 steps")
