"""The port's sharding policy (``repro_torch.dist.sharding``) against the
JAX package's (``repro.dist.sharding``).

``ShardingPolicy.spec_for`` is pure logic, so the comparison is exact:
for every leaf of every in-repo logical tree (the five LM configs, DIN and
the four GNNs, SMOKE and FULL/BASE), on the meshes (1,4), (2,2), (4,1),
(16,16) and (2,16,16), with ``fsdp`` and ``batch_over_all`` both ways, the
port's entries equal the JAX ``PartitionSpec``'s, with and without the
divisibility fallback. The port's own trees hold the LM layers in lists
where JAX stacks them: each port leaf's spec, after the stack's leading
``None``s, is the JAX leaf's. ``placements_for`` and ``shardings_for_tree``
need a ``DeviceMesh``: they run on one gloo rank in a subprocess
(``launch_ranks``), as the mesh tests do.
"""
import json
import re
import textwrap

import pytest

from jax.sharding import PartitionSpec as P

from repro.configs import (deepseek_v2_236b as j_deepseek, din_cfg as j_din,
                           dimenet_cfg as j_dimenet,
                           equiformer_v2_cfg as j_equiformer,
                           gatedgcn_cfg as j_gatedgcn, gemma3_12b as j_gemma,
                           granite_moe_1b as j_granite,
                           graphcast_cfg as j_graphcast,
                           internlm2_20b as j_internlm,
                           qwen2_5_14b as j_qwen)
from repro.dist.sharding import ShardingPolicy as JPolicy
from repro.models import din as j_din_m
from repro.models import transformer as jtf
from repro.models.gnn import (dimenet as j_dimenet_m,
                              equiformer_v2 as j_equiformer_m,
                              gatedgcn as j_gatedgcn_m,
                              graphcast as j_graphcast_m)

from repro_torch.configs import (deepseek_v2_236b, din_cfg, dimenet_cfg,
                                 equiformer_v2_cfg, gatedgcn_cfg, gemma3_12b,
                                 granite_moe_1b, graphcast_cfg,
                                 internlm2_20b, qwen2_5_14b)
from repro_torch.dist.sharding import MODEL_AXES, FSDP_AXES, ShardingPolicy
from repro_torch.launch.mesh import launch_ranks
from repro_torch.models import din as din_m
from repro_torch.models import transformer as tf
from repro_torch.models.gnn import dimenet, equiformer_v2, gatedgcn, graphcast

MESHES = {
    "1x4": {"data": 1, "model": 4},
    "2x2": {"data": 2, "model": 2},
    "4x1": {"data": 4, "model": 1},
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
}

LMS = {
    "qwen2.5-14b": (j_qwen, qwen2_5_14b),
    "internlm2-20b": (j_internlm, internlm2_20b),
    "gemma3-12b": (j_gemma, gemma3_12b),
    "deepseek-v2-236b": (j_deepseek, deepseek_v2_236b),
    "granite-moe-1b-a400m": (j_granite, granite_moe_1b),
}
GNNS = {
    "gatedgcn": (j_gatedgcn, gatedgcn_cfg, j_gatedgcn_m.init_gatedgcn,
                 gatedgcn.init_gatedgcn),
    "dimenet": (j_dimenet, dimenet_cfg, j_dimenet_m.init_dimenet,
                dimenet.init_dimenet),
    "equiformer-v2": (j_equiformer, equiformer_v2_cfg,
                      j_equiformer_m.init_equiformer,
                      equiformer_v2.init_equiformer),
    "graphcast": (j_graphcast, graphcast_cfg, j_graphcast_m.init_graphcast,
                  graphcast.init_graphcast),
}


def leaves(logical, shapes, path=""):
    """(path, logical axes, shape) of every leaf."""
    if isinstance(logical, tuple) and all(
            a is None or isinstance(a, str) for a in logical):
        yield path, logical, tuple(shapes.shape)
    elif isinstance(logical, dict):
        for k in sorted(logical):
            yield from leaves(logical[k], shapes[k], f"{path}[{k!r}]")
    else:
        for i, v in enumerate(logical):
            yield from leaves(v, shapes[i], f"{path}[{i}]")


def port_params(model):
    return model.tree() if hasattr(model, "tree") else model


def trees(name: str, scale: str):
    """(JAX leaves, port leaves) of one architecture's logical tree."""
    if name in LMS:
        jmod, pmod = LMS[name]
        attr = "SMOKE" if scale == "smoke" else "FULL"
        jp, jl = jtf.init_abstract(getattr(jmod, attr))
        pm, pl = tf.init_transformer(getattr(pmod, attr), None)
    elif name == "din":
        attr = "SMOKE" if scale == "smoke" else "FULL"
        jp, jl = j_din_m.init_din(getattr(j_din, attr), None)
        pm, pl = din_m.init_din(getattr(din_cfg, attr), None)
    else:
        jmod, pmod, jinit, pinit = GNNS[name]
        attr = "SMOKE" if scale == "smoke" else "BASE"
        jp, jl = jinit(getattr(jmod, attr), None)
        pm, pl = pinit(getattr(pmod, attr), None)
    return list(leaves(jl, jp)), list(leaves(pl, port_params(pm)))


TREES = [(n, s) for n in (*LMS, "din", *GNNS) for s in ("smoke", "full")]


@pytest.mark.parametrize("name,scale", TREES)
def test_spec_for_equals_jax(name, scale):
    """Every leaf, mesh and policy: the port's spec is JAX's, on the JAX
    leaf and (after the layer stack's leading Nones) on the port's."""
    jleaves, pleaves = trees(name, scale)
    by_path = {path: (lg, shape) for path, lg, shape in jleaves}

    def jax_path(path):
        if path in by_path:
            return path
        # an MLP layer is a dict of w and b in the port, a (w, b) pair in
        # some JAX models; a port LM's layer lists are JAX's stacked leaves
        pair = path.replace("['w']", "[0]").replace("['b']", "[1]")
        return pair if pair in by_path else re.sub(r"\[\d+\]", "", path)
    assert {jax_path(p) for p, _, _ in pleaves} == set(by_path)
    n_checked = 0
    for sizes in MESHES.values():
        axes = tuple(sizes)
        for fsdp in (False, True):
            for boa in (False, True):
                jpol = JPolicy(mesh_axes=axes, fsdp=fsdp, batch_over_all=boa)
                ppol = ShardingPolicy(mesh_axes=axes, fsdp=fsdp,
                                      batch_over_all=boa)
                for _, lg, shape in jleaves:
                    for args in ((), (shape, sizes)):
                        want = tuple(jpol.spec_for(lg, *args))
                        assert ppol.spec_for(lg, *args) == want, (lg, args)
                for path, lg, shape in pleaves:
                    jlg, jshape = by_path[jax_path(path)]
                    lead = len(jlg) - len(lg)
                    assert jlg[lead:] == lg and jshape[lead:] == shape, path
                    want = tuple(jpol.spec_for(jlg, jshape, sizes))
                    got = ppol.spec_for(lg, shape, sizes)
                    assert (((None,) * lead + got) if got else ()) == want, (
                        path, axes, fsdp, boa)
                    n_checked += 1
    assert n_checked >= len(pleaves) * len(MESHES) * 4


def test_axis_tables_and_policy_properties_equal_jax():
    from repro.dist import sharding as js
    assert MODEL_AXES == js.MODEL_AXES and FSDP_AXES == js.FSDP_AXES
    for axes in (("data", "model"), ("pod", "data", "model"), ("data",),
                 ("model",)):
        for fsdp in (False, True):
            for boa in (False, True):
                j = JPolicy(mesh_axes=axes, fsdp=fsdp, batch_over_all=boa)
                p = ShardingPolicy(mesh_axes=axes, fsdp=fsdp,
                                   batch_over_all=boa)
                assert (p.data_axes, p.model_axis, p._fsdp_axis()) == (
                    j.data_axes, j.model_axis, j._fsdp_axis())
    # the group entry of a batch dim is a tuple, a model entry a name
    pol = ShardingPolicy(("pod", "data", "model"), fsdp=True)
    assert pol.spec_for(("batch", None, "vocab")) == tuple(
        P(("pod", "data"), None, "model"))


RANK = textwrap.dedent("""
    import json, torch
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.launch.mesh import close_ranks, make_host_mesh
    from repro_torch.dist.sharding import (ShardingPolicy, distribute_tree,
                                           placements_for)
    from torch.distributed.device_mesh import DeviceMesh
    mesh = make_host_mesh(1, device="cpu")
    m3 = DeviceMesh("cpu", torch.zeros((1, 1, 1), dtype=torch.long),
                    mesh_dim_names=("pod", "data", "model"))
    out = {}
    def names(pls):
        return [f"Shard({p.dim})" if p.is_shard() else "Replicate"
                for p in pls]
    out["grouped"] = names(placements_for((("pod", "data"), None, "model"),
                                          m3))
    out["model"] = names(placements_for((None, "model"), mesh))
    out["empty"] = names(placements_for((), mesh))
    pol = ShardingPolicy(("data", "model"), fsdp=True)
    tree = {"w": torch.arange(12.).reshape(3, 4), "v": [torch.ones(2)]}
    sh = pol.shardings_for_tree(mesh, {"w": ("embed", "mlp"), "v": [(None,)]},
                                tree)
    out["spec"] = [list(sh["w"].spec), list(sh["v"][0].spec)]
    dt = distribute_tree(tree, {"w": ("embed", "mlp"), "v": [(None,)]},
                         mesh, pol)
    out["shares"] = (dt["v"][0].to_local().data_ptr()
                     == tree["v"][0].data_ptr())
    out["equal"] = bool((dt["w"].full_tensor() == tree["w"]).all())
    print(json.dumps(out))
    close_ranks()
""")


def test_placements_and_distribute_tree_on_one_rank():
    res = launch_ranks(1, ["-c", RANK], timeout=120)
    out = json.loads(res[0].stdout.strip().splitlines()[-1])
    assert out["grouped"] == ["Shard(0)", "Shard(0)", "Shard(2)"]
    assert out["model"] == ["Replicate", "Shard(1)"]
    assert out["empty"] == ["Replicate", "Replicate"]
    assert out["spec"] == [["data", "model"], []]
    assert out["shares"] is False and out["equal"] is True
