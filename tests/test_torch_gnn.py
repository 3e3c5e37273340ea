"""The port's GNN family (``repro_torch.models.gnn``, ``repro_torch.configs.
{gnn_common,*_cfg}``, ``repro_torch.data.sampler``) against the JAX
package's: the Wigner rotations and real spherical harmonics, DimeNet's
Bessel bases and host-side numpy parts, the neighbor sampler, and each
``SMOKE`` config's forward, loss, every gradient leaf and remat, with
the helpers of ``test_torch_gnn_train.py`` (three train steps, bf16) and
``test_torch_gnn_equiformer.py`` (EquiformerV2's cases).

Inputs are the JAX ``_smoke`` functions' (the same numpy generators); JAX
weights come across with ``gnn_from_numpy``, their all-zero leaves (biases,
GatedGCN's norms) first set to seeded noise so that they matter. JAX runs
compiled (``jax.jit``); the port on the CPU.

Tolerances, float32: forward and loss ``rtol=1e-5`` (the forward with an
``atol`` of 1e-5 of its largest magnitude: an output near zero is a
difference of larger terms, as GraphCast's after 3 layers of 512-term
sums); gradients and the
optimizer's moments ``rtol=1e-4`` with an ``atol`` of 1e-6 plus 3e-5 times
the leaf's largest magnitude (the LM train tests' rule: a gradient summed
from terms much larger than itself carries their float32 noise; DimeNet's
SMOKE outputs are ~700 and its loss ~6e5). Weights after three AdamW steps:
``rtol=1e-4``, ``atol=1e-6``, plus 2·lr for every step at which an element's
gradient is within the gradient tolerance of zero: Adam's m/sqrt(v) makes
the sign of such a gradient decide the element's step (EquiformerV2's last
attention bias has a gradient of exactly zero in exact arithmetic: the
softmax over a node's edges ignores it). The Wigner matrices, the spherical
harmonics and the bases: ``atol=1e-6`` (scaled by the largest value for the
bases). Host-side numpy (roots, triplets, sampler, synthetic batches):
bit-equal.

bf16 (``dtype`` bf16, the dtype of EquiformerV2's and GraphCast's
``BASE``): JAX runs compiled in a process of its own whose XLA keeps no
excess precision (``bf16_jax_references``). Its bf16 ``segment_sum`` adds
in index order, rounding at every add, which ``index_add_`` on the CPU
does not; so on a GraphCast batch where no scatter adds two messages the
forward, the loss and every weight's gradient are bit-identical, and a
bias's gradient (a sum over rows: XLA's in bf16, the port's in float32)
is within relative L2 ``BF16_BIAS_REL_L2``. On the ``_smoke`` inputs,
where scatters add many messages, the forward and the loss are within
relative L2 ``BF16_FWD_REL_L2`` and all gradients together within
``BF16_GRAD_REL_L2``, about twice what was measured (forward 2.2e-3 and
7.1e-3, gradients 2.8e-2 and 3.2e-2 for EquiformerV2 and GraphCast). In
EquiformerV2 XLA's bf16 sigmoid also rounds otherwise than
``torch.sigmoid``, which computes in float32 and rounds once (3.1e-3
relative L2 on the same input).

Tests marked ``gpu`` hold the card to the port on the CPU.
"""
import dataclasses
import functools
import inspect
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import dimenet_cfg as j_dimenet_cfg
from repro.configs import equiformer_v2_cfg as j_equiformer_cfg
from repro.configs import gatedgcn_cfg as j_gatedgcn_cfg
from repro.configs import gnn_common as j_gnn_common
from repro.configs import graphcast_cfg as j_graphcast_cfg
from repro.data import sampler as j_sampler
from repro.models.gnn import dimenet as JD
from repro.models.gnn import equiformer_v2 as JE
from repro.models.gnn import gatedgcn as JG
from repro.models.gnn import graphcast as JGC
from repro.models.gnn import wigner as JW
from repro.models.gnn.common import block_diagonal_batch, random_graph
from repro.optim import AdamW as JAdamW

from repro_torch.configs import (GNN_ARCHS, GNN_SHAPES, dimenet_cfg,
                                 equiformer_v2_cfg)
from repro_torch.configs import gnn_common
from repro_torch.data import sampler
from repro_torch.models.convert import gnn_from_numpy, gnn_to_numpy
from repro_torch.models.gnn import dimenet as TD
from repro_torch.models.gnn import equiformer_v2 as TE
from repro_torch.models.gnn import gatedgcn as TG
from repro_torch.models.gnn import graphcast as TGC
from repro_torch.models.gnn import wigner as TW
from repro_torch.models.gnn.common import to_device

FWD_RTOL = LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4
GRAD_LEAF_ATOL = 3e-5          # times the leaf's largest magnitude
BF16_BIAS_REL_L2 = 2e-2
BF16_FWD_REL_L2 = 1e-2
BF16_GRAD_REL_L2 = 6e-2
STEPS, LR = 3, 1e-3
ENV = {**os.environ, "PYTHONPATH": "src"}

# the JAX config modules by architecture, and the port's model modules
J_CFGS = {"gatedgcn": j_gatedgcn_cfg, "dimenet": j_dimenet_cfg,
          "equiformer-v2": j_equiformer_cfg, "graphcast": j_graphcast_cfg}
MODELS = {"gatedgcn": (JG, TG), "dimenet": (JD, TD),
          "equiformer-v2": (JE, TE), "graphcast": (JGC, TGC)}
INITS = {"gatedgcn": "init_gatedgcn", "dimenet": "init_dimenet",
         "equiformer-v2": "init_equiformer", "graphcast": "init_graphcast"}


def port_config(jcfg):
    """The port's config with a JAX config's fields (dtype as torch's)."""
    arch = jcfg.name
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    kw["dtype"] = getattr(torch, np.dtype(jcfg.dtype).name)
    return type(getattr(GNN_ARCHS[arch], "SMOKE"))(**kw)


@functools.lru_cache(maxsize=None)
def jax_params(jcfg, seed=0):
    """JAX weights of ``jcfg`` as numpy arrays, all-zero leaves (biases,
    norms) set to seeded noise (kept for the other tests: read only). The
    JAX init draws in float32 and casts, so a bf16 config's weights are
    its float32 twin's, cast."""
    if jcfg.dtype != jnp.float32:
        return jax.tree.map(
            lambda a: a.astype(jcfg.dtype),
            jax_params(dataclasses.replace(jcfg, dtype=jnp.float32), seed))
    init = getattr(MODELS[jcfg.name][0], INITS[jcfg.name])
    # compiled: the JAX init op by op compiles a random kernel per shape
    params = jax.jit(lambda k: init(jcfg, k)[0])(jax.random.key(seed))
    rng = np.random.default_rng(seed + 100)

    def noisy(a):
        a = np.asarray(a)
        if np.any(a.astype(np.float32)):
            return a
        return (0.1 * rng.normal(size=a.shape)).astype(a.dtype)
    return jax.tree.map(noisy, params)


# --- the cases: a JAX config and the inputs of its _smoke ---------------------

@dataclasses.dataclass
class Case:
    jcfg: object
    batch: object                  # numpy
    triplets: tuple | None = None  # numpy, dimenet

    @property
    def arch(self):
        return self.jcfg.name

    def __post_init__(self):
        # concrete JAX arrays, made outside any trace (DimeNet indexes its
        # numpy edge vectors with them, as its _smoke does)
        self.j_triplets = (None if self.triplets is None else
                           tuple(jnp.asarray(t) for t in self.triplets))

    def jax_loss(self, p):
        jm = MODELS[self.arch][0]
        if self.triplets is not None:
            return jm.loss_fn(self.jcfg, p, self.batch, self.j_triplets)
        return jm.loss_fn(self.jcfg, p, self.batch)

    def jax_forward(self, p):
        jm = MODELS[self.arch][0]
        if self.triplets is not None:
            return jm.forward(self.jcfg, p, self.batch, self.j_triplets)
        return jm.forward(self.jcfg, p, self.batch)

    def port_batch(self, device="cpu"):
        b = to_device(self.batch, device)
        if self.triplets is not None:
            return b, TD.triplets_to_device(self.triplets, device)
        return b

    def port_loss(self, cfg, model, device="cpu"):
        b = self.port_batch(device)
        tm = MODELS[self.arch][1]
        if self.triplets is not None:
            return tm.loss_fn(cfg, model, *b)
        return tm.loss_fn(cfg, model, b)

    def port_forward(self, cfg, model, device="cpu"):
        b = self.port_batch(device)
        tm = MODELS[self.arch][1]
        if self.triplets is not None:
            return tm.forward(cfg, model, *b)
        return tm.forward(cfg, model, b)


def gatedgcn_case(kind="smoke"):
    jcfg = j_gatedgcn_cfg.SMOKE
    if kind == "graph":
        jcfg = dataclasses.replace(jcfg, task="graph")
        b = block_diagonal_batch(4, 10, 24, jcfg.d_feat,
                                 np.random.default_rng(5),
                                 n_classes=jcfg.n_classes)
        return Case(jcfg, b)
    g = random_graph(40, 160, jcfg.d_feat, np.random.default_rng(0),
                     n_classes=jcfg.n_classes)
    if kind == "label-mask":   # the loss on a seeded half of the nodes
        g.label_mask = (np.random.default_rng(6).random(40) < 0.5
                        ).astype(np.float32)
    return Case(jcfg, g)


def dimenet_case(jcfg=j_dimenet_cfg.SMOKE):
    b = block_diagonal_batch(4, 10, 24, jcfg.d_feat,
                             np.random.default_rng(1), n_classes=1,
                             with_pos=True)
    return Case(jcfg, b, JD.build_triplets(b.src, b.dst,
                                           jcfg.max_in_per_edge))


def equiformer_case(edge_chunks=1, jcfg=j_equiformer_cfg.SMOKE):
    jcfg = dataclasses.replace(jcfg, edge_chunks=edge_chunks)
    b = block_diagonal_batch(3, 8, 20, jcfg.d_feat,
                             np.random.default_rng(3), n_classes=1,
                             with_pos=True)
    return Case(jcfg, b)


def graphcast_case(jcfg=j_graphcast_cfg.SMOKE):
    return Case(jcfg, JGC.synth_batch(jcfg, n_grid=256, n_mesh_edges=128,
                                      rng=np.random.default_rng(2)))


CASES = {
    "gatedgcn": lambda: gatedgcn_case(),
    "gatedgcn-graph": lambda: gatedgcn_case("graph"),
    "gatedgcn-label-mask": lambda: gatedgcn_case("label-mask"),
    "dimenet": dimenet_case,
    "graphcast": graphcast_case,
    "equiformer-v2": lambda: equiformer_case(1),
    "equiformer-v2-chunks-4": lambda: equiformer_case(4),
}


@functools.lru_cache(maxsize=None)
def jax_reference(name: str) -> dict:
    """JAX's forward, loss and gradients of case ``name`` (compiled once
    and kept for the other tests of the case)."""
    case = CASES[name]()
    params = jax_params(case.jcfg)
    jp = jax.tree.map(jnp.asarray, params)
    fag = forward_and_grads(case)
    out, (loss, grads) = fag(jp)
    return {"case": case, "params": params, "jparams": jp,
            "vg": lambda p: fag(p)[1],
            "forward": np.asarray(out), "loss": float(loss),
            "grads": jax.tree.map(np.asarray, grads)}


def forward_and_grads(case):
    """JAX's forward and ``value_and_grad`` of the loss of ``case``,
    compiled together (one compile)."""
    return jax.jit(lambda p: (case.jax_forward(p),
                              jax.value_and_grad(case.jax_loss)(p)))


def port_grads(case, cfg, model, device="cpu"):
    """The port's loss and gradients (a JAX-layout numpy tree)."""
    loss = case.port_loss(cfg, model, device)
    loss.backward()
    grads = gnn_to_numpy(cfg, model.tree(lambda p: p.grad))
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def leaf_atol(want) -> float:
    return GRAD_ATOL + GRAD_LEAF_ATOL * float(np.abs(want).max())


def assert_tree_close(got, want, what, scale=1.0):
    """Every leaf of ``got`` against ``want`` at the gradient rule (its
    tolerances times ``scale``)."""
    assert jax.tree.structure(got) == jax.tree.structure(want), what
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree.leaves(got)):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(
            g, w, rtol=GRAD_RTOL * scale, atol=leaf_atol(w) * scale,
            err_msg=f"{what}{jax.tree_util.keystr(path)}")


def rel_l2(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want)
                 / max(float(np.linalg.norm(want)), 1e-30))


def flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(x, np.float32).ravel()
                           for x in jax.tree.leaves(tree)])


def rand_rotations(n, rng):
    A = rng.normal(size=(n, 3, 3))
    Q, _ = np.linalg.qr(A)
    return Q * np.sign(np.linalg.det(Q))[:, None, None]


# --- configs, copies and host-side numpy ---------------------------------------

@pytest.mark.parametrize("arch", list(GNN_ARCHS))
def test_configs_equal_the_jax_configs(arch):
    jm, pm = J_CFGS[arch], GNN_ARCHS[arch]
    for which in ("BASE", "SMOKE"):
        jcfg, cfg = getattr(jm, which), getattr(pm, which)
        assert cfg == port_config(jcfg), which
        assert cfg.num_params() == jcfg.num_params(), which
    for shape in GNN_SHAPES:
        if hasattr(jm, "_cfg_for"):
            assert pm._cfg_for(shape) == port_config(jm._cfg_for(shape))
        assert pm._flops(shape) == jm._flops(shape), shape


def test_shapes_and_tables_equal_the_jax_ones():
    assert GNN_SHAPES == j_gnn_common.GNN_SHAPES
    assert (gnn_common.MB_NODES, gnn_common.MB_EDGES) == (
        j_gnn_common.MB_NODES, j_gnn_common.MB_EDGES) == (169984, 168960)
    assert dimenet_cfg.TRIPLET_CAP == j_dimenet_cfg.TRIPLET_CAP
    assert equiformer_v2_cfg.EDGE_CHUNKS == j_equiformer_cfg.EDGE_CHUNKS
    # the JAX bundles' AdamW(lr=1e-3, weight_decay=0.0), defaults else
    want = JAdamW(lr=1e-3, weight_decay=0.0)
    for f in ("lr", "b1", "b2", "eps", "weight_decay", "grad_clip"):
        assert getattr(gnn_common.OPTIMIZER, f) == getattr(want, f), f
    assert gnn_common.OPTIMIZER.state_dtype == torch.float32
    for shape in GNN_SHAPES:
        assert gnn_common.gnn_flops_info(shape, 3.0, 5.0, 7) == \
            j_gnn_common.gnn_flops_info(shape, 3.0, 5.0, 7)


def test_sampler_is_a_copy_and_samples_the_same_subgraph():
    assert inspect.getsource(sampler) == inspect.getsource(
        j_sampler).replace("repro.", "repro_torch.")
    rng = np.random.default_rng(1)
    n, e = 500, 4000
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    got = sampler.CSRGraph.from_edges(src, dst, n)
    want = j_sampler.CSRGraph.from_edges(src, dst, n)
    assert np.array_equal(got.indptr, want.indptr)
    assert np.array_equal(got.indices, want.indices)
    seeds = rng.choice(n, 32, replace=False).astype(np.int64)
    a = sampler.sample_subgraph(got, seeds, (5, 3),
                                np.random.default_rng(9))
    b = j_sampler.sample_subgraph(want, seeds, (5, 3),
                                  np.random.default_rng(9))
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert np.array_equal(x, y) and np.asarray(x).dtype == \
            np.asarray(y).dtype, f.name
    assert (len(a.node_ids), len(a.src)) == sampler.subgraph_shape(
        32, (5, 3))


def test_host_numpy_parts_are_bit_equal():
    assert np.array_equal(TD.bessel_roots(7, 6), JD.bessel_roots(7, 6))
    xs = np.linspace(0.0, 40.0, 301)
    for l in range(7):
        assert np.array_equal(TD._spherical_jn(l, xs),
                              JD._spherical_jn(l, xs), equal_nan=True)
    for seed, cap in ((0, 2), (1, 4)):
        g = random_graph(60, 300, 4, np.random.default_rng(seed))
        for a, b in zip(TD.build_triplets(g.src, g.dst, cap),
                        JD.build_triplets(g.src, g.dst, cap)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    cfg = j_graphcast_cfg.SMOKE
    a = TGC.synth_batch(port_config(cfg), 256, 128,
                        np.random.default_rng(2))
    b = JGC.synth_batch(cfg, 256, 128, np.random.default_rng(2))
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert np.array_equal(x, y) and np.asarray(x).dtype == \
            np.asarray(y).dtype, f.name


def test_dimenet_triplets():
    src = np.array([0, 1, 2, 1], np.int32)   # edges: 0→1, 1→2, 2→0, 1→0
    dst = np.array([1, 2, 0, 0], np.int32)
    t_kj, t_ji, mask = TD.build_triplets(src, dst, cap=4)
    pairs = {(int(a), int(b)) for a, b, m in zip(t_kj, t_ji, mask) if m}
    assert pairs == {(0, 1), (1, 2), (2, 0)}


# --- Wigner rotations and spherical harmonics ----------------------------------

def test_wigner_and_real_sh_match_jax():
    rng = np.random.default_rng(0)
    Q = rand_rotations(16, rng).astype(np.float32)
    v = np.vstack([rng.normal(size=(20, 3)),
                   [[0, 0, 1], [0, 0, -1], [1e-7, 0, -1]]]).astype(
                       np.float32)
    L = 6
    got = TW.wigner_stack(torch.from_numpy(Q), L)
    want = JW.wigner_stack(jnp.asarray(Q), L)
    assert len(got) == len(want) == L + 1
    for l, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=0, err_msg=f"D^{l}")
    np.testing.assert_allclose(
        TW.real_sh(torch.from_numpy(v), L).numpy(),
        np.asarray(JW.real_sh(jnp.asarray(v), L)), atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        TW.rotation_to_axis(torch.from_numpy(v)).numpy(),
        np.asarray(JW.rotation_to_axis(jnp.asarray(v))), atol=1e-6, rtol=0)
    assert TW.rotation_to_y is TW.rotation_to_axis


def test_wigner_equivariance_property():
    """The port's own D^l · sh_l(v) = sh_l(R v), and D^l orthogonal."""
    rng = np.random.default_rng(0)
    Q = torch.from_numpy(rand_rotations(8, rng).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(8, 3)).astype(np.float32))
    Rv = torch.einsum("bij,bj->bi", Q, v)
    L = 6
    D = TW.wigner_stack(Q, L)
    sh_v, sh_Rv = TW.real_sh(v, L), TW.real_sh(Rv, L)
    for l in range(L + 1):
        s, e = l * l, (l + 1) * (l + 1)
        lhs = torch.einsum("bij,bj->bi", D[l], sh_v[:, s:e])
        assert float((lhs - sh_Rv[:, s:e]).abs().max()) < 1e-4 * (l + 1)
        eye = torch.einsum("bij,bkj->bik", D[l], D[l])
        assert float((eye - torch.eye(2 * l + 1)[None]).abs().max()) < 2e-4


def _rotation_to_axis_holds(seed):
    rng = np.random.default_rng(seed)
    v = np.vstack([rng.normal(size=(20, 3)),
                   [[0, 0, 1], [0, 0, -1], [1e-7, 0, -1]]]).astype(
                       np.float32)
    R = TW.rotation_to_axis(torch.from_numpy(v)).numpy()
    vn = v / np.linalg.norm(v, axis=1, keepdims=True)
    out = np.einsum("bij,bj->bi", R, vn)
    assert np.abs(out - [0, 0, 1]).max() < 1e-5
    assert np.abs(R @ R.transpose(0, 2, 1) - np.eye(3)).max() < 1e-5
    assert np.linalg.det(R).min() > 0.999


try:
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=10, deadline=None)
    @given(seed=st.integers(0, 1000))
    def test_rotation_to_axis_property(seed):
        _rotation_to_axis_holds(seed)
except ImportError:        # no hypothesis: ten fixed seeds instead
    @pytest.mark.parametrize("seed", [0, 1, 7, 42, 99, 123, 500, 777,
                                      901, 1000])
    def test_rotation_to_axis_property(seed):
        _rotation_to_axis_holds(seed)


# --- DimeNet's bases --------------------------------------------------------

def test_bessel_bases_match_jax():
    cfg = j_dimenet_cfg.SMOKE
    rng = np.random.default_rng(4)
    xs = np.linspace(0.01, 45, 200).astype(np.float32)
    want = np.asarray(JD._jl_stack(7, jnp.asarray(xs)))
    got = TD._jl_stack(7, torch.from_numpy(xs)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    d = rng.uniform(0.1, 6.0, 50).astype(np.float32)
    want = np.asarray(JD.radial_basis(jnp.asarray(d), cfg))
    got = TD.radial_basis(torch.from_numpy(d), port_config(cfg)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    c = rng.uniform(-1, 1, 50).astype(np.float32)
    want = np.asarray(JD.spherical_basis(jnp.asarray(d), jnp.asarray(c),
                                         cfg))
    got = TD.spherical_basis(torch.from_numpy(d), torch.from_numpy(c),
                             port_config(cfg)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_bessel_basis_accuracy():
    xs = np.linspace(0.01, 45, 200)
    jl = TD._jl_stack(7, torch.from_numpy(xs)).numpy()
    ref = np.stack([TD._spherical_jn(l, xs) for l in range(7)], -1)
    assert np.abs(jl - ref).max() < 1e-4
    r = TD.bessel_roots(7, 6)
    for l in range(7):
        for n in range(6):
            assert abs(TD._spherical_jn(l, np.array([r[l, n]]))[0]) < 1e-10


# --- each SMOKE config against JAX ---------------------------------------------

F32_CASES = ["gatedgcn", "gatedgcn-graph", "gatedgcn-label-mask", "dimenet",
             "graphcast"]


def check_against_jax(name):
    ref = jax_reference(name)
    case = ref["case"]
    cfg = port_config(case.jcfg)
    model = gnn_from_numpy(cfg, ref["params"], "cpu")
    with torch.no_grad():
        out = case.port_forward(cfg, model)
    np.testing.assert_allclose(
        out.numpy(), ref["forward"], rtol=FWD_RTOL,
        atol=FWD_RTOL * float(np.abs(ref["forward"]).max()))
    loss, grads = port_grads(case, cfg, model)
    np.testing.assert_allclose(loss, ref["loss"], rtol=LOSS_RTOL)
    assert_tree_close(grads, ref["grads"], f"{name} gradient ")
    for g in jax.tree.leaves(grads):
        assert np.isfinite(g).all()
    # remat "full" recomputes each layer in the backward pass: the same
    # gradients, bit for bit, on the CPU
    full = dataclasses.replace(cfg, remat="full")
    loss_f, grads_f = port_grads(case, full, model)
    assert loss_f == loss
    for a, b in zip(jax.tree.leaves(grads_f), jax.tree.leaves(grads)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("name", F32_CASES)
def test_smoke_config_matches_jax(name):
    check_against_jax(name)


def check_train_steps(name):
    """``STEPS`` steps of the config's train step against JAX's
    ``value_and_grad`` and ``repro.optim.AdamW(lr=1e-3,
    weight_decay=0.0).update``: the losses, both moments and the weights."""
    ref = jax_reference(name)
    case = ref["case"]
    cfg = port_config(case.jcfg)
    opt = JAdamW(lr=LR, weight_decay=0.0)
    update = jax.jit(opt.update)
    p, ost = ref["jparams"], opt.init(ref["jparams"])
    j_losses, j_grads = [], []
    for _ in range(STEPS):
        loss, g = ref["vg"](p)
        j_losses.append(float(loss))
        j_grads.append(jax.tree.map(np.asarray, g))
        p, ost = update(p, g, ost)

    module = GNN_ARCHS[case.arch]
    state = gnn_common.gnn_train_state(gnn_from_numpy(cfg, ref["params"],
                                                      "cpu"))
    step = module.train_step(cfg)
    batch = case.port_batch()
    losses = []
    for _ in range(STEPS):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses, j_losses, rtol=LOSS_RTOL)
    assert int(state["step"]) == STEPS
    assert int(state["opt"]["count"]) == int(ost["count"]) == STEPS
    assert_tree_close(gnn_to_numpy(cfg, state["opt"]["m"]),
                      jax.tree.map(np.asarray, ost["m"]), f"{name} m ")
    # v holds squares: twice the relative error of a gradient
    assert_tree_close(gnn_to_numpy(cfg, state["opt"]["v"]),
                      jax.tree.map(np.asarray, ost["v"]), f"{name} v ",
                      scale=2.0)
    got = gnn_to_numpy(cfg, state["params"])
    for i, ((path, w), g) in enumerate(zip(
            jax.tree_util.tree_leaves_with_path(p), jax.tree.leaves(got))):
        w = np.asarray(w, np.float32)
        noise_steps = sum(
            np.abs(jax.tree.leaves(gs)[i])
            <= leaf_atol(jax.tree.leaves(gs)[i]) for gs in j_grads)
        tol = GRAD_ATOL + GRAD_RTOL * np.abs(w) + 2 * LR * noise_steps
        assert (np.abs(g - w) <= tol).all(), (
            f"{name} weight {jax.tree_util.keystr(path)}: "
            f"{np.abs(g - w).max()}")


# --- bf16 ---------------------------------------------------------------------

def graphcast_one_message_case():
    """GraphCast's SMOKE on a batch whose every scatter destination
    receives one message (its encoder's and processor's edges are
    permutations of the mesh, its decoder's of the grid)."""
    jcfg = j_graphcast_cfg.SMOKE
    rng = np.random.default_rng(8)
    b = JGC.synth_batch(jcfg, 256, 128, rng)
    m = b.n_mesh
    return Case(jcfg, dataclasses.replace(
        b, g2m_src=rng.permutation(256)[:m].astype(np.int32),
        g2m_dst=rng.permutation(m).astype(np.int32),
        g2m_feat=b.g2m_feat[:m],
        mesh_src=rng.permutation(m).astype(np.int32),
        mesh_dst=rng.permutation(m).astype(np.int32),
        m2g_dst=rng.permutation(256).astype(np.int32)))


BF16_CASES = {"graphcast-one-message": graphcast_one_message_case,
              "graphcast": graphcast_case,
              "equiformer-v2": lambda: equiformer_case(1)}


def bf16_case(name: str) -> Case:
    case = BF16_CASES[name]()
    return dataclasses.replace(case, jcfg=dataclasses.replace(
        case.jcfg, dtype=jnp.bfloat16))


def write_bf16_references(path: str, names) -> None:
    """JAX's compiled forward, loss and gradients of each bf16 case, as
    float32 arrays in one npz file (run by ``bf16_jax_references`` in a
    process of its own)."""
    out = {}
    for name in names:
        case = bf16_case(name)
        jp = jax.tree.map(jnp.asarray, jax_params(case.jcfg))
        fwd, (loss, grads) = forward_and_grads(case)(jp)
        out[f"{name}/forward"] = np.asarray(fwd, np.float32)
        out[f"{name}/loss"] = np.float32(loss)
        for i, g in enumerate(jax.tree.leaves(grads)):
            out[f"{name}/grad/{i}"] = np.asarray(g, np.float32)
    np.savez(path, **out)


@functools.lru_cache(maxsize=None)
def bf16_jax_references(names: tuple) -> dict:
    """``write_bf16_references`` in a JAX process whose XLA keeps no excess
    precision (``--xla_allow_excess_precision=false``): compiled, XLA
    otherwise keeps a fused bf16 product in float32 where the program
    rounds it, as op-by-op JAX does not. XLA reads its flags once a
    process, when its CPU backend starts."""
    code = ("import sys\n"
            "sys.path.insert(0, sys.argv[1])\n"
            "import test_torch_gnn\n"
            "test_torch_gnn.write_bf16_references(sys.argv[2], "
            "sys.argv[3:])\n")
    env = {**ENV, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_allow_excess_precision=false"}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "references.npz")
        subprocess.run([sys.executable, "-c", code,
                        os.path.dirname(os.path.abspath(__file__)), path,
                        *names], env=env, check=True, capture_output=True,
                       timeout=600)
        with np.load(path) as z:
            return dict(z)


def bf16_against_jax(name: str, refs: dict):
    """The port's bf16 forward, loss and gradients of case ``name`` (float32
    numpy; the gradients in the JAX tree's structure) and JAX's."""
    case = bf16_case(name)
    params = jax_params(case.jcfg)
    cfg = port_config(case.jcfg)
    assert cfg.dtype == torch.bfloat16
    model = gnn_from_numpy(cfg, params, "cpu")
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    with torch.no_grad():
        out = case.port_forward(cfg, model).float().numpy()
    loss, grads = port_grads(case, cfg, model)
    structure = jax.tree.structure(params)
    j_grads = jax.tree.unflatten(structure, [
        refs[f"{name}/grad/{i}"] for i in range(structure.num_leaves)])
    return ((out, loss, grads),
            (refs[f"{name}/forward"], float(refs[f"{name}/loss"]), j_grads))


# --- converters and entry points ------------------------------------------------

@pytest.mark.parametrize("arch", list(GNN_ARCHS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gnn_to_numpy_inverts_gnn_from_numpy(arch, dtype):
    jcfg = dataclasses.replace(J_CFGS[arch].SMOKE,
                               dtype=getattr(jnp, dtype))
    tree = jax_params(jcfg)
    cfg = port_config(jcfg)
    model = gnn_from_numpy(cfg, tree, "cpu")
    assert all(p.requires_grad for p in model.parameters())
    back = gnn_to_numpy(cfg, model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.shape == b.shape
        assert np.array_equal(a, np.asarray(b, np.float32))
    # the weights share no memory with the arrays they came from
    before = [np.array(a, copy=True) for a in jax.tree.leaves(tree)]
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    for a, b in zip(jax.tree.leaves(tree), before):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("arch", list(GNN_ARCHS))
def test_smoke_runs_on_the_cpu_and_defaults_to_cuda(arch):
    """``_smoke(device="cpu")`` passes its own checks; the default device
    is ``cuda``, which fails where there is no card, naming it."""
    module = GNN_ARCHS[arch]
    out = module._smoke(device="cpu")
    assert np.isfinite(out["loss"])
    assert inspect.signature(module._smoke).parameters[
        "device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device cuda"):
            module._smoke()


# --- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", F32_CASES + ["equiformer-v2",
                                              "equiformer-v2-chunks-4"])
def test_gpu_smoke_configs_match_the_cpu(cuda, name):
    """float32 on the card against the port on the CPU with the same
    weights: forward and loss ``rtol=1e-5``, gradients at the gradient
    rule (``index_add_`` on the card adds in varying order)."""
    assert not torch.backends.cuda.matmul.allow_tf32
    case = CASES[name]()
    cfg = port_config(case.jcfg)
    params = jax_params(case.jcfg)
    want_loss, want = port_grads(case, cfg, gnn_from_numpy(cfg, params,
                                                           "cpu"))
    got_loss, got = port_grads(case, cfg, gnn_from_numpy(cfg, params, cuda),
                               cuda)
    np.testing.assert_allclose(got_loss, want_loss, rtol=LOSS_RTOL)
    assert_tree_close(got, want, f"{name} card gradient ")


DIMENET_REPEATS = 10


@pytest.mark.gpu
def test_gpu_dimenet_gradient_holds_in_repeated_runs(cuda):
    """DimeNet's case on the card ``DIMENET_REPEATS`` times, each run at
    the gradient rule against the CPU (``index_add_`` on the card adds
    with atomics, in an order that changes from run to run; ``out_mlp``'s
    last bias, a difference of much larger terms, read 1.31e-4 from the
    CPU with float32 geometry: ``dimenet.BASIS_DTYPE``). Prints that bias
    from every run beside the CPU's and a float64 run's."""
    case = CASES["dimenet"]()
    cfg = port_config(case.jcfg)
    params = jax_params(case.jcfg)
    want_loss, want = port_grads(case, cfg, gnn_from_numpy(cfg, params,
                                                           "cpu"))
    cfg64 = dataclasses.replace(cfg, dtype=torch.float64)
    model64 = gnn_from_numpy(cfg64, jax.tree.map(
        lambda a: np.asarray(a, np.float64), params), "cpu")
    out = case.port_forward(cfg64, model64)
    tgt = torch.from_numpy(case.batch.labels).double().reshape(
        out.shape[0], -1)
    torch.mean((out - tgt) ** 2).backward()
    exact = gnn_to_numpy(cfg64, model64.tree(lambda p: p.grad))
    runs = [port_grads(case, cfg, gnn_from_numpy(cfg, params, cuda), cuda)
            for _ in range(DIMENET_REPEATS)]
    bias = [np.asarray(r[1]["blocks"]["out_mlp"][1][1]).ravel().tolist()
            for r in runs]
    print(f"dimenet out_mlp last bias: card {bias}, cpu "
          f"{np.asarray(want['blocks']['out_mlp'][1][1]).ravel().tolist()}"
          f", float64 "
          f"{np.asarray(exact['blocks']['out_mlp'][1][1]).ravel().tolist()}")
    for i, (loss, grads) in enumerate(runs):
        np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
        assert_tree_close(grads, want, f"dimenet card gradient, run {i} ")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", list(GNN_ARCHS))
def test_gpu_smoke(cuda, arch):
    assert np.isfinite(GNN_ARCHS[arch]._smoke()["loss"])
