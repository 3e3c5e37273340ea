"""The paper's own workload as a config: distributed quality assessment,
the port's counterpart of ``repro.configs.paper_qa``.

Registered alongside the model archs so the dry-run also lays out the QAP
scan at 256/512 ranks: rows shard over EVERY mesh axis (each rank is a
Spark 'worker'), counters sum and register banks take the max over the
mesh. A bundle's ``fn`` is one rank's step: the ``fused_scan`` pass over
its own rows (the kernel on the card, its plain version on the CPU), then
the reduce over every mesh axis.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..core import ALL_METRICS, QualityEvaluator
from ..dist.sharding import named_sharding
from ..models.common import require_device
from ..rdf import synth_encoded
from ..rdf.triple_tensor import N_PLANES
from .base import ArchSpec, Bundle, pad_to, register

QA_SHAPES = {
    # triple counts modeled on the paper's Table 3 datasets
    "bsbm_200gb": dict(n_triples=817_774_057),
    "dbpedia_en": dict(n_triples=812_545_486),
    "linkedgeodata": dict(n_triples=1_292_933_812),
    "bsbm_2gb": dict(n_triples=8_289_484),
}


def reduce_over_mesh(mesh, counts, regs):
    """One rank's counters (int64) and register banks (int32) summed and
    maxed over every axis of ``mesh``, axis by axis, on host copies (sum
    and max are exact and order-free): every rank returns the whole
    dataset's."""
    flat = counts.to(torch.int64).cpu()
    names = sorted(regs)
    bank = (torch.stack([regs[k] for k in names]).cpu() if names
            else None)
    for i in range(mesh.ndim):
        if mesh.size(i) > 1:
            group = mesh.get_group(i)
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
            if bank is not None:
                dist.all_reduce(bank, op=dist.ReduceOp.MAX, group=group)
    return flat, ({} if bank is None else dict(zip(names, bank.unbind(0))))


def _bundle(shape_name: str, mesh, multi_pod=False):
    info = QA_SHAPES[shape_name]
    n = pad_to(info["n_triples"], mesh.size())
    ev = QualityEvaluator(ALL_METRICS, fused=True, backend="fused_scan",
                          device="cpu")
    pln = ev.plans[0]
    local_pass = ev._local_pass_fn(pln)

    def scan(planes):
        if hasattr(planes, "to_local"):     # a DTensor: this rank's rows
            planes = planes.to_local()
        counts, regs = local_pass(planes)
        return reduce_over_mesh(mesh, counts, regs)
    planes = torch.empty((n, N_PLANES), dtype=torch.int32, device="meta")
    rows = named_sharding(mesh, tuple(mesh.mesh_dim_names))
    return Bundle(fn=scan, args=(planes,), in_shardings=(rows,),
                  description=f"fused QAP scan over {n:,} triples "
                              f"({len(pln.exprs)} counters, "
                              f"{len(pln.metrics)} metrics)")


def _smoke(device="cuda"):
    """The JAX ``_smoke``: 5,000 synthetic triples through ``fused_scan``
    in one pass; the metric count and the values."""
    device = require_device(device)
    tt = synth_encoded(5000, seed=0)
    ev = QualityEvaluator(ALL_METRICS, fused=True, backend="fused_scan",
                          device=device)
    res = ev.assess(tt)
    assert res.passes == 1  # sketches fold into the counter scan
    assert 0.0 <= res.values["I2"] <= 1.0
    assert res.values["L1"] in (0.0, 1.0)
    return {"metrics": len(res.values), "values": dict(res.values)}


def _flops(shape_name: str) -> dict:
    info = QA_SHAPES[shape_name]
    n = info["n_triples"]
    # the scan is integer-op/bandwidth bound; 'model flops' ≈ bytes touched
    return {"n_params": 0, "n_active": 0, "tokens": n,
            "model_flops": 0, "bytes": n * N_PLANES * 4, "kind": "scan",
            "scan_factor": 1}


register(ArchSpec(
    name="dist-quality-assessment", family="paper",
    shape_names=tuple(QA_SHAPES),
    smoke=_smoke, bundle=_bundle, flops_info=_flops,
    notes="the paper's workload: one-pass fused multi-metric RDF quality "
          "scan (HBM-bandwidth bound; collective term = K scalar psums).",
))
