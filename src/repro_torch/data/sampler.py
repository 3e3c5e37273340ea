"""Neighbor sampler for sampled-training GNN shapes (GraphSAGE-style).

``minibatch_lg`` (232,965-node / 114.6M-edge reddit-scale graph, batch 1024
seeds, fanout 15-10) needs a real sampler: CSR adjacency + per-hop uniform
sampling with replacement, producing a fixed-shape padded subgraph (static
shapes for jit). Runs host-side as part of the data pipeline; the device
step only sees the gathered features + local edge index.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray    # (N+1,)
    indices: np.ndarray   # (E,)
    n_nodes: int

    @staticmethod
    def from_edges(src: np.ndarray, dst: np.ndarray, n_nodes: int
                   ) -> "CSRGraph":
        """CSR over *outgoing* edges of each node (dst lists per src)."""
        order = np.argsort(src, kind="stable")
        s_sorted = src[order]
        indices = dst[order].astype(np.int32)
        indptr = np.zeros((n_nodes + 1,), np.int64)
        counts = np.bincount(s_sorted, minlength=n_nodes)
        indptr[1:] = np.cumsum(counts)
        return CSRGraph(indptr, indices, n_nodes)


@dataclasses.dataclass
class SampledSubgraph:
    """Fixed-shape subgraph: seeds first, then hop-1, hop-2... nodes.

    node_ids: (n_sub,) global ids (padded with 0 + mask);
    src/dst: (n_edges,) local indices; edge_mask: (n_edges,);
    seed_mask marks the first batch_nodes rows (loss is computed there).
    """
    node_ids: np.ndarray
    node_mask: np.ndarray
    src: np.ndarray
    dst: np.ndarray
    edge_mask: np.ndarray
    n_seeds: int


def sample_subgraph(g: CSRGraph, seeds: np.ndarray, fanouts: tuple[int, ...],
                    rng: np.random.Generator) -> SampledSubgraph:
    """Uniform fanout sampling (with replacement, like DGL's default)."""
    layers = [seeds.astype(np.int64)]
    srcs, dsts = [], []
    offset = 0
    next_offset = len(seeds)
    for fanout in fanouts:
        frontier = layers[-1]
        deg = g.indptr[frontier + 1] - g.indptr[frontier]
        # sample `fanout` neighbors per frontier node (with replacement)
        r = rng.integers(0, 2**31, size=(len(frontier), fanout))
        has = deg > 0
        idx = g.indptr[frontier][:, None] + np.where(
            has[:, None], r % np.maximum(deg, 1)[:, None], 0)
        nbrs = g.indices[idx]                     # (F, fanout)
        nbrs = np.where(has[:, None], nbrs, frontier[:, None])
        layers.append(nbrs.reshape(-1))
        # edges: sampled nbr (src) → frontier node (dst), local indices
        dst_local = np.repeat(np.arange(offset, offset + len(frontier)),
                              fanout)
        src_local = np.arange(next_offset,
                              next_offset + len(frontier) * fanout)
        srcs.append(src_local)
        dsts.append(dst_local)
        offset = next_offset
        next_offset += len(frontier) * fanout
    node_ids = np.concatenate(layers).astype(np.int64)
    src = np.concatenate(srcs).astype(np.int32)
    dst = np.concatenate(dsts).astype(np.int32)
    return SampledSubgraph(
        node_ids=node_ids,
        node_mask=np.ones((len(node_ids),), np.float32),
        src=src, dst=dst,
        edge_mask=np.ones((len(src),), np.float32),
        n_seeds=len(seeds))


def subgraph_shape(batch_nodes: int, fanouts: tuple[int, ...]
                   ) -> tuple[int, int]:
    """Static (n_nodes, n_edges) of a sampled subgraph."""
    n, e, frontier = batch_nodes, 0, batch_nodes
    for f in fanouts:
        e += frontier * f
        frontier *= f
        n += frontier
    return n, e
