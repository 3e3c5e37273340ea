"""TripleTensor — the dictionary-encoded *main dataset* (paper §2.2, step 3).

The Spark version stores an RDD of parsed Jena ``Triple`` objects. Here the
main dataset is a struct-of-arrays integer tensor: one ``(N, N_PLANES)`` int32
matrix whose columns are term ids plus precomputed per-position metadata
planes. Every QAP predicate any metric needs is answerable from these planes
with pure integer ops — the TPU hot path never sees a string.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from . import vocab

# Plane (column) layout ------------------------------------------------------
COL_S = 0          # subject term id
COL_P = 1          # predicate term id
COL_O = 2          # object term id
COL_S_FLAGS = 3    # vocab.* flag bits for subject
COL_P_FLAGS = 4    # ... predicate
COL_O_FLAGS = 5    # ... object
COL_S_LEN = 6      # lexical length of subject (IRI chars)
COL_P_LEN = 7
COL_O_LEN = 8
COL_O_DT = 9       # datatype id of object literal (vocab.DT_*)
COL_S_HASH = 10    # 32-bit content hash of the subject term's key bytes
COL_P_HASH = 11    # ... predicate
COL_O_HASH = 12    # ... object
N_PLANES = 13

# Bumped whenever the plane layout changes shape or meaning.  Persisted
# state that gathers planes (the repro.store engine signature) embeds this,
# so stores written under an older layout self-heal via a cold rescan
# instead of colliding on column indices.
# v2: content-hash planes (COL_*_HASH) — HLL sketches hash term *content*
# instead of term ids, making frozen register banks renumbering-invariant.
PLANE_LAYOUT_VERSION = 2

PLANE_NAMES = [
    "s_id", "p_id", "o_id", "s_flags", "p_flags", "o_flags",
    "s_len", "p_len", "o_len", "o_dt", "s_hash", "p_hash", "o_hash",
]


@dataclasses.dataclass
class TripleTensor:
    """The encoded main dataset.

    ``planes``: (N, N_PLANES) int32 — may include padding rows, which have all
    flag planes 0 (in particular the VALID bit unset, so they are invisible to
    every metric, including ``count(triples)``).
    ``n_valid``: number of real triples (≤ N).
    """

    planes: np.ndarray
    n_valid: int
    n_terms: int = 0

    def __post_init__(self):
        assert self.planes.ndim == 2 and self.planes.shape[1] == N_PLANES, (
            self.planes.shape)
        assert self.planes.dtype == np.int32

    def __len__(self) -> int:
        return int(self.n_valid)

    @property
    def n_rows(self) -> int:
        return self.planes.shape[0]

    def padded_to(self, multiple: int) -> "TripleTensor":
        """Pad row count up to a multiple (for sharding); pads are invisible."""
        n = self.planes.shape[0]
        target = ((n + multiple - 1) // multiple) * multiple
        if target == n:
            return self
        pad = np.zeros((target - n, N_PLANES), dtype=np.int32)
        return TripleTensor(np.concatenate([self.planes, pad], axis=0),
                            self.n_valid, self.n_terms)

    def take(self, n: int) -> "TripleTensor":
        return TripleTensor(self.planes[:n], min(self.n_valid, n), self.n_terms)

    def concat(self, other: "TripleTensor") -> "TripleTensor":
        # Only valid-for-concat if neither side has internal padding.
        assert self.n_rows == self.n_valid and other.n_rows == other.n_valid
        return TripleTensor(
            np.concatenate([self.planes, other.planes], axis=0),
            self.n_valid + other.n_valid,
            max(self.n_terms, other.n_terms))

    def chunks(self, n_chunks: int) -> list["TripleTensor"]:
        """Over-decompose into ``n_chunks`` equal chunks (straggler unit)."""
        padded = self.padded_to(n_chunks)
        rows = padded.n_rows // n_chunks
        out = []
        remaining = self.n_valid
        for i in range(n_chunks):
            block = padded.planes[i * rows:(i + 1) * rows]
            nv = min(max(remaining, 0), rows)
            out.append(TripleTensor(block, nv, self.n_terms))
            remaining -= rows
        return out


def mix32(x: np.ndarray) -> np.ndarray:
    """murmur3 fmix32 over uint32 lanes — the ONE host-side finalizer
    shared by the synthetic hash below and the encoder's content hashing
    (``encoder.content_hash_batch``), so the two can never drift.
    (The kernel oracles keep an independent copy on purpose.)"""
    x = x.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x = x * np.uint32(0x85EBCA6B)
    x ^= x >> np.uint32(13)
    x = x * np.uint32(0xC2B2AE35)
    x ^= x >> np.uint32(16)
    return x


def synthetic_term_hash(ids) -> np.ndarray:
    """Content hash for *synthetic* terms whose only identity is their id.

    ``synth_encoded`` tensors have no term strings, so their content-hash
    planes are defined as a murmur-style mix of the id — well-distributed,
    and injective over ids like a real content hash is over distinct terms.
    Real datasets never use this: their hashes come from
    ``encoder.content_hash_batch`` over the actual ``Term.key()`` bytes.
    """
    x = (np.asarray(ids).astype(np.uint32) + np.uint32(1)) \
        * np.uint32(0x9E3779B1)
    return mix32(x).view(np.int32)


def from_columns(s_id, p_id, o_id, s_flags, p_flags, o_flags,
                 s_len, p_len, o_len, o_dt, n_terms=0, *,
                 s_hash=None, p_hash=None, o_hash=None) -> TripleTensor:
    """Stack per-position columns into a TripleTensor.

    The content-hash columns default to ``synthetic_term_hash`` of the id
    columns — correct for synthetic tensors only.  The real encode paths
    (``encoder.encode``, ``rdf.ingest``) always pass the dictionary's
    content hashes explicitly.
    """
    if s_hash is None:
        s_hash = synthetic_term_hash(s_id)
    if p_hash is None:
        p_hash = synthetic_term_hash(p_id)
    if o_hash is None:
        o_hash = synthetic_term_hash(o_id)
    cols = [s_id, p_id, o_id, s_flags, p_flags, o_flags, s_len, p_len,
            o_len, o_dt, s_hash, p_hash, o_hash]
    planes = np.stack([np.asarray(c, dtype=np.int32) for c in cols], axis=1)
    return TripleTensor(planes, planes.shape[0], n_terms)


def empty(n_rows: int = 0) -> TripleTensor:
    return TripleTensor(np.zeros((n_rows, N_PLANES), np.int32), 0, 0)
