"""Dictionary encoder: Terms → integer ids + metadata flag planes.

This is the single string-touching stage (host-side, vectorizable across
cores). Everything any metric predicate may ask about a term is computed here
once and packed into the TripleTensor planes.

The dictionary is keyed on the UTF-8 bytes of ``Term.key()`` (canonical,
injective over terms), which lets the vectorized ingest path
(``repro.rdf.ingest``) intern whole batches of deduplicated token
byte-slices without materializing Python strings; ``terms`` decodes lazily.
Per-id metadata lives in growable int32 arrays so per-chunk plane gathers
need no list→array conversion.
"""
from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

from . import vocab
from .parser import Term
from .triple_tensor import TripleTensor, N_PLANES, from_columns, mix32

# --- content hashing ---------------------------------------------------------
# 32-bit hash of a term's canonical key bytes (``Term.key()`` UTF-8).  This
# is what the HLL sketch planes carry: hashing *content* instead of term
# ids makes frozen register banks invariant to id renumbering (the
# repro.store reuse lever).  The form is a position-tagged tabulation-style
# mix — each (byte, position) pair runs through the murmur3 finalizer, the
# per-key values XOR-combine, and the length is folded into a final mix —
# so the whole batch vectorizes as one pass over the concatenated key blob
# (XOR is order-free; order sensitivity comes from the position tag).

_H_BYTE = np.uint32(0x9E3779B1)   # byte-lane multiplier
_H_POS = np.uint32(0x85EBCA77)    # position-tag multiplier

_mix32 = mix32    # shared murmur3 fmix32 (triple_tensor.mix32)


def content_hash_batch(blob: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """uint32 content hash of each ``blob[offsets[i]:offsets[i+1]]`` slice.

    ``blob``: uint8 array of concatenated key bytes; ``offsets``: int64
    array of K+1 boundaries.  Fully vectorized: O(total bytes) regardless
    of how key lengths are distributed.  Keys are never empty in practice
    (``Term.key()`` always carries delimiters), but an empty slice still
    hashes deterministically (to ``_mix32(0)``-of-length-0) for safety.
    """
    offsets = np.asarray(offsets, np.int64)
    lens = np.diff(offsets).astype(np.uint32)
    k = lens.size
    if k == 0:
        return np.zeros(0, np.uint32)
    pos = (np.arange(blob.size, dtype=np.uint32)
           - np.repeat(offsets[:-1].astype(np.uint32), np.diff(offsets)))
    v = _mix32((blob.astype(np.uint32) + np.uint32(1)) * _H_BYTE
               ^ pos * _H_POS)
    acc = np.zeros(k, np.uint32)
    nonempty = lens > 0
    starts = offsets[:-1][nonempty]
    if starts.size:
        # reduceat requires non-empty slices; empty keys keep acc 0
        acc[nonempty] = np.bitwise_xor.reduceat(v, starts)
    return _mix32(acc ^ lens * _H_POS)


def content_hash_keys(keys: Sequence[bytes]) -> np.ndarray:
    """``content_hash_batch`` over a sequence of key byte strings."""
    if not keys:
        return np.zeros(0, np.uint32)
    blob = np.frombuffer(b"".join(keys), np.uint8)
    offs = np.zeros(len(keys) + 1, np.int64)
    np.cumsum([len(kb) for kb in keys], out=offs[1:])
    return content_hash_batch(blob, offs)


class _IntBuf:
    """Append-friendly int32 array (amortized O(1) growth, zero-copy view)."""

    def __init__(self, cap: int = 1024):
        self._a = np.zeros(cap, np.int32)
        self.n = 0

    def append(self, v: int) -> None:
        if self.n == self._a.size:
            self._a = np.concatenate([self._a, np.zeros(self._a.size,
                                                        np.int32)])
        self._a[self.n] = v
        self.n += 1

    def extend(self, vals: np.ndarray) -> None:
        need = self.n + len(vals)
        if need > self._a.size:
            cap = max(need, 2 * self._a.size)
            a = np.zeros(cap, np.int32)
            a[:self.n] = self._a[:self.n]
            self._a = a
        self._a[self.n:need] = vals
        self.n = need

    def view(self) -> np.ndarray:
        return self._a[:self.n]


class TermDictionary:
    """Interns terms → dense int32 ids and caches their flag metadata."""

    def __init__(self, base_namespaces: Sequence[str] = ()):
        self.base_namespaces = tuple(base_namespaces)
        self._ids: dict[bytes, int] = {}   # utf-8 Term.key() bytes → id
        self._kb: list[bytes] = []         # id → key bytes
        self._flags = _IntBuf()
        self._lengths = _IntBuf()
        self._dts = _IntBuf()
        self._hashes = _IntBuf()   # content hash of key bytes (int32 view)
        self._terms_cache: list[str] | None = None

    def __len__(self) -> int:
        return len(self._kb)

    # -- per-id metadata views -------------------------------------------------
    @property
    def flags(self) -> np.ndarray:
        return self._flags.view()

    @property
    def lengths(self) -> np.ndarray:
        return self._lengths.view()

    @property
    def datatypes(self) -> np.ndarray:
        return self._dts.view()

    @property
    def hashes(self) -> np.ndarray:
        """Per-id 32-bit content hash of the term's key bytes (int32 view
        of the uint32 hash — planes are int32)."""
        return self._hashes.view()

    @property
    def terms(self) -> list[str]:
        """Term keys in id order (decoded lazily, cached)."""
        if self._terms_cache is None or len(self._terms_cache) != len(self._kb):
            self._terms_cache = [k.decode("utf-8") for k in self._kb]
        return self._terms_cache

    def _term_flags(self, t: Term) -> tuple[int, int, int]:
        """Returns (flags, length, datatype_id) for a term."""
        f = vocab.VALID
        length = len(t.value)
        dt_id = vocab.DT_NONE
        if t.kind == "iri":
            f |= vocab.KIND_IRI
            if vocab.iri_valid(t.value):
                f |= vocab.IRI_VALID
            if any(t.value.startswith(ns) for ns in self.base_namespaces):
                f |= vocab.INTERNAL
            if t.value in vocab.LICENSE_PREDICATES:
                f |= vocab.IS_LICENSE_PRED
            if t.value in vocab.LICENSE_INDICATION_PREDICATES:
                f |= vocab.IS_LICENSE_INDICATION
            if t.value in vocab.LABEL_PREDICATES:
                f |= vocab.IS_LABEL_PRED
            if t.value == vocab.SAMEAS:
                f |= vocab.IS_SAMEAS
            if t.value == vocab.RDFTYPE:
                f |= vocab.IS_RDFTYPE
        elif t.kind == "blank":
            f |= vocab.KIND_BLANK
        else:  # literal
            f |= vocab.KIND_LITERAL
            if t.lang:
                f |= vocab.HAS_LANG
                dt_id = vocab.DT_LANGSTRING
            if t.datatype:
                f |= vocab.HAS_DATATYPE
                dt_id = vocab.datatype_id(t.datatype)
            if vocab.lexical_ok(t.value, dt_id if t.datatype else vocab.DT_STRING):
                f |= vocab.LEXICAL_OK
            if vocab.is_license_statement(t.value):
                f |= vocab.IS_LICENSE_STATEMENT
        return f, length, dt_id

    def intern(self, t: Term) -> int:
        kb = t.key().encode("utf-8")
        tid = self._ids.get(kb)
        if tid is not None:
            return tid
        tid = len(self._kb)
        self._ids[kb] = tid
        f, length, dt = self._term_flags(t)
        self._kb.append(kb)
        self._flags.append(f)
        self._lengths.append(length)
        self._dts.append(dt)
        self._hashes.append(int(content_hash_keys([kb])[0].view(np.int32)))
        return tid

    # -- vectorized fast path (repro.rdf.ingest) ------------------------------
    def intern_keys_batch(self, key_bytes: Sequence[bytes],
                          flags: np.ndarray, lengths: np.ndarray,
                          datatypes: np.ndarray) -> np.ndarray:
        """Bulk-intern already-deduplicated terms → int64 id array.

        ``key_bytes`` must be distinct, in first-appearance order over the
        dataset (so ids come out identical to a per-term ``intern()`` loop),
        and each entry must be the UTF-8 of the decoded term's ``key()``;
        the supplied metadata must equal what ``_term_flags`` would compute.
        The differential suite holds the two implementations together.
        """
        if not self._ids:
            # fresh dictionary: every key is new, ids are just the sequence
            n = len(key_bytes)
            ids = np.arange(n, dtype=np.int64)
            self._ids.update(zip(key_bytes, range(n)))
            self._kb.extend(key_bytes)
            self._flags.extend(np.asarray(flags))
            self._lengths.extend(np.asarray(lengths))
            self._dts.extend(np.asarray(datatypes))
            self._hashes.extend(content_hash_keys(key_bytes).view(np.int32))
            return ids
        hits = list(map(self._ids.get, key_bytes))
        ids = np.empty(len(key_bytes), np.int64)
        base = len(self._kb)
        new_rows = []
        n_new = 0
        _ids = self._ids
        for i, tid in enumerate(hits):
            if tid is None:
                kb = key_bytes[i]
                tid = base + n_new
                _ids[kb] = tid
                self._kb.append(kb)
                new_rows.append(i)
                n_new += 1
            ids[i] = tid
        if new_rows:
            flags = np.asarray(flags)
            lengths = np.asarray(lengths)
            datatypes = np.asarray(datatypes)
            self._flags.extend(flags[new_rows])
            self._lengths.extend(lengths[new_rows])
            self._dts.extend(datatypes[new_rows])
            self._hashes.extend(content_hash_keys(
                [key_bytes[i] for i in new_rows]).view(np.int32))
        return ids

    def keys_for(self, ids) -> list[bytes]:
        """Term key bytes for an id sequence (e.g. a segment's dictionary
        footprint, persisted by ``repro.store``)."""
        kb = self._kb
        return [kb[int(i)] for i in ids]

    def plane_arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                    np.ndarray]:
        """Per-id (flags, lengths, datatypes, content hashes) int32 views
        for per-chunk plane gathers."""
        return (self._flags.view(), self._lengths.view(), self._dts.view(),
                self._hashes.view())


def encode(triples: Iterable[tuple[Term, Term, Term]],
           base_namespaces: Sequence[str] = (),
           dictionary: TermDictionary | None = None) -> TripleTensor:
    """Encode parsed triples into a TripleTensor (the *main dataset*)."""
    # NOT `dictionary or ...`: an empty TermDictionary is falsy (len 0) and
    # must still be used — and populated — when explicitly passed in.
    d = dictionary if dictionary is not None else TermDictionary(base_namespaces)
    s_ids, p_ids, o_ids = [], [], []
    for s, p, o in triples:
        s_ids.append(d.intern(s))
        p_ids.append(d.intern(p))
        o_ids.append(d.intern(o))
    flags, lengths, dts, hashes = d.plane_arrays()
    s = np.asarray(s_ids, dtype=np.int32)
    p = np.asarray(p_ids, dtype=np.int32)
    o = np.asarray(o_ids, dtype=np.int32)
    if len(s) == 0:
        return TripleTensor(np.zeros((0, N_PLANES), np.int32), 0, len(d))
    tt = from_columns(
        s, p, o, flags[s], flags[p], flags[o],
        lengths[s], lengths[p], lengths[o], dts[o], n_terms=len(d),
        s_hash=hashes[s], p_hash=hashes[p], o_hash=hashes[o])
    return tt


def encode_ntriples(text: str, base_namespaces: Sequence[str] = ()
                    ) -> TripleTensor:
    from .parser import parse_ntriples
    return encode(parse_ntriples(text), base_namespaces)
