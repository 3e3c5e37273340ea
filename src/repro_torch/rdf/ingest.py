"""Vectorized streaming N-Triples ingest (paper §2.2 steps 1-3, scaled up).

The reference path (``parser.parse_ntriples`` → ``encoder.encode``) walks the
input one line and one term at a time through Python regexes and a per-term
dict intern — at scale that bottlenecks ``qa.assess`` before a single kernel
runs.  This module is the industrialized replacement:

* **Byte-level tokenizer** — the raw block is viewed through
  ``np.frombuffer`` and scanned once for structural bytes (newlines, angle
  brackets, quotes, whitespace).  Sorted position arrays answer every
  "first ``>`` after *i*" question for *all* lines at once via
  ``searchsorted``; inter-token whitespace is skipped with short
  data-adaptive vector sweeps.  Token boundaries for an entire block are
  extracted with a handful of vectorized ops and **zero per-line regexes**.

* **Reference fallback, not reference drift** — lines the structural fast
  path is not certain about (malformed syntax, escaped literals, exotic
  whitespace, over-long tokens) are routed through the legacy parser, which
  also owns the malformed-line-as-sentinel-triple semantics.  Whatever mix
  of paths a block takes, the result is *byte-identical* to running the
  legacy parser+encoder over the same text (the differential suite in
  ``tests/test_ingest.py`` enforces this).

* **Batch dictionary encoding** — token byte-slices are gathered into
  fixed-width matrices (two width tiers) and deduplicated with one
  ``np.unique`` per tier over 64-bit row mixes, followed by an exact
  byte-equality verification against each class representative (on the
  astronomically rare mix collision the tier falls back to a full
  byte-wise ``np.unique``).  Flag/length/datatype metadata is then computed
  *once per unique term*: per-IRI work (syntactic validity, namespace
  prefixes, known-predicate membership) is fully vectorized over the
  unique-token matrix, and per-position planes are pure integer gathers
  through ``TermDictionary.intern_keys_batch``.

* **Bounded-memory streaming** — ``stream_chunks`` reads a file in blocks,
  splits only on line boundaries (carrying partial-line remainders), and
  yields ready ``TripleTensor`` chunks of exactly ``chunk_triples`` rows
  into ``dist.ChunkScheduler`` / ``qa.pipeline().streamed(...)``.  One
  shared ``TermDictionary`` spans the stream, so term ids are global and
  chunked metric values (including HLL distinct-count sketches over ids)
  are bit-identical to a single-shot pass.
"""
from __future__ import annotations

import gzip
import io
import os
from typing import BinaryIO, Iterator, Optional, Sequence, Union

import numpy as np

from . import vocab
from .encoder import TermDictionary
from .parser import escape_literal, parse_ntriples
from .triple_tensor import TripleTensor, N_PLANES, from_columns

# Tokens longer than this take the reference path (keeps the dedup matrices
# dense); covers every generator-produced IRI/literal with room to spare.
MAX_FAST_TOKEN = 128
_W1 = 64                # dense dedup tier; > _W1 uses the wide tier
_MAX_LANG = 24          # fast-path cap on @lang suffix length
_SKIP = 8               # max whitespace-run the vector sweeps resolve

_DEFAULT_CHUNK = 65_536

# Byte values the fast path reasons about.
_LT, _GT, _QUOTE, _BSLASH = 0x3C, 0x3E, 0x22, 0x5C
_HASH, _DOT, _USCORE, _COLON, _AT, _CARET = 0x23, 0x2E, 0x5F, 0x3A, 0x40, 0x5E

_FNV = np.uint64(0x100000001B3)


def _lut(chars: bytes) -> np.ndarray:
    t = np.zeros(256, bool)
    t[np.frombuffer(chars, np.uint8)] = True
    return t


_ALNUM = (bytes(range(0x30, 0x3A)) + bytes(range(0x41, 0x5B))
          + bytes(range(0x61, 0x7B)))
_LANG_LUT = _lut(_ALNUM + b"-")                 # [A-Za-z0-9-]
_ALPHA_LUT = _lut(_ALNUM[10:])                  # [A-Za-z]
_SCHEME_LUT = _lut(_ALNUM + b"+.-")             # [A-Za-z0-9+.-]
# vocab._IRI_RE tail: [^\s<>"{}|^`\\] — ASCII blacklist (unicode whitespace
# cannot reach the fast path: its UTF-8 lead bytes are weird-routed)
_TAIL_BAD_LUT = _lut(b'\t\n\x0b\x0c\r <>"{}|^`\\')

_DT_IDS_B = {k.encode("utf-8"): v for k, v in vocab.DATATYPE_IDS.items()}
_INT_DT = (vocab.XSD_NS + "integer").encode("utf-8")
_INT_DT_SUFFIX = np.frombuffer(b"^^<" + _INT_DT + b">", np.uint8)
_DIGIT_LUT = _lut(_ALNUM[:10])
# numeric-ish literal values contain no letters, so no license-statement
# pattern (they all need letters) can match — the regex is skipped for them
_NUMERICISH_LUT = _lut(_ALNUM[:10] + b"+-.eE")

# single-gather byte classifiers for the block scan
_WS_LUT = _lut(b" \t")
_WEIRD_LUT = np.zeros(256, bool)
_WEIRD_LUT[:0x20] = True
_WEIRD_LUT[[0x09, 0x0A]] = False
_WEIRD_LUT[[0xC2, 0xE1, 0xE2, 0xE3]] = True
# structural byte classes: 1=ws 2='>' 3='"' 4='\' 5=weird (0 = plain)
_CLS_LUT = np.zeros(256, np.uint8)
_CLS_LUT[_WEIRD_LUT] = 5
_CLS_LUT[[0x20, 0x09]] = 1
_CLS_LUT[_GT] = 2
_CLS_LUT[_QUOTE] = 3
_CLS_LUT[_BSLASH] = 4
_CLS_LUT[0x0A] = 6


class _Scan:
    """One-pass positional index over a block of N-Triples bytes: sorted
    occurrence arrays that make per-line structural questions vectorized
    ``searchsorted`` lookups."""

    def __init__(self, data: bytes):
        buf = np.frombuffer(data, np.uint8)
        self.buf = buf
        self.n = n = buf.size
        # one classifying pass over the block, then split the (much smaller)
        # hit list per structural byte class
        hits = np.flatnonzero(_CLS_LUT[buf])
        cls = _CLS_LUT[buf[hits]]
        self.ws = hits[cls == 1]
        self.gt = hits[cls == 2]
        self.quote = hits[cls == 3]
        self.bslash = hits[cls == 4]
        # Bytes that force a line onto the reference path: control chars the
        # legacy str machinery treats as whitespace/line breaks (\r \v \f ...)
        # and the UTF-8 lead bytes that can start a unicode space/line break
        # (NEL, NBSP, ogham, U+2000-, ideographic — 0xC2/0xE1/0xE2/0xE3;
        # over-approximate on purpose: fallback is never wrong, only slower).
        self.weird = hits[cls == 5]
        self.nl = hits[cls == 6]

    # vectorized positional lookups -------------------------------------------
    def next_at(self, idx: np.ndarray, pos) -> np.ndarray:
        """First position in sorted ``idx`` that is >= pos (n when none)."""
        if idx.size == 0:
            return np.full(np.shape(pos), self.n)
        i = np.searchsorted(idx, pos)
        return np.where(i < idx.size, idx[np.minimum(i, idx.size - 1)], self.n)

    def count_in(self, idx: np.ndarray, a, b) -> np.ndarray:
        """Occurrences of ``idx`` positions within [a, b)."""
        return np.searchsorted(idx, b) - np.searchsorted(idx, a)

    def _is_ws_at(self, pos) -> np.ndarray:
        return _WS_LUT[self.buf[np.clip(pos, 0, self.n - 1)]]

    def skip_ws_fwd(self, pos: np.ndarray, bound: np.ndarray):
        """Advance past spaces/tabs while pos < bound; data-adaptive, at
        most ``_SKIP`` steps.  Returns (pos', resolved) — an unresolved row
        (a longer whitespace run) must take the reference path."""
        pos = pos.copy()
        for _ in range(_SKIP):
            m = self._is_ws_at(pos) & (pos < bound)
            if not m.any():
                return pos, np.ones(pos.shape, bool)
            pos[m] += 1
        return pos, ~(self._is_ws_at(pos) & (pos < bound))

    def skip_ws_back(self, pos: np.ndarray, bound: np.ndarray):
        """Mirror of ``skip_ws_fwd``: retreat while pos >= bound."""
        pos = pos.copy()
        for _ in range(_SKIP):
            m = self._is_ws_at(pos) & (pos >= bound)
            if not m.any():
                return pos, np.ones(pos.shape, bool)
            pos[m] -= 1
        return pos, ~(self._is_ws_at(pos) & (pos >= bound))


def _line_table(scan: _Scan):
    """Split the block into lines → (start, end, lo, hi, forced_fb) per line
    that is not provably blank or a comment.  ``[start, end)`` are raw line
    bounds (sans terminator, with a trailing ``\\r`` shaved off); ``[lo, hi]``
    spans the stripped content; ``forced_fb`` marks lines the whitespace
    sweeps could not resolve (reference path decides them)."""
    buf, n = scan.buf, scan.n
    nl = scan.nl
    start = np.concatenate([[0], nl + 1])
    end = np.concatenate([nl, [n]])
    keep = start < end                       # drop empty tail after final \n
    start, end = start[keep], end[keep]
    crlf = buf[np.maximum(end - 1, 0)] == 0x0D
    end = end - crlf.astype(end.dtype)       # \r\n: \r is part of the break
    lo, r1 = scan.skip_ws_fwd(start, end)
    hi, r2 = scan.skip_ws_back(end - 1, start)
    resolved = r1 & r2
    blank = resolved & (lo >= end)
    # a '#' line is only a whole-line comment if it holds none of the bytes
    # the legacy str machinery treats as line breaks (\r \f NEL ...) — with
    # one embedded, legacy splits the line and parses the remainder, so the
    # reference path must decide it (blank lines cannot hide such bytes:
    # they are non-ws, so the line would not be blank)
    comment = (resolved & ~blank
               & (buf[np.clip(lo, 0, n - 1)] == _HASH)
               & (scan.count_in(scan.weird, np.minimum(lo, n), end) == 0))
    keep2 = ~(blank | comment)
    return (start[keep2], end[keep2], lo[keep2], hi[keep2],
            ~resolved[keep2])


def _fast_spans(scan: _Scan, lo: np.ndarray, hi: np.ndarray,
                forced_fb: np.ndarray):
    """Vectorized structural tokenization of all candidate lines at once.

    Returns ``(ok, spans)`` — ``spans[i]`` holds the three ``[start, end)``
    token byte-spans of line *i*; ``ok[i]`` is True only when the line is a
    shape the fast path handles with *provably* legacy-identical results.
    Every check errs strict: a rejected line goes to the reference parser,
    which by definition cannot disagree with itself.
    """
    buf, n = scan.buf, scan.n
    L = lo.size
    spans = np.zeros((L, 3, 2), np.int64)
    if L == 0:
        return np.zeros(0, bool), spans

    def peek(pos):
        return buf[np.minimum(pos, n - 1)]

    # line-level prefilters: no legacy-whitespace/line-break oddities, a
    # terminal '.', and at least one token byte before it
    ok = ~forced_fb
    ok &= scan.count_in(scan.weird, lo, hi + 1) == 0
    ok &= peek(hi) == _DOT
    o_lim, res = scan.skip_ws_back(hi - 1, lo)   # last byte before the '.'
    ok &= res & (o_lim >= lo)

    # -- subject: <...> | _:label ---------------------------------------------
    s_iri = peek(lo) == _LT
    g1 = scan.next_at(scan.gt, lo)
    s_blank = (peek(lo) == _USCORE) & (peek(lo + 1) == _COLON)
    w1 = scan.next_at(scan.ws, lo)
    s_end = np.where(s_iri, g1 + 1, w1)
    ok &= s_iri | (s_blank & (w1 >= lo + 3))
    ok &= s_end <= o_lim

    # \s+ gap, then predicate: <...>
    p_start, res = scan.skip_ws_fwd(s_end, hi)
    ok &= res & (p_start > s_end) & (p_start < o_lim)
    ok &= peek(p_start) == _LT
    g2 = scan.next_at(scan.gt, p_start)
    p_end = g2 + 1
    ok &= p_end <= o_lim

    # \s+ gap, then object: <...> | _:label | "..."(@lang | ^^<dt>)?
    o_start, res = scan.skip_ws_fwd(p_end, hi)
    ok &= res & (o_start > p_end) & (o_start <= o_lim)
    b0 = peek(o_start)
    is_oi = b0 == _LT
    is_ob = (b0 == _USCORE) & (peek(o_start + 1) == _COLON)
    is_ol = b0 == _QUOTE
    ok &= is_oi | is_ob | is_ol

    g3 = scan.next_at(scan.gt, o_start)
    oi_ok = g3 == o_lim                      # IRI runs exactly to the end
    w3 = scan.next_at(scan.ws, o_start)
    ob_ok = (w3 > o_lim) & (o_lim >= o_start + 2)   # \S+ to the end
    # literal: closing quote = next quote (no backslash anywhere in the
    # object, so no escaped quotes), suffix empty | @lang | ^^<dt>
    q2 = scan.next_at(scan.quote, o_start + 1)
    no_bs = scan.count_in(scan.bslash, o_start, o_lim + 1) == 0
    wq = scan.next_at(scan.ws, q2 + 1)
    sl = o_lim - q2                          # suffix byte length
    suf_plain = sl == 0
    # @lang: every suffix byte after '@' in [A-Za-z0-9-] (bounded sweep,
    # restricted to the rows that actually carry an @ suffix)
    suf_lang = (sl >= 2) & (sl <= _MAX_LANG) & (peek(q2 + 1) == _AT)
    cand = np.flatnonzero(suf_lang)
    if cand.size:
        cq, csl = q2[cand], sl[cand]
        bad = np.zeros(cand.size, bool)
        for k in range(1, int(csl.max())):
            bad |= (k < csl) & ~_LANG_LUT[peek(cq + 1 + k)]
        suf_lang[cand[bad]] = False
    suf_dt = ((sl >= 4) & (peek(q2 + 1) == _CARET) & (peek(q2 + 2) == _CARET)
              & (peek(q2 + 3) == _LT) & (peek(o_lim) == _GT)
              & (scan.next_at(scan.gt, np.minimum(q2 + 4, n)) == o_lim))
    ol_ok = ((q2 <= o_lim) & no_bs & (wq > o_lim)
             & (suf_plain | suf_lang | suf_dt))

    o_end = np.where(is_oi, g3 + 1, o_lim + 1)
    ok &= np.where(is_oi, oi_ok, np.where(is_ob, ob_ok, ol_ok))

    spans[:, 0, 0], spans[:, 0, 1] = lo, s_end
    spans[:, 1, 0], spans[:, 1, 1] = p_start, p_end
    spans[:, 2, 0], spans[:, 2, 1] = o_start, o_end
    ok &= (spans[:, :, 1] - spans[:, :, 0] <= MAX_FAST_TOKEN).all(axis=1)
    return ok, spans


# length-indexed tail masks: _TAIL_MASK[W][l] keeps the first l bytes of a row
_TAIL_MASK = {W: (np.arange(W)[None, :]
                  < np.arange(W + 1)[:, None]).astype(np.uint8)
              for W in (_W1, MAX_FAST_TOKEN)}


def _tier_dedup(pad: np.ndarray, ts: np.ndarray, lens: np.ndarray, W: int):
    """Exact dedup of equal-tier tokens: gather into a zero-padded (T, W)
    matrix, ``np.unique`` over a 64-bit FNV-style row mix, then verify every
    occurrence byte-equals its class representative (collision → exact
    byte-wise ``np.unique``).  Returns (umat, ulen, inv)."""
    win = np.lib.stride_tricks.sliding_window_view(pad, W)
    mat = win[ts]
    mat *= _TAIL_MASK[W][lens]
    u = mat.view(np.uint64)
    h = u[:, 0] * _FNV
    for j in range(1, W // 8):
        h = (h ^ u[:, j]) * _FNV
    _, first, inv = np.unique(h, return_index=True, return_inverse=True)
    inv = inv.reshape(-1).astype(np.int32)
    # exact verification: every occurrence in a multi-member class must
    # byte-equal its class representative (singletons are trivially fine)
    multi = np.flatnonzero(np.bincount(inv)[inv] > 1)
    if not (u[first][inv[multi]] == u[multi]).all():
        _, first, inv = np.unique(mat.view(f"V{W}").ravel(),
                                  return_index=True, return_inverse=True)
        inv = inv.reshape(-1).astype(np.int32)
    return mat[first], lens[first], inv


def _dedup_tokens(data: bytes, spans: np.ndarray):
    """Batch dedup over token byte-slices in two width tiers.

    Returns ``(tiers, inv)`` — ``tiers`` is a list of (umat, ulen) unique
    token matrices, ``inv`` maps each occurrence to its global class id
    (tier-1 classes first).
    """
    ts, te = spans[:, 0], spans[:, 1]
    lens = te - ts
    pad = np.frombuffer(data + b"\0" * MAX_FAST_TOKEN, np.uint8)
    small = lens <= _W1
    inv = np.empty(ts.size, np.int32)
    tiers = []
    n_classes = 0
    for W, rows in ((_W1, np.flatnonzero(small)),
                    (MAX_FAST_TOKEN, np.flatnonzero(~small))):
        if rows.size == 0:
            continue
        umat, ulen, tinv = _tier_dedup(pad, ts[rows], lens[rows], W)
        inv[rows] = n_classes + tinv
        n_classes += umat.shape[0]
        tiers.append((umat, ulen))
    return tiers, inv


def _iri_flags(umat: np.ndarray, ulen: np.ndarray,
               base_ns: Sequence[str]) -> np.ndarray:
    """Vectorized ``TermDictionary._term_flags`` for unique IRI tokens.

    ``umat``: (K, W) token rows ``<value>`` zero-padded; ``ulen`` byte
    lengths.  Reproduces ``vocab.iri_valid`` (byte-level — exact, because
    multi-byte whitespace cannot reach the fast path), namespace prefixes,
    and the known-predicate memberships, with no per-term Python.
    """
    K, W = umat.shape
    f = np.full(K, vocab.VALID | vocab.KIND_IRI, np.int32)
    if K == 0:
        return f
    # --- iri_valid: [A-Za-z][A-Za-z0-9+.-]*://?[^\s<>"{}|^`\\]*$ ------------
    colon = umat == _COLON
    has_colon = colon.any(axis=1)            # only value bytes can hold ':'
    c = np.argmax(colon, axis=1)             # first ':' (row index)
    first_ok = _ALPHA_LUT[umat[:, 1]] & (c >= 2)
    cs_scheme = np.cumsum(_SCHEME_LUT[umat], axis=1, dtype=np.int32)
    take = np.take_along_axis
    # scheme chars fill (1, c): cumsum through c-1 equals c-1 ('<' at 0 is
    # not a scheme char, so cs[:, c-1] counts exactly the value prefix)
    scheme_ok = take(cs_scheme, np.maximum(c - 1, 0)[:, None],
                     1).ravel() == c - 1
    slash = take(umat, np.minimum(c + 1, W - 1)[:, None], 1).ravel() == 0x2F
    second = (take(umat, np.minimum(c + 2, W - 1)[:, None], 1).ravel()
              == 0x2F) & (c + 2 < ulen - 1)
    skip = c + 2 + second                    # tail starts here
    cs_bad = np.cumsum(_TAIL_BAD_LUT[umat], axis=1, dtype=np.int32)
    hi_cnt = take(cs_bad, np.maximum(ulen - 2, 0)[:, None], 1).ravel()
    lo_cnt = take(cs_bad, np.minimum(np.maximum(skip - 1, 0), W - 1)[:, None],
                  1).ravel()
    tail_ok = (skip >= ulen - 1) | (hi_cnt - lo_cnt == 0)
    valid = has_colon & first_ok & scheme_ok & slash & tail_ok
    f |= np.where(valid, vocab.IRI_VALID, 0).astype(np.int32)
    # --- INTERNAL: value startswith any base namespace -----------------------
    internal = np.zeros(K, bool)
    for ns in base_ns:
        nsb = np.frombuffer(ns.encode("utf-8"), np.uint8)
        if 0 < nsb.size <= W - 1:
            internal |= (umat[:, 1:1 + nsb.size] == nsb).all(axis=1)
    f |= np.where(internal, vocab.INTERNAL, 0).astype(np.int32)
    # --- known-predicate memberships (exact token match via np.isin) ---------
    uvoids = np.ascontiguousarray(umat).view(f"V{W}").ravel()
    for flag, known in _known_token_voids(W):
        if known.size:
            f |= np.where(np.isin(uvoids, known), flag, 0).astype(np.int32)
    return f


_KNOWN_VOIDS: dict = {}


def _known_token_voids(W: int):
    """(flag, void-array of '<iri>' tokens) per vocab membership set,
    padded to width ``W`` — computed once per width."""
    if W not in _KNOWN_VOIDS:
        out = []
        for flag, iris in (
                (vocab.IS_LICENSE_PRED, vocab.LICENSE_PREDICATES),
                (vocab.IS_LICENSE_INDICATION,
                 vocab.LICENSE_INDICATION_PREDICATES),
                (vocab.IS_LABEL_PRED, vocab.LABEL_PREDICATES),
                (vocab.IS_SAMEAS, (vocab.SAMEAS,)),
                (vocab.IS_RDFTYPE, (vocab.RDFTYPE,))):
            toks = [("<" + i + ">").encode("utf-8") for i in iris]
            toks = [t for t in toks if len(t) <= W]
            if toks:
                m = np.zeros((len(toks), W), np.uint8)
                for j, t in enumerate(toks):
                    m[j, :len(t)] = np.frombuffer(t, np.uint8)
                out.append((flag, np.sort(m.view(f"V{W}").ravel())))
            else:
                out.append((flag, np.zeros(0, f"V{W}")))
        _KNOWN_VOIDS[W] = out
    return _KNOWN_VOIDS[W]


def _unique_metadata(umat: np.ndarray, ulen: np.ndarray, d: TermDictionary):
    """Per-unique-term (key bytes, flags, lengths, datatypes) for one tier.

    Keys are the UTF-8 of the decoded term's ``Term.key()`` — which IS the
    raw token for every escape-free term, so no Python string ever
    materializes on the hot path.  IRI flags and the common literal shapes
    (plain, @lang, xsd:integer-typed) are fully vectorized; remaining
    literals take a short Python pass for datatype ids, lexical validation,
    and license-statement detection (exactly ``_term_flags``'s semantics on
    the decoded value).
    """
    U, W = umat.shape
    b0 = umat[:, 0]
    is_iri = b0 == _LT
    is_blank = b0 == _USCORE
    is_lit = b0 == _QUOTE

    flags = np.zeros(U, np.int32)
    dts = np.zeros(U, np.int32)
    iri_rows = np.flatnonzero(is_iri)
    flags[iri_rows] = _iri_flags(umat[iri_rows], ulen[iri_rows],
                                 d.base_namespaces)
    flags[is_blank] = vocab.VALID | vocab.KIND_BLANK
    # char length = byte length - 2 delimiters - UTF-8 continuation bytes
    # (exact for IRIs/blanks; literal rows are overwritten below)
    cont = ((umat & 0xC0) == 0x80).sum(axis=1, dtype=np.int64)
    lengths = ulen - 2 - cont

    raw = umat.tobytes()
    ulen_l = ulen.tolist()
    keys = [raw[i * W:i * W + ulen_l[i]] for i in range(U)]
    rekeyed = False   # a key transform may alias two distinct tokens

    lit_rows = np.flatnonzero(is_lit)
    if lit_rows.size:
        take = np.take_along_axis
        lmat = umat[lit_rows]
        lulen = ulen[lit_rows]
        lcont = cont[lit_rows]
        qs = (lmat[:, 1:] == _QUOTE).argmax(axis=1) + 1
        sb = take(lmat, np.minimum(qs + 1, W - 1)[:, None], 1).ravel()
        l_plain = qs == lulen - 1
        l_lang = ~l_plain & (sb == _AT)
        l_typed = ~l_plain & (sb == _CARET)
        # values without letters can't match any license pattern
        cs_num = np.cumsum(_NUMERICISH_LUT[lmat], axis=1, dtype=np.int32)
        numish = take(cs_num, (qs - 1)[:, None], 1).ravel() == qs - 1
        tabbed = (lmat == 0x09).any(axis=1)   # value holds a raw \t
        # ^^<…XMLSchema#integer> suffix + [+-]?\d+ value: fully vectorized
        K = _INT_DT_SUFFIX.size
        sfx_idx = np.minimum((qs + 1)[:, None] + np.arange(K), W - 1)
        int_sfx = (l_typed & (lulen - qs - 1 == K)
                   & (take(lmat, sfx_idx, 1) == _INT_DT_SUFFIX).all(axis=1))
        b1 = lmat[:, 1]
        sign = (b1 == 0x2B) | (b1 == 0x2D)
        cs_dig = np.cumsum(_DIGIT_LUT[lmat], axis=1, dtype=np.int32)
        ndig = (take(cs_dig, (qs - 1)[:, None], 1).ravel()
                - take(cs_dig, np.minimum(sign + 0, W - 1)[:, None],
                       1).ravel())
        int_ok = (ndig == qs - 1 - sign) & (qs - 1 - sign >= 1)

        LIT = vocab.VALID | vocab.KIND_LITERAL
        lf = np.full(lit_rows.size, LIT, np.int32)
        lf |= np.where(l_plain | l_lang, vocab.LEXICAL_OK, 0).astype(np.int32)
        lf |= np.where(l_lang, vocab.HAS_LANG, 0).astype(np.int32)
        lf |= np.where(int_sfx, vocab.HAS_DATATYPE, 0).astype(np.int32)
        lf |= np.where(int_sfx & int_ok, vocab.LEXICAL_OK, 0).astype(np.int32)
        ldt = np.where(l_lang, vocab.DT_LANGSTRING,
                       np.where(int_sfx, vocab.DT_INTEGER, 0)).astype(np.int32)
        flags[lit_rows] = lf
        dts[lit_rows] = ldt
        lengths[lit_rows] = qs - 1 - lcont    # suffixes are ASCII here
        # keys: Term.key() == the raw token for every escape-free literal
        # rows the slow reference loop will fully recompute; typed literals
        # with non-ASCII values must go there too — the reference lexical
        # regexes are unicode-aware (\d matches e.g. Arabic-Indic digits),
        # the vectorized digit check is byte-level
        nonascii = (lmat >= 0x80).any(axis=1)
        slow_mask = (l_typed & (~int_sfx | nonascii)) | tabbed
        # license-statement scan everywhere else a pattern could match
        lic_search = vocab.LICENSE_STATEMENT_RE.search
        lic_rows = ~numish & ~slow_mask
        for i, q in zip(lit_rows[lic_rows].tolist(), qs[lic_rows].tolist()):
            kb = keys[i]
            if lic_search(kb[1:q].decode("utf-8")) is not None:
                flags[i] |= vocab.IS_LICENSE_STATEMENT
        slow = np.flatnonzero(slow_mask)
        dt_get = _DT_IDS_B.get
        lex = vocab.lexical_ok
        for i, q in zip(lit_rows[slow].tolist(), qs[slow].tolist()):
            kb = keys[i]
            suffix = kb[q + 1:]
            value = kb[1:q].decode("utf-8")
            f = LIT
            dt_id = 0
            suffix_key = suffix
            if not suffix:
                f |= vocab.LEXICAL_OK        # lexical_ok(value, DT_STRING)
            elif suffix[0:1] == b"@":
                f |= vocab.HAS_LANG | vocab.LEXICAL_OK   # langString: .*
                dt_id = vocab.DT_LANGSTRING
            elif suffix == b"^^<>":          # empty datatype IRI is falsy —
                f |= vocab.LEXICAL_OK        # legacy treats it as untyped
                suffix_key = b""
            else:                            # ^^<datatype> — key keeps it
                f |= vocab.HAS_DATATYPE
                dt_id = dt_get(suffix[3:-1], vocab.DT_OTHER)
                if lex(value, dt_id):
                    f |= vocab.LEXICAL_OK
            if lic_search(value) is not None:
                f |= vocab.IS_LICENSE_STATEMENT
            flags[i] = f
            dts[i] = dt_id
            lengths[i] = len(value)
            if "\t" in value:                # Term.key() re-escapes \t
                keys[i] = (b'"' + escape_literal(value).encode("utf-8")
                           + b'"' + suffix_key)
                rekeyed = True
            elif suffix_key is not suffix:
                keys[i] = kb[:q + 1] + suffix_key
                rekeyed = rekeyed or suffix == b"^^<>"
    return keys, flags, lengths, dts, rekeyed


def _encode_block(data: bytes, dictionary: TermDictionary) -> np.ndarray:
    """Tokenize + dictionary-encode one block of complete lines → planes.

    Byte-identical to ``encode(parse_ntriples(text))`` with the same
    (shared, possibly pre-populated) dictionary.
    """
    if not data:
        return np.zeros((0, N_PLANES), np.int32)
    scan = _Scan(data)
    if scan.buf.max() >= 0x80:
        # match the reference path's contract (it only ever sees decoded
        # text): invalid UTF-8 fails loudly at ingest, not via a poisoned
        # dictionary or a deep per-line decode. Blocks are split on line
        # boundaries and multi-byte sequences never contain 0x0A, so block
        # edges cannot cut a character.
        data.decode("utf-8")
    start, end, lo, hi, forced_fb = _line_table(scan)
    ok, spans = _fast_spans(scan, lo, hi, forced_fb)
    L = lo.size

    # reference path for everything the fast path is not sure about; owns
    # comment/blank re-splitting and the malformed-line sentinel semantics
    fb_rows = np.flatnonzero(~ok)
    fb_counts = np.zeros(fb_rows.size, np.int64)
    fb_terms = []
    for j, r in enumerate(fb_rows):
        triples = parse_ntriples(data[start[r]:end[r]].decode("utf-8"))
        fb_counts[j] = len(triples)
        for s, p, o in triples:
            fb_terms.append(s)
            fb_terms.append(p)
            fb_terms.append(o)

    # batch-dedup fast tokens → classes 0..U-1, with vectorized metadata
    fast_spans = spans[ok].reshape(-1, 2)
    rekeyed = False
    if fast_spans.shape[0]:
        tiers, inv = _dedup_tokens(data, fast_spans)
        keys_l, flags_l, lengths_l, dts_l = [], [], [], []
        for umat, ulen in tiers:
            k, f, ln, dt, rk = _unique_metadata(umat, ulen, dictionary)
            keys_l.extend(k)
            flags_l.append(f)
            lengths_l.append(ln)
            dts_l.append(dt)
            rekeyed = rekeyed or rk
        class_keys = keys_l
        fast_flags = np.concatenate(flags_l)
        fast_lengths = np.concatenate(lengths_l)
        fast_dts = np.concatenate(dts_l)
    else:
        inv = np.zeros(0, np.int64)
        class_keys = []
        fast_flags = np.zeros(0, np.int32)
        fast_lengths = np.zeros(0, np.int64)
        fast_dts = np.zeros(0, np.int32)

    # fallback terms join the class space, unified by key bytes; a key
    # transform (e.g. ""^^<> → "") can alias two distinct fast tokens, so
    # build the canonicalization map whenever either source of duplicate
    # keys exists (token↔key is bijective otherwise)
    fb_class = np.empty(len(fb_terms), np.int32)
    fb_flags, fb_lengths, fb_dts = [], [], []
    canon = None
    if fb_terms or rekeyed:
        key_to_class: dict[bytes, int] = {}
        canon = np.arange(len(class_keys) + len(fb_terms), dtype=np.int32)
        for i, k in enumerate(class_keys):
            j = key_to_class.setdefault(k, i)
            if j != i:
                canon[i] = j
        for i, t in enumerate(fb_terms):
            kb = t.key().encode("utf-8")
            c = key_to_class.get(kb)
            if c is None:
                c = len(class_keys)
                key_to_class[kb] = c
                class_keys.append(kb)
                f, length, dt = dictionary._term_flags(t)
                fb_flags.append(f)
                fb_lengths.append(length)
                fb_dts.append(dt)
            fb_class[i] = c
    all_flags = np.concatenate([fast_flags, np.asarray(fb_flags, np.int32)])
    all_lengths = np.concatenate([fast_lengths,
                                  np.asarray(fb_lengths, np.int64)])
    all_dts = np.concatenate([fast_dts, np.asarray(fb_dts, np.int32)])

    # interleave fast and fallback triples back into line order
    n_per_line = np.ones(L, np.int64)
    n_per_line[fb_rows] = fb_counts
    offsets = np.concatenate([[0], np.cumsum(n_per_line)])
    N = int(offsets[-1])
    if N == 0:
        return np.zeros((0, N_PLANES), np.int32)
    cls = np.empty((N, 3), np.int32)
    cls[offsets[:-1][ok]] = inv.reshape(-1, 3)
    if fb_rows.size:
        fb_pos = np.concatenate([
            offsets[r] + np.arange(k)
            for r, k in zip(fb_rows, fb_counts)]).astype(np.int64)
        cls[fb_pos] = fb_class.reshape(-1, 3)
    if canon is not None:
        cls = canon[cls]

    # global first-appearance order over the flattened (s0,p0,o0,s1,...)
    # sequence = the exact order the per-term intern() loop would assign ids
    flat = cls.reshape(-1)
    present, first_pos = np.unique(flat, return_index=True)
    order = np.argsort(first_pos, kind="stable")
    ordered = present[order]
    gids = dictionary.intern_keys_batch(
        [class_keys[c] for c in ordered.tolist()],
        all_flags[ordered], all_lengths[ordered], all_dts[ordered])
    class_gid = np.zeros(len(class_keys), np.int64)
    class_gid[ordered] = gids
    ids = class_gid[cls]

    flags, lengths, dts, hashes = dictionary.plane_arrays()
    s, p, o = ids[:, 0], ids[:, 1], ids[:, 2]
    return from_columns(s, p, o, flags[s], flags[p], flags[o],
                        lengths[s], lengths[p], lengths[o], dts[o],
                        s_hash=hashes[s], p_hash=hashes[p],
                        o_hash=hashes[o]).planes


# --- public API ---------------------------------------------------------------

GZIP_MAGIC = b"\x1f\x8b"


def maybe_decompress(data: bytes) -> bytes:
    """Transparently gunzip gzipped N-Triples bytes (real LOD dumps ship
    as ``.nt.gz``; fetched cache files carry no suffix, so detection is
    by magic bytes, not by name)."""
    if data[:2] == GZIP_MAGIC:
        return gzip.decompress(data)
    return data


def open_nt(path: Union[str, os.PathLike]) -> BinaryIO:
    """Open an N-Triples file for binary streaming, transparently
    decoding gzip (sniffed by magic bytes) with bounded memory — the
    returned file object decompresses incrementally, so block-wise
    consumers (``stream_chunks``, the CDC segmenter) never hold the
    inflated dataset."""
    f = open(os.fspath(path), "rb")
    try:
        magic = f.read(2)
        f.seek(0)
    except OSError:
        f.close()
        raise
    if magic == GZIP_MAGIC:
        return gzip.GzipFile(fileobj=f)
    return f


def parse_encode(data: Union[str, bytes], base_namespaces: Sequence[str] = (),
                 dictionary: Optional[TermDictionary] = None) -> TripleTensor:
    """Vectorized drop-in for ``encode_ntriples``: N-Triples text/bytes →
    ``TripleTensor``, byte-identical to the legacy parse→encode path
    (planes, ``n_terms``, and dictionary term keys all match).  Gzipped
    bytes are decompressed transparently."""
    if isinstance(data, str):
        data = data.encode("utf-8")
    else:
        data = maybe_decompress(data)
    d = dictionary if dictionary is not None else TermDictionary(base_namespaces)
    planes = _encode_block(data, d)
    return TripleTensor(planes, planes.shape[0], len(d))


def stream_chunks(path: Union[str, os.PathLike],
                  chunk_triples: int = _DEFAULT_CHUNK, *,
                  base_namespaces: Sequence[str] = (),
                  dictionary: Optional[TermDictionary] = None,
                  block_bytes: Optional[int] = None
                  ) -> Iterator[TripleTensor]:
    """Stream an N-Triples file as ready ``TripleTensor`` chunks of exactly
    ``chunk_triples`` rows (the last may be short) without ever
    materializing the whole dataset.

    Blocks of ``block_bytes`` are read and split only on line boundaries —
    a partial trailing line is carried into the next block — so resident
    plane memory is bounded by the chunk size plus one read block,
    independent of file size.  One ``TermDictionary`` (optionally supplied,
    e.g. to share across files) spans the stream: term ids are global, and
    feeding the chunks to ``dist.ChunkScheduler`` reproduces the
    single-shot assessment bit-for-bit, HLL sketches included.
    """
    d = dictionary if dictionary is not None else TermDictionary(base_namespaces)
    with open_nt(path) as f:
        yield from _stream_fileobj(f, chunk_triples, d, block_bytes)


def stream_chunks_text(text: Union[str, bytes],
                       chunk_triples: int = _DEFAULT_CHUNK, *,
                       base_namespaces: Sequence[str] = (),
                       dictionary: Optional[TermDictionary] = None,
                       block_bytes: Optional[int] = None
                       ) -> Iterator[TripleTensor]:
    """``stream_chunks`` over in-memory N-Triples text (for text datasets
    fed to a streamed pipeline).  Gzipped bytes decompress transparently."""
    if isinstance(text, str):
        text = text.encode("utf-8")
    else:
        text = maybe_decompress(text)
    d = dictionary if dictionary is not None else TermDictionary(base_namespaces)
    yield from _stream_fileobj(io.BytesIO(text), chunk_triples, d, block_bytes)


def _stream_fileobj(f: BinaryIO, chunk_triples: int, d: TermDictionary,
                    block_bytes: Optional[int]) -> Iterator[TripleTensor]:
    if chunk_triples <= 0:
        raise ValueError(f"chunk_triples must be > 0, got {chunk_triples}")
    if block_bytes is None:
        # aim for roughly one chunk of triples per read (~96 B/triple)
        block_bytes = min(max(chunk_triples * 96, 1 << 16), 32 << 20)
    pending: list[np.ndarray] = []
    n_pending = 0
    parts: list[bytes] = []      # blocks of the current partial line(s);
                                 # joined lazily so a huge newline-free line
                                 # accumulates linearly, not quadratically

    def _take(k: int) -> TripleTensor:
        nonlocal n_pending
        got, acc = 0, []
        while got < k:
            a = pending[0]
            need = k - got
            if a.shape[0] <= need:
                acc.append(pending.pop(0))
                got += a.shape[0]
            else:
                acc.append(a[:need])
                pending[0] = a[need:]
                got = k
        n_pending -= k
        planes = acc[0] if len(acc) == 1 else np.concatenate(acc)
        return TripleTensor(np.ascontiguousarray(planes), planes.shape[0],
                            len(d))

    while True:
        block = f.read(block_bytes)
        if not block:
            break
        cut = block.rfind(b"\n")
        if cut < 0:              # no complete line yet — keep accumulating
            parts.append(block)
            continue
        data = b"".join(parts + [block[:cut + 1]])
        parts = [block[cut + 1:]] if cut + 1 < len(block) else []
        planes = _encode_block(data, d)
        if planes.shape[0]:
            pending.append(planes)
            n_pending += planes.shape[0]
        while n_pending >= chunk_triples:
            yield _take(chunk_triples)
    if parts:                    # final line without a trailing newline
        planes = _encode_block(b"".join(parts), d)
        if planes.shape[0]:
            pending.append(planes)
            n_pending += planes.shape[0]
    while n_pending:
        yield _take(min(chunk_triples, n_pending))
