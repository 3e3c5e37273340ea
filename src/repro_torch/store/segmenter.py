"""Content-defined segmentation of N-Triples byte streams.

The segment store keys partial assessment state by the *content* of each
segment, so the segmenter's one job is boundary **stability**: a local edit
(append, in-place mutation, deleted region) must change the byte ranges of
O(1) segments, not shift every boundary after the edit point.  Fixed-size
splitting fails this (any length change re-frames the whole tail), so we
use rolling-hash content-defined chunking, restricted to newline positions
(a segment is always a whole number of N-Triples lines — the parser is
line-based, so segments encode independently):

* every ``\\n`` whose trailing ``_WINDOW``-byte context hashes to
  ``mix & mask == _MAGIC`` is a *candidate* boundary — a purely local
  decision, unaffected by bytes outside the window;
* greedy selection enforces ``min_bytes ≤ segment ≤ ~max_bytes`` (a forced
  cut past ``max_bytes`` falls on the next newline, so pathological inputs
  degrade to fixed-size line-aligned splitting, never to a broken line).

``iter_segments`` streams a file object in blocks — only the segment being
assembled is resident, so segmentation memory is bounded by a few
``max_bytes`` regardless of dataset size.  ``iter_segments_bytes`` is the
same generator over in-memory bytes (one code path, so file- and
text-ingested copies of the same content segment identically).
"""
from __future__ import annotations

import hashlib
import io
from typing import BinaryIO, Iterator

import numpy as np

DEFAULT_TARGET_BYTES = 1 << 20   # ~1 MiB segments by default

_WINDOW = 16                     # rolling-hash context ending at the newline
_FNV = np.uint64(0x100000001B3)
_SEED = np.uint64(0xCBF29CE484222325)
_MAGIC = np.uint64(0x2A)


def fingerprint(data: bytes) -> str:
    """Content address of a segment (or any byte string)."""
    return hashlib.blake2b(data, digest_size=16).hexdigest()


def _candidate_newlines(buf: np.ndarray, mask: np.uint64) -> np.ndarray:
    """Positions of ``\\n`` bytes that are CDC boundary candidates.

    The decision for the newline at ``i`` hashes ``buf[i-_WINDOW+1 : i+1]``
    (zero-padded at the buffer start) — local context only.  Positions
    below ``_WINDOW - 1`` may hash with padding instead of true preceding
    bytes, but the greedy selector never picks a cut before ``min_bytes ≥
    _WINDOW``, so those candidates are irrelevant by construction.
    """
    nl = np.flatnonzero(buf == 0x0A)
    if nl.size == 0:
        return nl
    pad = np.concatenate([np.zeros(_WINDOW - 1, np.uint8), buf])
    win = np.lib.stride_tricks.sliding_window_view(pad, _WINDOW)[nl]
    h = np.full(nl.shape, _SEED)
    for j in range(_WINDOW):
        h = (h ^ win[:, j].astype(np.uint64)) * _FNV
    # compare under the mask: with a narrow mask (tiny targets) a full
    # _MAGIC could exceed it and no newline would EVER match — silently
    # degrading to forced fixed-size cuts with no edit locality
    return nl[(h & mask) == (_MAGIC & mask)]


def _params(target_bytes: int) -> tuple[np.uint64, int, int]:
    """(candidate mask, min_bytes, max_bytes) for a target segment size.

    The mask accepts roughly one newline in ``target_bytes / 96`` (N-Triples
    lines average ~60-120 bytes), giving segments near the target without
    measuring the data — a data-derived rate would make *every* boundary
    depend on global statistics and destroy edit locality.
    """
    if target_bytes <= 0:
        raise ValueError(f"target_bytes must be > 0, got {target_bytes}")
    rate = max(1, target_bytes // 96)
    bits = max(0, int(rate).bit_length() - 1)
    mask = np.uint64((1 << bits) - 1)
    return mask, max(_WINDOW, target_bytes // 4), max(_WINDOW + 1,
                                                      target_bytes * 4)


def iter_segments(f: BinaryIO, target_bytes: int = DEFAULT_TARGET_BYTES
                  ) -> Iterator[bytes]:
    """Stream CDC segments from a binary file object with bounded memory.

    Concatenation of the yielded segments is exactly the stream's content;
    every segment but the last ends in ``\\n``.
    """
    mask, min_bytes, max_bytes = _params(target_bytes)
    block = max(max_bytes, 1 << 20)
    buf = b""
    eof = False
    need = 2 * max_bytes
    while True:
        while not eof and len(buf) < need:
            chunk = f.read(block)
            if not chunk:
                eof = True
            else:
                buf += chunk
        if not buf:
            return
        arr = np.frombuffer(buf, np.uint8)
        cands = _candidate_newlines(arr, mask)
        lo = np.searchsorted(cands, min_bytes - 1)
        cut = -1
        if lo < cands.size and cands[lo] < max_bytes:
            cut = int(cands[lo])
        elif len(buf) >= max_bytes:
            # no candidate within bounds: force a line-aligned cut
            forced = np.flatnonzero(arr[max_bytes - 1:] == 0x0A)
            if forced.size:
                cut = int(forced[0]) + max_bytes - 1
        if cut >= 0:
            yield buf[:cut + 1]
            buf = buf[cut + 1:]
            need = 2 * max_bytes
            continue
        if eof:
            yield buf
            return
        need = len(buf) + block   # newline-free so far — keep reading


def iter_segments_bytes(data: bytes,
                        target_bytes: int = DEFAULT_TARGET_BYTES
                        ) -> Iterator[bytes]:
    return iter_segments(io.BytesIO(data), target_bytes)


def split_segments(data: bytes, target_bytes: int = DEFAULT_TARGET_BYTES
                   ) -> list[bytes]:
    """Split a complete byte string into CDC segments (concatenation of the
    returned segments is exactly ``data``)."""
    return list(iter_segments_bytes(data, target_bytes))
