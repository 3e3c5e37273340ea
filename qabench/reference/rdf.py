"""The encoded triple's layout, flag bits and 32-bit hash arithmetic, as
plain constants and torch functions of the benchmark's own.

The values are transcribed from the port's ``rdf/vocab.py`` and
``rdf/triple_tensor.py`` (a CPU test holds them equal); nothing here
imports the port.

torch has no unsigned 32-bit type on every device and its ``>>`` on int32
is arithmetic, so 32-bit words are held in int64 lanes in ``[0, 2^32)``
and masked after every step; a 32×32-bit product is taken in 16-bit halves
so it never leaves int64.
"""
from __future__ import annotations

import torch

# plane (column) of the (N, 13) int32 rows
S, P, O = 0, 1, 2
S_FLAGS, P_FLAGS, O_FLAGS = 3, 4, 5
S_LEN, P_LEN, O_LEN = 6, 7, 8
O_DT = 9
S_HASH, P_HASH, O_HASH = 10, 11, 12
N_PLANES = 13

FLAGS = {"s": S_FLAGS, "p": P_FLAGS, "o": O_FLAGS}
LENS = {"s": S_LEN, "p": P_LEN, "o": O_LEN}

# flag bits of a position
KIND_IRI = 1 << 0
KIND_LITERAL = 1 << 1
KIND_BLANK = 1 << 2
VALID = 1 << 3
INTERNAL = 1 << 4
HAS_LANG = 1 << 5
LEXICAL_OK = 1 << 6
HAS_DATATYPE = 1 << 7
IS_LICENSE_PRED = 1 << 8
IS_LICENSE_INDICATION = 1 << 9
IS_LICENSE_STATEMENT = 1 << 10
IS_LABEL_PRED = 1 << 11
IS_SAMEAS = 1 << 12
IS_RDFTYPE = 1 << 13
IRI_VALID = 1 << 14

# datatype ids of the o_dt plane
DT_NONE, DT_STRING, DT_LANGSTRING, DT_OTHER = 0, 1, 11, 14

M32 = 0xFFFFFFFF


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for int64 ``x`` in ``[0, 2^32)``."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def as_int32(x: torch.Tensor) -> torch.Tensor:
    """32-bit words held in int64 ``[0, 2^32)`` as int32 with the same
    bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def as_word(x: torch.Tensor) -> torch.Tensor:
    """int32 values as the int64 words ``[0, 2^32)`` of their bits."""
    return x.to(torch.int64) & M32


def term_hash(ids: torch.Tensor) -> torch.Tensor:
    """The content hash of a synthetic term, which has only its id:
    fmix32((id + 1) * 0x9E3779B1), as int32 bits."""
    return as_int32(fmix32(mul32((ids.to(torch.int64) + 1) & M32,
                                 0x9E3779B1)))
