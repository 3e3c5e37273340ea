"""The 16 registered quality metrics, written out as masks over the planes.

Each metric's counters and finalize are transcribed from its definition in
the port's ``core/metrics.py`` (paper Table 2 and the extended set), not
derived from the planner's program. A counter counts the rows where its
mask holds and the row's VALID bit is set, as the port's evaluator masks
every counter. Sketch metrics read the HLL estimate of ``hll.py``.
"""
from __future__ import annotations

import torch

from . import rdf as R

URI_TOO_LONG = 80      # RC1: an IRI longer than this many characters


class Cols:
    """The planes of a block of rows, each a contiguous int32 column."""

    def __init__(self, block: torch.Tensor):
        self.c = block.T.contiguous()

    def __getitem__(self, plane: int) -> torch.Tensor:
        return self.c[plane]

    def has(self, pos: str, bits: int) -> torch.Tensor:
        return (self[R.FLAGS[pos]] & bits) == bits

    def uri(self, pos):
        return self.has(pos, R.KIND_IRI)

    def literal(self, pos):
        return self.has(pos, R.KIND_LITERAL)

    def blank(self, pos):
        return self.has(pos, R.KIND_BLANK)

    def internal(self, pos):
        return self.has(pos, R.INTERNAL)

    def external(self, pos):
        return self.uri(pos) & ((self[R.FLAGS[pos]] & R.INTERNAL) == 0)

    def too_long(self, pos):
        return self.uri(pos) & (self[R.LENS[pos]] > URI_TOO_LONG)

    def valid(self):
        return self.has("s", R.VALID)


def _ratio(num, den) -> float:
    return float(num) / float(den) if den else 0.0


def _exists(c) -> float:
    return 1.0 if next(iter(c.values())) > 0 else 0.0


def _l1(x):
    return {"lic": x.has("p", R.IS_LICENSE_PRED)}


def _l2(x):
    return {"hlic": x.uri("s") & x.has("p", R.IS_LICENSE_INDICATION)
            & x.literal("o") & x.has("o", R.IS_LICENSE_STATEMENT)}


def _i2(x):
    return {"r3": (x.uri("s") & x.internal("s") & x.uri("o")
                   & x.external("o"))
            | (x.external("s") & x.uri("o") & x.internal("o")),
            "total": x.valid()}


def _u1(x):
    label = x.has("p", R.IS_LABEL_PRED)
    return {"lab_s": x.uri("s") & x.internal("s") & label,
            "lab_p": x.internal("p") & label,
            "lab_o": x.uri("o") & x.internal("o") & label,
            "total": x.valid()}


def _rc1(x):
    return {"too_long": x.too_long("s") | x.too_long("p") | x.too_long("o"),
            "total": x.valid()}


def _sv3(x):
    return {"malformed": x.literal("o") & x.has("o", R.HAS_DATATYPE)
            & ((x[R.O_FLAGS] & R.LEXICAL_OK) == 0)}


def _cn2(x):
    return {"uri_uri": x.uri("s") & x.uri("o"), "total": x.valid()}


def _i1(x):
    return {"sameas": x.has("p", R.IS_SAMEAS), "total": x.valid()}


def _sv1(x):
    return {"typed": x.literal("o") & x.has("o", R.HAS_DATATYPE),
            "lits": x.literal("o")}


def _sv2(x):
    out = {}
    for pos in "spo":
        out[f"ok_{pos}"] = x.uri(pos) & x.has(pos, R.IRI_VALID)
    for pos in "spo":
        out[f"uri_{pos}"] = x.uri(pos)
    return out


def _v1(x):
    return {"lang": x.literal("o") & x.has("o", R.HAS_LANG),
            "lits": x.literal("o")}


def _io1(x):
    return {"blank": x.blank("s") | x.blank("o"), "total": x.valid()}


def _cs1(x):
    return {"self": (x[R.S] == x[R.O]) & x.valid() & x.uri("o"),
            "total": x.valid()}


def _cm1(x):
    return {"typed": x.has("p", R.IS_RDFTYPE), "total": x.valid()}


def _total(x):
    return {"total": x.valid()}


# name -> (counter masks, finalize(counts, estimates), sketches)
METRICS: dict[str, tuple] = {
    "L1": (_l1, lambda c, e: _exists(c), ()),
    "L2": (_l2, lambda c, e: _exists(c), ()),
    "I2": (_i2, lambda c, e: _ratio(c["r3"], c["total"]), ()),
    "U1": (_u1, lambda c, e: _ratio(c["lab_s"] + c["lab_p"] + c["lab_o"],
                                    c["total"]), ()),
    "RC1": (_rc1, lambda c, e: _ratio(c["too_long"], c["total"]), ()),
    "SV3": (_sv3, lambda c, e: float(c["malformed"]), ()),
    "CN2": (_cn2, lambda c, e: _ratio(c["total"] - c["uri_uri"],
                                      c["total"]), ()),
    "I1": (_i1, lambda c, e: _ratio(c["sameas"], c["total"]), ()),
    "SV1": (_sv1, lambda c, e: _ratio(c["typed"], c["lits"]), ()),
    "SV2": (_sv2, lambda c, e: _ratio(c["ok_s"] + c["ok_p"] + c["ok_o"],
                                      c["uri_s"] + c["uri_p"] + c["uri_o"]),
            ()),
    "V1": (_v1, lambda c, e: _ratio(c["lang"], c["lits"]), ()),
    "IO1": (_io1, lambda c, e: _ratio(c["blank"], c["total"]), ()),
    "CS1": (_cs1, lambda c, e: _ratio(c["self"], c["total"]), ()),
    "CM1": (_cm1, lambda c, e: _ratio(c["typed"], c["total"]), ()),
    "CN2_EXACT": (_total, lambda c, e: _ratio(e["spo"], c["total"]),
                  (("spo", (R.S_HASH, R.P_HASH, R.O_HASH)),)),
    "SCH1": (_total, lambda c, e: float(e["p"]), (("p", (R.P_HASH,)),)),
}
