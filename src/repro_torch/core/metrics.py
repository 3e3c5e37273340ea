"""Quality metric registry (paper Table 2 + extended Zaveri-survey set).

Each metric follows the QAP (paper Def 5): a set of *counters* — named
transformations τ whose action α is ``count`` — plus a ``finalize`` that
arithmetically combines counter values (ratio / sum / threshold), exactly the
"action can be an arithmetic combination of multiple actions" clause.

Counters are ``Expr`` trees over the TripleTensor planes; identical counters
are shared across metrics by the planner (one-pass fused evaluation).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Sequence

from ..rdf import vocab
from ..rdf.triple_tensor import (
    COL_S, COL_P, COL_O, COL_S_FLAGS, COL_P_FLAGS, COL_O_FLAGS,
    COL_S_LEN, COL_P_LEN, COL_O_LEN, COL_O_DT,
    COL_S_HASH, COL_P_HASH, COL_O_HASH)
from .expr import AnyBits, Cmp, EqPlanes, Expr, HasBits

# --- Predicate vocabulary (paper Def 1 Filters) ------------------------------
URI_TOO_LONG = 80  # RC1 threshold (chars)

_POS_FLAGS = {"s": COL_S_FLAGS, "p": COL_P_FLAGS, "o": COL_O_FLAGS}
_POS_LEN = {"s": COL_S_LEN, "p": COL_P_LEN, "o": COL_O_LEN}


def is_uri(pos: str) -> Expr:
    return HasBits(_POS_FLAGS[pos], vocab.KIND_IRI)


def is_literal(pos: str) -> Expr:
    return HasBits(_POS_FLAGS[pos], vocab.KIND_LITERAL)


def is_blank(pos: str) -> Expr:
    return HasBits(_POS_FLAGS[pos], vocab.KIND_BLANK)


def is_internal(pos: str) -> Expr:
    return HasBits(_POS_FLAGS[pos], vocab.INTERNAL)


def is_external(pos: str) -> Expr:
    return is_uri(pos) & ~AnyBits(_POS_FLAGS[pos], vocab.INTERNAL)


def has_flag(pos: str, flag: int) -> Expr:
    return HasBits(_POS_FLAGS[pos], flag)


def res_too_long(pos: str) -> Expr:
    return is_uri(pos) & Cmp(_POS_LEN[pos], "gt", URI_TOO_LONG)


def valid_triple() -> Expr:
    return HasBits(COL_S_FLAGS, vocab.VALID)


# --- Metric definition -------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Metric:
    """A QAP metric: counters (τ+count actions) + arithmetic finalize."""
    name: str
    dimension: str
    description: str
    counters: tuple[tuple[str, Expr], ...]
    finalize: Callable[[Mapping[str, int]], float]
    # distinct-count (HLL sketch) requirements: tuple of (name, columns)
    sketches: tuple[tuple[str, tuple[int, ...]], ...] = ()

    def counter_exprs(self) -> list[Expr]:
        return [e for _, e in self.counters]


def _exists(c: Mapping[str, int]) -> float:
    return 1.0 if next(iter(c.values())) > 0 else 0.0


def _safe_ratio(num: float, den: float) -> float:
    return float(num) / float(den) if den else 0.0


REGISTRY: dict[str, Metric] = {}


def register(m: Metric, *, overwrite: bool = False) -> Metric:
    """Add a metric to the global registry (usable as a decorator on
    functions returning a ``Metric``).

    Refuses to silently replace an existing metric (in particular the
    built-ins) — pass ``overwrite=True`` or ``unregister`` first.
    """
    if callable(m) and not isinstance(m, Metric):
        return register(m(), overwrite=overwrite)
    existing = REGISTRY.get(m.name)
    if existing is not None and existing is not m and not overwrite:
        raise ValueError(
            f"metric {m.name!r} is already registered with a different "
            f"definition; unregister it first, rename yours, or pass "
            f"overwrite=True")
    REGISTRY[m.name] = m
    return m


def unregister(name: str) -> None:
    """Remove a user-registered metric (tests, experiments)."""
    REGISTRY.pop(name, None)


# --- LQML-style declarative builders (Debattista's LQML DSL, as Python) ------
# A user metric is declared from Expr predicates alone — no Metric(...)
# boilerplate — and composes into the fused planner like any built-in
# (shared counters such as count(valid triples) are deduplicated).

def _as_counters(spec) -> tuple[tuple[str, Expr], ...]:
    return tuple(spec.items()) if isinstance(spec, Mapping) else tuple(spec)


def ratio_metric(name: str, num: Expr, den: Expr | None = None, *,
                 dimension: str = "custom", description: str = "",
                 auto_register: bool = True) -> Metric:
    """``count(num) / count(den)``; ``den`` defaults to all valid triples
    (sharing the planner slot every built-in ratio metric uses)."""
    m = Metric(
        name=name, dimension=dimension,
        description=description or f"ratio of {name} triples",
        counters=(("num", num),
                  ("den", den if den is not None else valid_triple())),
        finalize=lambda c: _safe_ratio(c["num"], c["den"]))
    return register(m) if auto_register else m


def exists_metric(name: str, cond: Expr, *, dimension: str = "custom",
                  description: str = "",
                  auto_register: bool = True) -> Metric:
    """1.0 iff at least one triple satisfies ``cond`` (paper's L1/L2 form)."""
    m = Metric(name=name, dimension=dimension,
               description=description or f"existence of {name} triples",
               counters=(("hit", cond),), finalize=_exists)
    return register(m) if auto_register else m


def count_metric(name: str, cond: Expr, *, dimension: str = "custom",
                 description: str = "",
                 auto_register: bool = True) -> Metric:
    """Raw count of triples satisfying ``cond`` (paper's SV3 form)."""
    m = Metric(name=name, dimension=dimension,
               description=description or f"count of {name} triples",
               counters=(("hit", cond),),
               finalize=lambda c: float(c["hit"]))
    return register(m) if auto_register else m


def qap_metric(name: str, counters, *, dimension: str = "custom",
               description: str = "", sketches=()):
    """Decorator form for arbitrary QAPs: declare named counters, write
    the arithmetic finalize as the decorated function::

        @qap_metric("PCT_SELF", {"self": EqPlanes(COL_S, COL_O),
                                 "total": valid_triple()})
        def pct_self(c):
            return c["self"] / max(c["total"], 1)
    """
    def deco(fn) -> Metric:
        doc_lines = (fn.__doc__ or "").strip().splitlines() or [name]
        m = Metric(name=name, dimension=dimension,
                   description=description or doc_lines[0],
                   counters=_as_counters(counters), finalize=fn,
                   sketches=tuple(sketches))
        return register(m)
    return deco


# --- Paper Table 2 metrics ---------------------------------------------------

register(Metric(
    name="L1", dimension="licensing",
    description="Detection of a machine-readable license",
    counters=(("lic", has_flag("p", vocab.IS_LICENSE_PRED)),),
    finalize=_exists,
))

register(Metric(
    name="L2", dimension="licensing",
    description="Detection of a human-readable license",
    counters=(
        ("hlic", is_uri("s")
         & has_flag("p", vocab.IS_LICENSE_INDICATION)
         & is_literal("o")
         & has_flag("o", vocab.IS_LICENSE_STATEMENT)),),
    finalize=_exists,
))

register(Metric(
    name="I2", dimension="interlinking",
    description="Linkage degree of linked external data providers",
    counters=(
        ("r3", (is_uri("s") & is_internal("s") & is_uri("o") & is_external("o"))
         | (is_external("s") & is_uri("o") & is_internal("o"))),
        ("total", valid_triple()),),
    finalize=lambda c: _safe_ratio(c["r3"], c["total"]),
))

register(Metric(
    name="U1", dimension="understandability",
    description="Detection of human-readable labels",
    counters=(
        ("lab_s", is_uri("s") & is_internal("s")
         & has_flag("p", vocab.IS_LABEL_PRED)),
        ("lab_p", is_internal("p") & has_flag("p", vocab.IS_LABEL_PRED)),
        ("lab_o", is_uri("o") & is_internal("o")
         & has_flag("p", vocab.IS_LABEL_PRED)),
        ("total", valid_triple()),),
    finalize=lambda c: _safe_ratio(
        c["lab_s"] + c["lab_p"] + c["lab_o"], c["total"]),
))

register(Metric(
    name="RC1", dimension="representational-conciseness",
    description="Short URIs (fraction of triples with an over-long URI)",
    counters=(
        ("too_long", res_too_long("s") | res_too_long("p")
         | res_too_long("o")),
        ("total", valid_triple()),),
    finalize=lambda c: _safe_ratio(c["too_long"], c["total"]),
))

register(Metric(
    name="SV3", dimension="syntactic-validity",
    description="Identification of literals with malformed datatypes",
    counters=(
        ("malformed", is_literal("o") & has_flag("o", vocab.HAS_DATATYPE)
         & ~AnyBits(COL_O_FLAGS, vocab.LEXICAL_OK)),),
    finalize=lambda c: float(c["malformed"]),
))

register(Metric(
    name="CN2", dimension="conciseness",
    description="Extensional conciseness (paper's simplified form)",
    counters=(
        ("uri_uri", is_uri("s") & is_uri("o")),
        ("total", valid_triple()),),
    finalize=lambda c: _safe_ratio(c["total"] - c["uri_uri"], c["total"]),
))

PAPER_METRICS = ("L1", "L2", "I2", "U1", "RC1", "SV3", "CN2")

# --- Extended metrics (beyond the paper's seven, same QAP pattern) -----------

register(Metric(
    name="I1", dimension="interlinking",
    description="owl:sameAs interlink ratio",
    counters=(("sameas", has_flag("p", vocab.IS_SAMEAS)),
              ("total", valid_triple())),
    finalize=lambda c: _safe_ratio(c["sameas"], c["total"]),
))

register(Metric(
    name="SV1", dimension="syntactic-validity",
    description="Typed-literal ratio (literals carrying an explicit datatype)",
    counters=(("typed", is_literal("o") & has_flag("o", vocab.HAS_DATATYPE)),
              ("lits", is_literal("o"))),
    finalize=lambda c: _safe_ratio(c["typed"], c["lits"]),
))

register(Metric(
    name="SV2", dimension="syntactic-validity",
    description="Well-formed IRI ratio over all three positions",
    counters=(
        ("ok_s", is_uri("s") & has_flag("s", vocab.IRI_VALID)),
        ("ok_p", is_uri("p") & has_flag("p", vocab.IRI_VALID)),
        ("ok_o", is_uri("o") & has_flag("o", vocab.IRI_VALID)),
        ("uri_s", is_uri("s")), ("uri_p", is_uri("p")), ("uri_o", is_uri("o")),
    ),
    finalize=lambda c: _safe_ratio(
        c["ok_s"] + c["ok_p"] + c["ok_o"],
        c["uri_s"] + c["uri_p"] + c["uri_o"]),
))

register(Metric(
    name="V1", dimension="versatility",
    description="Language-tag coverage of plain literals",
    counters=(("lang", is_literal("o") & has_flag("o", vocab.HAS_LANG)),
              ("lits", is_literal("o"))),
    finalize=lambda c: _safe_ratio(c["lang"], c["lits"]),
))

register(Metric(
    name="IO1", dimension="interoperability",
    description="Blank-node usage ratio (lower is better)",
    counters=(("blank", is_blank("s") | is_blank("o")),
              ("total", valid_triple())),
    finalize=lambda c: _safe_ratio(c["blank"], c["total"]),
))

register(Metric(
    name="CS1", dimension="consistency",
    description="Self-loop ratio (s == o)",
    counters=(("self", EqPlanes(COL_S, COL_O) & valid_triple()
               & is_uri("o")),
              ("total", valid_triple())),
    finalize=lambda c: _safe_ratio(c["self"], c["total"]),
))

register(Metric(
    name="CM1", dimension="completeness",
    description="rdf:type coverage (typed-assertion ratio)",
    counters=(("typed", has_flag("p", vocab.IS_RDFTYPE)),
              ("total", valid_triple())),
    finalize=lambda c: _safe_ratio(c["typed"], c["total"]),
))

# --- Sketch-based metrics (exact-distinct via HyperLogLog, beyond paper) -----
# Sketches hash the CONTENT-hash planes, not the id planes: a term's hash
# column carries a 32-bit hash of its key bytes, so register banks are
# invariant to id renumbering — the repro.store reuse lever for
# mutations/deletes (frozen sketch state stays valid wherever the bytes
# are unchanged, no matter how upstream edits shifted the id space).

register(Metric(
    name="CN2_EXACT", dimension="conciseness",
    description="Extensional conciseness via distinct-(s,p,o) HLL sketch",
    counters=(("total", valid_triple()),),
    finalize=lambda c: _safe_ratio(c.get("sketch:spo", c["total"]),
                                   c["total"]),
    sketches=(("spo", (COL_S_HASH, COL_P_HASH, COL_O_HASH)),),
))

register(Metric(
    name="SCH1", dimension="schema",
    description="Property diversity: distinct predicates (HLL estimate)",
    counters=(("total", valid_triple()),),
    finalize=lambda c: float(c.get("sketch:p", 0)),
    sketches=(("p", (COL_P_HASH,)),),
))

EXTENDED_METRICS = ("I1", "SV1", "SV2", "V1", "IO1", "CS1", "CM1")
SKETCH_METRICS = ("CN2_EXACT", "SCH1")
ALL_METRICS = PAPER_METRICS + EXTENDED_METRICS + SKETCH_METRICS


def get_metrics(names: Sequence[str]) -> list[Metric]:
    return [REGISTRY[n] for n in names]
