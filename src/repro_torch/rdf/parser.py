"""NTriples parser (paper §2.2 step 2/3 — "spark.rdf(lang)(input)").

Line-oriented N-Triples subset: IRIs ``<...>``, blank nodes ``_:x``, literals
``"..."`` with optional ``@lang`` or ``^^<datatype>``. Malformed lines are
*kept* (reported via a parse-error flag term) rather than dropped — quality
assessment must see the dirt.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Iterable, Iterator, Optional

_TRIPLE_RE = re.compile(
    r'^\s*'
    r'(<[^>]*>|_:\S+)\s+'               # subject
    r'(<[^>]*>)\s+'                      # predicate
    r'(<[^>]*>|_:\S+|"(?:[^"\\]|\\.)*"(?:@[A-Za-z0-9-]+|\^\^<[^>]*>)?)'
    r'\s*\.\s*$')

_LITERAL_RE = re.compile(
    r'^"((?:[^"\\]|\\.)*)"(?:@([A-Za-z0-9-]+)|\^\^<([^>]*)>)?$')

# N-Triples string escapes (ECHAR + UCHAR). Literal *values* are stored
# unescaped — flag planes, lengths, and lexical validation judge the real
# lexical form — and ``Term.key()`` re-escapes for serialization.
_UNESCAPE_RE = re.compile(r'\\(u[0-9A-Fa-f]{4}|U[0-9A-Fa-f]{8}|.)', re.DOTALL)
_ECHAR_DECODE = {"t": "\t", "b": "\b", "n": "\n", "r": "\r", "f": "\f",
                 '"': '"', "'": "'", "\\": "\\"}
_ESCAPE_RE = re.compile(r'[\\"\n\r\t]')
_ECHAR_ENCODE = {"\\": "\\\\", '"': '\\"', "\n": "\\n", "\r": "\\r",
                 "\t": "\\t"}


def unescape_literal(s: str) -> str:
    """Decode ``\\n``/``\\"``/``\\uXXXX``-style escapes; invalid escape
    sequences are preserved verbatim (quality tools must see the dirt)."""
    if "\\" not in s:
        return s

    def repl(m: re.Match) -> str:
        e = m.group(1)
        if e[0] in "uU" and len(e) > 1:
            cp = int(e[1:], 16)
            # out-of-range and surrogate codepoints stay escaped: a lone
            # surrogate is not encodable, so decoding it would make the
            # term un-internable (and quality tools must see the dirt)
            if cp <= 0x10FFFF and not 0xD800 <= cp <= 0xDFFF:
                return chr(cp)
            return "\\" + e
        return _ECHAR_DECODE.get(e, "\\" + e)

    return _UNESCAPE_RE.sub(repl, s)


def escape_literal(s: str) -> str:
    """Canonical N-Triples escaping (inverse of ``unescape_literal``)."""
    return _ESCAPE_RE.sub(lambda m: _ECHAR_ENCODE[m.group(0)], s)


@dataclasses.dataclass(frozen=True)
class Term:
    kind: str           # 'iri' | 'blank' | 'literal'
    value: str          # IRI string / blank label / *unescaped* lexical form
    lang: Optional[str] = None
    datatype: Optional[str] = None

    def key(self) -> str:
        """Canonical N-Triples serialization (also the dictionary key):
        parsing a key reproduces an equal Term."""
        if self.kind == "iri":
            return "<" + self.value + ">"
        if self.kind == "blank":
            return "_:" + self.value
        dt = "^^<" + self.datatype + ">" if self.datatype else ""
        lang = "@" + self.lang if self.lang else ""
        return '"' + escape_literal(self.value) + '"' + lang + dt


def parse_term(tok: str) -> Term:
    if tok.startswith("<"):
        return Term("iri", tok[1:-1])
    if tok.startswith("_:"):
        return Term("blank", tok[2:])
    m = _LITERAL_RE.match(tok)
    if not m:
        raise ValueError(f"bad term: {tok!r}")
    value, lang, dt = m.group(1), m.group(2), m.group(3)
    return Term("literal", unescape_literal(value), lang=lang, datatype=dt)


def parse_lines(lines: Iterable[str]) -> Iterator[tuple[Term, Term, Term]]:
    """Yield (s, p, o) Term triples; skips comments/empties, raises never —
    malformed lines yield a sentinel triple flagged via an invalid IRI."""
    for line in lines:
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _TRIPLE_RE.match(line)
        if not m:
            # Surface as a malformed-syntax triple: quality tools must count it.
            yield (Term("iri", "urn:repro:parse-error"),
                   Term("iri", "urn:repro:parse-error"),
                   Term("literal", line[:64]))
            continue
        yield (parse_term(m.group(1)), parse_term(m.group(2)),
               parse_term(m.group(3)))


def parse_ntriples(text: str) -> list[tuple[Term, Term, Term]]:
    return list(parse_lines(text.splitlines()))
