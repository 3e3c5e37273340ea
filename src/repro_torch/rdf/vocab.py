"""RDF vocabulary, namespace, and datatype knowledge used by the encoder.

All string-level semantics live HERE and in the encoder — nothing downstream of
the encoder ever touches a string. Every per-term property that any QAP metric
can ask about is materialized at ingest time into integer flag planes (see
``triple_tensor.py`` for the plane layout).
"""
from __future__ import annotations

import re

# --- Term kind / property flag bits (per triple position) -------------------
KIND_IRI = 1 << 0
KIND_LITERAL = 1 << 1
KIND_BLANK = 1 << 2
VALID = 1 << 3            # row is a real triple (unset on padding rows)
INTERNAL = 1 << 4         # IRI under one of the dataset's base namespaces
HAS_LANG = 1 << 5         # literal with @lang tag
LEXICAL_OK = 1 << 6       # literal lexical form valid for its datatype
HAS_DATATYPE = 1 << 7     # literal with ^^<datatype>
IS_LICENSE_PRED = 1 << 8  # p ∈ license-associating predicates  (L1)
IS_LICENSE_INDICATION = 1 << 9   # p ∈ license-indicating predicates (L2)
IS_LICENSE_STATEMENT = 1 << 10   # literal text looks like a license stmt (L2)
IS_LABEL_PRED = 1 << 11   # p ∈ labelling predicates (U1)
IS_SAMEAS = 1 << 12       # p == owl:sameAs (interlinking)
IS_RDFTYPE = 1 << 13      # p == rdf:type
IRI_VALID = 1 << 14       # IRI is syntactically well-formed
ALL_KINDS = KIND_IRI | KIND_LITERAL | KIND_BLANK

FLAG_NAMES = {
    "KIND_IRI": KIND_IRI, "KIND_LITERAL": KIND_LITERAL, "KIND_BLANK": KIND_BLANK,
    "VALID": VALID, "INTERNAL": INTERNAL, "HAS_LANG": HAS_LANG,
    "LEXICAL_OK": LEXICAL_OK, "HAS_DATATYPE": HAS_DATATYPE,
    "IS_LICENSE_PRED": IS_LICENSE_PRED, "IS_LICENSE_INDICATION": IS_LICENSE_INDICATION,
    "IS_LICENSE_STATEMENT": IS_LICENSE_STATEMENT, "IS_LABEL_PRED": IS_LABEL_PRED,
    "IS_SAMEAS": IS_SAMEAS, "IS_RDFTYPE": IS_RDFTYPE, "IRI_VALID": IRI_VALID,
}

# --- Well-known namespaces ---------------------------------------------------
RDF_NS = "http://www.w3.org/1999/02/22-rdf-syntax-ns#"
RDFS_NS = "http://www.w3.org/2000/01/rdf-schema#"
OWL_NS = "http://www.w3.org/2002/07/owl#"
XSD_NS = "http://www.w3.org/2001/XMLSchema#"
DCT_NS = "http://purl.org/dc/terms/"
DC_NS = "http://purl.org/dc/elements/1.1/"
CC_NS = "http://creativecommons.org/ns#"
SKOS_NS = "http://www.w3.org/2004/02/skos/core#"
FOAF_NS = "http://xmlns.com/foaf/0.1/"
SCHEMA_NS = "http://schema.org/"

# Predicates that associate a machine-readable license with a dataset (L1).
LICENSE_PREDICATES = frozenset({
    DCT_NS + "license", DC_NS + "rights", DCT_NS + "rights",
    CC_NS + "license", SCHEMA_NS + "license",
    "http://www.w3.org/1999/xhtml/vocab#license",
    DCT_NS + "accessRights",
})

# Predicates whose literal objects may carry a human-readable license (L2).
LICENSE_INDICATION_PREDICATES = frozenset({
    RDFS_NS + "label", RDFS_NS + "comment", DCT_NS + "description",
    DC_NS + "description", SCHEMA_NS + "description", SKOS_NS + "note",
    DC_NS + "rights", DCT_NS + "rights",
})

# Labelling predicates (U1 — human-readable labels).
LABEL_PREDICATES = frozenset({
    RDFS_NS + "label", SKOS_NS + "prefLabel", SKOS_NS + "altLabel",
    FOAF_NS + "name", SCHEMA_NS + "name", DCT_NS + "title", DC_NS + "title",
})

SAMEAS = OWL_NS + "sameAs"
RDFTYPE = RDF_NS + "type"

# Case-insensitive detector for license-ish literal text (L2).
LICENSE_STATEMENT_RE = re.compile(
    r"licen[sc]e|copyright|all rights reserved|\(c\)\s*\d{4}|creative\s*commons"
    r"|public domain|cc[- ]by", re.IGNORECASE)

# --- Datatypes and lexical-form validation (SV3) -----------------------------
# Datatype ids are stable small ints; 0 = none/unknown.
DT_NONE = 0
DT_STRING = 1
DT_INTEGER = 2
DT_DECIMAL = 3
DT_DOUBLE = 4
DT_FLOAT = 5
DT_BOOLEAN = 6
DT_DATE = 7
DT_DATETIME = 8
DT_GYEAR = 9
DT_ANYURI = 10
DT_LANGSTRING = 11
DT_NONNEG_INT = 12
DT_LONG = 13
DT_OTHER = 14

DATATYPE_IDS = {
    XSD_NS + "string": DT_STRING,
    XSD_NS + "integer": DT_INTEGER,
    XSD_NS + "int": DT_INTEGER,
    XSD_NS + "decimal": DT_DECIMAL,
    XSD_NS + "double": DT_DOUBLE,
    XSD_NS + "float": DT_FLOAT,
    XSD_NS + "boolean": DT_BOOLEAN,
    XSD_NS + "date": DT_DATE,
    XSD_NS + "dateTime": DT_DATETIME,
    XSD_NS + "gYear": DT_GYEAR,
    XSD_NS + "anyURI": DT_ANYURI,
    RDF_NS + "langString": DT_LANGSTRING,
    XSD_NS + "nonNegativeInteger": DT_NONNEG_INT,
    XSD_NS + "long": DT_LONG,
}

_LEXICAL_RES = {
    DT_STRING: re.compile(r".*", re.DOTALL),
    DT_INTEGER: re.compile(r"[+-]?\d+$"),
    DT_LONG: re.compile(r"[+-]?\d+$"),
    DT_NONNEG_INT: re.compile(r"\+?\d+$"),
    DT_DECIMAL: re.compile(r"[+-]?(\d+(\.\d*)?|\.\d+)$"),
    DT_DOUBLE: re.compile(
        r"([+-]?(\d+(\.\d*)?|\.\d+)([eE][+-]?\d+)?|[+-]?INF|NaN)$"),
    DT_FLOAT: re.compile(
        r"([+-]?(\d+(\.\d*)?|\.\d+)([eE][+-]?\d+)?|[+-]?INF|NaN)$"),
    DT_BOOLEAN: re.compile(r"(true|false|0|1)$"),
    DT_DATE: re.compile(r"-?\d{4,}-\d{2}-\d{2}([+-]\d{2}:\d{2}|Z)?$"),
    DT_DATETIME: re.compile(
        r"-?\d{4,}-\d{2}-\d{2}T\d{2}:\d{2}:\d{2}(\.\d+)?([+-]\d{2}:\d{2}|Z)?$"),
    DT_GYEAR: re.compile(r"-?\d{4,}([+-]\d{2}:\d{2}|Z)?$"),
    DT_ANYURI: re.compile(r"\S*$"),
    DT_LANGSTRING: re.compile(r".*", re.DOTALL),
}

_IRI_RE = re.compile(r"[A-Za-z][A-Za-z0-9+.-]*://?[^\s<>\"{}|^`\\]*$")


def datatype_id(iri: str) -> int:
    return DATATYPE_IDS.get(iri, DT_OTHER)


def lexical_ok(value: str, dt_id: int) -> bool:
    """Is ``value`` a valid lexical form for datatype ``dt_id``?"""
    rex = _LEXICAL_RES.get(dt_id)
    if rex is None:  # unknown datatype — cannot invalidate, treat as ok
        return True
    return rex.match(value) is not None


def iri_valid(iri: str) -> bool:
    return _IRI_RE.match(iri) is not None


def is_license_statement(text: str) -> bool:
    return LICENSE_STATEMENT_RE.search(text) is not None
