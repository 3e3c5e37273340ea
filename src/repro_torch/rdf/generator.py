"""Synthetic RDF generators.

Two paths, mirroring the paper's evaluation data:

* ``bsbm_ntriples`` — a BSBM-flavoured e-commerce N-Triples *string* generator
  (products / vendors / offers / reviews), used for parser+encoder tests and
  small end-to-end runs. Injects controlled dirt: malformed datatypes,
  overlong URIs, missing labels, external links, license statements.
* ``synth_encoded`` — a vectorized generator that emits an already-encoded
  TripleTensor with the same *statistical* profile, so benchmarks can scale to
  10⁸+ triples without paying host string costs. The planes it produces are
  self-consistent (same invariants the real encoder guarantees), which the
  property tests verify.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import vocab
from .triple_tensor import TripleTensor, from_columns

BASE = "http://bsbm.example.org/"
EXTERNAL = "http://external.example.com/"


@dataclasses.dataclass
class DirtProfile:
    """Fractions controlling injected quality problems."""
    literal_obj: float = 0.35       # P(object is literal)
    typed_literal: float = 0.6      # P(literal has ^^datatype)
    malformed_literal: float = 0.05  # P(typed literal lexically invalid)
    lang_literal: float = 0.2       # P(untyped literal has @lang)
    external_obj: float = 0.15      # P(IRI object is external)
    external_subj: float = 0.02
    long_uri: float = 0.03          # P(IRI longer than threshold)
    label_triple: float = 0.08      # P(triple is a labelling assertion)
    license_triple: float = 0.0005  # P(triple is a license association)
    license_stmt_literal: float = 0.001
    blank_obj: float = 0.02
    sameas: float = 0.01
    rdftype: float = 0.15
    uri_len_mean: int = 38
    uri_len_long: int = 96


def bsbm_ntriples(n_products: int = 50, seed: int = 0,
                  dirt: DirtProfile | None = None) -> str:
    """Small BSBM-like dataset as N-Triples text."""
    dirt = dirt or DirtProfile()
    rng = np.random.default_rng(seed)
    lines = []
    lines.append(f'<{BASE}dataset> <http://purl.org/dc/terms/license> '
                 f'<http://creativecommons.org/licenses/by/4.0/> .')
    for i in range(n_products):
        p_uri = f"{BASE}Product{i}"
        lines.append(f'<{p_uri}> <{vocab.RDFTYPE}> <{BASE}Product> .')
        if rng.random() > 0.2:  # some products miss labels (U1 dirt)
            lines.append(
                f'<{p_uri}> <{vocab.RDFS_NS}label> "Product number {i}"@en .')
        price = rng.integers(1, 9999)
        if rng.random() < dirt.malformed_literal:  # SV3 dirt
            lines.append(f'<{p_uri}> <{BASE}price> '
                         f'"abc{price}"^^<{vocab.XSD_NS}integer> .')
        else:
            lines.append(f'<{p_uri}> <{BASE}price> '
                         f'"{price}"^^<{vocab.XSD_NS}integer> .')
        vendor = rng.integers(0, max(2, n_products // 10))
        lines.append(f'<{p_uri}> <{BASE}vendor> <{BASE}Vendor{vendor}> .')
        if rng.random() < dirt.external_obj:  # I2: external link
            lines.append(f'<{p_uri}> <{vocab.SAMEAS}> '
                         f'<{EXTERNAL}item/{i}> .')
        if rng.random() < dirt.long_uri:  # RC1 dirt
            long_frag = "x" * dirt.uri_len_long
            lines.append(f'<{p_uri}> <{BASE}seeAlso> <{BASE}{long_frag}> .')
        if rng.random() < 0.3:
            r = rng.integers(0, 10)
            lines.append(f'_:rev{i}_{r} <{BASE}reviewFor> <{p_uri}> .')
            lines.append(f'_:rev{i}_{r} <{BASE}rating> '
                         f'"{rng.integers(1, 10)}"^^<{vocab.XSD_NS}integer> .')
        if rng.random() < dirt.license_stmt_literal * 50:
            lines.append(f'<{p_uri}> <{vocab.RDFS_NS}comment> '
                         f'"Data available under Creative Commons CC-BY" .')
    return "\n".join(lines) + "\n"


def synth_encoded(n_triples: int, seed: int = 0,
                  dirt: DirtProfile | None = None,
                  n_subject_pool: int | None = None) -> TripleTensor:
    """Directly emit an encoded TripleTensor with the profile's statistics."""
    dirt = dirt or DirtProfile()
    rng = np.random.default_rng(seed)
    n = int(n_triples)
    n_subj = n_subject_pool or max(16, n // 8)

    u = rng.random(n)
    is_lit = u < dirt.literal_obj
    is_blank = (~is_lit) & (u < dirt.literal_obj + dirt.blank_obj)
    is_iri_o = ~(is_lit | is_blank)

    # --- ids (zipf-ish subject reuse, small predicate pool) ---
    s_id = rng.zipf(1.3, size=n).clip(max=n_subj) - 1
    p_pool = 64
    p_id = n_subj + (rng.zipf(1.4, size=n).clip(max=p_pool) - 1)
    o_id = n_subj + p_pool + rng.integers(0, max(4, n // 4), size=n)

    # --- subject flags ---
    s_flags = np.full(n, vocab.VALID | vocab.KIND_IRI | vocab.IRI_VALID,
                      np.int32)
    s_internal = rng.random(n) >= dirt.external_subj
    s_flags |= np.where(s_internal, vocab.INTERNAL, 0).astype(np.int32)
    s_len = rng.poisson(dirt.uri_len_mean, n).astype(np.int32)
    s_long = rng.random(n) < dirt.long_uri
    s_len = np.where(s_long, dirt.uri_len_long + rng.integers(0, 64, n), s_len)

    # --- predicate flags (predicates are always internal IRIs here) ---
    p_flags = np.full(n, vocab.VALID | vocab.KIND_IRI | vocab.IRI_VALID
                      | vocab.INTERNAL, np.int32)
    r = rng.random(n)
    is_label = r < dirt.label_triple
    is_license = (~is_label) & (r < dirt.label_triple + dirt.license_triple)
    is_sameas = (~is_label & ~is_license) & (
        r < dirt.label_triple + dirt.license_triple + dirt.sameas)
    is_rdftype = (~is_label & ~is_license & ~is_sameas) & (
        r < dirt.label_triple + dirt.license_triple + dirt.sameas
        + dirt.rdftype)
    p_flags |= np.where(is_label, vocab.IS_LABEL_PRED
                        | vocab.IS_LICENSE_INDICATION, 0).astype(np.int32)
    p_flags |= np.where(is_license, vocab.IS_LICENSE_PRED, 0).astype(np.int32)
    p_flags |= np.where(is_sameas, vocab.IS_SAMEAS, 0).astype(np.int32)
    p_flags |= np.where(is_rdftype, vocab.IS_RDFTYPE, 0).astype(np.int32)
    p_len = rng.poisson(dirt.uri_len_mean, n).astype(np.int32)

    # --- object flags ---
    o_flags = np.full(n, vocab.VALID, np.int32)
    o_flags |= np.where(is_lit, vocab.KIND_LITERAL, 0).astype(np.int32)
    o_flags |= np.where(is_blank, vocab.KIND_BLANK, 0).astype(np.int32)
    o_flags |= np.where(is_iri_o, vocab.KIND_IRI | vocab.IRI_VALID,
                        0).astype(np.int32)
    o_external = is_iri_o & (rng.random(n) < dirt.external_obj)
    o_flags |= np.where(is_iri_o & ~o_external, vocab.INTERNAL,
                        0).astype(np.int32)

    typed = is_lit & (rng.random(n) < dirt.typed_literal)
    malformed = typed & (rng.random(n) < dirt.malformed_literal)
    lang = is_lit & ~typed & (rng.random(n) < dirt.lang_literal)
    o_flags |= np.where(typed, vocab.HAS_DATATYPE, 0).astype(np.int32)
    o_flags |= np.where(lang, vocab.HAS_LANG, 0).astype(np.int32)
    o_flags |= np.where(is_lit & ~malformed, vocab.LEXICAL_OK,
                        0).astype(np.int32)
    lic_stmt = is_lit & (rng.random(n) < dirt.license_stmt_literal)
    o_flags |= np.where(lic_stmt, vocab.IS_LICENSE_STATEMENT,
                        0).astype(np.int32)
    o_dt = np.where(
        typed,
        rng.integers(vocab.DT_STRING, vocab.DT_OTHER + 1, n),
        np.where(lang, vocab.DT_LANGSTRING, vocab.DT_NONE)).astype(np.int32)
    o_len = np.where(is_lit, rng.poisson(24, n),
                     rng.poisson(dirt.uri_len_mean, n)).astype(np.int32)
    o_long = is_iri_o & (rng.random(n) < dirt.long_uri)
    o_len = np.where(o_long, dirt.uri_len_long + rng.integers(0, 64, n), o_len)

    n_terms = int(n_subj + p_pool + max(4, n // 4))
    return from_columns(s_id, p_id, o_id, s_flags, p_flags, o_flags,
                        s_len, p_len, o_len, o_dt, n_terms=n_terms)
