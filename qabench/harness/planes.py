"""The dataset of a configuration, made on the device from the seed.

The rows have the statistics of the port's ``rdf/generator.py::
synth_encoded`` under its ``DirtProfile`` defaults (the configuration's
``profile``): subjects Zipf over triples/8, predicates Zipf over 64,
objects uniform over triples/4, the kinds, flags, lengths and datatypes
drawn with the profile's fractions, and the content-hash planes as
``synthetic_term_hash`` of the ids. The draws are torch's, on the device,
in blocks of rows: one ``torch.Generator`` seeded once, so a seed gives
the same planes on the same device and torch. They are not numpy's rows.
"""
from __future__ import annotations

import torch

from ..reference import rdf as R

BLOCK_ROWS = 1 << 25


def zipf(gen: torch.Generator, n: int, a: float, cap: int,
         device) -> torch.Tensor:
    """``n`` draws of Zipf(``a``) clipped to ``cap``, as int64: numpy's
    rejection method (``random_zipf``), all rows at once, redrawing the
    rejected ones until none is left."""
    am1 = a - 1.0
    b = 2.0 ** am1
    out = torch.empty((n,), dtype=torch.int64, device=device)
    todo = torch.arange(n, device=device)
    while todo.numel():
        m = todo.numel()
        u = 1.0 - torch.rand((m,), generator=gen, device=device,
                             dtype=torch.float64)
        v = torch.rand((m,), generator=gen, device=device,
                       dtype=torch.float64)
        x = torch.floor(u ** (-1.0 / am1))
        t = (1.0 + 1.0 / x) ** am1
        ok = (x >= 1.0) & (v * x * (t - 1.0) / (b - 1.0) <= t / b)
        out[todo[ok]] = torch.clamp(x[ok], max=float(cap)).to(torch.int64)
        todo = todo[~ok]
    return out


def _block(gen: torch.Generator, m: int, n: int, prof: dict,
           device) -> torch.Tensor:
    """``m`` rows of a dataset of ``n`` triples: a (13, m) int32 tensor,
    one plane a row."""
    def rand():
        return torch.rand((m,), generator=gen, device=device)

    def poisson(rate):
        if not torch.is_tensor(rate):
            rate = torch.full((m,), float(rate), device=device)
        return torch.poisson(rate, generator=gen).to(torch.int32)

    def flag(mask, bit):
        return torch.where(mask, bit, 0).to(torch.int32)

    n_subj = max(16, n // prof["subject_pool_divisor"])
    p_pool = prof["predicate_pool"]
    n_obj = max(4, n // prof["object_pool_divisor"])

    u = rand()
    is_lit = u < prof["literal_obj"]
    is_blank = ~is_lit & (u < prof["literal_obj"] + prof["blank_obj"])
    is_iri_o = ~(is_lit | is_blank)

    s_id = zipf(gen, m, prof["subject_zipf"], n_subj, device) - 1
    p_id = n_subj + zipf(gen, m, prof["predicate_zipf"], p_pool, device) - 1
    o_id = n_subj + p_pool + torch.randint(0, n_obj, (m,), generator=gen,
                                           device=device)

    s_flags = torch.full((m,), R.VALID | R.KIND_IRI | R.IRI_VALID,
                         dtype=torch.int32, device=device)
    s_flags |= flag(rand() >= prof["external_subj"], R.INTERNAL)
    long_len = prof["uri_len_long"]
    spread = prof["long_len_spread"]

    def lengthen(length, mask):
        extra = torch.randint(0, spread, (m,), generator=gen, device=device)
        return torch.where(mask, (long_len + extra).to(torch.int32), length)

    s_len = lengthen(poisson(prof["uri_len_mean"]),
                     rand() < prof["long_uri"])

    p_flags = torch.full((m,), R.VALID | R.KIND_IRI | R.IRI_VALID
                         | R.INTERNAL, dtype=torch.int32, device=device)
    r = rand()
    c_label = prof["label_triple"]
    c_license = c_label + prof["license_triple"]
    c_sameas = c_license + prof["sameas"]
    c_type = c_sameas + prof["rdftype"]
    p_flags |= flag(r < c_label, R.IS_LABEL_PRED | R.IS_LICENSE_INDICATION)
    p_flags |= flag((r >= c_label) & (r < c_license), R.IS_LICENSE_PRED)
    p_flags |= flag((r >= c_license) & (r < c_sameas), R.IS_SAMEAS)
    p_flags |= flag((r >= c_sameas) & (r < c_type), R.IS_RDFTYPE)
    p_len = poisson(prof["uri_len_mean"])

    o_flags = torch.full((m,), R.VALID, dtype=torch.int32, device=device)
    o_flags |= flag(is_lit, R.KIND_LITERAL)
    o_flags |= flag(is_blank, R.KIND_BLANK)
    o_flags |= flag(is_iri_o, R.KIND_IRI | R.IRI_VALID)
    o_external = is_iri_o & (rand() < prof["external_obj"])
    o_flags |= flag(is_iri_o & ~o_external, R.INTERNAL)
    typed = is_lit & (rand() < prof["typed_literal"])
    malformed = typed & (rand() < prof["malformed_literal"])
    lang = is_lit & ~typed & (rand() < prof["lang_literal"])
    o_flags |= flag(typed, R.HAS_DATATYPE)
    o_flags |= flag(lang, R.HAS_LANG)
    o_flags |= flag(is_lit & ~malformed, R.LEXICAL_OK)
    o_flags |= flag(is_lit & (rand() < prof["license_stmt_literal"]),
                    R.IS_LICENSE_STATEMENT)
    dt = torch.randint(R.DT_STRING, R.DT_OTHER + 1, (m,), generator=gen,
                       device=device).to(torch.int32)
    o_dt = torch.where(typed, dt, torch.where(lang, R.DT_LANGSTRING,
                                              R.DT_NONE).to(torch.int32))
    o_rate = torch.where(is_lit, float(prof["literal_len_mean"]),
                         float(prof["uri_len_mean"]))
    o_len = lengthen(poisson(o_rate), is_iri_o & (rand() < prof["long_uri"]))

    return torch.stack([
        s_id.to(torch.int32), p_id.to(torch.int32), o_id.to(torch.int32),
        s_flags, p_flags, o_flags, s_len, p_len, o_len, o_dt,
        R.term_hash(s_id), R.term_hash(p_id), R.term_hash(o_id)])


def make_planes(config: dict, seed: int, device,
                block_rows: int = BLOCK_ROWS) -> torch.Tensor:
    """The configuration's ``(triples, 13)`` int32 planes on ``device``."""
    n = int(config["triples"])
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    planes = torch.empty((n, R.N_PLANES), dtype=torch.int32, device=device)
    for start in range(0, n, block_rows):
        m = min(block_rows, n - start)
        planes[start:start + m].copy_(
            _block(gen, m, n, config["profile"], device).T)
    return planes
