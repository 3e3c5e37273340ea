"""DQV-style machine-readable quality report (paper §2.3, line 10) and
quality history (Luzzu-style timestamped quality metadata).

The paper emits W3C Data Quality Vocabulary (DQV) descriptions; we produce
the same structure as JSON-LD-shaped dicts (and N-Triples text), keyed by
the metric registry's dimension taxonomy.  Every property key is properly
namespaced (``dqv:`` for measurement structure, ``prov:`` for provenance,
``dcterms:`` for descriptions) so the JSON-LD and N-Triples serializations
describe the same graph.

Quality over time: ``append_history`` / ``load_history`` maintain a
``history.jsonl`` of timestamped snapshots (one JSON object per line —
append-only, so a torn write corrupts at most the final line, which
``load_history`` skips), and ``to_dqv_history`` folds a history into a
trend report with per-metric deltas.  ``repro.store`` appends a snapshot
on every incremental assessment; ``--watch`` mode turns that into live
dataset monitoring.
"""
from __future__ import annotations

import datetime
import json
import math
import os
import re
from typing import Iterable, Mapping, Union

from .. import tracing
from .evaluator import AssessmentResult
from .metrics import REGISTRY

DQV = "http://www.w3.org/ns/dqv#"
PROV = "http://www.w3.org/ns/prov#"
DCT = "http://purl.org/dc/terms/"
XSD = "http://www.w3.org/2001/XMLSchema#"
SDMX = "http://purl.org/linked-data/sdmx/2009/measure#"


class _UnknownMetric:
    dimension = "custom"
    description = "(metric no longer registered)"


_UNKNOWN_METRIC = _UnknownMetric()


def _now() -> str:
    return datetime.datetime.now(datetime.timezone.utc).isoformat()


def _dimension_uri(dimension: str) -> str:
    return f"urn:repro:dimension:{dimension}"


def to_dqv(result: AssessmentResult, dataset_uri: str = "urn:repro:dataset",
           computed_on: str | None = None) -> dict:
    return _dqv(result.values, result.n_triples, result.passes,
                _exec_stats_provenance(result), dataset_uri,
                computed_on or _now())


def _dqv(values: Mapping, n_triples, passes, exec_stats: dict | None,
         dataset_uri: str, ts) -> dict:
    measurements = []
    for name, value in sorted(values.items()):
        # results may outlive their registry entries (user metrics can be
        # unregistered after assessment) — degrade gracefully
        m = REGISTRY.get(name) or _UNKNOWN_METRIC
        measurements.append({
            "@type": DQV + "QualityMeasurement",
            DQV + "computedOn": {"@id": dataset_uri},
            DQV + "isMeasurementOf": {"@id": f"urn:repro:metric:{name}"},
            DQV + "value": value,
            DQV + "inDimension": {"@id": _dimension_uri(m.dimension)},
            DCT + "description": m.description,
            PROV + "generatedAtTime": {"@value": ts,
                                       "@type": XSD + "dateTime"},
        })
    out = {
        "@context": {"dqv": DQV, "prov": PROV, "dcterms": DCT, "xsd": XSD,
                     "sdmx-measure": SDMX},
        "@id": dataset_uri,
        "nTriples": n_triples,
        "passes": passes,
        "measurements": measurements,
    }
    if exec_stats is not None:
        out["execStats"] = exec_stats
    return out


def _exec_stats_provenance(result: AssessmentResult) -> dict | None:
    """Key execution-provenance fields for service consumers (how the
    value was computed: incremental reuse, passes, bytes), so a report
    served over HTTP needs no side channel to ``exec_stats``.  ``None``
    for single-shot results, which carry no scheduler stats."""
    s = result.exec_stats
    if s is None:
        return None
    es = {
        "mode": getattr(s, "mode", "sync"),
        "chunks_total": int(getattr(s, "chunks_total", 0)),
        "passes_per_chunk": int(getattr(s, "passes_per_chunk", 0)),
    }
    if getattr(s, "devices", 1) > 1:    # mesh runs: record the shard count
        es["devices"] = int(s.devices)
    if getattr(s, "bytes_total", 0):
        es["segments_reused"] = int(s.segments_reused)
        es["segments_rescanned"] = int(s.segments_rescanned)
        es["bytes_total"] = int(s.bytes_total)
        es["bytes_rescanned"] = int(s.bytes_rescanned)
    return es


def to_ntriples(result: AssessmentResult,
                dataset_uri: str = "urn:repro:dataset",
                computed_on: str | None = None) -> str:
    from ..rdf.parser import escape_literal
    ts = computed_on or _now()
    lines = []
    for name, value in sorted(result.values.items()):
        m = REGISTRY.get(name) or _UNKNOWN_METRIC
        node = f"_:meas_{name}"
        lines.append(f"{node} <{DQV}computedOn> <{dataset_uri}> .")
        lines.append(f"{node} <{DQV}isMeasurementOf> "
                     f"<urn:repro:metric:{name}> .")
        lines.append(
            f'{node} <{DQV}value> '
            f'"{value}"^^<{XSD}double> .')
        lines.append(f"{node} <{DQV}inDimension> "
                     f"<{_dimension_uri(m.dimension)}> .")
        lines.append(f'{node} <{DCT}description> '
                     f'"{escape_literal(m.description)}" .')
        lines.append(f'{node} <{PROV}generatedAtTime> '
                     f'"{ts}"^^<{XSD}dateTime> .')
    return "\n".join(lines) + "\n"


def to_json(result: AssessmentResult, dataset_uri: str = "urn:repro:dataset",
            computed_on: str | None = None) -> str:
    """``json.dumps(to_dqv(result, ...), indent=2)``, byte for byte.

    The indented encoder is pure Python; instead the text is filled into
    a template of the report's static text, built once a shape (metric
    names and their registry entries, ``dataset_uri``, ``execStats``'
    keys) from that same encoder. A value the template cannot hold (NaN,
    infinities, a bool, anything but a ``str``, ``int`` or ``float``)
    takes the encoder itself. One of the counters ``report.template_hit``,
    ``report.template_build`` or ``report.template_fallback`` counts each
    call."""
    with tracing.span("report.to_json"):
        with tracing.span("report.dqv"):
            ts = computed_on or _now()
            es = _exec_stats_provenance(result)
            names = sorted(result.values)
            metrics = [REGISTRY.get(name) or _UNKNOWN_METRIC
                       for name in names]
            key = (dataset_uri, None if es is None else tuple(es),
                   tuple(names), tuple([m.dimension for m in metrics]),
                   tuple([m.description for m in metrics]))
            template = _TEMPLATES.get(key)
            counter = "report.template_hit"
            if template is None:
                template = _build_template(key, names, es, dataset_uri)
                counter = "report.template_build"
        if template is not None:
            with tracing.span("report.encode"):
                text = _fill(template, (
                    result.n_triples, result.passes,
                    *(() if es is None else es.values()),
                    *(result.values[name] for name in names), ts))
            if text is not None:
                tracing.add(counter)
                return text
        tracing.add("report.template_fallback")
        with tracing.span("report.dqv"):
            dqv = to_dqv(result, dataset_uri, computed_on)
        with tracing.span("report.encode"):
            return json.dumps(dqv, indent=2)


# to_json's templates: a tuple of the report's static text at even
# positions and, between them, the index of the leaf that goes there
# (``nTriples``, ``passes``, execStats' values, the metric values in name
# order, the timestamp). Nothing in them depends on a value.
_TEMPLATES: dict = {}
_TEMPLATES_MAX = 64
_SLOT = "@repro.slot.{}@"
_SLOT_SPLIT = re.compile(r'"@repro\.slot\.(\d+)@"')


def _build_template(key, names, es, dataset_uri):
    """The template of ``key``, cached, from ``json.dumps(..., indent=2)``
    of a report whose leaves are sentinels; None where a sentinel is not
    found as often as it was put in (the static text holds one)."""
    n_es = 0 if es is None else len(es)
    slot = [_SLOT.format(i) for i in range(3 + n_es + len(names))]
    pieces = _SLOT_SPLIT.split(json.dumps(_dqv(
        dict(zip(names, slot[2 + n_es:-1])), slot[0], slot[1],
        None if es is None else dict(zip(es, slot[2:2 + n_es])),
        dataset_uri, slot[-1]), indent=2))
    pieces[1::2] = map(int, pieces[1::2])
    if sorted(pieces[1::2]) != [*range(len(slot) - 1),
                                *[len(slot) - 1] * len(names)]:
        return None
    template = tuple(pieces)
    if len(_TEMPLATES) >= _TEMPLATES_MAX:
        _TEMPLATES.clear()
    _TEMPLATES[key] = template
    return template


def _fill(template: tuple, leaves: tuple) -> str | None:
    """``template`` with each slot replaced by its leaf as ``json``'s
    encoder writes it; None if a leaf is one the template cannot hold."""
    text = []
    for v in leaves:
        if isinstance(v, float):
            if not math.isfinite(v):
                return None
            text.append(float.__repr__(v))
        elif isinstance(v, int) and not isinstance(v, bool):
            text.append(int.__repr__(v))
        elif isinstance(v, str):
            text.append(json.encoder.encode_basestring_ascii(v))
        else:
            return None
    pieces = list(template)
    pieces[1::2] = [text[i] for i in template[1::2]]
    return "".join(pieces)


# --- quality history ----------------------------------------------------------

def history_entry(result: AssessmentResult,
                  dataset_uri: str = "urn:repro:dataset",
                  computed_on: str | None = None) -> dict:
    """One timestamped snapshot for ``history.jsonl``."""
    entry = {
        "generatedAtTime": computed_on or _now(),
        "dataset": dataset_uri,
        "nTriples": result.n_triples,
        "values": {k: float(v) for k, v in sorted(result.values.items())},
    }
    s = result.exec_stats
    if s is not None and getattr(s, "bytes_total", 0):
        entry["segments_reused"] = s.segments_reused
        entry["segments_rescanned"] = s.segments_rescanned
        entry["bytes_total"] = s.bytes_total
        entry["bytes_rescanned"] = s.bytes_rescanned
    return entry


def append_history(path: Union[str, os.PathLike], result: AssessmentResult,
                   **kw) -> dict:
    """Append one snapshot line to ``path``; returns the entry written."""
    entry = history_entry(result, **kw)
    with open(path, "a") as f:
        f.write(json.dumps(entry, sort_keys=True) + "\n")
    return entry


def load_history(path: Union[str, os.PathLike]) -> list[dict]:
    """Snapshots in append order.  Undecodable lines (e.g. the torn tail
    of a crashed append) are skipped, not fatal."""
    out = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    e = json.loads(line)
                except ValueError:
                    continue
                if isinstance(e, dict) and "values" in e:
                    out.append(e)
    except OSError:
        pass
    return out


def to_dqv_history(history: Union[str, os.PathLike, Iterable[Mapping]],
                   dataset_uri: str | None = None) -> dict:
    """Fold a quality history into a DQV-shaped trend report.

    ``history``: a path to ``history.jsonl`` or an iterable of entries.
    Per metric: the full value series plus ``latest``, ``delta`` (latest −
    previous snapshot, 0.0 for a single snapshot), and min/max over the
    window — the machine-readable core of dataset quality monitoring.
    """
    entries = (load_history(history)
               if isinstance(history, (str, os.PathLike)) else list(history))
    times = [e.get("generatedAtTime") for e in entries]
    # align every metric's series to the snapshot axis (None where a
    # snapshot didn't measure it — metric sets may change across engine
    # reconfigurations), so values[i] always belongs to times[i]
    names = sorted({n for e in entries for n in e["values"]})
    metrics: dict[str, dict] = {}
    for name in names:
        vs = [e["values"].get(name) for e in entries]
        vs = [float(v) if v is not None else None for v in vs]
        present = [v for v in vs if v is not None]
        delta = (vs[-1] - vs[-2]
                 if len(vs) >= 2 and vs[-1] is not None
                 and vs[-2] is not None else 0.0)
        metrics[name] = {
            "values": vs,
            "latest": present[-1],
            "delta": delta,
            "min": min(present),
            "max": max(present),
            "@id": f"urn:repro:metric:{name}",
        }
    uri = dataset_uri or (entries[-1].get("dataset") if entries
                          else "urn:repro:dataset")
    return {
        "@context": {"dqv": DQV, "prov": PROV, "xsd": XSD},
        "@id": uri,
        "snapshots": len(entries),
        PROV + "generatedAtTime": times,
        "nTriples": [e.get("nTriples") for e in entries],
        "metrics": metrics,
    }
