"""Cross-crawl regression tracking: which datasets got worse, and why.

A catalog crawl re-runs periodically; the interesting output is rarely
the absolute scores but their movement.  This module compares each
dataset's latest ``history.jsonl`` snapshot against its previous one and
reports per-metric deltas, plus rule-based alerts reusing the exact
grammar of ``repro_torch.serve.alerts``::

    dereferenceability < 0.9
    delta(no_prolix_features) < -0.05

so a threshold that pages on one dataset in the service daemon can be
applied fleet-wide in a crawl report without re-encoding it.
"""
from __future__ import annotations

from typing import Mapping, Sequence

from ..serve.alerts import parse_rules
from .ranking import load_catalog_histories


def regression_report(histories: Mapping[str, list[dict]],
                      rules: Sequence[str] = ()) -> dict:
    """Latest-vs-previous deltas per dataset per metric.

    Returns ``{"n_datasets", "n_with_previous", "rules", "datasets":
    [{"name", "values", "previous", "deltas", "regressed", "improved",
    "alerts"}, ...], "fired": [...]}`` where ``fired`` flattens every
    alert with its dataset name.  A dataset with a single snapshot has
    no deltas (first crawl) but its absolute-value rules still apply.
    """
    parsed = parse_rules(rules)
    rows, fired = [], []
    for name in sorted(histories):
        snaps = histories[name]
        if not snaps:
            continue
        latest = snaps[-1]
        prev = snaps[-2] if len(snaps) > 1 else None
        values = {k: float(v)
                  for k, v in sorted(latest.get("values", {}).items())}
        pvalues = ({k: float(v)
                    for k, v in sorted(prev.get("values", {}).items())}
                   if prev else None)
        deltas = ({m: values[m] - pvalues[m]
                   for m in values if m in pvalues}
                  if pvalues is not None else {})
        alerts = []
        for rule in parsed:
            rec = rule.evaluate(values, pvalues)
            if rec:
                alerts.append(rec)
                fired.append(dict(rec, name=name))
        rows.append({
            "name": name,
            "generatedAtTime": latest.get("generatedAtTime"),
            "values": values,
            "previous": pvalues,
            "deltas": deltas,
            "regressed": sorted(m for m, d in deltas.items() if d < 0),
            "improved": sorted(m for m, d in deltas.items() if d > 0),
            "alerts": alerts,
        })
    return {
        "n_datasets": len(rows),
        "n_with_previous": sum(1 for r in rows
                               if r["previous"] is not None),
        "rules": list(rules),
        "datasets": rows,
        "fired": fired,
    }


def report_catalog(root, rules: Sequence[str] = (),
                   names=None) -> dict:
    """``regression_report`` over the stores under a catalog root."""
    return regression_report(load_catalog_histories(root, names),
                             rules=rules)


def regression_markdown(doc: dict) -> str:
    """The regression report as markdown: a delta table plus the fired
    alerts, worst movers first."""
    lines = ["# Catalog regression report", "",
             f"{doc['n_datasets']} dataset(s), "
             f"{doc['n_with_previous']} with a previous crawl to "
             "compare against.", ""]
    movers = sorted((r for r in doc["datasets"] if r["deltas"]),
                    key=lambda r: min(r["deltas"].values()))
    if movers:
        lines += ["| dataset | worst delta | regressed | improved |",
                  "|---|---|---|---|"]
        for r in movers:
            worst_m = min(r["deltas"], key=lambda m: r["deltas"][m])
            lines.append(
                f"| {r['name']} | {worst_m} "
                f"{r['deltas'][worst_m]:+.4f} "
                f"| {', '.join(r['regressed']) or '-'} "
                f"| {', '.join(r['improved']) or '-'} |")
    else:
        lines.append("No datasets have a previous snapshot yet.")
    if doc["fired"]:
        lines += ["", "## Alerts", ""]
        for f in doc["fired"]:
            subj = (f"delta {f['delta']:+.4f}" if f["on_delta"]
                    else f"value {f['value']:.4f}")
            lines.append(f"- **{f['name']}**: `{f['rule']}` fired "
                         f"({subj})")
    return "\n".join(lines) + "\n"
