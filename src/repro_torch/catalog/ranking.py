"""Cross-dataset quality ranking from per-store history snapshots.

The paper's fleet-scale story ends in a comparison: once every dataset
in a catalog has been assessed with the *same* metric suite, their
scores are directly comparable and the catalog can be ranked.  This
module derives that ranking purely from ``history.jsonl`` snapshots —
no re-assessment, no access to the datasets themselves — so it is cheap
enough to serve from the daemon on every request.

The aggregate score is the unweighted mean of a dataset's metric values
(all repro metrics are already normalized ratios in [0, 1]); datasets
missing a metric are averaged over the metrics they do have.  Ranking is
deterministic: score descending, name ascending on ties.
"""
from __future__ import annotations

import os
from typing import Mapping, Optional, Sequence

from .crawl import store_dir


def load_catalog_histories(root,
                           names: Optional[Sequence[str]] = None
                           ) -> dict[str, list[dict]]:
    """``{name: snapshots}`` for every dataset under the catalog root
    (or just ``names``), reading each ``<root>/<name>/store/
    history.jsonl``.  Datasets with no snapshots yet are omitted."""
    from ..core import report
    root = os.fspath(root)
    if names is None:
        try:
            names = sorted(
                d for d in os.listdir(root)
                if os.path.isdir(store_dir(root, d)))
        except OSError:
            names = []
    out = {}
    for name in names:
        hist = report.load_history(
            os.path.join(store_dir(root, name), "history.jsonl"))
        if hist:
            out[name] = hist
    return out


def rank_histories(histories: Mapping[str, list[dict]]) -> dict:
    """Rank datasets by their *latest* snapshot.

    Returns ``{"n_datasets", "metrics": {m: {"mean","min","max","best",
    "worst"}}, "ranking": [{"rank","name","score","values","n_triples",
    "generatedAtTime"}, ...]}`` — JSON-ready, stable across runs given
    identical snapshots.
    """
    rows = []
    for name in sorted(histories):
        snaps = histories[name]
        if not snaps:
            continue
        latest = snaps[-1]
        values = {k: float(v)
                  for k, v in sorted(latest.get("values", {}).items())}
        score = (sum(values.values()) / len(values)) if values else 0.0
        rows.append({
            "name": name,
            "score": score,
            "values": values,
            "n_triples": int(latest.get("nTriples", 0)),
            "generatedAtTime": latest.get("generatedAtTime"),
        })
    rows.sort(key=lambda r: (-r["score"], r["name"]))
    for i, row in enumerate(rows):
        row["rank"] = i + 1

    metric_names = sorted({m for r in rows for m in r["values"]})
    metrics = {}
    for m in metric_names:
        have = [r for r in rows if m in r["values"]]
        vals = [r["values"][m] for r in have]
        # rows are name-sorted and min/max keep the first-encountered
        # extremum, so ties resolve to the lexicographically first name
        best = max(have, key=lambda r: r["values"][m])
        worst = min(have, key=lambda r: r["values"][m])
        metrics[m] = {
            "mean": sum(vals) / len(vals),
            "min": min(vals),
            "max": max(vals),
            "best": best["name"],
            "worst": worst["name"],
        }
    return {"n_datasets": len(rows), "metrics": metrics, "ranking": rows}


def rank_catalog(root, names: Optional[Sequence[str]] = None) -> dict:
    """``rank_histories`` over the stores under a catalog root."""
    return rank_histories(load_catalog_histories(root, names))


def ranking_markdown(doc: dict) -> str:
    """The ranking as a readable markdown dashboard (one table of
    datasets, one of per-metric spread)."""
    lines = ["# Catalog quality ranking", "",
             f"{doc['n_datasets']} dataset(s) ranked by mean metric "
             "score (latest snapshot each).", ""]
    metric_names = sorted(doc.get("metrics", {}))
    head = ["rank", "dataset", "score", "triples"] + metric_names
    lines.append("| " + " | ".join(head) + " |")
    lines.append("|" + "---|" * len(head))
    for r in doc.get("ranking", []):
        cells = [str(r["rank"]), r["name"], f"{r['score']:.4f}",
                 str(r["n_triples"])]
        cells += [f"{r['values'][m]:.4f}" if m in r["values"] else "-"
                  for m in metric_names]
        lines.append("| " + " | ".join(cells) + " |")
    if metric_names:
        lines += ["", "## Per-metric spread", "",
                  "| metric | mean | min | max | best | worst |",
                  "|---|---|---|---|---|---|"]
        for m in metric_names:
            s = doc["metrics"][m]
            lines.append(
                f"| {m} | {s['mean']:.4f} | {s['min']:.4f} "
                f"| {s['max']:.4f} | {s['best']} | {s['worst']} |")
    return "\n".join(lines) + "\n"
