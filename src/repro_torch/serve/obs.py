"""Service observability: a minimal Prometheus-text metrics registry.

Stdlib-only (no ``prometheus_client``): counters, summaries (``_sum`` +
``_count``, enough for request-latency rate/avg queries), and gauges
backed by callables sampled at scrape time.  Rendered in the Prometheus
text exposition format by ``render()`` for ``GET /metrics``.

Label sets are kept low-cardinality by construction: routes are labeled
by *route name* (the pattern, not the raw path) and datasets by their
registered name.
"""
from __future__ import annotations

import threading
from typing import Callable, Tuple

_LabelKey = Tuple[str, tuple]


def _label_str(labels: dict) -> str:
    if not labels:
        return ""
    parts = []
    for k in sorted(labels):
        v = str(labels[k]).replace("\\", r"\\").replace('"', r"\"") \
            .replace("\n", r"\n")
        parts.append(f'{k}="{v}"')
    return "{" + ",".join(parts) + "}"


def _fmt(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else repr(float(v))


class Metrics:
    """Thread-safe counter/summary/gauge registry."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[_LabelKey, float] = {}
        self._summaries: dict[_LabelKey, list] = {}   # [sum, count]
        self._gauges: dict[str, Callable[[], float]] = {}

    def inc(self, name: str, amount: float = 1.0, **labels) -> None:
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + amount

    def observe(self, name: str, value: float, **labels) -> None:
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            s = self._summaries.setdefault(key, [0.0, 0])
            s[0] += value
            s[1] += 1

    def gauge(self, name: str, fn: Callable[[], float]) -> None:
        """Register a gauge sampled at render time (e.g. queue depth)."""
        with self._lock:
            self._gauges[name] = fn

    def value(self, name: str, **labels) -> float:
        """Current counter value (0.0 when never incremented)."""
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            return self._counters.get(key, 0.0)

    def render(self) -> str:
        """Prometheus text exposition format, families sorted by name."""
        with self._lock:
            counters = dict(self._counters)
            summaries = {k: list(v) for k, v in self._summaries.items()}
            gauges = dict(self._gauges)
        lines: list[str] = []
        for fam in sorted({name for name, _ in counters}):
            lines.append(f"# TYPE {fam} counter")
            for (name, labels), v in sorted(counters.items()):
                if name == fam:
                    lines.append(f"{name}{_label_str(dict(labels))} "
                                 f"{_fmt(v)}")
        for fam in sorted({name for name, _ in summaries}):
            lines.append(f"# TYPE {fam} summary")
            for (name, labels), (vsum, vcount) in sorted(summaries.items()):
                if name == fam:
                    ls = _label_str(dict(labels))
                    lines.append(f"{name}_sum{ls} {repr(float(vsum))}")
                    lines.append(f"{name}_count{ls} {vcount}")
        for name in sorted(gauges):
            lines.append(f"# TYPE {name} gauge")
            try:
                v = float(gauges[name]())
            except Exception:           # noqa: BLE001 — a broken gauge
                continue                # must not break the whole scrape
            lines.append(f"{name} {_fmt(v)}")
        return "\n".join(lines) + "\n"
