"""Threshold / regression alert rules over assessment results.

Rule syntax (one string per rule, registered per dataset)::

    L1 < 0.9              # value threshold: fire when the latest value
    SV3 <= 0.5            #   satisfies the comparison
    delta(CN2) < -0.01    # regression: fire on the change vs the
                          #   previous snapshot (latest - previous)

Operators: ``< <= > >= == !=``.  Metric names follow the registry
(``[A-Za-z_][A-Za-z0-9._-]*``).  Rules referencing a metric the run did
not measure never fire; ``delta(...)`` rules need a previous snapshot.

Fired alerts become append-only records in the dataset's
``alerts.jsonl`` and, when the registration carries a ``webhook``, a
JSON POST to that URL (failures are logged, never fatal — alerting must
not take an assessment down).
"""
from __future__ import annotations

import dataclasses
import json
import operator
import re
import sys
import time
import urllib.request
from typing import Mapping, Optional, Sequence

_OPS = {"<": operator.lt, "<=": operator.le, ">": operator.gt,
        ">=": operator.ge, "==": operator.eq, "!=": operator.ne}

_RULE_RE = re.compile(
    r"^\s*(?:(delta)\(\s*([A-Za-z_][A-Za-z0-9._-]*)\s*\)"
    r"|([A-Za-z_][A-Za-z0-9._-]*))\s*"
    r"(<=|>=|==|!=|<|>)\s*"
    r"([-+]?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?)\s*$")


@dataclasses.dataclass(frozen=True)
class AlertRule:
    text: str                 # the source string, echoed in fired records
    metric: str
    op: str
    bound: float
    on_delta: bool = False    # compare latest - previous, not the value

    def evaluate(self, values: Mapping[str, float],
                 previous: Optional[Mapping[str, float]] = None,
                 ) -> Optional[dict]:
        """The fired-alert record, or ``None`` when the rule holds."""
        v = values.get(self.metric)
        if v is None:
            return None
        prev = previous.get(self.metric) if previous else None
        if self.on_delta:
            if prev is None:
                return None             # nothing to regress against yet
            subject = v - prev
        else:
            subject = v
        if not _OPS[self.op](subject, self.bound):
            return None
        return {
            "rule": self.text, "metric": self.metric, "op": self.op,
            "bound": self.bound, "value": v, "previous": prev,
            "delta": (v - prev) if prev is not None else None,
            "on_delta": self.on_delta,
        }


def parse_rule(text: str) -> AlertRule:
    m = _RULE_RE.match(text or "")
    if not m:
        raise ValueError(
            f"bad alert rule {text!r}: expected '<metric> <op> <number>' "
            "or 'delta(<metric>) <op> <number>' with op in "
            "< <= > >= == !=")
    delta_kw, delta_metric, metric, op, bound = m.groups()
    return AlertRule(text=text.strip(), metric=delta_metric or metric,
                     op=op, bound=float(bound),
                     on_delta=delta_kw is not None)


def parse_rules(rules: Sequence[str]) -> tuple[AlertRule, ...]:
    return tuple(parse_rule(r) for r in rules)


def post_webhook(url: str, payload: dict, timeout: float = 5.0,
                 retries: int = 3, backoff: float = 0.5,
                 fault=None) -> bool:
    """POST a fired-alert record as JSON; returns success.  Up to
    ``retries`` attempts with exponential backoff between them
    (``backoff × 2^(attempt-1)`` seconds) — a webhook receiver mid-deploy
    gets the alert on the next try instead of losing it.  Any final
    failure (unreachable target, non-2xx, timeout) is reported on stderr
    and swallowed — the assessment result stands regardless; the daemon
    counts it in ``repro_webhook_failures_total``.  ``fault`` is a
    ``ServiceFaultInjector`` hook (``on_webhook`` may raise per attempt,
    the test substrate for the retry path)."""
    data = json.dumps(payload, sort_keys=True).encode()
    last = "no attempts"
    for attempt in range(1, max(1, retries) + 1):
        try:
            if fault is not None:
                fault.on_webhook(url)
            req = urllib.request.Request(
                url, data=data,
                headers={"Content-Type": "application/json"},
                method="POST")
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                if 200 <= resp.status < 300:
                    return True
                last = f"HTTP {resp.status}"
        except Exception as e:          # noqa: BLE001 — never fatal
            last = str(e)
        if attempt < max(1, retries):
            time.sleep(backoff * (2 ** (attempt - 1)))
    print(f"# repro_torch.serve: webhook POST to {url} failed after "
          f"{max(1, retries)} attempts: {last}", file=sys.stderr)
    return False
