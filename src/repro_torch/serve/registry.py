"""Multi-tenant dataset registry: one segment store per dataset.

Layout under the service's store root (every file written atomically via
temp file + ``os.replace`` so concurrent readers — including the CDC
segmenter streaming an upload mid-assessment — never see torn content)::

    <root>/
      <name>/                # one directory per registered dataset
        dataset.json         # registration record (source, alert rules, webhook)
        data.nt              # last uploaded N-Triples payload
        store/               # repro_torch.store segment store (manifest.json,
                             #   segments/, history.jsonl, .lock)
        report.json          # latest DQV report, JSON-LD shape
        report.nt            # latest DQV report, N-Triples serialization
        alerts.jsonl         # fired alert records, append-only

Dataset names are the only client-controlled path component, so they are
validated against a conservative charset (``[A-Za-z0-9][A-Za-z0-9._-]*``,
max 64 chars, no ``.``/``..``) — a name can never escape the root or
collide with another tenant's directory.

The per-dataset ``store/`` is an ordinary ``repro_torch.store`` directory: the
daemon's jobs and any external CLI run (``--store <root>/<name>/store``)
can assess against it concurrently — commits are serialized by the
store's flock and the manifest version is CAS'd (see ``repro_torch.store``).
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import os
import re
import shutil
import threading
from typing import Optional, Sequence

_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")


class RegistryError(ValueError):
    """Invalid registration input (bad dataset name, bad record)."""


class UnknownDataset(KeyError):
    """Lookup of a dataset that was never registered."""

    def __str__(self):  # KeyError wraps args in quotes; keep it readable
        return str(self.args[0]) if self.args else ""


def validate_name(name: str) -> str:
    """A dataset name is used as a directory name under the root — accept
    only path-safe tokens (this also excludes ``.``, ``..``, separators,
    NUL, and anything needing URL escaping beyond the obvious)."""
    if not isinstance(name, str) or not _NAME_RE.match(name):
        raise RegistryError(
            f"invalid dataset name {name!r}: must match "
            "[A-Za-z0-9][A-Za-z0-9._-]* (max 64 chars)")
    return name


def _now() -> str:
    return datetime.datetime.now(datetime.timezone.utc).isoformat()


def _atomic_write(path: str, data: bytes) -> None:
    """Temp file + rename in the destination directory; the tmp name is
    per-writer-unique so concurrent writers never race each other's
    rename (same contract as the segment store's writes)."""
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass


@dataclasses.dataclass
class Dataset:
    """One registered dataset (the registration record, not its state)."""
    name: str
    source: Optional[str] = None     # server-side N-Triples path to monitor
    rules: tuple = ()                # alert rule strings (repro_torch.serve.alerts)
    webhook: Optional[str] = None    # POST target for fired alerts
    created: str = ""                # ISO timestamp of first registration

    def to_dict(self) -> dict:
        return {"name": self.name, "source": self.source,
                "alerts": list(self.rules), "webhook": self.webhook,
                "created": self.created}


class DatasetRegistry:
    """Registrations + per-dataset filesystem layout under one root.

    Registrations are persisted (``dataset.json`` per dataset) and
    reloaded on construction, so a restarted daemon finds its tenants —
    the stores, histories, and reports were on disk all along.
    """

    def __init__(self, root: str):
        self.root = os.path.abspath(os.fspath(root))
        os.makedirs(self.root, exist_ok=True)
        self._lock = threading.Lock()
        self._datasets: dict[str, Dataset] = {}
        self._load()

    def _load(self) -> None:
        for entry in sorted(os.listdir(self.root)):
            rec = os.path.join(self.root, entry, "dataset.json")
            if not _NAME_RE.match(entry) or not os.path.isfile(rec):
                continue
            try:
                with open(rec) as f:
                    doc = json.load(f)
                self._datasets[entry] = Dataset(
                    name=entry, source=doc.get("source"),
                    rules=tuple(doc.get("alerts") or ()),
                    webhook=doc.get("webhook"),
                    created=doc.get("created") or "")
            except (OSError, ValueError):
                continue            # torn/corrupt record: not registered

    # -- registration ----------------------------------------------------------
    def register(self, name: str, *, source: Optional[str] = None,
                 rules: Sequence[str] = (), webhook: Optional[str] = None,
                 ) -> tuple[Dataset, bool]:
        """Create or update a dataset registration; returns
        ``(dataset, created)``.  Re-registering updates source / alert
        rules / webhook but keeps the original creation timestamp and all
        on-disk state (store, history, reports)."""
        validate_name(name)
        if source is not None and not isinstance(source, str):
            raise RegistryError("source must be a server-side path string")
        if webhook is not None and not isinstance(webhook, str):
            raise RegistryError("webhook must be a URL string")
        with self._lock:
            old = self._datasets.get(name)
            ds = Dataset(name=name, source=source, rules=tuple(rules),
                         webhook=webhook,
                         created=old.created if old else _now())
            os.makedirs(self.dataset_dir(name), exist_ok=True)
            _atomic_write(
                os.path.join(self.dataset_dir(name), "dataset.json"),
                json.dumps(ds.to_dict(), sort_keys=True,
                           indent=2).encode())
            self._datasets[name] = ds
            return ds, old is None

    def delete(self, name: str) -> int:
        """Unregister ``name`` and reclaim its entire on-disk footprint
        (store segments via ``SegmentStore.destroy`` — which serializes
        with any concurrent committer on the store's flock — plus the
        registration record, payload, reports, and alert log).  Returns
        bytes freed.  The *caller* is responsible for quiescence (the
        daemon refuses the DELETE while jobs are queued or running) and
        for journaling the tombstone."""
        from ..store.store import SegmentStore
        validate_name(name)
        with self._lock:
            if name not in self._datasets:
                raise UnknownDataset(f"dataset {name!r} is not registered"
                                     ) from None
            del self._datasets[name]
        d = self.dataset_dir(name)
        freed = SegmentStore.destroy(self.store_dir(name))
        for base, _dirs, files in os.walk(d):
            for fn in files:
                try:
                    freed += os.path.getsize(os.path.join(base, fn))
                except OSError:
                    pass
        shutil.rmtree(d, ignore_errors=True)
        return freed

    def get(self, name: str) -> Dataset:
        with self._lock:
            try:
                return self._datasets[name]
            except KeyError:
                raise UnknownDataset(f"dataset {name!r} is not registered"
                                     ) from None

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._datasets)

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._datasets

    # -- layout ----------------------------------------------------------------
    def dataset_dir(self, name: str) -> str:
        return os.path.join(self.root, validate_name(name))

    def data_path(self, name: str) -> str:
        return os.path.join(self.dataset_dir(name), "data.nt")

    def store_dir(self, name: str) -> str:
        return os.path.join(self.dataset_dir(name), "store")

    def history_path(self, name: str) -> str:
        return os.path.join(self.store_dir(name), "history.jsonl")

    def report_path(self, name: str, fmt: str = "json") -> str:
        return os.path.join(self.dataset_dir(name), f"report.{fmt}")

    def alerts_path(self, name: str) -> str:
        return os.path.join(self.dataset_dir(name), "alerts.jsonl")

    # -- payloads --------------------------------------------------------------
    def save_upload(self, name: str, data: bytes) -> str:
        """Persist an uploaded N-Triples payload as the dataset's data
        file.  Atomic (tmp + rename): a job segmenting the previous
        payload keeps reading the old inode; the watcher/next job sees
        the complete new file or nothing — never a torn prefix."""
        self.get(name)                       # must be registered
        path = self.data_path(name)
        _atomic_write(path, data)
        return path

    def write_report(self, name: str, json_bytes: bytes,
                     nt_bytes: bytes) -> None:
        """Persist both serializations of the latest DQV report."""
        _atomic_write(self.report_path(name, "json"), json_bytes)
        _atomic_write(self.report_path(name, "nt"), nt_bytes)

    # -- alert records ---------------------------------------------------------
    def append_alert(self, name: str, record: dict) -> None:
        with open(self.alerts_path(name), "a") as f:
            f.write(json.dumps(record, sort_keys=True) + "\n")

    def load_alerts(self, name: str) -> list[dict]:
        out = []
        try:
            with open(self.alerts_path(name)) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        out.append(json.loads(line))
                    except ValueError:
                        continue          # torn tail of a crashed append
        except OSError:
            pass
        return out
