"""Persistent, content-addressed segment store for assessment state.

On-disk layout (all writes atomic: temp file + ``os.replace``)::

    <dir>/
      manifest.json        # {"format", "payload": {...}, "digest"}
      history.jsonl        # appended quality snapshots (one JSON per line)
      .lock                # advisory flock serializing commits
      segments/
        <fingerprint>.seg  # frozen partial state of one segment
                           # (self-verifying header + npz payload)

Concurrent runners (e.g. two ``--watch`` monitors) are safe: commits are
serialized by an inter-process lock, the manifest version is monotone and
compare-and-swapped past concurrent commits (merging their state digests
when the engine signature matches), and garbage collection spares
unreferenced-but-fresh state files — another runner's frozen-but-not-yet-
committed work.

A segment's frozen state is the paper's partial aggregate made durable:
the per-plan counter vectors, every HLL sketch's register bank, the triple
count — plus the segment's **dictionary footprint**: its distinct term
keys (with flag/length/datatype metadata) in first-appearance order and
the global term ids they were assigned.  Since plane layout v2, counters
AND registers are content-determined (sketches hash the content-hash
planes, not term ids), so a stored state is valid whenever its bytes are
unchanged — the footprint is replayed only to keep the run's dictionary
canonical (cold-identical id assignment for rescans), not as a reuse
gate.

Integrity is checked at every boundary, each with a *local* fallback:

* the manifest embeds a digest of its payload — corruption or a torn
  write degrades to an empty manifest (full rescan, store rebuilt);
* the manifest records each state file's content digest — a corrupt,
  truncated, or missing ``<fp>.seg`` fails verification and only that
  segment is rescanned;
* states carry the engine signature implicitly: a manifest whose
  ``signature`` does not match the current evaluator (metrics, fusion,
  ``hll_p``, base namespaces, plan bytecode) is discarded wholesale —
  counter layouts would not line up.

This is persistence *across* runs, distinct from ``repro.checkpoint``'s
in-run resume: checkpoints snapshot a half-merged scan so a crashed
coordinator can continue; the segment store freezes per-segment monoid
elements so the *next* assessment can skip unchanged data entirely.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import io
import json
import os
import threading
import time
import zipfile
from typing import Optional, Sequence

import numpy as np

try:                     # POSIX: advisory inter-process lock, auto-released
    import fcntl         # on process death (no stale-lock cleanup needed)
except ImportError:      # non-POSIX fallback: single-process stores only
    fcntl = None

FORMAT_VERSION = 1

# Unreferenced state files younger than this survive garbage collection:
# they may be another runner's freshly-frozen, not-yet-committed work (the
# put_state → commit window).  Stale orphans older than the grace period
# are collected as before.
GC_GRACE_SECONDS = 600.0


@dataclasses.dataclass
class SegmentState:
    """Frozen partial assessment state of one segment."""
    fingerprint: str
    n_bytes: int
    n_triples: int
    counts: list                 # per-plan int64 counter vectors
    regs: dict                   # sketch name -> int32 register bank
    keys: list                   # footprint: term keys (bytes), first-seen order
    flags: np.ndarray            # footprint metadata, aligned with keys
    lengths: np.ndarray
    datatypes: np.ndarray
    ids: np.ndarray              # int64 global ids assigned at compute time


def _digest(data: bytes) -> str:
    return hashlib.blake2b(data, digest_size=16).hexdigest()


def _pack_keys(keys: Sequence[bytes]) -> tuple[np.ndarray, np.ndarray]:
    blob = b"".join(keys)
    offs = np.zeros(len(keys) + 1, np.int64)
    np.cumsum([len(k) for k in keys], out=offs[1:])
    return np.frombuffer(blob, np.uint8).copy(), offs


def _unpack_keys(blob: np.ndarray, offs: np.ndarray) -> list[bytes]:
    raw = blob.tobytes()
    o = offs.tolist()
    return [raw[o[i]:o[i + 1]] for i in range(len(o) - 1)]


class SegmentStore:
    """Content-addressed persistence for ``SegmentState``s + manifest.

    ``signature`` is the engine signature dict (see
    ``runner.engine_signature``); a stored manifest with a different
    signature is ignored (its states describe different counter layouts or
    sketch precisions), and the next ``commit`` replaces it.

    Crash recovery: state files are frozen (``put_state``) as segments
    merge, but the manifest is committed only at the end of a successful
    run.  A crash in between leaves *orphan* state files — valid, but not
    digest-listed in any manifest.  Each state file therefore embeds its
    own content digest and the engine-signature digest, so ``load_state``
    can safely adopt an orphan: torn writes fail to load, bit corruption
    fails the self-digest, and a signature mismatch (different metrics /
    ``hll_p``) is rejected before any array shapes can collide.  The id
    replay check in the runner still gates reuse, so recovery never
    weakens exactness — an interrupted cold scan resumes from the
    segments it already froze.
    """

    def __init__(self, directory: str, signature: dict):
        self.directory = directory
        self.signature = signature
        self._sig_digest = _digest(
            json.dumps(signature, sort_keys=True).encode())
        self._seg_dir = os.path.join(directory, "segments")
        os.makedirs(self._seg_dir, exist_ok=True)
        self._manifest = self._load_manifest()
        # monotone manifest version observed at load; commit() re-reads
        # the disk manifest under the lock and CASes past whatever landed
        # since (concurrent monitors against one store dir)
        self._version = int(self._manifest.get("version", 0))
        # fingerprint -> state-file digest for the CURRENT manifest
        self._digests: dict[str, str] = {
            s["fp"]: s["digest"]
            for s in self._manifest.get("segments", [])}
        self._pending: dict[str, str] = {}   # fp -> digest, put this run

    @property
    def version(self) -> int:
        """Version of the last manifest this store instance loaded or
        committed (0 = no valid manifest)."""
        return self._version

    @contextlib.contextmanager
    def _commit_lock(self):
        """Exclusive inter-process lock serializing manifest commits (and
        their GC) across concurrent runners on one store directory.  The
        lock file is advisory and empty; ``flock`` releases it on process
        death, so a crashed runner never wedges the store."""
        if fcntl is None:
            yield
            return
        fd = os.open(os.path.join(self.directory, ".lock"),
                     os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            yield
        finally:
            fcntl.flock(fd, fcntl.LOCK_UN)
            os.close(fd)

    # -- manifest --------------------------------------------------------------
    @property
    def manifest_path(self) -> str:
        return os.path.join(self.directory, "manifest.json")

    @property
    def history_path(self) -> str:
        return os.path.join(self.directory, "history.jsonl")

    def _load_manifest(self) -> dict:
        payload = self._disk_manifest_raw()  # digest-verified or {}
        if payload.get("format") != FORMAT_VERSION:
            return {}
        if payload.get("signature") != self.signature:
            return {}            # different engine -> states unusable
        return payload

    @property
    def known_segments(self) -> list[dict]:
        """Segment descriptors of the last committed manifest, in order."""
        return list(self._manifest.get("segments", []))

    def _atomic_write(self, path: str, data: bytes) -> None:
        # unique tmp per writer: concurrent runners freezing the SAME
        # fingerprint must not race each other's rename (content
        # addressing makes either replacement equally correct)
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        try:
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):     # failed mid-write: don't litter
                try:
                    os.remove(tmp)
                except OSError:
                    pass

    def _disk_manifest_raw(self) -> dict:
        """The digest-verified manifest payload currently on disk, with
        NO signature filtering (any engine's committed version counts for
        CAS ordering) — ``{}`` when absent/torn/corrupt."""
        try:
            with open(self.manifest_path) as f:
                doc = json.load(f)
            payload = doc["payload"]
            if (_digest(json.dumps(payload, sort_keys=True).encode())
                    != doc["digest"]):
                return {}
            return payload
        except (OSError, ValueError, KeyError):
            return {}

    def commit(self, segments: Sequence[dict]) -> None:
        """Persist the manifest for the current dataset version.

        ``segments``: ordered descriptors ``{"fp", "n_bytes", "n_triples"}``
        — the state-file digests are filled in from this run's puts and the
        previous manifest.  Unreferenced state files are garbage-collected
        (content addressing means a fingerprint shared across versions is
        naturally retained).

        Concurrency: the whole commit (re-read → swap → GC) runs under an
        exclusive inter-process lock, and the manifest carries a monotone
        ``version`` that is compare-and-swapped past whatever landed on
        disk since this store instance loaded.  A same-signature manifest
        committed concurrently contributes its state digests, so a run
        may reference segments a *concurrent* run froze (two monitors
        assessing the same appended tail) instead of failing — the last
        commit wins the manifest, but never by corrupting the loser's
        work: the loser's states stay adoptable orphans (GC grace).
        """
        with self._commit_lock():
            disk = self._disk_manifest_raw()
            if disk.get("signature") == self.signature:
                # merge concurrently-committed same-engine state digests
                # (ours win on conflict: we verified our own puts)
                merged = {s["fp"]: s["digest"]
                          for s in disk.get("segments", [])}
                merged.update(self._digests)
                self._digests = merged
            version = max(self._version, int(disk.get("version", 0))) + 1
            digests = {**self._digests, **self._pending}
            seg_docs = []
            for s in segments:
                fp = s["fp"]
                if fp not in digests:
                    raise KeyError(f"no state on disk for segment {fp}")
                seg_docs.append({**s, "digest": digests[fp]})
            payload = {
                "format": FORMAT_VERSION,
                "version": version,
                "signature": self.signature,
                "segments": seg_docs,
                "n_segments": len(seg_docs),
                "n_bytes": int(sum(s["n_bytes"] for s in seg_docs)),
                "n_triples": int(sum(s["n_triples"] for s in seg_docs)),
            }
            doc = {"payload": payload,
                   "digest": _digest(
                       json.dumps(payload, sort_keys=True).encode())}
            self._atomic_write(self.manifest_path,
                               json.dumps(doc, indent=2).encode())
            self._manifest = payload
            self._version = version
            self._digests = {s["fp"]: s["digest"] for s in seg_docs}
            self._pending = {}
            self._gc(set(self._digests))

    @classmethod
    def destroy(cls, directory) -> int:
        """Reclaim an entire store directory (dataset lifecycle GC —
        ``DELETE /datasets/<name>`` in ``repro.serve``); returns bytes
        freed.  Acquires the store's commit flock first, so a concurrent
        runner's in-flight commit completes before files vanish; a racing
        runner that starts *after* the removal simply rebuilds cold (the
        store self-heals from an empty directory).  Safe on a path that
        never held a store (returns 0)."""
        directory = os.path.abspath(os.fspath(directory))
        if not os.path.isdir(directory):
            return 0
        freed = 0
        lock_path = os.path.join(directory, ".lock")
        lock_fd = None
        if fcntl is not None:
            try:
                lock_fd = os.open(lock_path,
                                  os.O_CREAT | os.O_RDWR, 0o644)
                fcntl.flock(lock_fd, fcntl.LOCK_EX)
            except OSError:
                lock_fd = None
        try:
            for base, _dirs, files in os.walk(directory, topdown=False):
                for fn in files:
                    path = os.path.join(base, fn)
                    if path == lock_path:
                        continue
                    try:
                        freed += os.path.getsize(path)
                        os.remove(path)
                    except OSError:
                        pass
                if base != directory:
                    try:
                        os.rmdir(base)
                    except OSError:
                        pass
        finally:
            if lock_fd is not None:
                fcntl.flock(lock_fd, fcntl.LOCK_UN)
                os.close(lock_fd)
        for leftover in (lock_path, directory):
            try:
                if leftover == directory:
                    os.rmdir(leftover)
                else:
                    os.remove(leftover)
            except OSError:
                pass
        return freed

    def compact(self, *, max_history: int = 0,
                grace: float = 0.0) -> dict:
        """Explicit store maintenance for long edit histories: reclaim
        every ``.seg`` file the committed manifest no longer references
        and rewrite the on-disk artifacts in place.

        The per-commit GC spares unreferenced state files younger than
        ``GC_GRACE_SECONDS`` (they may be a concurrent runner's
        uncommitted work), so a burst of edits leaves stale segments on
        disk for up to ten minutes.  ``compact()`` is the administrative
        "really clean now": it collects unreferenced files older than
        ``grace`` (default 0 — everything; raise it when concurrent
        runners may be mid-freeze), canonically rewrites the manifest,
        and, with ``max_history > 0``, truncates ``history.jsonl`` to its
        newest ``max_history`` snapshots.  Everything runs under the
        store's commit flock, and liveness is judged against the *disk*
        manifest regardless of engine signature — compacting never
        deletes another engine's referenced state.

        Returns ``{"segments_kept", "segments_removed",
        "bytes_reclaimed", "history_dropped"}``.  A compacted store
        reuses exactly what the uncompacted one would have.
        """
        stats = {"segments_kept": 0, "segments_removed": 0,
                 "bytes_reclaimed": 0, "history_dropped": 0}
        with self._commit_lock():
            disk = self._disk_manifest_raw()
            live = {s["fp"] for s in disk.get("segments", [])}
            live |= set(self._pending)          # this run's own freezes
            now = time.time()
            for name in os.listdir(self._seg_dir):
                if not name.endswith(".seg"):
                    continue
                path = os.path.join(self._seg_dir, name)
                if name[:-4] in live:
                    stats["segments_kept"] += 1
                    continue
                try:
                    if now - os.path.getmtime(path) < grace:
                        continue
                    size = os.path.getsize(path)
                    os.remove(path)
                    stats["segments_removed"] += 1
                    stats["bytes_reclaimed"] += size
                except OSError:
                    pass
            if disk:
                # canonical rewrite: same payload, freshly serialized
                # (a manifest that accreted through many CAS'd commits
                # is re-emitted in one clean write)
                doc = {"payload": disk,
                       "digest": _digest(json.dumps(
                           disk, sort_keys=True).encode())}
                self._atomic_write(self.manifest_path,
                                   json.dumps(doc, indent=2).encode())
            if max_history > 0:
                stats["history_dropped"] = self._truncate_history_locked(
                    max_history)
        return stats

    @classmethod
    def compact_dir(cls, directory, *, max_history: int = 0,
                    grace: float = 0.0) -> dict:
        """Compact the store at ``directory`` without knowing its engine
        signature (the CLI maintenance hook).  A path that never held a
        store returns all-zero stats."""
        directory = os.fspath(directory)
        if not os.path.isdir(os.path.join(directory, "segments")):
            return {"segments_kept": 0, "segments_removed": 0,
                    "bytes_reclaimed": 0, "history_dropped": 0}
        return cls(directory, signature={}).compact(
            max_history=max_history, grace=grace)

    def verify(self) -> dict:
        """Integrity-check every ``.seg`` file the *disk* manifest
        references without deserializing any state (no ``np.load`` — the
        whole walk is digest arithmetic over raw bytes, cheap enough to
        run before a crawl).

        Two layers per segment, the same ones ``load_state`` trusts: the
        manifest's whole-file digest, then the self-verifying header's
        payload digest.  The engine-signature field is deliberately *not*
        checked — a state frozen by a different engine is unusable, not
        damaged, and fsck reports damage.  Unreferenced ``.seg`` files
        are counted as ``orphans`` (possibly a concurrent runner's
        uncommitted freezes; never an error).

        Returns ``{"segments_checked", "segments_ok", "missing": [fp…],
        "corrupt": [{"fp", "issue"}…], "orphans", "clean"}``.  Damage is
        not fatal to the store — a corrupt segment self-heals on the next
        rescan — but fsck makes it visible *before* the crawl pays for
        the rescan."""
        report = {"segments_checked": 0, "segments_ok": 0,
                  "missing": [], "corrupt": [], "orphans": 0}
        with self._commit_lock():
            disk = self._disk_manifest_raw()
            referenced = disk.get("segments", [])
            fps = set()
            for s in referenced:
                fp = s.get("fp", "?")
                fps.add(fp)
                report["segments_checked"] += 1
                try:
                    with open(self._state_path(fp), "rb") as f:
                        data = f.read()
                except OSError:
                    report["missing"].append(fp)
                    continue
                issue = None
                if s.get("digest") and _digest(data) != s["digest"]:
                    issue = "file digest != manifest digest"
                else:
                    nl = data.find(b"\n")
                    parts = data[:nl].split(b" ") if nl >= 0 else []
                    if (len(parts) != 3 or parts[0] != self._HEADER_MAGIC
                            or parts[1].decode(errors="replace")
                            != _digest(data[nl + 1:])):
                        issue = "self-verifying header digest mismatch"
                if issue is None:
                    report["segments_ok"] += 1
                else:
                    report["corrupt"].append({"fp": fp, "issue": issue})
            try:
                names = os.listdir(self._seg_dir)
            except OSError:
                names = []
            report["orphans"] = sum(
                1 for n in names
                if n.endswith(".seg") and n[:-4] not in fps)
        report["clean"] = not report["missing"] and not report["corrupt"]
        return report

    @classmethod
    def verify_dir(cls, directory) -> dict:
        """``verify()`` without knowing the engine signature (the CLI
        fsck hook).  A path that never held a store is vacuously clean
        (``exists: False``) and, like ``compact_dir``, is **not**
        turned into one."""
        directory = os.fspath(directory)
        if not os.path.isdir(os.path.join(directory, "segments")):
            return {"segments_checked": 0, "segments_ok": 0,
                    "missing": [], "corrupt": [], "orphans": 0,
                    "clean": True, "exists": False}
        report = cls(directory, signature={}).verify()
        report["exists"] = True
        return report

    def _gc(self, live: set) -> None:
        """Remove state files not referenced by the manifest just written
        — except *fresh* ones (younger than ``GC_GRACE_SECONDS``), which
        may be a concurrent runner's frozen-but-uncommitted segments."""
        now = time.time()
        for name in os.listdir(self._seg_dir):
            fp = name[:-4] if name.endswith(".seg") else None
            if fp in live:
                continue
            path = os.path.join(self._seg_dir, name)
            try:
                if now - os.path.getmtime(path) < GC_GRACE_SECONDS:
                    continue
                os.remove(path)
            except OSError:
                pass

    # -- segment states --------------------------------------------------------
    # state file = one header line ("reprostore1 <payload digest>
    # <signature digest>\n") + the npz payload; the header makes the file
    # self-verifying so orphans (frozen before a crash, never committed to
    # a manifest) can be adopted safely
    _HEADER_MAGIC = b"reprostore1"

    def _state_path(self, fp: str) -> str:
        return os.path.join(self._seg_dir, fp + ".seg")

    def put_state(self, state: SegmentState) -> None:
        """Serialize one segment's state; atomic, digest recorded for the
        next ``commit``."""
        blob, offs = _pack_keys(state.keys)
        arrays = {
            "meta": np.asarray([state.n_bytes, state.n_triples], np.int64),
            "ids": np.asarray(state.ids, np.int64),
            "flags": np.asarray(state.flags, np.int32),
            "lengths": np.asarray(state.lengths, np.int64),
            "datatypes": np.asarray(state.datatypes, np.int32),
            "keys_blob": blob,
            "key_offsets": offs,
        }
        for i, c in enumerate(state.counts):
            arrays[f"counts_{i}"] = np.asarray(c, np.int64)
        for name, regs in state.regs.items():
            arrays[f"reg_{name}"] = np.asarray(regs, np.int32)
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        payload = buf.getvalue()
        header = b"%s %s %s\n" % (self._HEADER_MAGIC,
                                  _digest(payload).encode(),
                                  self._sig_digest.encode())
        data = header + payload
        self._atomic_write(self._state_path(state.fingerprint), data)
        self._pending[state.fingerprint] = _digest(data)

    def load_state(self, fp: str) -> Optional[SegmentState]:
        """Load + verify one segment's state; ``None`` on any failure
        (missing file, digest mismatch, wrong engine signature, malformed
        arrays) — the caller falls back to rescanning that segment.

        Verification is two-layer: the manifest's file digest when the
        fingerprint is committed, else the file's own header (orphan
        adoption after a crash between ``put_state`` and ``commit``)."""
        want = self._pending.get(fp) or self._digests.get(fp)
        try:
            with open(self._state_path(fp), "rb") as f:
                data = f.read()
            if want is not None:
                if _digest(data) != want:
                    return None
            nl = data.find(b"\n")
            if nl < 0:
                return None
            parts = data[:nl].split(b" ")
            payload = data[nl + 1:]
            if (len(parts) != 3 or parts[0] != self._HEADER_MAGIC
                    or parts[1].decode() != _digest(payload)
                    or parts[2].decode() != self._sig_digest):
                return None
            if want is None:
                # verified orphan: make it committable this run
                self._pending.setdefault(fp, _digest(data))
            with np.load(io.BytesIO(payload)) as z:
                meta = z["meta"]
                counts = []
                while f"counts_{len(counts)}" in z:
                    counts.append(z[f"counts_{len(counts)}"])
                regs = {k[4:]: z[k] for k in z.files if k.startswith("reg_")}
                return SegmentState(
                    fingerprint=fp,
                    n_bytes=int(meta[0]), n_triples=int(meta[1]),
                    counts=counts, regs=regs,
                    keys=_unpack_keys(z["keys_blob"], z["key_offsets"]),
                    flags=z["flags"], lengths=z["lengths"],
                    datatypes=z["datatypes"], ids=z["ids"])
        except (OSError, ValueError, KeyError, zipfile.BadZipFile):
            return None

    # -- history ---------------------------------------------------------------
    def append_history(self, entry: dict, *, max_history: int = 0) -> None:
        """Append one quality snapshot.  ``max_history > 0`` bounds the
        file: after the append, only the newest ``max_history`` snapshots
        remain (oldest dropped by an atomic rewrite) — fleet crawls
        append one snapshot per dataset per crawl, so unbounded growth is
        a real cost at catalog scale.  Retention runs under the commit
        flock so two retained appenders never lose each other's line; a
        plain append (``max_history=0``) stays lock-free as before."""
        if max_history <= 0:
            with open(self.history_path, "a") as f:
                f.write(json.dumps(entry, sort_keys=True) + "\n")
            return
        with self._commit_lock():
            lines = []
            try:
                with open(self.history_path) as f:
                    lines = [ln for ln in f.read().splitlines()
                             if ln.strip()]
            except OSError:
                pass
            lines.append(json.dumps(entry, sort_keys=True))
            self._atomic_write(self.history_path,
                               ("\n".join(lines[-max_history:]) + "\n"
                                ).encode())

    def _truncate_history_locked(self, max_history: int) -> int:
        """Drop all but the newest ``max_history`` snapshots (atomic
        rewrite).  Caller must hold ``_commit_lock``.  Returns the number
        of snapshots dropped."""
        try:
            with open(self.history_path) as f:
                lines = [ln for ln in f.read().splitlines() if ln.strip()]
        except OSError:
            return 0
        if len(lines) <= max_history:
            return 0
        keep = lines[-max_history:]
        self._atomic_write(self.history_path,
                           ("\n".join(keep) + "\n").encode())
        return len(lines) - len(keep)

    def history(self) -> list[dict]:
        from ..core import report
        return report.load_history(self.history_path)
