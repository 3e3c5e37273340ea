"""Content-addressed on-disk cache for fetched HTTP(S) payloads.

One cache directory is shared by every crawler pointing at it (the CLI,
the daemon's watcher, parallel crawl workers): entries are keyed by the
URL's digest, every write is a per-writer-unique temp file + ``os.replace``
(the segment store's atomic-write contract), and the commit of an entry's
``data``/``meta`` pair runs under the same advisory flock the store uses —
two workers fetching the same URL concurrently both land a complete,
self-consistent entry, never a torn one.

Layout::

    <dir>/
      .lock                  # advisory flock serializing entry commits
      <key>.data             # the payload bytes, exactly as fetched
      <key>.meta.json        # {"url", "etag", "last_modified", "size",
                             #  "digest", "fetched_at", "validated_at"}

The ``data`` file path is **stable per URL**, so downstream consumers that
diff by content (the incremental segment store) see the same local path
crawl after crawl — a 304 revalidation leaves the bytes untouched and the
whole store warm.

An entry is only served when its meta record parses AND the data file's
size matches the recorded size; the full content digest is stored for
explicit ``verify()`` (and for change detection by the daemon's watcher)
but is not re-hashed on every hit — the assessment layer reads and
fingerprints the bytes anyway.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import threading
import time
from typing import Optional

try:                     # POSIX advisory lock; released on process death
    import fcntl
except ImportError:      # non-POSIX: single-process caches only
    fcntl = None


def content_digest(data: bytes) -> str:
    """Digest used for cache change detection (blake2b-128, the same
    family the segment store fingerprints with)."""
    return hashlib.blake2b(data, digest_size=16).hexdigest()


class FetchCache:
    """URL-keyed payload cache with atomic, flock-serialized commits."""

    def __init__(self, directory):
        self.directory = os.path.abspath(os.fspath(directory))
        os.makedirs(self.directory, exist_ok=True)

    @staticmethod
    def key(url: str) -> str:
        return hashlib.blake2b(url.encode("utf-8"),
                               digest_size=16).hexdigest()

    def data_path(self, url: str) -> str:
        return os.path.join(self.directory, self.key(url) + ".data")

    def meta_path(self, url: str) -> str:
        return os.path.join(self.directory, self.key(url) + ".meta.json")

    @contextlib.contextmanager
    def _lock(self):
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

    def _atomic_write(self, path: str, data: bytes) -> None:
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

    # -- read ------------------------------------------------------------------
    def load(self, url: str) -> Optional[dict]:
        """The entry's meta record, or ``None`` when absent/torn/stale.
        A meta whose data file is missing or size-mismatched is treated
        as absent (a crash between the two writes, or manual damage)."""
        try:
            with open(self.meta_path(url)) as f:
                meta = json.load(f)
            if meta.get("url") != url:       # digest collision paranoia
                return None
            if os.path.getsize(self.data_path(url)) != meta.get("size"):
                return None
            return meta
        except (OSError, ValueError):
            return None

    # -- write -----------------------------------------------------------------
    def store(self, url: str, data: bytes, *, etag: Optional[str] = None,
              last_modified: Optional[str] = None) -> dict:
        """Commit one fetched payload (data first, then the meta record
        that references it — a crash in between leaves the previous entry
        governing, never a half entry)."""
        meta = {
            "url": url,
            "etag": etag,
            "last_modified": last_modified,
            "size": len(data),
            "digest": content_digest(data),
            "fetched_at": time.time(),
            "validated_at": time.time(),
        }
        with self._lock():
            self._atomic_write(self.data_path(url), data)
            self._atomic_write(self.meta_path(url),
                               json.dumps(meta, indent=2,
                                          sort_keys=True).encode())
        return meta

    def touch_validated(self, url: str) -> Optional[dict]:
        """Record a successful 304 revalidation (freshness bookkeeping
        only — the bytes are untouched)."""
        with self._lock():
            meta = self.load(url)
            if meta is None:
                return None
            meta["validated_at"] = time.time()
            self._atomic_write(self.meta_path(url),
                               json.dumps(meta, indent=2,
                                          sort_keys=True).encode())
            return meta

    def verify(self, url: str) -> bool:
        """Full content-digest check of a cached entry."""
        meta = self.load(url)
        if meta is None:
            return False
        try:
            with open(self.data_path(url), "rb") as f:
                return content_digest(f.read()) == meta.get("digest")
        except OSError:
            return False
