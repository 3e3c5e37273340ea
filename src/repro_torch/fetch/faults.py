"""Fault injection for the fetch plane: a flaky in-process HTTP origin.

Mirrors ``serve.faults.ServiceFaultInjector``: tests declare a fault
schedule up front, the server consumes it request by request, and the
request log makes "the client never touched the network" assertable.

``HttpFaultInjector`` fields are keyed by URL *path* (e.g. ``"/d0.nt"``):

* ``fail_requests``  — path → N: first N GETs answer 503 (+ Retry-After);
* ``drop_connections`` — path → N: first N GETs close the socket without
  sending a single byte (connection reset from the client's view);
* ``truncate_bodies`` — path → N: first N GETs declare the full
  Content-Length, send roughly half the body, then close mid-stream
  (the client sees ``http.client.IncompleteRead`` and must Range-resume);
* ``corrupt_bodies`` — path → N: first N GETs serve a body of the right
  length with flipped bytes (only a checksum can catch this);
* ``wrong_etag`` — paths whose ETag changes on every response, so an
  ``If-None-Match`` revalidation can never 304;
* ``down`` — a *mutable* set of paths treated as unreachable (every
  request dropped) — add ``"*"`` to take the whole origin down
  mid-test, discard it to bring the origin back.

``FlakyOriginServer`` is an otherwise-honest static file server over a
directory: strong ``ETag`` (content digest), ``Last-Modified``,
``If-None-Match``/``If-Modified-Since`` → 304, and single-range
``Range: bytes=N-`` → 206 with ``Content-Range`` (``If-Range`` honored).
Every request is appended to ``server.requests`` as
``(method, path, status)`` — a dropped connection logs status ``0``.
"""
from __future__ import annotations

import dataclasses
import email.utils
import hashlib
import http.server
import os
import threading
import urllib.parse
from typing import Dict, MutableSet, Optional, Tuple


@dataclasses.dataclass
class HttpFaultInjector:
    """Declarative per-path fault schedule, consumed as requests arrive."""
    fail_requests: Dict[str, int] = dataclasses.field(default_factory=dict)
    drop_connections: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    truncate_bodies: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    corrupt_bodies: Dict[str, int] = dataclasses.field(default_factory=dict)
    wrong_etag: MutableSet[str] = dataclasses.field(default_factory=set)
    down: MutableSet[str] = dataclasses.field(default_factory=set)
    retry_after: float = 0.0       # Retry-After on injected 503s

    def __post_init__(self):
        self._lock = threading.Lock()
        self._etag_serial = 0

    def _consume(self, table: Dict[str, int], path: str) -> bool:
        with self._lock:
            n = table.get(path, 0)
            if n <= 0:
                return False
            table[path] = n - 1
            return True

    def is_down(self, path: str) -> bool:
        with self._lock:
            return "*" in self.down or path in self.down

    def take_fail(self, path: str) -> bool:
        return self._consume(self.fail_requests, path)

    def take_drop(self, path: str) -> bool:
        return self._consume(self.drop_connections, path)

    def take_truncate(self, path: str) -> bool:
        return self._consume(self.truncate_bodies, path)

    def take_corrupt(self, path: str) -> bool:
        return self._consume(self.corrupt_bodies, path)

    def etag_for(self, path: str, honest: str) -> str:
        with self._lock:
            if path not in self.wrong_etag:
                return honest
            self._etag_serial += 1
            return f'"bogus-{self._etag_serial}"'


class FlakyOriginServer:
    """In-process ``ThreadingHTTPServer`` file origin with fault hooks."""

    def __init__(self, root_dir, faults: Optional[HttpFaultInjector] = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.root = os.path.abspath(os.fspath(root_dir))
        self.faults = faults or HttpFaultInjector()
        self.requests: list = []       # (method, path, status)
        self._req_lock = threading.Lock()
        origin = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):      # noqa: D102 — silence stderr
                pass

            def _log(self, status: int) -> None:
                with origin._req_lock:
                    origin.requests.append(
                        ("GET", urllib.parse.urlsplit(self.path).path,
                         status))

            def _drop(self) -> None:
                self._log(0)
                try:
                    self.connection.close()
                except OSError:
                    pass
                self.close_connection = True

            def do_GET(self):               # noqa: N802 — http.server API
                path = urllib.parse.unquote(
                    urllib.parse.urlsplit(self.path).path)
                inj = origin.faults
                if inj.is_down(path) or inj.take_drop(path):
                    self._drop()
                    return
                if inj.take_fail(path):
                    self._log(503)
                    self.send_response(503)
                    if inj.retry_after:
                        self.send_header("Retry-After",
                                         str(inj.retry_after))
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                local = origin._resolve(path)
                if local is None:
                    self._log(404)
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                with open(local, "rb") as f:
                    body = f.read()
                honest_etag = '"' + hashlib.blake2b(
                    body, digest_size=16).hexdigest() + '"'
                etag = inj.etag_for(path, honest_etag)
                mtime = os.path.getmtime(local)
                last_mod = email.utils.formatdate(mtime, usegmt=True)

                inm = self.headers.get("If-None-Match")
                if inm is not None and inm == etag:
                    self._log(304)
                    self.send_response(304)
                    self.send_header("ETag", etag)
                    self.end_headers()
                    return

                status, start = 200, 0
                rng = self._range(len(body))
                if rng is not None:
                    if_range = self.headers.get("If-Range")
                    if if_range is None or if_range == etag:
                        status, start = 206, rng

                if inj.take_corrupt(path):
                    # same length, different bytes — only a checksum
                    # (or the honest ETag changing) can tell
                    body = bytes(b ^ 0xFF for b in body[:64]) + body[64:]

                payload = body[start:]
                self._log(status)
                self.send_response(status)
                self.send_header("ETag", etag)
                self.send_header("Last-Modified", last_mod)
                self.send_header("Content-Length", str(len(payload)))
                if status == 206:
                    self.send_header(
                        "Content-Range",
                        f"bytes {start}-{len(body) - 1}/{len(body)}")
                self.end_headers()
                if inj.take_truncate(path):
                    self.wfile.write(payload[:max(1, len(payload) // 2)])
                    self.wfile.flush()
                    try:
                        self.connection.close()
                    except OSError:
                        pass
                    self.close_connection = True
                    return
                self.wfile.write(payload)

            def _range(self, size: int) -> Optional[int]:
                """Start offset of a ``bytes=N-`` range, else ``None``."""
                header = self.headers.get("Range")
                if not header or not header.startswith("bytes="):
                    return None
                spec = header[len("bytes="):].split(",")[0].strip()
                if not spec.endswith("-") or not spec[:-1].isdigit():
                    return None
                start = int(spec[:-1])
                return start if 0 < start < size or start == 0 else None

        self._httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.url = f"http://{host}:{self._httpd.server_address[1]}"
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="flaky-origin",
            daemon=True)
        self._started = False

    def _resolve(self, path: str) -> Optional[str]:
        rel = os.path.normpath(path.lstrip("/"))
        if rel.startswith("..") or os.path.isabs(rel):
            return None
        local = os.path.join(self.root, rel)
        return local if os.path.isfile(local) else None

    def url_for(self, name: str) -> str:
        return f"{self.url}/{urllib.parse.quote(name)}"

    def request_log(self, path: Optional[str] = None) -> list:
        """Snapshot of ``(method, path, status)`` triples, optionally
        filtered to one path."""
        with self._req_lock:
            log = list(self.requests)
        return [r for r in log if path is None or r[1] == path]

    def start(self) -> "FlakyOriginServer":
        if not self._started:
            self._thread.start()
            self._started = True
        return self

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()

    def __enter__(self) -> "FlakyOriginServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()
