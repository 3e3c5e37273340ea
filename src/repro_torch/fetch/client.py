"""Robust HTTP(S) fetcher over the content-addressed cache.

Stdlib-only (``urllib`` / ``http.client``), matching the serve daemon's
zero-dep rule.  One ``Fetcher`` is shared by all crawl workers; its job
is to turn a flaky origin into a boring local file:

* **timeouts** on every request (connect + read);
* **retry with exponential backoff** on transient failures — 5xx, 429,
  408, timeouts, connection resets — classified through the exception
  taxonomy ``serve.jobs.default_transient`` already understands
  (``TransientFetchError`` subclasses ``TransientJobError``; permanent
  failures are deliberately *not* ``OSError``, because urllib's
  ``HTTPError ⊂ URLError ⊂ OSError`` would otherwise make a 404 look
  like flaky I/O).  Backoff is ``retry_base × 2^(attempt-1)`` scaled by
  a deterministic per-(url, attempt) jitter in [0.5, 1.5) — the job
  queue's formula — and floored by any server ``Retry-After``;
* **per-host circuit breakers**: consecutive failed fetches against one
  host open its breaker (cool-down doubling per trip, one half-open
  probe), so a dead mirror is failed fast instead of burning
  ``max_attempts × timeout`` per dataset;
* **a per-host concurrency cap** so a parallel crawl cannot dogpile one
  origin;
* **conditional revalidation**: a cached entry re-fetches with
  ``If-None-Match`` / ``If-Modified-Since``; a 304 costs zero body bytes
  and leaves the cached file untouched (the downstream incremental
  store stays fully warm);
* **resumable downloads**: a body torn mid-stream keeps its partial
  bytes and the next attempt asks for ``Range: bytes=<n>-``; a 206
  appends (``If-Range`` guards against the resource changing under us),
  anything else restarts cleanly;
* **checksum verification**: a manifest-declared digest is verified
  before the payload is committed to the cache — a mismatch is a
  *permanent* failure (re-downloading corrupt bytes will not fix them)
  and the previous good entry, if any, is preserved;
* **graceful degradation**: when every attempt fails (or the host's
  breaker is open) but a cached copy exists, it is served **stale** —
  flagged on the result and counted in
  ``repro_fetch_stale_served_total`` — so one dead origin degrades one
  dataset's freshness instead of failing the crawl.

``offline=True`` never touches the network: cached entries are served
as-is and anything uncached raises.  ``refresh=True`` skips conditional
headers and forces a full re-download.
"""
from __future__ import annotations

import dataclasses
import hashlib
import http.client
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Callable, Optional, Tuple

from ..serve.jobs import TransientJobError
from .cache import FetchCache

_CHUNK = 1 << 16


class FetchError(RuntimeError):
    """Base class for fetch failures (never ``OSError`` — see module
    docstring for why the distinction is load-bearing)."""


class TransientFetchError(FetchError, TransientJobError):
    """A fetch failure worth retrying (5xx, timeout, torn connection).
    Subclasses ``TransientJobError`` so the crawl/job layer's
    ``default_transient`` classifier needs no special cases."""

    retry_after: float = 0.0       # server-suggested backoff floor
    attempts: int = 0              # attempts made when finally raised


class PermanentFetchError(FetchError):
    """A fetch failure retrying cannot fix (404, checksum mismatch,
    offline miss)."""


class ChecksumMismatch(PermanentFetchError):
    """Downloaded bytes do not match the manifest-declared checksum."""


class HostQuarantined(TransientFetchError):
    """The host's circuit breaker is open; the fetch was failed fast."""


@dataclasses.dataclass
class FetchResult:
    """Outcome of one ``fetch()``: where the bytes are and how they got
    there.  ``path`` always names a readable local file."""
    url: str
    path: str
    status: str                    # fetched | revalidated | stale | offline
    stale: bool = False            # origin unreachable; cached copy served
    bytes_fetched: int = 0         # body bytes actually transferred
    attempts: int = 0              # network attempts made (0 = no network)
    not_modified: bool = False     # revalidated via 304
    resumed: bool = False          # a torn download was completed via Range
    digest: Optional[str] = None   # content digest of the served bytes
    error: Optional[str] = None    # the failure a stale serve papered over

    def to_dict(self) -> dict:
        return {"url": self.url, "status": self.status, "stale": self.stale,
                "bytes_fetched": self.bytes_fetched,
                "attempts": self.attempts,
                "not_modified": self.not_modified, "resumed": self.resumed,
                "error": self.error}


@dataclasses.dataclass
class _HostBreaker:
    """Per-host circuit-breaker state (guarded by the fetcher lock)."""
    failures: int = 0
    open_until: float = 0.0
    probing: bool = False
    trips: int = 0


class _Torn(TransientFetchError):
    """A body torn mid-stream; ``partial`` holds the bytes read so far
    so the next attempt can Range-resume from that offset."""

    def __init__(self, message: str, partial: bytearray):
        super().__init__(message)
        self.partial = partial


def verify_checksum(data: bytes, checksum: Tuple[str, str]) -> None:
    """Raise ``ChecksumMismatch`` unless ``data`` hashes to the declared
    ``(algorithm, hexdigest)``.  Unknown algorithms are a permanent
    configuration error, not something retry can fix."""
    algo, want = checksum[0].lower(), checksum[1].lower()
    try:
        got = hashlib.new(algo, data).hexdigest()
    except ValueError as e:
        raise PermanentFetchError(
            f"unknown checksum algorithm {algo!r}") from e
    if got != want:
        raise ChecksumMismatch(
            f"checksum mismatch ({algo}): manifest declares {want}, "
            f"downloaded bytes hash to {got}")


class Fetcher:
    """Shared, thread-safe HTTP(S) fetch front end over a ``FetchCache``."""

    def __init__(self, cache_dir, *, timeout: float = 10.0,
                 max_attempts: int = 3, retry_base: float = 0.2,
                 retry_cap: float = 30.0, breaker_threshold: int = 3,
                 breaker_cooldown: float = 30.0, max_per_host: int = 4,
                 offline: bool = False, refresh: bool = False,
                 metrics=None, user_agent: str = "repro-qa-fetch/1",
                 sleep: Callable[[float], None] = time.sleep):
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got "
                             f"{max_attempts}")
        self.cache = FetchCache(cache_dir)
        self.timeout = timeout
        self.max_attempts = max_attempts
        self.retry_base = retry_base
        self.retry_cap = retry_cap
        self.breaker_threshold = breaker_threshold   # 0 = breaker off
        self.breaker_cooldown = breaker_cooldown
        self.offline = offline
        self.refresh = refresh
        self.metrics = metrics
        self.user_agent = user_agent
        self._sleep = sleep
        self._lock = threading.Lock()
        self._breakers: dict[str, _HostBreaker] = {}
        self._sems: dict[str, threading.BoundedSemaphore] = {}
        self._max_per_host = max(1, max_per_host)

    # -- metrics ----------------------------------------------------------------
    def _inc(self, name: str, amount: float = 1.0, **labels) -> None:
        if self.metrics is not None:
            self.metrics.inc(name, amount, **labels)

    # -- per-host machinery -----------------------------------------------------
    @staticmethod
    def _host(url: str) -> str:
        return urllib.parse.urlsplit(url).netloc or "?"

    def _semaphore(self, host: str) -> threading.BoundedSemaphore:
        with self._lock:
            sem = self._sems.get(host)
            if sem is None:
                sem = self._sems[host] = threading.BoundedSemaphore(
                    self._max_per_host)
            return sem

    def _breaker_check(self, host: str) -> None:
        """Fail fast while ``host``'s breaker is open; admit exactly one
        half-open probe once the cool-down passes."""
        if not self.breaker_threshold:
            return
        with self._lock:
            b = self._breakers.get(host)
            if b is None or not b.open_until:
                return
            now = time.time()
            if b.open_until > now:
                exc = HostQuarantined(
                    f"host {host!r} is quarantined after consecutive "
                    f"fetch failures; cool-down ends in "
                    f"{b.open_until - now:.1f}s")
                exc.retry_after = b.open_until - now
                raise exc
            if b.probing:
                exc = HostQuarantined(
                    f"host {host!r} is quarantined; a cool-down probe is "
                    "already in flight")
                exc.retry_after = max(1.0, self.breaker_cooldown / 4)
                raise exc
            b.probing = True

    def _breaker_record(self, host: str, ok: bool) -> None:
        """Fold one terminal fetch outcome into the host's breaker."""
        if not self.breaker_threshold:
            return
        with self._lock:
            if ok:
                self._breakers.pop(host, None)
                return
            b = self._breakers.setdefault(host, _HostBreaker())
            b.failures += 1
            if b.probing or b.failures >= self.breaker_threshold:
                cool = self.breaker_cooldown * (2 ** min(b.trips, 5))
                b.open_until = time.time() + cool
                b.trips += 1
                b.failures = 0
                b.probing = False
                self._inc("repro_fetch_breaker_open_total", host=host)

    def breaker_state(self, url_or_host: str) -> dict:
        """Display-only breaker snapshot (mirrors the job queue's)."""
        host = (self._host(url_or_host) if "//" in url_or_host
                else url_or_host)
        with self._lock:
            b = self._breakers.get(host)
            if not self.breaker_threshold or b is None:
                return {"state": "closed", "consecutive_failures":
                        b.failures if b else 0}
            now = time.time()
            state = ("open" if b.open_until > now
                     else "half-open" if b.open_until else "closed")
            return {"state": state, "consecutive_failures": b.failures,
                    "open_until": b.open_until or None, "trips": b.trips}

    # -- backoff ----------------------------------------------------------------
    def _retry_delay(self, url: str, attempt: int,
                     retry_after: float) -> float:
        """Job-queue backoff formula keyed on (url, attempt) instead of a
        job id, floored by any server-supplied ``Retry-After``."""
        seed = int(FetchCache.key(url)[:8], 16) + attempt
        jitter = 0.5 + ((seed * 2654435761) & 1023) / 1024.0
        delay = self.retry_base * (2 ** (attempt - 1)) * jitter
        return min(self.retry_cap, max(delay, retry_after))

    # -- public API -------------------------------------------------------------
    def fetch(self, url: str,
              checksum: Optional[Tuple[str, str]] = None) -> FetchResult:
        """Make ``url``'s bytes available locally; returns a
        ``FetchResult`` whose ``path`` is readable.  Raises
        ``PermanentFetchError`` (bad resource / checksum / offline miss)
        or ``TransientFetchError`` (attempts exhausted, nothing cached)."""
        self._inc("repro_fetch_requests_total")
        cached = self.cache.load(url)
        if self.offline:
            if cached is None:
                raise PermanentFetchError(
                    f"offline mode and {url} is not cached")
            return FetchResult(url=url, path=self.cache.data_path(url),
                               status="offline", digest=cached["digest"])

        host = self._host(url)
        with self._semaphore(host):
            try:
                self._breaker_check(host)
                result = self._fetch_with_retries(url, cached, checksum)
            except TransientFetchError as e:
                # quarantined host or exhausted retries: degrade to the
                # cached copy when one exists; only never-fetched URLs fail
                if not isinstance(e, HostQuarantined):
                    self._breaker_record(host, ok=False)
                if cached is not None:
                    self._inc("repro_fetch_stale_served_total", host=host)
                    return FetchResult(
                        url=url, path=self.cache.data_path(url),
                        status="stale", stale=True, attempts=e.attempts,
                        digest=cached["digest"],
                        error=f"{type(e).__name__}: {e}")
                self._inc("repro_fetch_failures_total", host=host)
                raise
            except PermanentFetchError:
                self._inc("repro_fetch_failures_total", host=host)
                raise
            self._breaker_record(host, ok=True)
            return result

    # -- internals --------------------------------------------------------------
    def _fetch_with_retries(self, url: str, cached: Optional[dict],
                            checksum) -> FetchResult:
        partial = bytearray()          # body bytes from torn attempts
        partial_etag: Optional[str] = None
        resumed = False
        last: Optional[TransientFetchError] = None
        for attempt in range(1, self.max_attempts + 1):
            self._inc("repro_fetch_attempts_total")
            try:
                result = self._attempt(url, cached, checksum,
                                       partial, partial_etag)
                result.attempts = attempt
                result.resumed = result.resumed or resumed
                return result
            except _Torn as e:
                partial = e.partial
                partial_etag = getattr(e, "etag", partial_etag)
                resumed = True         # next attempt continues via Range
                last = e
            except TransientFetchError as e:
                partial.clear()        # connection-level failure: restart
                last = e
            if attempt < self.max_attempts:
                self._sleep(self._retry_delay(
                    url, attempt, getattr(last, "retry_after", 0.0)))
        last.attempts = self.max_attempts
        raise last

    def _attempt(self, url: str, cached, checksum, partial: bytearray,
                 partial_etag: Optional[str]) -> FetchResult:
        """One network attempt: returns a *fetched* or *revalidated*
        result, or raises a classified fetch error (``_Torn`` carries
        partial bytes for Range resumption)."""
        headers = {"User-Agent": self.user_agent}
        if partial:
            # Resume takes priority over revalidation: Range and
            # If-None-Match are never combined (a 304 has no body to
            # append).  If-Range makes a changed resource come back as a
            # full 200 instead of a mismatched 206.
            headers["Range"] = f"bytes={len(partial)}-"
            if partial_etag:
                headers["If-Range"] = partial_etag
        elif cached is not None and not self.refresh:
            if cached.get("etag"):
                headers["If-None-Match"] = cached["etag"]
            if cached.get("last_modified"):
                headers["If-Modified-Since"] = cached["last_modified"]
        req = urllib.request.Request(url, headers=headers)
        try:
            resp = urllib.request.urlopen(req, timeout=self.timeout)
        except urllib.error.HTTPError as e:
            if e.code == 304:
                meta = self.cache.touch_validated(url)
                if meta is None:       # cache vanished between load + 304
                    raise TransientFetchError(
                        f"{url}: 304 Not Modified but the cache entry "
                        "is gone") from e
                self._inc("repro_fetch_not_modified_total")
                return FetchResult(
                    url=url, path=self.cache.data_path(url),
                    status="revalidated", not_modified=True,
                    digest=meta["digest"])
            raise self._classify_http(url, e) from e
        except urllib.error.URLError as e:
            raise TransientFetchError(
                f"connection to {url} failed: {e.reason}") from e
        except (ConnectionError, TimeoutError, OSError) as e:
            raise TransientFetchError(
                f"connection to {url} failed: {e}") from e

        with resp:
            status = getattr(resp, "status", None) or resp.getcode()
            etag = resp.headers.get("ETag")
            last_modified = resp.headers.get("Last-Modified")
            if status == 206 and partial:
                buf, resumed = partial, True
            else:
                # the server ignored the Range (or If-Range invalidated
                # it): restart from byte zero
                buf, resumed = bytearray(), False
            self._read_body(url, resp, buf, etag)
        if resumed:
            self._inc("repro_fetch_resumed_total")
        data = bytes(buf)
        if checksum is not None:
            try:
                verify_checksum(data, checksum)
            except ChecksumMismatch:
                self._inc("repro_fetch_checksum_failures_total")
                raise
        self._inc("repro_fetch_bytes_fetched_total", float(len(data)))
        meta = self.cache.store(url, data, etag=etag,
                                last_modified=last_modified)
        return FetchResult(url=url, path=self.cache.data_path(url),
                           status="fetched", bytes_fetched=len(data),
                           resumed=resumed, digest=meta["digest"])

    def _read_body(self, url: str, resp, buf: bytearray,
                   etag: Optional[str]) -> None:
        """Append the response body to ``buf`` chunk-wise.  A body torn
        mid-stream raises ``_Torn`` carrying everything read so far."""
        start = len(buf)
        try:
            while True:
                chunk = resp.read(_CHUNK)
                if not chunk:
                    break
                buf.extend(chunk)
        except http.client.IncompleteRead as e:
            buf.extend(e.partial)
            exc = _Torn(f"body of {url} torn after {len(buf)} bytes "
                        "(connection closed mid-stream)", buf)
            exc.etag = etag
            raise exc from e
        except (ConnectionError, TimeoutError, OSError) as e:
            exc = _Torn(f"body of {url} torn after {len(buf)} bytes: {e}",
                        buf)
            exc.etag = etag
            raise exc from e
        # a short body under a declared Content-Length that http.client
        # did not flag (e.g. a will-close connection) is still torn
        want = resp.headers.get("Content-Length")
        if want is not None and len(buf) - start < int(want):
            exc = _Torn(f"body of {url} torn: got {len(buf) - start} of "
                        f"{want} bytes", buf)
            exc.etag = etag
            raise exc from None

    @staticmethod
    def _classify_http(url: str,
                       e: urllib.error.HTTPError) -> FetchError:
        """Map a non-304 HTTP error status onto the fetch taxonomy."""
        if e.code in (408, 425, 429) or e.code >= 500:
            exc = TransientFetchError(f"{url}: HTTP {e.code} {e.reason}")
            ra = e.headers.get("Retry-After") if e.headers else None
            if ra is not None:
                try:
                    exc.retry_after = float(ra)
                except ValueError:
                    pass
            return exc
        return PermanentFetchError(f"{url}: HTTP {e.code} {e.reason}")
