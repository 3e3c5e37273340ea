"""repro_torch.fetch — resilient HTTP(S) fetch/cache plane for remote catalogs.

A content-addressed download cache (``FetchCache``) fronted by a
retrying, revalidating, circuit-breaking client (``Fetcher``), plus the
flaky-origin test fixture (``FlakyOriginServer`` / ``HttpFaultInjector``)
that proves the robustness claims.  Stdlib-only by design — the same
zero-dep rule as ``repro_torch.serve``.
"""
from .cache import FetchCache, content_digest
from .client import (ChecksumMismatch, Fetcher, FetchError, FetchResult,
                     HostQuarantined, PermanentFetchError,
                     TransientFetchError, verify_checksum)
from .faults import FlakyOriginServer, HttpFaultInjector

__all__ = [
    "FetchCache", "content_digest",
    "Fetcher", "FetchResult", "FetchError", "TransientFetchError",
    "PermanentFetchError", "ChecksumMismatch", "HostQuarantined",
    "verify_checksum",
    "FlakyOriginServer", "HttpFaultInjector",
]
