"""``repro_torch.fetch`` (the HTTP fetch/cache plane) against the JAX
package's ``repro.fetch``.

The plane carries no JAX: its modules are copies, held to the originals
below.  The same fault schedule driven through either package's flaky
origin and fetcher gives the same outcomes (status, attempts, bytes,
304s, Range resumes, stale serves, errors) and the same request log, and
one download cache serves both packages: what one fetched, the other
revalidates with a 304 and 0 bytes, and serves stale when the origin is
down.  Tolerance: exact (the outcomes are counts, flags and bytes).
"""
import hashlib
import os

import pytest

from repro import fetch as jfetch

from repro_torch import fetch as tfetch
from repro_torch.rdf import bsbm_ntriples

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
PACKAGES = {"jax": jfetch, "torch": tfetch}


def as_port(text: str) -> str:
    """A module of ``repro`` as the port carries it: only the package's
    name in docstrings and messages differs."""
    return (text.replace("repro.", "repro_torch.")
            .replace("from repro import", "from repro_torch import"))


@pytest.mark.parametrize("name", ["cache.py", "client.py", "faults.py",
                                  "__init__.py"])
def test_copied_modules_equal_the_originals(name):
    with open(os.path.join(SRC, "repro", "fetch", name)) as f:
        original = f.read()
    with open(os.path.join(SRC, "repro_torch", "fetch", name)) as f:
        assert f.read() == as_port(original)


def _put(root, name, data):
    if isinstance(data, str):
        data = data.encode()
    with open(os.path.join(root, name), "wb") as f:
        f.write(data)
    return data


def _scenario(pkg, which, tmp):
    """Run one fault schedule through ``pkg``'s origin and fetcher; the
    outcomes with the origin's address taken out, and the status codes
    the origin answered."""
    origin_dir = tmp / which / "origin"
    origin_dir.mkdir(parents=True)
    inj = pkg.HttpFaultInjector()
    data = _put(origin_dir, "d.nt", bsbm_ntriples(30, seed=3))
    outcomes = []
    with pkg.FlakyOriginServer(origin_dir, inj) as origin:
        url = origin.url_for("d.nt")

        def fetcher(**kw):
            kw.setdefault("retry_base", 0.01)
            return pkg.Fetcher(tmp / which / "cache", **kw)

        def record(fn):
            try:
                r = fn()
            except pkg.FetchError as e:
                outcomes.append({"raised": type(e).__name__,
                                 "message": str(e).replace(origin.url,
                                                           "ORIGIN")})
                return
            d = r.to_dict()
            d["url"] = d["url"].replace(origin.url, "ORIGIN")
            if d["error"]:
                d["error"] = d["error"].replace(origin.url, "ORIGIN")
            with open(r.path, "rb") as f:
                d["bytes_served"] = f.read()
            d["digest"] = r.digest
            outcomes.append(d)

        fe = fetcher()
        if which == "503-burst":
            inj.fail_requests["/d.nt"] = 2
        elif which == "torn":
            inj.truncate_bodies["/d.nt"] = 1
        elif which == "dropped":
            inj.drop_connections["/d.nt"] = 1
        elif which == "wrong-etag":
            inj.wrong_etag.add("/d.nt")
        record(lambda: fe.fetch(url))
        if which == "checksum":
            want = ("sha256", hashlib.sha256(data).hexdigest())
            inj.corrupt_bodies["/d.nt"] = 9
            record(lambda: fetcher(refresh=True).fetch(url, checksum=want))
        elif which == "stale":
            inj.down.add("*")
            record(lambda: fetcher(max_attempts=2).fetch(url))
        elif which == "offline":
            record(lambda: fetcher(offline=True).fetch(url))
            record(lambda: fetcher(offline=True).fetch(
                origin.url + "/never.nt"))
        else:
            record(lambda: fe.fetch(url))     # revalidate (or refetch)
        codes = [s for _, _, s in origin.request_log()]
    return outcomes, codes


@pytest.mark.parametrize("which", ["revalidate", "503-burst", "torn",
                                   "dropped", "wrong-etag", "checksum",
                                   "stale", "offline"])
def test_fault_schedules_give_the_jax_outcomes(tmp_path, which):
    got = {k: _scenario(pkg, which, tmp_path / k)
           for k, pkg in PACKAGES.items()}
    assert got["torch"] == got["jax"]
    outcomes, codes = got["torch"]
    assert outcomes[0]["status"] == "fetched"
    if which == "revalidate":
        assert outcomes[1]["not_modified"] and codes[-1] == 304
    if which == "torn":
        assert outcomes[0]["resumed"] and codes == [200, 206, 304]
    if which == "stale":
        assert outcomes[1]["stale"]


@pytest.mark.parametrize("first,second", [("jax", "torch"),
                                          ("torch", "jax")])
def test_one_cache_serves_both_packages(tmp_path, first, second):
    """What one package fetched, the other revalidates with a 304 and 0
    bytes from the same cache file, and serves stale when the origin is
    down; the cache layout and the user agent are the same."""
    origin_dir = tmp_path / "origin"
    origin_dir.mkdir()
    data = _put(origin_dir, "d.nt", bsbm_ntriples(40, seed=8))
    cache = tmp_path / "cache"
    inj = tfetch.HttpFaultInjector()
    with PACKAGES[first].FlakyOriginServer(origin_dir, inj) as origin:
        url = origin.url_for("d.nt")
        a = PACKAGES[first].Fetcher(cache, retry_base=0.01)
        b = PACKAGES[second].Fetcher(cache, retry_base=0.01,
                                     max_attempts=2)
        assert a.user_agent == b.user_agent
        assert a.cache.data_path(url) == b.cache.data_path(url)
        got = a.fetch(url)
        assert got.status == "fetched" and got.bytes_fetched == len(data)
        again = b.fetch(url)
        assert again.status == "revalidated" and again.not_modified
        assert again.bytes_fetched == 0
        assert again.path == got.path and again.digest == got.digest
        assert origin.request_log("/d.nt")[-1][2] == 304
        inj.down.add("*")
        stale = b.fetch(url)
        assert stale.status == "stale" and stale.stale
        with open(stale.path, "rb") as f:
            assert f.read() == data
