"""Catalog discovery: turn a catalog *source* into named dataset refs.

The paper's motivation is 10,000+ public Linked Data datasets; a crawl
has to start from some description of where they live.  Four source
shapes are accepted, chosen by inspection:

* a **directory tree** — every ``*.nt`` file below it is one dataset,
  named by its root-relative path (``shops/berlin.nt`` →
  ``shops__berlin``);
* a **glob pattern** (the string contains ``*``/``?``/``[``) — every
  match is one dataset, named by its basename;
* a **JSON manifest** (an existing ``*.json`` path) — either a plain
  mapping ``{"name": "path-or-url", ...}``, a ``{"datasets": [{"name",
  "path"}, ...]}`` list, or a DCAT-style document (``{"dataset":
  [{"title"|"identifier", "distribution": [{"downloadURL"|
  "accessURL"}]}]}`` — the shape of data.gov-style catalog dumps).
  Relative paths resolve against the manifest's own directory;
* a **remote manifest URL** (``http(s)://…``) — the manifest itself is
  fetched through the caller-supplied ``fetcher`` and parsed like a
  local one, with relative distribution URLs resolved against the
  manifest URL.

Distributions with ``http(s)://`` URLs become *remote* refs: ``url`` is
set, ``path`` stays empty until the crawl's fetch stage localizes the
bytes through the download cache.  A DCAT/SPDX checksum on the
distribution (``{"checksum": {"algorithm", "checksumValue"}}``, or a
flat ``"sha256": "<hex>"``) rides along on the ref and is verified by
the fetcher before assessment.

Names are sanitized into the same path-safe charset the service registry
enforces (``[A-Za-z0-9][A-Za-z0-9._-]*``, max 64 chars) because each
dataset gets a directory under the catalog root.  Two refs collapsing to
one name is a configuration error, not a tie to break silently —
``CatalogError`` names both sources.

Discovery never touches dataset *content*: a ref whose path is missing
or unreadable (or whose origin is down) is still discovered, and the
crawl records the failure in its summary while the rest of the fleet
proceeds.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
import re
import urllib.parse
from typing import Iterable, Optional, Tuple, Union

_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")
_UNSAFE_RE = re.compile(r"[^A-Za-z0-9._-]")


class CatalogError(ValueError):
    """Invalid catalog source (bad manifest, duplicate dataset names)."""


@dataclasses.dataclass(frozen=True)
class DatasetRef:
    """One discovered dataset: a registry-safe name plus where its bytes
    live — a local ``path``, or a remote ``url`` the crawl's fetch stage
    localizes first (existence is checked at crawl time, not here).
    ``checksum`` is an optional manifest-declared ``(algorithm, hex)``
    pair verified on download."""
    name: str
    path: str
    url: Optional[str] = None
    checksum: Optional[Tuple[str, str]] = None

    @property
    def remote(self) -> bool:
        return self.url is not None


def is_url(s: str) -> bool:
    return isinstance(s, str) and s.startswith(("http://", "https://"))


def dataset_name(raw: str) -> str:
    """Sanitize an arbitrary label into the registry-safe charset: path
    separators become ``__``, anything else unsafe becomes ``_``, and
    the result is clipped to 64 chars with an alphanumeric head.
    Compression and N-Triples suffixes are dropped (``d0.nt.gz`` and
    ``d0.nt`` are the same dataset)."""
    base = raw
    if is_url(base):
        base = urllib.parse.unquote(
            urllib.parse.urlsplit(base).path).lstrip("/") or base
    if base.endswith(".gz"):
        base = base[:-3]
    if base.endswith(".nt"):
        base = base[:-3]
    base = base.replace("/", "__").replace(os.sep, "__")
    base = _UNSAFE_RE.sub("_", base).lstrip("._-")
    base = base[:64] or "dataset"
    if not _NAME_RE.match(base):
        base = ("d" + base)[:64]
    return base


def _check_unique(refs: list[DatasetRef]) -> list[DatasetRef]:
    seen: dict[str, str] = {}
    for ref in refs:
        src = ref.url or ref.path
        if ref.name in seen:
            raise CatalogError(
                f"duplicate dataset name {ref.name!r}: both "
                f"{seen[ref.name]!r} and {src!r} map to it — rename "
                "one source or give explicit manifest names")
        seen[ref.name] = src
    return refs


def _from_tree(root: str, pattern: str) -> list[DatasetRef]:
    refs = []
    for base, _dirs, files in sorted(os.walk(root)):
        for fn in sorted(files):
            path = os.path.join(base, fn)
            if glob.fnmatch.fnmatch(fn, pattern):
                rel = os.path.relpath(path, root)
                refs.append(DatasetRef(dataset_name(rel),
                                       os.path.abspath(path)))
    return refs


def _from_glob(pattern: str) -> list[DatasetRef]:
    return [DatasetRef(dataset_name(os.path.basename(p)),
                       os.path.abspath(p))
            for p in sorted(glob.glob(pattern, recursive=True))]


def _entry_checksum(entry: dict) -> Optional[Tuple[str, str]]:
    """A manifest-declared checksum: DCAT/SPDX ``{"checksum":
    {"algorithm", "checksumValue"}}`` (the algorithm may be a full SPDX
    URI like ``…#checksumAlgorithm_sha256``) or a flat ``"sha256"``
    field."""
    ck = entry.get("checksum")
    if isinstance(ck, dict):
        algo = str(ck.get("algorithm") or "")
        value = ck.get("checksumValue") or ck.get("value")
        if algo and value:
            algo = algo.rsplit("_", 1)[-1].rsplit("#", 1)[-1]
            return (algo.lower(), str(value).lower())
    for algo in ("sha256", "sha512", "sha1", "md5"):
        if isinstance(entry.get(algo), str):
            return (algo, entry[algo].lower())
    return None


def _dist_location(entry: dict, base_dir: Optional[str],
                   base_url: Optional[str]):
    """Where a manifest entry's bytes live: ``(path, url, checksum)``.
    An explicit ``path`` wins; otherwise the first usable DCAT
    distribution — ``http(s)`` URLs stay remote, ``file://`` and bare
    paths resolve locally.  In a *remote* manifest relative references
    resolve against the manifest URL instead of a directory."""

    def resolve(ref: str):
        if is_url(ref):
            return None, ref
        if ref.startswith("file://"):
            ref = ref[len("file://"):]
        elif base_url is not None:
            # a relative reference inside a fetched manifest is relative
            # to the manifest's own URL, not to any local directory
            return None, urllib.parse.urljoin(base_url, ref)
        if not os.path.isabs(ref) and base_dir is not None:
            ref = os.path.join(base_dir, ref)
        return os.path.abspath(ref), None

    path = entry.get("path")
    if path is not None:
        p, u = resolve(path)
        return p, u, _entry_checksum(entry)
    for dist in entry.get("distribution") or []:
        ref = dist.get("downloadURL") or dist.get("accessURL")
        if not ref:
            continue
        p, u = resolve(ref)
        return p, u, _entry_checksum(dist) or _entry_checksum(entry)
    return None, None, None


def _parse_manifest(doc, label: str, base_dir: Optional[str],
                    base_url: Optional[str]) -> list[DatasetRef]:
    if isinstance(doc, dict) and ("datasets" in doc or "dataset" in doc):
        entries = doc.get("datasets") or doc.get("dataset") or []
        if not isinstance(entries, list):
            raise CatalogError(
                f"manifest {label!r}: 'datasets' must be a list")
        refs = []
        for i, e in enumerate(entries):
            if not isinstance(e, dict):
                raise CatalogError(
                    f"manifest {label!r}: entry {i} is not an object")
            raw = e.get("name") or e.get("title") or e.get("identifier")
            p, u, ck = _dist_location(e, base_dir, base_url)
            if not raw or not (p or u):
                raise CatalogError(
                    f"manifest {label!r}: entry {i} needs a name/title "
                    "and a path/distribution")
            refs.append(DatasetRef(dataset_name(str(raw)), p or "",
                                   url=u, checksum=ck))
        return refs
    if isinstance(doc, dict):
        # plain mapping name -> path-or-url
        refs = []
        for raw, p in sorted(doc.items()):
            if not isinstance(p, str):
                raise CatalogError(
                    f"manifest {label!r}: value for {raw!r} must be a "
                    "path or URL string")
            if is_url(p):
                refs.append(DatasetRef(dataset_name(str(raw)), "", url=p))
                continue
            if base_url is not None:
                refs.append(DatasetRef(
                    dataset_name(str(raw)), "",
                    url=urllib.parse.urljoin(base_url, p)))
                continue
            if not os.path.isabs(p):
                p = os.path.join(base_dir or ".", p)
            refs.append(DatasetRef(dataset_name(str(raw)),
                                   os.path.abspath(p)))
        return refs
    raise CatalogError(
        f"manifest {label!r}: expected an object (name->path mapping, "
        "'datasets' list, or DCAT 'dataset' list)")


def _from_manifest(path: str) -> list[DatasetRef]:
    base_dir = os.path.dirname(os.path.abspath(path))
    try:
        with open(path) as f:
            doc = json.load(f)
    except ValueError as e:
        raise CatalogError(f"manifest {path!r} is not valid JSON: {e}"
                           ) from None
    return _parse_manifest(doc, path, base_dir, None)


def _from_remote_manifest(url: str, fetcher) -> list[DatasetRef]:
    if fetcher is None:
        raise CatalogError(
            f"catalog source {url!r} is a remote manifest: pass a "
            "fetcher (crawl_catalog does this when cache_dir/fetch "
            "options are set, and by default)")
    result = fetcher.fetch(url)
    try:
        with open(result.path, "rb") as f:
            doc = json.loads(f.read().decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        raise CatalogError(
            f"remote manifest {url!r} is not valid JSON: {e}") from None
    return _parse_manifest(doc, url, None, url)


def discover(source: Union[str, os.PathLike], pattern: str = "*.nt",
             fetcher=None) -> list[DatasetRef]:
    """Resolve a catalog source into a deterministic, duplicate-free
    list of ``DatasetRef``s (sorted walk/glob order; manifest order for
    list manifests).  A ``http(s)://`` source is a remote manifest,
    fetched through ``fetcher``.  An empty catalog is a valid catalog:
    the crawl simply has nothing to do."""
    source = os.fspath(source)
    if is_url(source):
        return _check_unique(_from_remote_manifest(source, fetcher))
    if os.path.isdir(source):
        return _check_unique(_from_tree(source, pattern))
    if os.path.isfile(source) and source.endswith(".json"):
        return _check_unique(_from_manifest(source))
    if any(c in source for c in "*?["):
        return _check_unique(_from_glob(source))
    raise CatalogError(
        f"catalog source {source!r} is neither a directory, a .json "
        "manifest, a glob pattern, nor a manifest URL")


def names(refs: Iterable[DatasetRef]) -> list[str]:
    return [r.name for r in refs]
