"""repro_torch.catalog — fleet-scale assessment of whole dataset catalogs.

The paper motivates the framework with the size of public Linked Data
catalogs (10,000+ datasets); ``repro_torch.qa`` assesses one dataset,
``repro_torch.serve`` serves many on demand, and this package closes the loop:
point a *crawl* at a catalog source and every dataset is assessed
incrementally into its own segment store, in parallel, with per-dataset
failure isolation::

    from repro_torch import catalog
    summary = catalog.crawl_catalog("datasets/", "catroot/", workers=4)
    ranking = catalog.rank_catalog("catroot/")
    report  = catalog.report_catalog("catroot/",
                                     rules=["delta(no_bogus_uris) < -0.05"])

Catalog sources (``catalog.discover``): a directory tree of ``.nt``
files, a glob pattern, a JSON manifest (plain name→path mapping, a
``datasets`` list, or DCAT-style ``dataset`` entries), or an
``http(s)://`` manifest URL.  Remote distributions are localized
through ``repro_torch.fetch`` — retry/backoff, ETag revalidation, Range
resume, checksum verification, stale-serve degradation — into a shared
download cache under the catalog root.

A warm re-crawl reuses each dataset's store, so only changed bytes are
rescanned anywhere in the fleet (an unchanged remote distribution is a
304: zero bytes fetched, zero bytes rescanned); rankings and regression
reports are derived purely from the per-store ``history.jsonl``
snapshots.  CLI: ``python -m repro_torch.launch.qa_catalog
crawl|rank|report|compact|fsck``.
"""
from .crawl import CACHE_DIRNAME, crawl_catalog, load_crawls, store_dir
from .discovery import (CatalogError, DatasetRef, dataset_name, discover,
                        is_url)
from .ranking import (load_catalog_histories, rank_catalog,
                      rank_histories, ranking_markdown)
from .regression import (regression_markdown, regression_report,
                         report_catalog)

__all__ = [
    "CatalogError", "DatasetRef", "dataset_name", "discover", "is_url",
    "crawl_catalog", "load_crawls", "store_dir", "CACHE_DIRNAME",
    "load_catalog_histories", "rank_catalog", "rank_histories",
    "ranking_markdown",
    "regression_report", "report_catalog", "regression_markdown",
]
