"""repro_torch.store — persistent mergeable segment store + incremental
planner.

Quality metrics are merges of partial aggregates (counter vectors and HLL
register banks, commutative monoid elements), so a changed dataset only
needs its *changed* segments rescanned.  This package persists
per-segment partial states content-addressed by segment fingerprint and
diffs a dataset's segments against the store:

* ``segmenter`` — content-defined, line-aligned segmentation (edit
  locality: a local edit invalidates O(1) segments); a copy of the JAX
  package's, so both packages cut the same bytes at the same places;
* ``store`` — on-disk format: manifest + ``segments/<fp>.seg`` states,
  digests at every boundary, atomic writes, an ``fcntl`` commit lock,
  corrupt/torn files degrade to a rescan of the affected segments only;
  a copy of the JAX package's, so either package reuses the other's
  store;
* ``runner`` — the incremental planner/executor; rescans run through the
  scan kernels on the card, and results are bit-identical (registers
  included) to a cold assessment of the same bytes.

Entry points: ``qa.pipeline().incremental(store_dir)`` /
``qa.assess(..., store=...)`` / ``python -m repro_torch.launch.assess
--store``.
"""
from .segmenter import (DEFAULT_TARGET_BYTES, fingerprint, iter_segments,
                        iter_segments_bytes, split_segments)
from .store import FORMAT_VERSION, SegmentState, SegmentStore
from .runner import assess_incremental, engine_signature

__all__ = [
    "DEFAULT_TARGET_BYTES", "fingerprint", "iter_segments",
    "iter_segments_bytes", "split_segments",
    "FORMAT_VERSION", "SegmentState", "SegmentStore",
    "assess_incremental", "engine_signature",
]
