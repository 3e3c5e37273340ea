"""hll kernel package: one HyperLogLog sketch's register fold."""
from .ops import hll_fold  # noqa: F401
from .ref import hll_fold_torch  # noqa: F401
