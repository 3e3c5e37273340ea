"""fused_scan kernel package."""
from .ops import fused_scan  # noqa: F401
from .ref import fused_scan_torch  # noqa: F401
