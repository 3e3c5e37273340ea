"""qap_count kernel package."""
from . import ops, ref
