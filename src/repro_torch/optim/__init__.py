"""Optimizers of the port."""
from .adamw import AdamW, cosine_schedule

__all__ = ["AdamW", "cosine_schedule"]
