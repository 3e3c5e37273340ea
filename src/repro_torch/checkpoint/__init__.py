"""Checkpointing of nested dicts/lists of numpy arrays (``CheckpointManager``)."""
from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
