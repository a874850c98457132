"""Checkpoints in the reference package's on-disk format
(:class:`~repro_torch.checkpoint.store.CheckpointStore`)."""
from .store import CheckpointStore

__all__ = ["CheckpointStore"]
