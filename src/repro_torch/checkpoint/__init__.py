"""Fault-tolerant checkpoints (atomic saves, resharding restore) — port of
``repro.checkpoint``."""

from repro_torch.checkpoint.checkpoint import CheckpointError, CheckpointManager

__all__ = ["CheckpointError", "CheckpointManager"]
