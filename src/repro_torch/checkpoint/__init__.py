"""Durability — ``repro.checkpoint``: atomic checkpoints and the
write-ahead op journal, in the JAX package's on-disk formats."""
from repro_torch.checkpoint.manager import CheckpointCorruptError, CheckpointManager

__all__ = ["CheckpointCorruptError", "CheckpointManager"]
