"""Atomic, async checkpointing of the port's training state (a port of the
JAX package's ``repro.checkpoint``)."""
from repro_torch.checkpoint.checkpoint import (CheckpointManager, cleanup,
                                               list_checkpoints,
                                               restore_latest,
                                               save_checkpoint)

__all__ = ["CheckpointManager", "cleanup", "list_checkpoints",
           "restore_latest", "save_checkpoint"]
