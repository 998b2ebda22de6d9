"""On-disk checkpoints in the reference package's format, and the
trainer's asynchronous checkpoint manager."""
from .checkpoint import (CheckpointManager, latest_step,  # noqa: F401
                         restore_checkpoint, restore_like, save_checkpoint)

__all__ = ["CheckpointManager", "latest_step", "restore_checkpoint",
           "restore_like", "save_checkpoint"]
