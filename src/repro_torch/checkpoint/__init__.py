"""On-disk checkpoints in the reference package's format (numpy only)."""
from .checkpoint import latest_step, restore_checkpoint, save_checkpoint  # noqa: F401

__all__ = ["latest_step", "restore_checkpoint", "save_checkpoint"]
