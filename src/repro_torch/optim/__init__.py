"""AdamW with its schedules and global-norm clipping, over dicts of
tensors."""
from .optimizer import (OptConfig, adamw_init, adamw_update,  # noqa: F401
                        clip_by_global_norm, schedule_lr)
