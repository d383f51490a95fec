# Port of src/repro/ckpt/__init__.py: the same exports.
from .checkpoint import save_checkpoint, restore_checkpoint, latest_step, CheckpointManager

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "CheckpointManager"]
