"""Checkpoints in the reference's on-disk format
(``checkpoint/manager.py``)."""
from repro_torch.checkpoint.manager import (CheckpointManager, latest_step,
                                            restore, save)

__all__ = ["CheckpointManager", "latest_step", "restore", "save"]
