"""Atomic checkpoints in the reference's on-disk format: the counterpart
of `repro.checkpoint`."""
from repro_torch.checkpoint.ckpt import (CheckpointManager, latest_step,
                                         manifest, restore, save)

__all__ = ["save", "restore", "latest_step", "manifest", "CheckpointManager"]
