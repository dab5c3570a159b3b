"""Checkpointing substrate.

Counterpart of ``repro.checkpoint``, on the same on-disk layout: a
checkpoint written by either package loads in the other, bit for bit.
"""

from repro_torch.checkpoint.store import (CheckpointManager, latest_step,
                                          load_checkpoint, save_checkpoint)

__all__ = ["CheckpointManager", "latest_step", "load_checkpoint",
           "save_checkpoint"]
