"""Checkpoints of the port, in the JAX package's on-disk format."""
from repro_torch.checkpoint.checkpointer import (CheckpointManager, available_steps, load,
                                                 save)

__all__ = ["CheckpointManager", "available_steps", "load", "save"]
