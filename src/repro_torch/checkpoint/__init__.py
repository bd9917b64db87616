# Crash-safe checkpoints in the JAX package's npz format.
from repro_torch.checkpoint.ckpt import (
    CheckpointCorrupt,
    CheckpointManager,
    latest_common_step,
    load_checkpoint,
    restore_train_state,
    save_checkpoint,
)

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "restore_train_state",
    "CheckpointCorrupt",
    "CheckpointManager",
    "latest_common_step",
]
