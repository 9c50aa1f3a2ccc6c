from repro_torch.checkpoint.ckpt import (RestoreStats, corrupt_shard,
                                         delete_shard, restore, save)
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = [
    "save", "restore", "RestoreStats", "corrupt_shard", "delete_shard",
    "CheckpointManager",
]
