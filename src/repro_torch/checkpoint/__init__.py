"""repro_torch.checkpoint — atomic, async npz-shard checkpoints."""

from .manager import CheckpointManager, latest_step, restore_tree, save_tree

__all__ = ["CheckpointManager", "latest_step", "restore_tree", "save_tree"]
