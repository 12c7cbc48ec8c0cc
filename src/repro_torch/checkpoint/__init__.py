"""Checkpoints of the port: a JSON index and zlib-compressed raw tensors."""

from .store import CheckpointManager, load_tree, restore_latest, save_tree

__all__ = ["CheckpointManager", "save_tree", "load_tree", "restore_latest"]
