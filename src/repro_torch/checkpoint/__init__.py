from .manager import CheckpointManager, save_pytree, load_pytree

__all__ = ["CheckpointManager", "save_pytree", "load_pytree"]
