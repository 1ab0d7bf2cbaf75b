from .manager import CheckpointManager, save_pytree, load_pytree
from .elastic import reshard_checkpoint, validate_compat

__all__ = ["CheckpointManager", "save_pytree", "load_pytree",
           "reshard_checkpoint", "validate_compat"]
