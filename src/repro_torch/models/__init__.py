from .common import ArchConfig
from .api import Model

__all__ = ["ArchConfig", "Model"]
