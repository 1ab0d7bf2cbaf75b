from .pipeline import SyntheticLM, DataState

__all__ = ["SyntheticLM", "DataState"]
