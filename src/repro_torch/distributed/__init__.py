"""repro_torch.distributed: meshes' sharding rules, collectives, the ring
overlap products and the pipeline (the counterpart of
``repro.distributed``; its ``compat`` shim has no counterpart)."""
from . import collectives, overlap, pipeline, sharding

__all__ = ["sharding", "collectives", "overlap", "pipeline"]
