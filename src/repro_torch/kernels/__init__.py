"""repro_torch.kernels — NTX streaming kernels for Hopper (CUDA C++) and
their plain PyTorch versions.

``ops`` is the public facade used by the models and the descriptor
machine; ``ref`` holds the plain oracles the kernels are held against.
"""
from . import ops, ref

__all__ = ["ops", "ref"]
