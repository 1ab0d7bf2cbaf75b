"""Analytical performance models: the paper's machine (``ntx``), its DNN
training efficiency against GPUs (``dnn``), and the H100 roofline of the
dry run's cells (``gpu_roofline``)."""
from . import dnn, gpu_roofline

__all__ = ["dnn", "gpu_roofline"]
