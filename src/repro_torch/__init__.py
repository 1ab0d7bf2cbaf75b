"""repro_torch — the NTX reproduction on PyTorch and CUDA (NVIDIA Hopper).

A second package beside the JAX reference ``repro``, with the same
subpackage layout and module names so that every module has a
counterpart to be held against. It imports ``torch`` and never ``jax``
or anything of ``repro``/``ntx``.

Which code runs is decided by the device of the tensors: an ``ops``
wrapper given CPU tensors runs the kernel's plain PyTorch version, and
given CUDA tensors launches the hand-written Hopper kernel (built from
``kernels/csrc`` on first use) or raises. Entry points (``Model``,
``Server``, ``Executor``) default to ``device="cuda"``.
"""
