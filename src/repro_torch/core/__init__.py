"""repro_torch.core — the NTX descriptor machine on PyTorch.

The descriptor ISA (descriptor.py), the functional engines (engine.py),
the kernel dispatch (dispatch.py), fused command streams (stream.py),
the Program builder (program.py) and the policy-driven Executor
(executor.py), over the paper's cluster spec (cluster.py, memory.py),
and the PCS wide-accumulator precision study (precision.py).
"""
from .descriptor import (Agu, Descriptor, Opcode, axpy, gemv, gemm, memcpy,
                         memset, relu, argmax, laplace1d,
                         hw_steps_to_strides, strides_to_hw_steps,
                         NUM_LOOPS, NUM_AGUS, MAX_HW_COUNT)
from .engine import execute, execute_vectorized, execute_torch
from .cluster import NtxClusterSpec, PAPER_CLUSTER
from .memory import NtxMemSpec, PAPER_MEM
from .dispatch import dispatch
from .stream import CommandStream, plan_stream, program_spans
from .program import BufferHandle, Program, ProgramResult
from .executor import ExecutionPolicy, Executor
from . import precision

__all__ = [
    "Agu", "Descriptor", "Opcode", "axpy", "gemv", "gemm", "memcpy",
    "memset", "relu", "argmax", "laplace1d", "hw_steps_to_strides",
    "strides_to_hw_steps", "NUM_LOOPS", "NUM_AGUS", "MAX_HW_COUNT",
    "execute", "execute_vectorized", "execute_torch",
    "NtxClusterSpec", "PAPER_CLUSTER", "NtxMemSpec", "PAPER_MEM",
    "dispatch", "CommandStream", "plan_stream", "program_spans",
    "BufferHandle", "Program", "ProgramResult", "ExecutionPolicy",
    "Executor", "precision",
]
