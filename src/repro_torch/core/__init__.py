"""repro_torch.core — the NTX descriptor machine on PyTorch.

The descriptor ISA (descriptor.py), the functional engines (engine.py),
the kernel dispatch (dispatch.py), fused command streams (stream.py),
the multi-cluster and stage-pipeline schedulers (multistream.py), the
out-of-core tile plans (tiling.py), the Program builder (program.py) and
the policy-driven Executor (executor.py), over the paper's cluster spec
(cluster.py, memory.py, scheduler.py), and the PCS wide-accumulator
precision study (precision.py).
"""
from .descriptor import (Agu, Descriptor, Opcode, axpy, gemv, gemm, memcpy,
                         memset, relu, argmax, laplace1d,
                         hw_steps_to_strides, strides_to_hw_steps,
                         NUM_LOOPS, NUM_AGUS, MAX_HW_COUNT)
from .engine import execute, execute_vectorized, execute_torch
from .cluster import NtxClusterSpec, PAPER_CLUSTER, ntx_multi_cluster
from .memory import (NtxMemSpec, PAPER_MEM, fits, working_set_bytes,
                     working_set_elems, working_set_spans)
from .scheduler import (TileSchedule, Tile, schedule_axpy, schedule_gemv,
                        schedule_gemm, schedule_conv2d, schedule_stencil,
                        pick_matmul_blocks)
from .dispatch import dispatch
from .stream import CommandStream, plan_stream, program_spans
from .multistream import (ClusterScheduler, StageSchedule, StreamGraph,
                          SubStream)
from .tiling import TileIteration, TilePlan
from .program import BufferHandle, Program, ProgramResult
from .executor import (ExecutionPolicy, Executor,
                       clear_measured_policy_cache)
from . import precision

__all__ = [
    "Agu", "Descriptor", "Opcode", "axpy", "gemv", "gemm", "memcpy",
    "memset", "relu", "argmax", "laplace1d", "hw_steps_to_strides",
    "strides_to_hw_steps", "NUM_LOOPS", "NUM_AGUS", "MAX_HW_COUNT",
    "execute", "execute_vectorized", "execute_torch",
    "NtxClusterSpec", "PAPER_CLUSTER", "ntx_multi_cluster",
    "NtxMemSpec", "PAPER_MEM", "fits", "working_set_bytes",
    "working_set_elems", "working_set_spans",
    "TileSchedule", "Tile", "schedule_axpy", "schedule_gemv",
    "schedule_gemm", "schedule_conv2d", "schedule_stencil",
    "pick_matmul_blocks", "dispatch",
    "CommandStream", "plan_stream", "program_spans",
    "ClusterScheduler", "StageSchedule", "StreamGraph", "SubStream",
    "TileIteration", "TilePlan",
    "BufferHandle", "Program", "ProgramResult", "ExecutionPolicy",
    "Executor", "clear_measured_policy_cache", "precision",
]
