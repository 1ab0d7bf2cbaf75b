"""The NTX front door on PyTorch: ``import ntx_torch as ntx``.

    import ntx_torch as ntx

    with ntx.Program() as p:
        x = p.buffer((1024,), name="x")
        y = p.buffer((1024,), name="y")
        out = p.axpy(2.5, x, y)
    res = ntx.Executor().run(p, inputs={x: xs, y: ys})   # on the card
    res[out]                       # named result, no base addresses

A thin alias over ``repro_torch.core``, mirroring ``ntx`` over
``repro.core``: the Program builder, the Executor and its five policies,
and the tile plan of the ``tiled`` policy.
"""
from repro_torch.core.descriptor import Agu, Descriptor, Opcode
from repro_torch.core.executor import ExecutionPolicy, Executor
from repro_torch.core.memory import NtxMemSpec, PAPER_MEM
from repro_torch.core.program import BufferHandle, Program, ProgramResult
from repro_torch.core.tiling import TilePlan

__all__ = ["Agu", "Descriptor", "Opcode", "ExecutionPolicy", "Executor",
           "BufferHandle", "Program", "ProgramResult", "NtxMemSpec",
           "PAPER_MEM", "TilePlan"]
