"""NTX command decoder: Descriptor -> kernel dispatch.

Counterpart of ``repro.core.dispatch``: pattern-matches a descriptor
against the kernel suite (GEMM/GEMV panels, the elementwise command set,
row reductions) and dispatches to the ``repro_torch.kernels.ops`` entry
point (the CUDA kernel for a CUDA memory image, the plain version for a
CPU one). A loop nest with no kernel equivalent runs on the functional
engine on the image's own device: the numpy engine for a CPU image,
:func:`engine.execute_torch` for a CUDA one (which covers only
descriptors with ``store_level == init_level``; the rest raise there).
Every such fallback is counted in :data:`engine_fallbacks`.

Unlike the reference's functional ``dispatch``, the port writes the
command's stores into ``mem`` in place and returns it: the executor
hands it a private copy of the memory image.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops
from . import engine
from .descriptor import Descriptor, Opcode

_EW_OPS = {Opcode.AXPY: "axpy", Opcode.ADD: "add", Opcode.SUB: "sub",
           Opcode.MUL: "mul", Opcode.MASK: "mask", Opcode.RELU: "relu",
           Opcode.THRESH: "thresh", Opcode.COPY: "copy", Opcode.SET: "set"}
_RED_OPS = {Opcode.VSUM: "sum", Opcode.MIN: "min", Opcode.MAX: "max",
            Opcode.ARGMIN: "argmin", Opcode.ARGMAX: "argmax"}

#: descriptors that matched no kernel and ran on the functional engine
engine_fallbacks = 0


def reset_engine_fallbacks() -> None:
    global engine_fallbacks
    engine_fallbacks = 0


def _is_contiguous_1d(desc: Descriptor) -> bool:
    return (len(desc.bounds) == 1
            and desc.agu0.strides[0] in (0, 1)
            and desc.agu1.strides[0] in (0, 1)
            and desc.agu2.strides[0] in (0, 1))


def _match_gemm(desc: Descriptor) -> Optional[tuple]:
    """C[m,n] = A[m,k] @ B[k,n] with the canonical AGU pattern."""
    if (desc.opcode is not Opcode.MAC or len(desc.bounds) != 3
            or desc.init_level != 1 or desc.store_level != 1):
        return None
    k, n, m = desc.bounds
    a0, a1, a2 = desc.agu0, desc.agu1, desc.agu2
    if (a0.strides[:3] == (1, 0, k) and a1.strides[:3] == (n, 1, 0)
            and a2.strides[:3] == (0, 1, n)):
        return m, n, k
    return None


def _match_gemv(desc: Descriptor) -> Optional[tuple]:
    if (desc.opcode is not Opcode.MAC or len(desc.bounds) != 2
            or desc.init_level != 1 or desc.store_level != 1):
        return None
    n, m = desc.bounds
    a0, a1, a2 = desc.agu0, desc.agu1, desc.agu2
    if (a0.strides[1] == n and a0.strides[0] == 1
            and a1.strides[:2] == (1, 0) and a2.strides[:2] == (0, 1)):
        return m, n
    return None


def _matches_reduce(desc: Descriptor) -> bool:
    return (desc.opcode in _RED_OPS and len(desc.bounds) == 1
            and desc.init_level == 1 and desc.agu0.strides[0] == 1)


def dispatch(desc: Descriptor, mem: torch.Tensor) -> torch.Tensor:
    """Execute one NTX command on the flat fp32 memory via the kernel
    suite, storing into ``mem`` in place; returns ``mem``."""
    global engine_fallbacks
    if desc.num_iters == 0:     # zero-trip nest: no iterations, no stores
        return mem

    gm = _match_gemm(desc)
    if gm is not None:
        m, n, k = gm
        A = mem[desc.agu0.base:desc.agu0.base + m * k].reshape(m, k)
        B = mem[desc.agu1.base:desc.agu1.base + k * n].reshape(k, n)
        C = ops.gemm(A, B)
        mem[desc.agu2.base:desc.agu2.base + m * n] = C.reshape(-1)
        return mem

    gv = _match_gemv(desc)
    if gv is not None:
        m, n = gv
        A = mem[desc.agu0.base:desc.agu0.base + m * n].reshape(m, n)
        x = mem[desc.agu1.base:desc.agu1.base + n]
        y = ops.gemm(A, x[:, None])[:, 0]
        mem[desc.agu2.base:desc.agu2.base + m] = y
        return mem

    if desc.opcode in _EW_OPS and _is_contiguous_1d(desc):
        n = desc.bounds[0]
        x = mem[desc.agu0.base:desc.agu0.base + n][None]
        y = (mem[desc.agu1.base:desc.agu1.base + n][None]
             if desc.reads_per_iter >= 2 else None)
        out = ops.elementwise(_EW_OPS[desc.opcode], x, y, imm=desc.imm)
        mem[desc.agu2.base:desc.agu2.base + n] = out[0]
        return mem

    if _matches_reduce(desc):
        n = desc.bounds[0]
        x = mem[desc.agu0.base:desc.agu0.base + n][None]
        red = ops.reduce(_RED_OPS[desc.opcode], x)
        mem[desc.agu2.base] = red[0].to(torch.float32)
        return mem

    # no kernel for this nest: the functional engine, on the image's device
    if mem.device.type == "cpu":
        out = torch.from_numpy(engine.execute_vectorized(
            desc, mem.detach().numpy()))
    elif desc.store_level == desc.init_level:
        out = engine.execute_torch(desc, mem)
    else:
        raise NotImplementedError(
            f"{desc.opcode.name} nest with store_level {desc.store_level} < "
            f"init_level {desc.init_level} matches no kernel and has no "
            f"on-device engine path; run it on a CPU memory image")
    engine_fallbacks += 1
    mem.copy_(out)
    return mem


def traceable_descriptor(desc: Descriptor) -> bool:
    """True iff :func:`dispatch` runs this descriptor through a kernel
    pattern or a plan the torch engine covers (store_level ==
    init_level) — the requirement the reference places on stacked
    multi-cluster execution, which the port adds with slice C."""
    return (desc.num_iters == 0
            or _match_gemm(desc) is not None
            or _match_gemv(desc) is not None
            or (desc.opcode in _EW_OPS and _is_contiguous_1d(desc))
            or _matches_reduce(desc)
            or desc.store_level == desc.init_level)
