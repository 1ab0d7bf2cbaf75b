"""NTX command decoder: Descriptor -> kernel dispatch.

Counterpart of ``repro.core.dispatch``: pattern-matches a descriptor
against the kernel suite (GEMM/GEMV panels, the elementwise command set,
row reductions) and dispatches to the ``repro_torch.kernels.ops`` entry
point (the CUDA kernel for a CUDA memory image, the plain version for a
CPU one). A loop nest with no kernel equivalent runs on the functional
engine on the image's own device: the numpy engine for a CPU image,
:func:`engine.execute_torch` for a CUDA one (prefix-store nests too, as
running reductions). Every such fallback is counted in
:data:`engine_fallbacks`.

Unlike the reference's functional ``dispatch``, the port writes the
command's stores into ``mem`` in place and returns it: the executor
hands it a private copy of the memory image.

:func:`dispatch_lanes` runs one descriptor over L lanes at once, an (L,
W) stack of memory windows (the rows may be strided views of one image):
a GEMM/GEMV is one lane-batched ``ops.gemm`` launch, a streaming command
or a reduction one ``ops.elementwise``/``ops.reduce`` launch with rows =
L. This is the port's form of the reference running ``dispatch`` under
``jax.vmap``. :func:`dispatch` is the one-lane case.
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
    """One reduction over a contiguous row, stored once. Unlike the
    reference's pattern (which also takes store_level 0), a 1-D
    prefix-store reduction is not one: the reduce kernel would store only
    its last value (ROADMAP queue 3, record 5)."""
    return (desc.opcode in _RED_OPS and len(desc.bounds) == 1
            and desc.init_level == 1 and desc.store_level == 1
            and desc.agu0.strides[0] == 1)


def lane_gemm(A: torch.Tensor, B: torch.Tensor, epilogue=None):
    """``ops.gemm`` over lanes: (L, m, k) @ (L, k, n) with (L, ...)
    epilogue operands, one launch for all L. A single lane runs as the
    2-D product it is."""
    if A.shape[0] != 1:
        return ops.gemm(A, B, epilogue=epilogue)
    ep = [(st[0],) + tuple(v[0] if torch.is_tensor(v) else v
                           for v in st[1:]) for st in epilogue or ()]
    return ops.gemm(A[0], B[0], epilogue=ep)[None]


def _engine(desc: Descriptor, mem: torch.Tensor) -> None:
    """A nest that matches no kernel, on the functional engine of the
    image's device, storing into the 1-D ``mem`` in place."""
    global engine_fallbacks
    if mem.device.type == "cpu":
        out = torch.from_numpy(engine.execute_vectorized(
            desc, mem.detach().numpy()))
    else:
        out = engine.execute_torch(desc, mem)
    engine_fallbacks += 1
    mem.copy_(out)


def dispatch_lanes(desc: Descriptor, stack: torch.Tensor) -> torch.Tensor:
    """Execute one NTX command on each row of the (L, W) fp32 ``stack``
    (lane l's memory window in row l, addresses local to the window), as
    one lane-batched kernel launch, storing in place; returns ``stack``.
    A nest that matches no kernel runs on the engine one lane at a time
    (a loop over the rows)."""
    if desc.num_iters == 0:     # zero-trip nest: no iterations, no stores
        return stack
    L = stack.shape[0]
    a0, a1, a2 = desc.agu0.base, desc.agu1.base, desc.agu2.base

    gm = _match_gemm(desc)
    if gm is not None:
        m, n, k = gm
        A = stack[:, a0:a0 + m * k].unflatten(1, (m, k))
        B = stack[:, a1:a1 + k * n].unflatten(1, (k, n))
        stack[:, a2:a2 + m * n] = lane_gemm(A, B).reshape(L, m * n)
        return stack

    gv = _match_gemv(desc)
    if gv is not None:
        m, n = gv
        A = stack[:, a0:a0 + m * n].unflatten(1, (m, n))
        x = stack[:, a1:a1 + n].unsqueeze(-1)
        stack[:, a2:a2 + m] = lane_gemm(A, x)[..., 0]
        return stack

    if desc.opcode in _EW_OPS and _is_contiguous_1d(desc):
        n = desc.bounds[0]
        x = stack[:, a0:a0 + n]
        y = stack[:, a1:a1 + n] if desc.reads_per_iter >= 2 else None
        stack[:, a2:a2 + n] = ops.elementwise(_EW_OPS[desc.opcode], x, y,
                                              imm=desc.imm)
        return stack

    if _matches_reduce(desc):
        n = desc.bounds[0]
        red = ops.reduce(_RED_OPS[desc.opcode], stack[:, a0:a0 + n])
        stack[:, a2] = red.to(torch.float32)
        return stack

    for lane in range(L):       # no kernel for this nest: lane by lane
        _engine(desc, stack[lane])
    return stack


def dispatch(desc: Descriptor, mem: torch.Tensor) -> torch.Tensor:
    """Execute one NTX command on the flat fp32 memory via the kernel
    suite, storing into ``mem`` in place; returns ``mem``."""
    dispatch_lanes(desc, mem[None])
    return mem


def traceable_descriptor(desc: Descriptor) -> bool:
    """True iff :func:`dispatch` runs this descriptor through a kernel
    pattern or a plan the torch engine covers (store_level ==
    init_level) — the reference's rule for stacked multi-cluster
    execution (``vmap``/``shard_map``), which the port keeps so that
    ``plan_mode`` picks the reference's mode. Prefix-store nests
    (store_level < init_level) are not, and run ``interleave`` (on a CUDA
    image through ``engine.execute_torch``'s running reductions)."""
    return (desc.num_iters == 0
            or _match_gemm(desc) is not None
            or _match_gemv(desc) is not None
            or (desc.opcode in _EW_OPS and _is_contiguous_1d(desc))
            or _matches_reduce(desc)
            or desc.store_level == desc.init_level)
