"""``Program`` — the recording builder behind the NTX front door.

The paper's offload model (§II) is a host core *writing a program* of NTX
descriptors into command queues. Until now every in-repo caller built that
program by hand: a raw flat ``mem`` array plus integer base addresses
threaded through ``Agu(base, strides)`` — the serving loop, the optimizer
planner and every benchmark each carried its own offset arithmetic.

:class:`Program` replaces the arithmetic with symbolic buffers:

    with Program() as p:
        x = p.buffer((n,), name="x")
        y = p.buffer((n,), name="y")
        out = p.axpy(2.5, x, y)          # -> BufferHandle
        s = p.reduce("sum", out)

A bump allocator assigns each buffer a base offset at declaration time
(deterministic: declaration order, aligned to ``align`` elements), so the
recorded descriptors carry real addresses while callers only ever touch
handles. ``pack`` assembles the flat fp32 memory image from buffer
initializers and call-time bindings; ``unpack`` slices named results back
out. Execution goes through :class:`repro_torch.core.executor.Executor`
— the single policy-driven front door — or the lower layers
(``CommandStream``, ``dispatch``), which consume ``Program.descriptors``
unchanged. Counterpart of ``repro.core.program``; the memory image is a
torch tensor on the device the caller names.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import descriptor as dsc
from .descriptor import Agu, Descriptor, Opcode

_REDUCE_OPS = {"sum": Opcode.VSUM, "min": Opcode.MIN, "max": Opcode.MAX,
               "argmin": Opcode.ARGMIN, "argmax": Opcode.ARGMAX}


def _align_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


class BufferHandle:
    """A symbolic region of the program's flat memory.

    Handles are created by :meth:`Program.buffer` (or returned by op
    methods) and are only meaningful inside their owning program. The
    assigned base ``offset`` is an implementation detail — callers pass
    handles, never addresses.
    """

    __slots__ = ("program", "index", "name", "shape", "offset")

    def __init__(self, program: "Program", index: int, name: str,
                 shape: Tuple[int, ...], offset: int):
        self.program = program
        self.index = index
        self.name = name
        self.shape = shape
        self.offset = offset

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def span(self) -> Tuple[int, int]:
        """Half-open [lo, hi) element range this buffer occupies."""
        return self.offset, self.offset + self.size

    def __repr__(self) -> str:
        return (f"BufferHandle({self.name!r}, shape={self.shape}, "
                f"offset={self.offset})")


HandleOrName = Union[BufferHandle, str]


class ProgramResult:
    """Named view over an executed program's flat memory.

    Indexing by handle (or buffer name) returns the buffer's contents as a
    numpy array in its declared shape; ``mem`` is the raw flat fp32 torch
    image. The device -> host transfer happens once, lazily, for all
    reads.
    """

    def __init__(self, program: "Program", mem: torch.Tensor):
        self.program = program
        self.mem = mem
        self._np: Optional[np.ndarray] = None

    def numpy(self) -> np.ndarray:
        if self._np is None:
            self._np = self.mem.detach().cpu().numpy()
        return self._np

    def __getitem__(self, key: HandleOrName) -> np.ndarray:
        h = self.program.resolve(key)
        lo, hi = h.span
        return self.numpy()[lo:hi].reshape(h.shape)

    def read_tensor(self, key: HandleOrName) -> torch.Tensor:
        """Device-side view of one buffer (no host transfer)."""
        h = self.program.resolve(key)
        lo, hi = h.span
        return self.mem[lo:hi].reshape(h.shape)


class Program:
    """Recording builder for NTX descriptor programs.

    ``align`` (elements) pads every buffer's base offset — deterministic
    layout, declaration order. The default of 8 keeps the reference's
    layout, so both packages place every buffer at the same offset.
    """

    def __init__(self, align: int = 8):
        if align < 1:
            raise ValueError(f"align must be >= 1, got {align}")
        self.align = int(align)
        self.buffers: List[BufferHandle] = []
        self._by_name: Dict[str, BufferHandle] = {}
        self._init: Dict[int, np.ndarray] = {}
        self._descs: List[Descriptor] = []
        self._size = 0
        #: bumped on every mutation; executors key their plan caches on it
        self.version = 0
        # pack() is on serving hot paths: default segments (zeros / init)
        # and alignment-gap zeros are constant per buffer, so they are
        # staged once per device and reused across packs
        self._seg_cache: Dict[tuple, torch.Tensor] = {}
        self._gap_cache: Dict[tuple, torch.Tensor] = {}

    # -- context manager (purely for the `with Program() as p:` idiom) --
    def __enter__(self) -> "Program":
        return self

    def __exit__(self, *exc) -> None:
        return None

    # -- introspection -------------------------------------------------
    @property
    def descriptors(self) -> Tuple[Descriptor, ...]:
        return tuple(self._descs)

    @property
    def size(self) -> int:
        """Flat memory image length in elements."""
        return self._size

    def spans(self) -> List[Tuple[int, int]]:
        """Allocated [lo, hi) per buffer, in declaration order."""
        return [h.span for h in self.buffers]

    def resolve(self, key: HandleOrName) -> BufferHandle:
        if isinstance(key, BufferHandle):
            if key.program is not self:
                raise ValueError(f"{key!r} belongs to a different Program")
            return key
        h = self._by_name.get(key)
        if h is None:
            raise KeyError(f"no buffer named {key!r}")
        return h

    # -- allocation ----------------------------------------------------
    def buffer(self, shape: Union[int, Sequence[int]], name: str = None,
               init=None) -> BufferHandle:
        """Declare a buffer; optionally seed it with ``init`` at pack time.

        Offsets are assigned by a bump allocator in declaration order,
        aligned to ``self.align`` — the layout is a pure function of the
        declaration sequence (property-tested in tests/test_program.py).
        """
        if isinstance(shape, (int, np.integer)):
            shape = (int(shape),)
        shape = tuple(int(s) for s in shape)
        if any(s < 0 for s in shape):
            raise ValueError(f"negative dimension in {shape}")
        index = len(self.buffers)
        if name is None:
            name = f"buf{index}"
        if name in self._by_name:
            raise ValueError(f"duplicate buffer name {name!r}")
        offset = _align_up(self._size, self.align)
        h = BufferHandle(self, index, name, shape, offset)
        self.buffers.append(h)
        self._by_name[name] = h
        self._size = offset + h.size
        self.version += 1
        if init is not None:
            a = np.asarray(init, np.float32)
            if a.size != h.size:
                raise ValueError(f"init size {a.size} != buffer size {h.size}")
            self._init[index] = a.reshape(-1)
        return h

    def _out_like(self, x: BufferHandle, out: Optional[BufferHandle],
                  shape=None) -> BufferHandle:
        if out is None:
            return self.buffer(shape if shape is not None else x.shape)
        out = self.resolve(out)
        want = shape if shape is not None else x.shape
        n = int(np.prod(want)) if want else 1
        if out.size != n:
            raise ValueError(f"out size {out.size} != expected {n}")
        return out

    def emit(self, desc: Descriptor) -> Descriptor:
        """Escape hatch: append a raw descriptor (addresses must have come
        from this program's handles — nothing validates them)."""
        self._descs.append(desc)
        self.version += 1
        return desc

    # -- streaming elementwise commands --------------------------------
    def _ew(self, opcode: Opcode, x: Optional[BufferHandle],
            y: Optional[BufferHandle], out: Optional[BufferHandle],
            imm: float = 0.0, shape=None) -> BufferHandle:
        x = self.resolve(x) if x is not None else None
        y = self.resolve(y) if y is not None else None
        out = self._out_like(x if x is not None else out, out, shape)
        n = out.size
        for operand in (x, y):
            if operand is not None and operand.size != n:
                raise ValueError(
                    f"operand size {operand.size} != output size {n}")
        self.emit(Descriptor(
            bounds=(n,), opcode=opcode, imm=imm,
            agu0=Agu(x.offset, (1,)) if x is not None else Agu(),
            agu1=Agu(y.offset, (1,)) if y is not None else Agu(),
            agu2=Agu(out.offset, (1,))))
        return out

    def axpy(self, a: float, x: BufferHandle, y: BufferHandle,
             out: Optional[BufferHandle] = None) -> BufferHandle:
        """``out = a*x + y`` (BLAS-1 as one NTX command)."""
        return self._ew(Opcode.AXPY, x, y, out, imm=float(a))

    def add(self, x, y, out=None) -> BufferHandle:
        return self._ew(Opcode.ADD, x, y, out)

    def sub(self, x, y, out=None) -> BufferHandle:
        return self._ew(Opcode.SUB, x, y, out)

    def mul(self, x, y, out=None) -> BufferHandle:
        return self._ew(Opcode.MUL, x, y, out)

    def mask(self, x, m, out=None) -> BufferHandle:
        """``out[i] = x[i] if m[i] != 0 else 0``."""
        return self._ew(Opcode.MASK, x, m, out)

    def relu(self, x, out=None) -> BufferHandle:
        return self._ew(Opcode.RELU, x, None, out)

    def thresh(self, x, imm: float, out=None) -> BufferHandle:
        """``out[i] = x[i] if x[i] > imm else 0``."""
        return self._ew(Opcode.THRESH, x, None, out, imm=float(imm))

    def copy(self, x, out=None) -> BufferHandle:
        return self._ew(Opcode.COPY, x, None, out)

    def set(self, out, value: float) -> BufferHandle:
        """memset: ``out[:] = value``."""
        out = self.resolve(out)
        return self._ew(Opcode.SET, None, None, out, imm=float(value),
                        shape=out.shape)

    # -- MAC loop nests ------------------------------------------------
    def gemv(self, A: BufferHandle, x: BufferHandle,
             out: Optional[BufferHandle] = None) -> BufferHandle:
        A, x = self.resolve(A), self.resolve(x)
        if len(A.shape) != 2:
            raise ValueError(f"gemv needs a 2-D matrix, got {A.shape}")
        m, n = A.shape
        if x.size != n:
            raise ValueError(f"x size {x.size} != {n}")
        out = self._out_like(A, out, shape=(m,))
        self.emit(dsc.gemv(m, n, A.offset, x.offset, out.offset))
        return out

    def gemm(self, A: BufferHandle, B: BufferHandle,
             out: Optional[BufferHandle] = None) -> BufferHandle:
        A, B = self.resolve(A), self.resolve(B)
        if len(A.shape) != 2 or len(B.shape) != 2:
            raise ValueError(f"gemm needs 2-D operands, got {A.shape} "
                             f"@ {B.shape}")
        m, k = A.shape
        k2, n = B.shape
        if k != k2:
            raise ValueError(f"inner dims disagree: {A.shape} @ {B.shape}")
        out = self._out_like(A, out, shape=(m, n))
        self.emit(dsc.gemm(m, n, k, A.offset, B.offset, out.offset))
        return out

    def laplace1d(self, x: BufferHandle, coef: BufferHandle,
                  out: Optional[BufferHandle] = None) -> BufferHandle:
        """1-D 3-point stencil: ``out[i] = sum_j coef[j] * x[i+j]``."""
        x, coef = self.resolve(x), self.resolve(coef)
        if coef.size != 3:
            raise ValueError(f"laplace1d needs 3 coefficients, "
                             f"got {coef.size}")
        n = x.size - 2
        if n < 1:
            raise ValueError(f"input too short: {x.size}")
        out = self._out_like(x, out, shape=(n,))
        self.emit(dsc.laplace1d(n, x.offset, coef.offset, out.offset))
        return out

    # -- reductions ----------------------------------------------------
    def reduce(self, op: str, x: BufferHandle,
               out: Optional[BufferHandle] = None,
               name: str = None) -> BufferHandle:
        """One reduction over the whole buffer -> a 1-element buffer.

        ``op`` is sum/min/max/argmin/argmax; the arg ops store the winning
        *index* (as fp32, the engine's write-back convention). Placed right
        after an in-place elementwise chain over ``x`` the reduction fuses
        as the chain's tail (``core.stream``) — including the arg ops'
        comparator + index-counter datapath.
        """
        opcode = _REDUCE_OPS.get(op)
        if opcode is None:
            raise ValueError(f"op must be one of {sorted(_REDUCE_OPS)}, "
                             f"got {op!r}")
        x = self.resolve(x)
        if out is None:
            out = self.buffer((1,), name=name)
        else:
            out = self.resolve(out)
            if out.size != 1:
                raise ValueError(f"reduction output must be 1 element, "
                                 f"got {out.size}")
        self.emit(Descriptor(
            bounds=(x.size,), opcode=opcode, init_level=1, store_level=1,
            agu0=Agu(x.offset, (1,)), agu2=Agu(out.offset, (0,))))
        return out

    def argmax(self, x, out=None, name=None) -> BufferHandle:
        return self.reduce("argmax", x, out, name)

    def argmin(self, x, out=None, name=None) -> BufferHandle:
        return self.reduce("argmin", x, out, name)

    # -- memory image --------------------------------------------------
    def pack(self, inputs: Optional[Dict[HandleOrName, object]] = None,
             device="cuda") -> torch.Tensor:
        """Assemble the flat fp32 memory image on ``device`` (a new tensor
        on every call).

        Precedence per buffer: call-time ``inputs`` binding, else the
        declaration-time ``init``, else zeros. Gap elements introduced by
        alignment are zero."""
        device = torch.device(device)
        bound: Dict[int, torch.Tensor] = {}
        for key, val in (inputs or {}).items():
            h = self.resolve(key)
            arr = torch.as_tensor(val, dtype=torch.float32,
                                  device=device).reshape(-1)
            if arr.shape[0] != h.size:
                raise ValueError(f"binding for {h.name!r} has {arr.shape[0]} "
                                 f"elements, buffer holds {h.size}")
            bound[h.index] = arr
        segs: List[torch.Tensor] = []
        cursor = 0
        for h in self.buffers:
            if h.offset > cursor:
                segs.append(self._gap(h.offset - cursor, device))
            val = bound.get(h.index)
            if val is None:
                val = self._seg_cache.get((h.index, device))
                if val is None:
                    init = self._init.get(h.index)
                    val = (torch.as_tensor(init, device=device)
                           if init is not None
                           else torch.zeros(h.size, dtype=torch.float32,
                                            device=device))
                    self._seg_cache[(h.index, device)] = val
            segs.append(val)
            cursor = h.offset + h.size
        if self._size > cursor:
            segs.append(self._gap(self._size - cursor, device))
        if not segs:
            return torch.zeros(0, dtype=torch.float32, device=device)
        return torch.cat(segs)

    def _gap(self, length: int, device: torch.device) -> torch.Tensor:
        z = self._gap_cache.get((length, device))
        if z is None:
            z = torch.zeros(length, dtype=torch.float32, device=device)
            self._gap_cache[(length, device)] = z
        return z

    def unpack(self, mem: torch.Tensor) -> ProgramResult:
        mem = torch.as_tensor(mem, dtype=torch.float32)
        if tuple(mem.shape) != (self._size,):
            raise ValueError(f"memory image has shape {mem.shape}, "
                             f"program needs ({self._size},)")
        return ProgramResult(self, mem)

    def __repr__(self) -> str:
        return (f"Program({len(self.buffers)} buffers, "
                f"{len(self._descs)} descriptors, {self._size} elements)")
