"""Functional execution of NTX descriptors.

Three execution paths, from most-faithful to fastest:

* :func:`execute` — a sequential interpreter that walks the loop nest cycle
  by cycle exactly like the silicon's controller (cascaded HWLs, AGU address
  per cycle, wide accumulator with deferred rounding). This is the oracle.
* :func:`execute_vectorized` — numpy gather/reduce over the affine index
  grids. Bit-compatible with ``execute`` for fp32 accumulate is NOT
  guaranteed (different summation order); used where tolerance-based
  comparison is appropriate.
* :func:`execute_torch` — the same plan as torch index tensors on any
  device (the counterpart of the reference's ``execute_jax``), which
  also runs prefix-store nests (``store_level < init_level``) as running
  reductions in the engine's order.

Memory is modelled as a flat 1-D array (the TCDM). All addresses are element
indices.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .descriptor import ACC_INIT, INDEX_OPS, Descriptor, Opcode


# ----------------------------------------------------------------------
# Sequential oracle
# ----------------------------------------------------------------------
def _op_elem(op: Opcode, rd0, rd1, imm):
    """The non-reducing (streaming) element operations."""
    if op is Opcode.MUL:
        return rd0 * rd1
    if op is Opcode.ADD:
        return rd0 + rd1
    if op is Opcode.SUB:
        return rd0 - rd1
    if op is Opcode.RELU:
        return max(rd0, 0.0)
    if op is Opcode.THRESH:
        return rd0 if rd0 > imm else 0.0
    if op is Opcode.MASK:
        return rd0 if rd1 != 0.0 else 0.0
    if op is Opcode.COPY:
        return rd0
    if op is Opcode.SET:
        return imm
    if op is Opcode.AXPY:
        return imm * rd0 + rd1
    raise ValueError(f"not a streaming op: {op}")


class _WideAcc:
    """Accumulator models.

    ``fp32``  — conventional FPU: round after every FMA (the baseline the
                paper compares against).
    ``f64``   — double accumulate, round at store (default interpreter mode).
    ``exact`` — record every product and fsum at store: the PCS semantics
                (fp32 products are exact in f64; fsum is exactly rounded).
    """

    def __init__(self, mode: str, init: float):
        self.mode = mode
        self.init(init)

    def init(self, v: float):
        self._v = np.float32(v) if self.mode == "fp32" else float(v)
        self._terms = [float(v)] if self.mode == "exact" else None

    def mac(self, a: float, b: float):
        if self.mode == "fp32":
            self._v = np.float32(np.float32(a) * np.float32(b) + self._v)
        elif self.mode == "exact":
            self._terms.append(float(a) * float(b))
        else:
            self._v = self._v + float(a) * float(b)

    def set(self, v: float):
        self._v = np.float32(v) if self.mode == "fp32" else float(v)
        if self.mode == "exact":
            self._terms = [float(v)]

    @property
    def value(self) -> float:
        if self.mode == "exact":
            return math.fsum(self._terms)
        return float(self._v)

    def round_store(self) -> np.float32:
        return np.float32(self.value)


def execute(desc: Descriptor, mem: np.ndarray, acc_mode: str = "f64") -> np.ndarray:
    """Sequential, cycle-faithful interpretation. Returns the updated memory."""
    mem = np.array(mem, dtype=np.float32, copy=True)
    n = len(desc.bounds)
    op = desc.opcode
    acc = _WideAcc(acc_mode, ACC_INIT.get(op, 0.0))
    best_idx = 0
    flat_count = 0  # index counter for arg ops (counts innermost iterations
    #                 since the last accumulator init, like the HW counter)

    idx = [0] * n

    def addr(agu):
        return agu.addr(idx)

    total = desc.num_iters
    for _ in range(total):
        # -- accumulator init: at the start of each pass of levels < init_level
        if desc.init_level > 0 and all(idx[l] == 0 for l in range(desc.init_level)):
            acc.init(ACC_INIT[op])
            best_idx = 0
            flat_count = 0

        rd0 = float(mem[addr(desc.agu0)]) if desc.reads_per_iter >= 1 else 0.0
        rd1 = float(mem[addr(desc.agu1)]) if desc.reads_per_iter >= 2 else 0.0

        if op is Opcode.MAC:
            acc.mac(rd0, rd1)
        elif op is Opcode.VSUM:
            acc.mac(rd0, 1.0)
        elif op in (Opcode.MIN, Opcode.ARGMIN):
            if rd0 < acc.value:
                acc.set(rd0)
                best_idx = flat_count
        elif op in (Opcode.MAX, Opcode.ARGMAX):
            if rd0 > acc.value:
                acc.set(rd0)
                best_idx = flat_count
        else:
            acc.set(_op_elem(op, rd0, rd1, desc.imm))

        # -- store: at the end of each pass of levels < store_level
        if all(idx[l] == desc.bounds[l] - 1 for l in range(desc.store_level)):
            out = np.float32(best_idx) if op in INDEX_OPS else acc.round_store()
            mem[addr(desc.agu2)] = out

        # -- advance the cascaded hardware loops
        flat_count += 1
        for l in range(n):
            idx[l] += 1
            if idx[l] < desc.bounds[l]:
                break
            idx[l] = 0
    return mem


# ----------------------------------------------------------------------
# Affine index plans (shared by the vectorized paths)
# ----------------------------------------------------------------------
def _index_grids(desc: Descriptor, np_mod):
    """Index grids of shape bounds[::-1] (outermost axis first)."""
    # axis order: outermost loop first => shape (b[n-1], ..., b[0])
    shape = tuple(desc.bounds[::-1])
    grids = np_mod.indices(shape)  # grids[a] indexes axis a
    # grids[a] corresponds to loop level n-1-a
    return shape, grids


def _agu_addresses(desc: Descriptor, agu, np_mod):
    shape, grids = _index_grids(desc, np_mod)
    n = len(desc.bounds)
    addr = np_mod.zeros(shape, dtype=np_mod.int32) + agu.base
    for a in range(n):
        level = n - 1 - a
        s = agu.strides[level]
        if s:
            addr = addr + grids[a] * s
    return addr


def store_addresses_injective(desc: Descriptor) -> bool:
    """Heuristic check that vectorized scatter is order-independent."""
    n = len(desc.bounds)
    # store index space: levels >= store_level
    dims = range(desc.store_level, n)
    seen = set()
    strides = [desc.agu2.strides[l] for l in dims]
    bounds = [desc.bounds[l] for l in dims]
    total = 1
    for b in bounds:
        total *= b
    if total > 200_000:  # sample-based check for big nests
        rng = np.random.default_rng(0)
        for _ in range(1000):
            i = [int(rng.integers(b)) for b in bounds]
            a = desc.agu2.base + sum(x * s for x, s in zip(i, strides))
            if a in seen:
                return False
            seen.add(a)
        return True
    import itertools
    for i in itertools.product(*[range(b) for b in bounds]):
        a = desc.agu2.base + sum(x * s for x, s in zip(i, strides))
        if a in seen:
            return False
        seen.add(a)
    return True


def execute_vectorized(desc: Descriptor, mem: np.ndarray) -> np.ndarray:
    """Numpy gather/reduce fast path (store_level == init_level only)."""
    if desc.store_level != desc.init_level:
        return execute(desc, mem)
    mem = np.array(mem, dtype=np.float32, copy=True)
    if desc.num_iters == 0:     # zero-trip nest: no iterations, no stores
        return mem
    n = len(desc.bounds)
    op = desc.opcode
    imm = np.float32(desc.imm)

    rd0 = mem[_agu_addresses(desc, desc.agu0, np)] if desc.reads_per_iter >= 1 else None
    rd1 = mem[_agu_addresses(desc, desc.agu1, np)] if desc.reads_per_iter >= 2 else None
    shape, _ = _index_grids(desc, np)

    # reduce over the innermost init_level loops == trailing axes
    red_axes = tuple(range(n - desc.init_level, n)) if desc.init_level else ()

    if op is Opcode.MAC:
        val = (rd0.astype(np.float64) * rd1.astype(np.float64)).sum(red_axes)
    elif op is Opcode.VSUM:
        val = rd0.astype(np.float64).sum(red_axes)
    elif op is Opcode.MIN:
        val = rd0.min(red_axes)
    elif op is Opcode.MAX:
        val = rd0.max(red_axes)
    elif op in INDEX_OPS:
        flat = rd0.reshape(rd0.shape[:n - desc.init_level] + (-1,))
        val = (np.argmin if op is Opcode.ARGMIN else np.argmax)(flat, axis=-1)
    elif op is Opcode.RELU:
        val = np.maximum(rd0, 0)
    elif op is Opcode.THRESH:
        val = np.where(rd0 > imm, rd0, 0)
    elif op is Opcode.MASK:
        val = np.where(rd1 != 0, rd0, 0)
    elif op is Opcode.COPY:
        val = rd0
    elif op is Opcode.SET:
        val = np.full(shape, imm, np.float32)
    elif op is Opcode.ADD:
        val = rd0 + rd1
    elif op is Opcode.SUB:
        val = rd0 - rd1
    elif op is Opcode.MUL:
        val = rd0 * rd1
    elif op is Opcode.AXPY:
        val = imm * rd0 + rd1
    else:
        raise ValueError(op)

    # store addresses: evaluate AGU2 on the kept (outer) axes only
    kept = Descriptor(bounds=tuple(desc.bounds[desc.store_level:]) or (1,),
                      opcode=Opcode.SET, agu2=_shift_agu(desc, n),
                      imm=0.0)
    st_addr = _agu_addresses(kept, kept.agu2, np)
    mem[st_addr.reshape(-1)] = np.asarray(val, np.float32).reshape(-1)
    return mem


def _shift_agu(desc: Descriptor, n: int):
    from .descriptor import Agu
    lv = desc.store_level
    return Agu(desc.agu2.base, tuple(desc.agu2.strides[lv:]) + (0,) * lv)


def _running(op: Opcode, rd0: torch.Tensor, rd1, inner: int):
    """The accumulator after every iteration of a nest whose reduction
    spans the last ``inner`` elements of each row of the flattened grid
    (the levels below ``init_level``, level 0 fastest, as the engine
    walks them): running sums for MAC/SUM (in fp64, as the oracle's wide
    accumulator; rounded once at the store), running MIN/MAX, and for the
    arg ops the running index with ties first-wins (rule 3). Returns
    ``(values (rows, inner), int)`` with the value or index stored at
    each iteration."""
    rows = rd0.numel() // max(inner, 1)
    x = rd0.reshape(rows, inner)
    if op is Opcode.MAC:
        return torch.cumsum(x.double() * rd1.reshape(rows, inner).double(),
                            -1).float()
    if op is Opcode.VSUM:
        return torch.cumsum(x.double(), -1).float()
    # MIN/MAX: the oracle updates on a strict improvement only, so a NaN
    # never wins and the first of equal values stays; with NaN as the
    # accumulator's identity the running best of ``x`` is the oracle's
    lo = op in (Opcode.MIN, Opcode.ARGMIN)
    x = torch.where(torch.isnan(x), torch.full_like(x, ACC_INIT[op]), x)
    best = (torch.cummin if lo else torch.cummax)(x, -1).values
    better = torch.ones_like(x, dtype=torch.bool)
    better[:, 1:] = best[:, 1:] < best[:, :-1] if lo else \
        best[:, 1:] > best[:, :-1]
    pos = torch.arange(inner, device=x.device).expand(rows, inner)
    idx = torch.cummax(torch.where(better, pos, torch.zeros_like(pos)),
                       -1).values
    if op in INDEX_OPS:
        return idx.float()
    return torch.gather(x, -1, idx)


def _store_prefix(desc: Descriptor, mem: torch.Tensor, val: torch.Tensor,
                  read_addrs) -> None:
    """Store the values of a prefix-store nest: one per iteration whose
    levels below ``store_level`` are at their last trip, at AGU2's address
    there, in the engine's order (a later store to an address wins)."""
    s = desc.store_level
    inner = int(np.prod(desc.bounds[:s], dtype=np.int64)) if s else 1
    addr = _agu_addresses(desc, desc.agu2, np).reshape(-1, inner)[:, -1]
    if np.intersect1d(addr, np.concatenate(read_addrs)).size:
        raise NotImplementedError(
            "a prefix-store nest that reads an address it stores: its "
            "reads see earlier stores, which the gather plan does not "
            "model; run it on a CPU memory image (engine.execute)")
    _, first_rev = np.unique(addr[::-1], return_index=True)
    keep = np.sort(addr.size - 1 - first_rev)
    dev = mem.device
    mem[torch.as_tensor(addr[keep], dtype=torch.long, device=dev)] = \
        val.reshape(-1, inner)[:, -1][torch.as_tensor(keep, device=dev)]


def execute_torch(desc: Descriptor, mem: torch.Tensor) -> torch.Tensor:
    """Gather/reduce plan on a torch memory image: the AGU addresses
    become index tensors on the image's device. Returns a new image;
    ``mem`` is not modified.

    ``store_level == init_level``: fp32 accumulate (torch's reduction
    order); validated against the oracle with tolerances. A prefix-store
    nest (``store_level < init_level``) stores running reductions: fp64
    running sums (within the SUM tolerance of :func:`execute`) and
    running MIN/MAX/arg values bit-equal to it (:func:`_running`).
    """
    n = len(desc.bounds)
    op = desc.opcode
    mem = torch.as_tensor(mem, dtype=torch.float32).clone()
    if desc.num_iters == 0:     # zero-trip nest: no iterations, no stores
        return mem
    dev = mem.device
    imm = float(np.float32(desc.imm))
    reads = []

    def gather(agu):
        addrs = _agu_addresses(desc, agu, np)
        reads.append(addrs.reshape(-1))
        return mem[torch.as_tensor(addrs, dtype=torch.long, device=dev)]

    rd0 = gather(desc.agu0) if desc.reads_per_iter >= 1 else None
    rd1 = gather(desc.agu1) if desc.reads_per_iter >= 2 else None
    shape = tuple(desc.bounds[::-1])
    if desc.store_level < desc.init_level:     # only reductions have one
        inner = int(np.prod(desc.bounds[:desc.init_level], dtype=np.int64))
        _store_prefix(desc, mem, _running(op, rd0, rd1, inner), reads)
        return mem
    red_axes = tuple(range(n - desc.init_level, n)) if desc.init_level else ()

    def over(fn, t):            # torch reduces everything over dims ()
        return fn(t, red_axes) if red_axes else t

    if op is Opcode.MAC:
        val = over(torch.sum, rd0 * rd1)
    elif op is Opcode.VSUM:
        val = over(torch.sum, rd0)
    elif op is Opcode.MIN:
        val = over(torch.amin, rd0)
    elif op is Opcode.MAX:
        val = over(torch.amax, rd0)
    elif op in INDEX_OPS:
        flat = rd0.reshape(rd0.shape[:n - desc.init_level] + (-1,))
        val = (torch.argmin if op is Opcode.ARGMIN else torch.argmax)(flat, -1)
    elif op is Opcode.RELU:
        val = torch.clamp_min(rd0, 0.0)
    elif op is Opcode.THRESH:
        val = torch.where(rd0 > imm, rd0, torch.zeros_like(rd0))
    elif op is Opcode.MASK:
        val = torch.where(rd1 != 0, rd0, torch.zeros_like(rd0))
    elif op is Opcode.COPY:
        val = rd0
    elif op is Opcode.SET:
        val = torch.full(shape, imm, dtype=torch.float32, device=dev)
    elif op is Opcode.ADD:
        val = rd0 + rd1
    elif op is Opcode.SUB:
        val = rd0 - rd1
    elif op is Opcode.MUL:
        val = rd0 * rd1
    elif op is Opcode.AXPY:
        val = imm * rd0 + rd1
    else:
        raise ValueError(op)

    kept = Descriptor(bounds=tuple(desc.bounds[desc.store_level:]) or (1,),
                      opcode=Opcode.SET, agu2=_shift_agu(desc, n), imm=0.0)
    st_addr = torch.as_tensor(_agu_addresses(kept, kept.agu2, np),
                              dtype=torch.long, device=dev).reshape(-1)
    mem[st_addr] = torch.as_tensor(val, dtype=torch.float32).reshape(-1)
    return mem
