"""NTX descriptor ISA.

The paper's co-processor is programmed with a single *command* describing an
affine loop nest (Fig. 2 / Fig. 3 of the paper):

  * up to ``NUM_LOOPS = 5`` cascaded hardware loops (HWLs). Loop 0 is the
    innermost loop; a loop wrapping from its maximum count to zero increments
    the next-higher loop.
  * ``NUM_AGUS = 3`` address-generation units. AGU0/AGU1 produce the two read
    streams, AGU2 the write stream. In hardware each AGU advances every cycle
    by one of five step sizes "chosen based on the outermost loop enabled in
    that cycle"; that delta encoding is exactly equivalent to the affine form

        addr(i) = base + sum_l idx[l] * stride[l]

    which we use as the canonical semantics (see :func:`hw_steps_to_strides`
    and the property test proving equivalence).
  * an opcode executed in the innermost loop, an ``init_level`` at which the
    accumulator is (re-)initialised and a ``store_level`` at which it is
    rounded once and written back (deferred rounding — the PCS accumulator).

Deviation from silicon (documented in DESIGN.md §2): HWL counters are 16 bit
in hardware; we validate against ``MAX_HW_COUNT`` but allow int32 bounds when
``strict_hw=False``.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Sequence, Tuple

NUM_LOOPS = 5
NUM_AGUS = 3
MAX_HW_COUNT = (1 << 16) - 1  # 16-bit hardware loop counters


class Opcode(enum.Enum):
    """The NTX command set (paper Fig. 3b).

    Reads: ``rd0 = *AGU0``, ``rd1 = *AGU1``. ``acc`` is the wide accumulator.
    Write-back at store_level: ``*AGU2 = round(acc)`` (or the element result
    for streaming ops whose store_level is the innermost loop).
    """

    MAC = "mac"          # acc += rd0 * rd1
    VSUM = "vsum"        # acc += rd0             (MAC with implicit 1.0)
    MUL = "mul"          # acc  = rd0 * rd1
    ADD = "add"          # acc  = rd0 + rd1
    SUB = "sub"          # acc  = rd0 - rd1
    MIN = "min"          # acc  = min(acc, rd0)
    MAX = "max"          # acc  = max(acc, rd0)
    ARGMIN = "argmin"    # acc, idx = min-with-index(acc, rd0)
    ARGMAX = "argmax"    # acc, idx = max-with-index(acc, rd0)
    RELU = "relu"        # acc  = max(rd0, 0)
    THRESH = "thresh"    # acc  = (rd0 > imm) ? rd0 : 0
    MASK = "mask"        # acc  = (rd1 != 0) ? rd0 : 0
    COPY = "copy"        # acc  = rd0             (memcpy)
    SET = "set"          # acc  = imm             (memset)
    AXPY = "axpy"        # acc  = imm * rd0 + rd1


#: Opcodes that reduce across innermost iterations (init_level > 0 legal).
REDUCING_OPS = {Opcode.MAC, Opcode.VSUM, Opcode.MIN, Opcode.MAX,
                Opcode.ARGMIN, Opcode.ARGMAX}
#: Opcodes reading two streams.
TWO_READ_OPS = {Opcode.MAC, Opcode.MUL, Opcode.ADD, Opcode.SUB, Opcode.MASK,
                Opcode.AXPY}
#: Opcodes reading one stream.
ONE_READ_OPS = {Opcode.VSUM, Opcode.MIN, Opcode.MAX, Opcode.ARGMIN,
                Opcode.ARGMAX, Opcode.RELU, Opcode.THRESH, Opcode.COPY}
#: Opcodes reading no stream.
ZERO_READ_OPS = {Opcode.SET}
#: Opcodes whose write-back is the index counter, not the value.
INDEX_OPS = {Opcode.ARGMIN, Opcode.ARGMAX}

#: Accumulator identity per reducing opcode.
ACC_INIT = {
    Opcode.MAC: 0.0,
    Opcode.VSUM: 0.0,
    Opcode.MIN: float("inf"),
    Opcode.MAX: float("-inf"),
    Opcode.ARGMIN: float("inf"),
    Opcode.ARGMAX: float("-inf"),
}


@dataclasses.dataclass(frozen=True)
class Agu:
    """One address-generation unit: affine pointer over the loop nest.

    ``strides[l]`` is the affine stride (in elements) applied to the counter
    of loop level ``l`` (0 = innermost). Unused levels have stride 0.
    """

    base: int = 0
    strides: Tuple[int, ...] = (0,) * NUM_LOOPS

    def __post_init__(self):
        s = tuple(self.strides) + (0,) * (NUM_LOOPS - len(self.strides))
        object.__setattr__(self, "strides", s[:NUM_LOOPS])

    def addr(self, idx: Sequence[int]) -> int:
        return self.base + sum(int(i) * int(s) for i, s in zip(idx, self.strides))


@dataclasses.dataclass(frozen=True)
class Descriptor:
    """One NTX command: a complete affine reduction loop nest.

    ``bounds[l]`` is the trip count of loop level ``l`` (0 = innermost).
    A bound of 0 is a legal zero-trip nest: the command executes no
    iterations, stores nothing and touches no addresses (the silicon's HWL
    simply never fires).

    ``init_level = L`` means the reduction spans loop levels ``0..L-1``: the
    accumulator is (re-)initialised once per iteration of the levels ``>= L``
    (so ``L = 0`` is pure streaming — no reduction — and ``L = len(bounds)``
    is one reduction over the whole nest). ``store_level = S`` (``S <= L``)
    writes the accumulator back — with ONE deferred rounding, the PCS
    property — once per iteration of levels ``>= S``; ``S < L`` streams out
    running partial reductions (prefix sums).
    """

    bounds: Tuple[int, ...]
    opcode: Opcode
    agu0: Agu = Agu()
    agu1: Agu = Agu()
    agu2: Agu = Agu()
    init_level: int = 0
    store_level: int = 0
    imm: float = 0.0
    strict_hw: bool = False

    def __post_init__(self):
        b = tuple(int(x) for x in self.bounds)
        if not 1 <= len(b) <= NUM_LOOPS:
            raise ValueError(f"need 1..{NUM_LOOPS} loops, got {len(b)}")
        if any(x < 0 for x in b):
            raise ValueError(f"loop bounds must be >= 0, got {b}")
        if self.strict_hw and any(x > MAX_HW_COUNT for x in b):
            raise ValueError(f"bound exceeds 16-bit HWL counter: {b}")
        object.__setattr__(self, "bounds", b)
        n = len(b)
        if not (0 <= self.store_level <= self.init_level <= n):
            raise ValueError("need 0 <= store_level <= init_level <= n_loops")
        if self.opcode not in REDUCING_OPS and self.init_level != 0:
            raise ValueError(f"{self.opcode} is not a reduction; init_level"
                             " must be 0")

    # ------------------------------------------------------------------
    @property
    def outer_level(self) -> int:
        return len(self.bounds) - 1

    @property
    def num_iters(self) -> int:
        n = 1
        for b in self.bounds:
            n *= b
        return n

    @property
    def reads_per_iter(self) -> int:
        if self.opcode in TWO_READ_OPS:
            return 2
        if self.opcode in ONE_READ_OPS:
            return 1
        return 0

    @property
    def num_stores(self) -> int:
        """Number of write-backs: one per iteration of levels >= store_level."""
        n = 1
        for b in self.bounds[self.store_level:]:
            n *= b
        return n

    def flops(self) -> int:
        """Flop count using the paper's convention (FMAC = 2 flops)."""
        per = {Opcode.MAC: 2, Opcode.AXPY: 2}.get(self.opcode, 1)
        return per * self.num_iters

    def bytes_moved(self, elem_bytes: int = 4) -> int:
        return elem_bytes * (self.reads_per_iter * self.num_iters
                             + self.num_stores)

    def operational_intensity(self, elem_bytes: int = 4) -> float:
        return self.flops() / max(1, self.bytes_moved(elem_bytes))


# ----------------------------------------------------------------------
# Hardware delta-step encoding <-> affine strides
# ----------------------------------------------------------------------
def strides_to_hw_steps(strides: Sequence[int], bounds: Sequence[int]):
    """Convert affine strides to the per-level delta steps the silicon uses.

    In hardware the AGU adds ``step[l]`` where ``l`` is the outermost loop
    that wrapped this cycle (l = 0 when no loop wrapped). Moving from index
    vector i to its successor where loops 0..l-1 wrap to 0 and loop l
    increments changes the affine address by
        stride[l] - sum_{k<l} (bounds[k]-1) * stride[k]
    """
    steps = []
    for l in range(len(bounds)):
        d = strides[l] - sum((bounds[k] - 1) * strides[k] for k in range(l))
        steps.append(d)
    return tuple(steps)


def hw_steps_to_strides(steps: Sequence[int], bounds: Sequence[int]):
    """Inverse of :func:`strides_to_hw_steps`."""
    strides: list = []
    for l in range(len(bounds)):
        s = steps[l] + sum((bounds[k] - 1) * strides[k] for k in range(l))
        strides.append(s)
    return tuple(strides)


# ----------------------------------------------------------------------
# Named constructors for the paper's kernel suite (§III-B)
# ----------------------------------------------------------------------
def axpy(n: int, a: float, x_base: int, y_base: int, out_base: int) -> Descriptor:
    """BLAS-1 ``y = a*x + y`` as one NTX command (1 loop, store every iter)."""
    return Descriptor(
        bounds=(n,), opcode=Opcode.AXPY, imm=a,
        agu0=Agu(x_base, (1,)), agu1=Agu(y_base, (1,)), agu2=Agu(out_base, (1,)),
    )


def gemv(m: int, n: int, a_base: int, x_base: int, y_base: int,
         lda: int | None = None) -> Descriptor:
    """BLAS-2 ``y = A @ x``: 2 loops, reduce over columns (level 0)."""
    lda = n if lda is None else lda
    return Descriptor(
        bounds=(n, m), opcode=Opcode.MAC, init_level=1, store_level=1,
        agu0=Agu(a_base, (1, lda)),   # A[row, col]
        agu1=Agu(x_base, (1, 0)),     # x[col]
        agu2=Agu(y_base, (0, 1)),     # y[row]
    )


def gemm(m: int, n: int, k: int, a_base: int, b_base: int, c_base: int) -> Descriptor:
    """BLAS-3 ``C[m,n] = A[m,k] @ B[k,n]``: 3 loops (k innermost)."""
    return Descriptor(
        bounds=(k, n, m), opcode=Opcode.MAC, init_level=1, store_level=1,
        agu0=Agu(a_base, (1, 0, k)),     # A[i, kk]
        agu1=Agu(b_base, (n, 1, 0)),     # B[kk, j]
        agu2=Agu(c_base, (0, 1, n)),     # C[i, j]
    )


def conv2d_3x3_row(w: int, kw: int, kh: int, img_base: int, ker_base: int,
                   out_base: int, img_w: int) -> Descriptor:
    """One output row of a 2-D valid convolution (paper §III-B2).

    Loops: (kernel col, kernel row, out col) — 3 of the 5 HWLs; the host
    (RISC-V / scheduler) iterates output rows and channels.
    """
    return Descriptor(
        bounds=(kw, kh, w), opcode=Opcode.MAC, init_level=2, store_level=2,
        agu0=Agu(img_base, (1, img_w, 1)),
        agu1=Agu(ker_base, (1, kw, 0)),
        agu2=Agu(out_base, (0, 0, 1)),
    )


def laplace1d(n: int, x_base: int, coef_base: int, out_base: int) -> Descriptor:
    """1-D discrete Laplace: out[i] = sum_j coef[j] * x[i+j], 3 coefficients."""
    return Descriptor(
        bounds=(3, n), opcode=Opcode.MAC, init_level=1, store_level=1,
        agu0=Agu(x_base, (1, 1)),
        agu1=Agu(coef_base, (1, 0)),
        agu2=Agu(out_base, (0, 1)),
    )


def memset(n: int, value: float, out_base: int) -> Descriptor:
    return Descriptor(bounds=(n,), opcode=Opcode.SET, imm=value,
                      agu2=Agu(out_base, (1,)))


def memcpy(n: int, src_base: int, out_base: int) -> Descriptor:
    return Descriptor(bounds=(n,), opcode=Opcode.COPY,
                      agu0=Agu(src_base, (1,)), agu2=Agu(out_base, (1,)))


def relu(n: int, src_base: int, out_base: int) -> Descriptor:
    return Descriptor(bounds=(n,), opcode=Opcode.RELU,
                      agu0=Agu(src_base, (1,)), agu2=Agu(out_base, (1,)))


def argmax(n: int, src_base: int, out_base: int) -> Descriptor:
    """Index of the maximum of a vector (one reduction over the whole nest)."""
    return Descriptor(bounds=(n,), opcode=Opcode.ARGMAX, init_level=1,
                      store_level=1, agu0=Agu(src_base, (1,)),
                      agu2=Agu(out_base, (0,)))
