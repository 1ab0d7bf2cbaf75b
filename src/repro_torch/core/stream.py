"""Fused command-stream execution: the paper's §II-E offload model.

Counterpart of ``repro.core.stream``. On silicon the RISC-V enqueues
descriptors while the NTX FPUs stream — the scratchpad keeps operands
resident *across* commands, so a chain of commands costs one DMA in and
one DMA out, not one round trip per command. ``dispatch.dispatch`` loses
that: it gathers and scatters through the flat memory for every
descriptor.

:class:`CommandStream` restores it on the card. It takes an ordered descriptor
list, does dependency analysis over the AGUs' affine address ranges, and
fuses compatible runs:

* elementwise -> elementwise chains whose intermediate value is carried
  in-place (every command in the run writes the same region) run as ONE
  kernel pass (``ops.elementwise_chain``): one gather, one scatter,
  the chain value never touching HBM in between;
* a MAC descriptor in canonical GEMM form followed by streaming commands
  over its output region becomes a GEMM with a *fused epilogue*
  (``ops.gemm(..., epilogue=...)``) applied at the store step — the exact
  point the paper's store path rounds and writes back once.

Runs where fusion is illegal (address ranges alias, shapes disagree, an
opcode has no epilogue form) fall back to today's per-descriptor
``dispatch`` path, so a stream is always semantically equal to folding
``dispatch`` over its descriptors — dispatch's functional
gather-compute-scatter semantics, which also match the sequential
``engine.execute`` oracle except for descriptors whose operand stream
reads *behind* its own write head inside one command (the cycle-by-cycle
engine observes its own partial writes there; the functional paths do
not — a property of dispatch, not of fusion).

Groups store into the memory image in place (``dispatch`` does too):
``CommandStream.execute`` updates and returns the image it is given.

Every group also runs over L lanes at once (``run_lanes``): an (L, W)
stack of memory windows that share one rebased program, the
multi-cluster scheduler's ``vmap`` transport. A fused chain, a chain
with a reduction tail, or a single streaming command or reduction is
then one streaming-kernel launch with rows = L; a fused GEMM one GEMM
launch of L lanes. ``run`` is the one-lane case.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import ops
from .dispatch import _EW_OPS, _match_gemm, dispatch_lanes, lane_gemm
from .descriptor import Agu, Descriptor, Opcode

_ELEM_BYTES = 4

#: streaming opcodes with a fused-epilogue form over a GEMM output
#: (opcode -> epilogue kind); 2-read kinds stream one external operand.
_EPILOGUE_FORMS = {Opcode.RELU: "relu", Opcode.THRESH: "thresh",
                   Opcode.ADD: "residual", Opcode.MUL: "mul",
                   Opcode.SUB: "sub", Opcode.MASK: "mask",
                   Opcode.AXPY: "axpy"}
#: epilogue kinds streaming a full (m, n) matrix operand
_MATRIX_EPILOGUES = ("residual", "mul", "sub", "mask")

#: reducing opcodes with a fused chain-tail form (chain ->
#: VSUM/MAX/MIN/ARGMAX/ARGMIN): the chain value is reduced in-register,
#: one pass total; the arg tails carry the index counter too.
_REDUCE_TAILS = {Opcode.VSUM: "sum", Opcode.MAX: "max", Opcode.MIN: "min",
                 Opcode.ARGMAX: "argmax", Opcode.ARGMIN: "argmin"}


# ----------------------------------------------------------------------
# AGU address-range analysis
# ----------------------------------------------------------------------
def agu_span(agu: Agu, bounds: Sequence[int]) -> Tuple[int, int]:
    """Half-open [lo, hi) range of addresses the AGU can touch over the
    nest — the conservative footprint used for dependency analysis.

    A zero-trip nest (any bound <= 0) touches NO addresses and returns the
    empty span (base, base); naively folding ``stride * (b - 1)`` would add
    ``-stride`` and could shrink ``lo`` below base (or overstate ``hi``),
    manufacturing phantom overlaps and false dependency edges. Zero-stride
    levels re-read one address and never widen the span.
    """
    if any(b <= 0 for b in bounds):
        return agu.base, agu.base
    lo = hi = agu.base
    for b, s in zip(bounds, agu.strides):
        if s == 0 or b == 1:
            continue
        d = s * (b - 1)
        if d < 0:
            lo += d
        else:
            hi += d
    return lo, hi + 1


def span_empty(a: Tuple[int, int]) -> bool:
    """True for a span touching no addresses (zero-trip nests)."""
    return a[0] >= a[1]


def spans_overlap(a: Tuple[int, int], b: Tuple[int, int]) -> bool:
    """Half-open interval intersection; empty spans overlap nothing."""
    if span_empty(a) or span_empty(b):
        return False
    return a[0] < b[1] and b[0] < a[1]


def write_span(desc: Descriptor) -> Tuple[int, int]:
    return agu_span(desc.agu2, desc.bounds)


def desc_spans(desc: Descriptor) -> Tuple[List[Tuple[int, int]],
                                          Tuple[int, int]]:
    """(read spans, write span) — the conservative AGU footprints."""
    reads: List[Tuple[int, int]] = []
    if desc.reads_per_iter >= 1:
        reads.append(agu_span(desc.agu0, desc.bounds))
    if desc.reads_per_iter >= 2:
        reads.append(agu_span(desc.agu1, desc.bounds))
    return reads, agu_span(desc.agu2, desc.bounds)


def merge_spans(spans: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Union of half-open intervals: sorted, empties dropped,
    overlaps/adjacency merged."""
    out: List[Tuple[int, int]] = []
    for lo, hi in sorted(s for s in spans if not span_empty(s)):
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def program_spans(descs: Sequence[Descriptor]) -> Tuple[
        List[Tuple[int, int]], List[Tuple[int, int]]]:
    """(merged read spans, merged write spans) of a descriptor program —
    what the multi-cluster scheduler sizes handoff DMAs with."""
    reads: List[Tuple[int, int]] = []
    writes: List[Tuple[int, int]] = []
    for d in descs:
        r, w = desc_spans(d)
        reads.extend(r)
        writes.append(w)
    return merge_spans(reads), merge_spans(writes)


def dispatch_bytes(desc: Descriptor, elem_bytes: int = _ELEM_BYTES) -> int:
    """Memory traffic of ONE per-descriptor dispatch: each operand array
    footprint gathered once, the output footprint scattered once. (This is
    HBM/DMA traffic; ``Descriptor.bytes_moved`` is the paper's
    per-iteration TCDM stream accounting — a different base.)"""
    span = lambda agu: agu_span(agu, desc.bounds)
    total = span(desc.agu2)[1] - span(desc.agu2)[0]
    if desc.reads_per_iter >= 1:
        s = span(desc.agu0)
        total += s[1] - s[0]
    if desc.reads_per_iter >= 2:
        s = span(desc.agu1)
        total += s[1] - s[0]
    return elem_bytes * total


def _is_stream_ew(desc: Descriptor) -> bool:
    """Contiguous 1-loop streaming command (init = store = level 0)."""
    return (desc.opcode in _EW_OPS
            and len(desc.bounds) == 1
            and desc.bounds[0] >= 1
            and desc.init_level == 0 and desc.store_level == 0
            and desc.agu2.strides[0] == 1
            and (desc.reads_per_iter < 1 or desc.agu0.strides[0] == 1)
            and (desc.reads_per_iter < 2 or desc.agu1.strides[0] == 1))


def _match_bias_add(desc: Descriptor, m: int, n: int,
                    c_base: int) -> Optional[int]:
    """ADD of a broadcast row vector over the (m, n) region at ``c_base``:
    bounds (n, m), AGU0/AGU2 walking the matrix, AGU1 re-reading an
    n-vector each row. Returns the bias base address."""
    if (desc.opcode is not Opcode.ADD or len(desc.bounds) != 2
            or desc.init_level != 0 or desc.store_level != 0
            or desc.bounds != (n, m)):
        return None
    if (desc.agu0.base == c_base and desc.agu0.strides[:2] == (1, n)
            and desc.agu2.base == c_base and desc.agu2.strides[:2] == (1, n)
            and desc.agu1.strides[:2] == (1, 0)):
        return desc.agu1.base
    return None


# ----------------------------------------------------------------------
# Execution groups
# ----------------------------------------------------------------------
@dataclasses.dataclass
class SequentialGroup:
    """Per-descriptor fallback: exactly today's dispatch path."""

    descs: List[Descriptor]
    fused: bool = False

    def bytes_moved(self) -> int:
        return sum(dispatch_bytes(d) for d in self.descs)

    def run(self, mem: torch.Tensor, stats: dict) -> torch.Tensor:
        self.run_lanes(mem[None], stats)
        return mem

    def run_lanes(self, stack: torch.Tensor, stats: dict) -> torch.Tensor:
        for d in self.descs:
            dispatch_lanes(d, stack)
            stats["gathers"] += min(1, d.reads_per_iter)
            stats["operand_gathers"] += max(0, d.reads_per_iter - 1)
            stats["scatters"] += 1
        return stack


@dataclasses.dataclass
class FusedChain:
    """Elementwise chain carried in registers: one gather + one scatter."""

    descs: List[Descriptor]
    n: int
    x_base: int
    out_base: int
    stages: List[Tuple[str, float]]      # ops for ops.elementwise_chain
    y_bases: List[int]                   # external operand per 2-read stage
    fused: bool = True

    def bytes_moved(self) -> int:
        return _ELEM_BYTES * self.n * (2 + len(self.y_bases))

    def run(self, mem: torch.Tensor, stats: dict) -> torch.Tensor:
        self.run_lanes(mem[None], stats)
        return mem

    def run_lanes(self, stack: torch.Tensor, stats: dict) -> torch.Tensor:
        n = self.n
        x = stack[:, self.x_base:self.x_base + n]
        ys = tuple(stack[:, b:b + n] for b in self.y_bases)
        out = ops.elementwise_chain(self.stages, x, ys)
        stats["gathers"] += 1
        stats["operand_gathers"] += len(ys)
        stats["scatters"] += 1
        stack[:, self.out_base:self.out_base + n] = out
        return stack


@dataclasses.dataclass
class FusedChainReduce:
    """Elementwise chain with a reduction tail: the chain value is written
    back once AND reduced in-register in the same pass (softmax-style
    numerator/denominator patterns; argmax/argmin sampling tails)."""

    descs: List[Descriptor]
    n: int
    x_base: int
    out_base: int
    stages: List[Tuple[str, float]]
    y_bases: List[int]
    red_op: str                # "sum" | "max" | "min" | "argmax" | "argmin"
    red_base: int                        # scalar output address
    fused: bool = True

    def bytes_moved(self) -> int:
        return _ELEM_BYTES * (self.n * (2 + len(self.y_bases)) + 1)

    def run(self, mem: torch.Tensor, stats: dict) -> torch.Tensor:
        self.run_lanes(mem[None], stats)
        return mem

    def run_lanes(self, stack: torch.Tensor, stats: dict) -> torch.Tensor:
        n = self.n
        x = stack[:, self.x_base:self.x_base + n]
        ys = tuple(stack[:, b:b + n] for b in self.y_bases)
        out, red = ops.chain_reduce(self.stages, self.red_op, x, ys)
        stats["gathers"] += 1
        stats["operand_gathers"] += len(ys)
        stats["scatters"] += 2
        stack[:, self.out_base:self.out_base + n] = out
        stack[:, self.red_base] = red.to(torch.float32)
        return stack


@dataclasses.dataclass
class FusedGemm:
    """GEMM whose trailing streaming commands run as a store epilogue."""

    descs: List[Descriptor]
    m: int
    n: int
    k: int
    stages: List[Tuple[str, float, Optional[int]]]   # (kind, imm, operand base)
    fused: bool = True

    def bytes_moved(self) -> int:
        ep_elems = sum(self.n if kind == "bias" else self.m * self.n
                       for kind, _, base in self.stages if base is not None)
        return _ELEM_BYTES * ((self.m + self.n) * self.k
                              + ep_elems + self.m * self.n)

    def run(self, mem: torch.Tensor, stats: dict) -> torch.Tensor:
        self.run_lanes(mem[None], stats)
        return mem

    def run_lanes(self, stack: torch.Tensor, stats: dict) -> torch.Tensor:
        d0 = self.descs[0]
        m, n, k = self.m, self.n, self.k
        a, b = d0.agu0.base, d0.agu1.base
        A = stack[:, a:a + m * k].unflatten(1, (m, k))
        B = stack[:, b:b + k * n].unflatten(1, (k, n))
        ep = []
        for kind, imm, base in self.stages:
            if kind == "bias":
                ep.append(("bias", stack[:, base:base + n]))
                stats["operand_gathers"] += 1
            elif kind in _MATRIX_EPILOGUES:
                ep.append((kind,
                           stack[:, base:base + m * n].unflatten(1, (m, n))))
                stats["operand_gathers"] += 1
            elif kind in ("scale", "thresh"):
                ep.append((kind, imm))
            else:
                ep.append((kind,))
        C = lane_gemm(A, B, epilogue=ep)
        stats["gathers"] += 2
        stats["scatters"] += 1
        c = d0.agu2.base
        stack[:, c:c + m * n] = C.reshape(stack.shape[0], m * n)
        return stack


# ----------------------------------------------------------------------
# The planner
# ----------------------------------------------------------------------
def _match_reduce_tail(d: Descriptor, n: int, t_base: int) -> Optional[str]:
    """A VSUM/MAX/MIN/ARGMAX/ARGMIN over exactly the chain region T, one
    reduction over the whole stream with a single scalar store — the
    softmax-style tail (the arg forms store the winning index, the
    sampling tail). Returns the reduce op name, or None."""
    if (d.opcode in _REDUCE_TAILS and len(d.bounds) == 1
            and d.bounds[0] == n and d.init_level == 1 and d.store_level == 1
            and d.agu0.base == t_base and d.agu0.strides[0] == 1
            and d.agu2.strides[0] == 0):
        return _REDUCE_TAILS[d.opcode]
    return None


def _plan_chain(descs: List[Descriptor], i: int):
    """Greedy in-place elementwise chain starting at descs[i], with an
    optional fused reduction tail.

    Legality (vs. folding engine.execute): every command writes the SAME
    contiguous region T (so skipping the intermediate stores is invisible
    — each is overwritten by the final one), every follow-up reads its
    primary stream from T (value carried in registers), and every external
    second operand is disjoint from T (it must observe pre-chain memory).
    A VSUM/MAX/MIN tail reading exactly T consumes the carried value in the
    same pass; its scalar store runs last, matching sequential order.
    """
    d0 = descs[i]
    if not _is_stream_ew(d0):
        return None
    n = d0.bounds[0]
    t_base = d0.agu2.base
    t_span = write_span(d0)
    chain = [d0]
    stages = [(_EW_OPS[d0.opcode], d0.imm)]
    y_bases = []
    if d0.reads_per_iter >= 2:
        y_bases.append(d0.agu1.base)
    j = i + 1
    while j < len(descs):
        d = descs[j]
        if not (_is_stream_ew(d) and d.bounds[0] == n
                and d.agu2.base == t_base
                and d.reads_per_iter >= 1 and d.agu0.base == t_base):
            break
        if d.reads_per_iter >= 2:
            if spans_overlap(agu_span(d.agu1, d.bounds), t_span):
                break                      # operand aliases the carried value
            y_bases.append(d.agu1.base)
        chain.append(d)
        stages.append((_EW_OPS[d.opcode], d.imm))
        j += 1
    x_base = d0.agu0.base if d0.reads_per_iter >= 1 else t_base
    if j < len(descs):
        red = _match_reduce_tail(descs[j], n, t_base)
        if red is not None:
            return FusedChainReduce(chain + [descs[j]], n, x_base, t_base,
                                    stages, y_bases, red,
                                    descs[j].agu2.base)
    if len(chain) < 2:
        return None
    return FusedChain(chain, n, x_base, t_base, stages, y_bases)


def _plan_gemm(descs: List[Descriptor], i: int) -> Optional[FusedGemm]:
    """GEMM + fused-epilogue run starting at descs[i]."""
    if descs[i].num_iters == 0:
        return None      # zero-trip MAC is a no-op; fusing would write C
    gm = _match_gemm(descs[i])
    if gm is None:
        return None
    m, n, k = gm
    c_base = descs[i].agu2.base
    c_span = write_span(descs[i])
    group = [descs[i]]
    stages: List[Tuple[str, float, Optional[int]]] = []
    j = i + 1
    while j < len(descs):
        d = descs[j]
        bias_base = _match_bias_add(d, m, n, c_base)
        if bias_base is not None:
            if spans_overlap(agu_span(d.agu1, d.bounds), c_span):
                break
            stages.append(("bias", 0.0, bias_base))
            group.append(d)
            j += 1
            continue
        kind = _EPILOGUE_FORMS.get(d.opcode)
        if (kind is None or not _is_stream_ew(d) or d.bounds[0] != m * n
                or d.agu0.base != c_base or d.agu2.base != c_base):
            break
        if d.reads_per_iter >= 2:
            if spans_overlap(agu_span(d.agu1, d.bounds), c_span):
                break
        if kind == "axpy":               # imm * C + y: scale then residual
            stages.append(("scale", d.imm, None))
            stages.append(("residual", 0.0, d.agu1.base))
        elif kind in _MATRIX_EPILOGUES:
            stages.append((kind, 0.0, d.agu1.base))
        else:
            stages.append((kind, d.imm, None))
        group.append(d)
        j += 1
    if len(group) < 2:
        return None
    return FusedGemm(group, m, n, k, stages)


def plan_stream(descs: Sequence[Descriptor]) -> List[object]:
    """Partition a descriptor stream into fused and sequential groups."""
    descs = list(descs)
    groups: List[object] = []
    pending: List[Descriptor] = []

    def flush():
        if pending:
            groups.append(SequentialGroup(list(pending)))
            pending.clear()

    i = 0
    while i < len(descs):
        g = _plan_gemm(descs, i) or _plan_chain(descs, i)
        if g is not None:
            flush()
            groups.append(g)
            i += len(g.descs)
        else:
            pending.append(descs[i])
            i += 1
    flush()
    return groups


# ----------------------------------------------------------------------
# The stream
# ----------------------------------------------------------------------
class CommandStream:
    """An ordered NTX descriptor stream with fused execution.

    ``execute`` is semantically equivalent to folding ``dispatch`` (and
    therefore ``engine.execute``) over the descriptors; ``stats`` after a
    run records how much memory traffic fusion removed.
    """

    def __init__(self, descs: Sequence[Descriptor]):
        self.descs = list(descs)
        self.groups = plan_stream(self.descs)
        self.stats = self._fresh_stats()

    def _fresh_stats(self) -> dict:
        return {"n_descriptors": len(self.descs),
                "n_groups": len(self.groups),
                "n_fused_groups": sum(1 for g in self.groups if g.fused),
                "gathers": 0, "operand_gathers": 0, "scatters": 0}

    # -- analysis ------------------------------------------------------
    def read_spans(self) -> List[Tuple[int, int]]:
        """Merged read footprint of the whole stream (handoff sizing)."""
        return program_spans(self.descs)[0]

    def write_spans(self) -> List[Tuple[int, int]]:
        """Merged write footprint of the whole stream (handoff sizing)."""
        return program_spans(self.descs)[1]

    def bytes_moved(self) -> int:
        """Planned bytes with fusion (vs. ``bytes_sequential``)."""
        return sum(g.bytes_moved() for g in self.groups)

    def bytes_sequential(self) -> int:
        """Traffic of per-descriptor dispatch: one array-footprint round
        trip per command (same accounting base as ``bytes_moved``)."""
        return sum(dispatch_bytes(d) for d in self.descs)

    def flops(self) -> int:
        return sum(d.flops() for d in self.descs)

    # -- execution -----------------------------------------------------
    def execute(self, mem: torch.Tensor) -> torch.Tensor:
        """Run the groups over the fp32 image ``mem``, in place."""
        self.stats = self._fresh_stats()
        for g in self.groups:
            mem = g.run(mem, self.stats)
        return mem
