"""Out-of-core tiled execution: streaming oversize programs through TCDM.

Counterpart of ``repro.core.tiling``: the same tile schedule, bank
addresses and ``stats`` for the same program and memory spec.

Every execution layer below this one assumes the program's working set is
cluster-resident — the silent unfaithfulness this module removes. On the
paper's machine (§II-E) the RISC-V walks a tile loop: the DMA engine
copies tile i+1 of every operand into one half of the double-buffered
TCDM while the NTX FPUs stream tile i from the other half, and copies
tile i-1's results back out. Steady-state time per tile is
max(compute, dma); without the DMA engine the phases add.

:class:`TilePlan` rewrites a descriptor program into exactly that loop:

* AGU spans are split along the **outermost hardware-loop dimension**
  into chunks whose staged footprint (two buffers per operand) fits the
  :class:`~repro_torch.core.memory.NtxMemSpec` budget;
* each tile iteration becomes real descriptors — ``COPY`` commands are
  the DMA primitive (the same handoff idiom the stage pipeline uses for
  inter-cluster moves), bracketing the original command rebased into the
  staging bank — so ``plan.descriptors`` is itself an ordinary descriptor
  program over the extended memory image;
* in-place elementwise chains tile as a **group**: the carried region
  stays bank-resident across the whole chain within each tile (the §II-E
  fusion, preserved through the tile loop);
* a software-pipelined schedule (``execute(..., overlap=True)``) issues
  tile i+1's DMA-in into the *other* bank before tile i's compute; on
  the card the DMA-in copies go on a copy stream and the compute and
  DMA-out on the compute stream, CUDA events carrying each dependency,
  so data movement hides under compute; ``overlap=False`` emulates a
  machine with no DMA engine — every phase completes
  (``torch.cuda.synchronize``) before the next starts.

Legality keeps everything bit-equal to serial execution: only outer
loops *outside* the reduction (``init_level <= outer``) are split, so
tiles never re-associate the paper's fp32 accumulate order; descriptors
whose reads alias their write without being identical (shifted copies),
or whose single-iteration footprint exceeds the budget, stay resident
("spill" tiles, counted in ``stats``) and run on the global image
directly. Reductions over a whole oversize buffer keep their one-command
PCS accumulation — on silicon the DMA streams chunks under the running
accumulator; here the resident fallback models the same single ordered
reduction.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .descriptor import Agu, Descriptor, Opcode
from .memory import NtxMemSpec, PAPER_MEM, working_set_spans
from .stream import (CommandStream, FusedChain, FusedChainReduce, agu_span,
                     desc_spans, plan_stream, spans_overlap)

Span = Tuple[int, int]

_ELEM_BYTES = 4


def _align_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def _hull_len(span: Span) -> int:
    return max(0, span[1] - span[0])


def _copy(n: int, src: int, dst: int) -> Descriptor:
    """The DMA primitive: one contiguous COPY command."""
    return Descriptor(bounds=(n,), opcode=Opcode.COPY,
                      agu0=Agu(src, (1,)), agu2=Agu(dst, (1,)))


# ----------------------------------------------------------------------
# One tile iteration
# ----------------------------------------------------------------------
@dataclasses.dataclass
class TileIteration:
    """DMA-in -> compute -> DMA-out, one trip through the staging bank.

    ``bank`` is the double-buffer half this tile stages into (-1 for
    resident/spill tiles that run on the global image). ``in_hulls`` /
    ``out_hulls`` are the *global* [lo, hi) element spans the DMA phases
    touch — what the overlap scheduler checks before prefetching."""

    item: int
    index: int
    bank: int
    outer: Span
    dma_in: List[Descriptor]
    compute: List[Descriptor]
    dma_out: List[Descriptor]
    in_hulls: List[Span]
    out_hulls: List[Span]
    footprint_elems: int
    compute_stream: Optional[CommandStream] = None

    @property
    def in_bytes(self) -> int:
        return _ELEM_BYTES * sum(_hull_len(s) for s in self.in_hulls)

    @property
    def out_bytes(self) -> int:
        return _ELEM_BYTES * sum(_hull_len(s) for s in self.out_hulls)

    def flops(self) -> int:
        return sum(d.flops() for d in self.compute)


# ----------------------------------------------------------------------
# Splittability analysis (per descriptor)
# ----------------------------------------------------------------------
def _active_agus(d: Descriptor) -> List[Tuple[str, Agu]]:
    out: List[Tuple[str, Agu]] = []
    if d.reads_per_iter >= 1:
        out.append(("agu0", d.agu0))
    if d.reads_per_iter >= 2:
        out.append(("agu1", d.agu1))
    out.append(("agu2", d.agu2))
    return out


def _agu_key(a: Agu, n_levels: int) -> tuple:
    return (a.base,) + tuple(a.strides[:n_levels])


def splittable(d: Descriptor) -> bool:
    """Can the outermost hardware loop be split without changing bits?

    Requires (1) the outer loop to sit outside the reduction
    (``init_level <= outer``) so no accumulate order is re-associated,
    (2) consecutive outer iterations to write disjoint hulls (outer
    write stride covers the inner write extent), and (3) every read AGU
    to be either *identical* to the write AGU (a pure in-place stream)
    or hull-disjoint from the write span — a partially-overlapping
    shifted read would observe other tiles' writes."""
    if d.num_iters == 0:
        return False
    L = len(d.bounds) - 1
    if d.bounds[L] < 2 or d.init_level > L:
        return False
    w = d.agu2
    sw = w.strides[L]
    inner_w = _hull_len(agu_span(w, d.bounds[:L] + (1,)))
    if sw <= 0 or sw < inner_w:
        return False
    n_levels = len(d.bounds)
    wkey = _agu_key(w, n_levels)
    wspan = agu_span(w, d.bounds)
    for _, a in _active_agus(d)[:-1]:          # read AGUs
        if _agu_key(a, n_levels) == wkey:
            continue
        if spans_overlap(agu_span(a, d.bounds), wspan):
            return False
    return True


# ----------------------------------------------------------------------
# Item planners: how one descriptor (or fused chain) becomes tiles
# ----------------------------------------------------------------------
class _DescItem:
    """Per-descriptor tiling along the outermost hardware loop."""

    def __init__(self, desc: Descriptor, budget: int):
        self.desc = desc
        self.descs = [desc]
        L = self.L = len(desc.bounds) - 1
        B = desc.bounds[L]
        agus = _active_agus(desc)
        # unique slots; identical read/write AGUs share one (in-place)
        self.slot_of: Dict[str, int] = {}
        self.slots: List[Agu] = []
        keys: Dict[tuple, int] = {}
        for attr, a in agus:
            k = _agu_key(a, len(desc.bounds))
            if k not in keys:
                keys[k] = len(self.slots)
                self.slots.append(a)
            self.slot_of[attr] = keys[k]
        self.spill = False
        if desc.num_iters == 0:
            # zero-trip nests are no-ops; run resident, touch nothing
            self.spill, self.chunk = True, B
        elif splittable(desc):
            if self._footprint(1) > budget:
                self.spill, self.chunk = True, B
            else:
                lo, hi = 1, B
                while lo < hi:                 # largest chunk that fits
                    mid = (lo + hi + 1) // 2
                    if self._footprint(mid) <= budget:
                        lo = mid
                    else:
                        hi = mid - 1
                self.chunk = lo
        else:
            self.chunk = B
            self.spill = self._footprint(B) > budget
        if self.spill:
            self.slot_sizes = [0] * len(self.slots)
            self.footprint = 0
        else:
            self.slot_sizes = [self._hull_size(a, self.chunk)
                               for a in self.slots]
            self.footprint = sum(self.slot_sizes)
        self.slot_offs = []
        off = 0
        for sz in self.slot_sizes:
            self.slot_offs.append(off)
            off += sz
        self.n_tiles = 1 if self.spill else -(-B // self.chunk)

    def _hull_size(self, a: Agu, c: int) -> int:
        return _hull_len(agu_span(a, self.desc.bounds[:self.L] + (c,)))

    def _footprint(self, c: int) -> int:
        return sum(self._hull_size(a, c) for a in self.slots)

    def materialize(self, item_idx: int, t: int, bank: int,
                    bank_base: int) -> TileIteration:
        d = self.desc
        if self.spill:
            reads, wr = desc_spans(d)
            return TileIteration(item_idx, t, -1, (0, d.bounds[self.L]),
                                 [], [d], [], list(reads), [wr],
                                 self.footprint)
        L, c = self.L, self.chunk
        o0 = t * c
        o1 = min(d.bounds[L], o0 + c)
        bounds = d.bounds[:L] + (o1 - o0,)
        dma_in: List[Descriptor] = []
        in_hulls: List[Span] = []
        hulls: List[Span] = []
        for si, a in enumerate(self.slots):
            ra_base = a.base + o0 * a.strides[L]
            hull = agu_span(dataclasses.replace(a, base=ra_base), bounds)
            hulls.append(hull)
            addr = bank_base + self.slot_offs[si]
            dma_in.append(_copy(_hull_len(hull), hull[0], addr))
            in_hulls.append(hull)
        kw = {}
        for attr, si in self.slot_of.items():
            a = getattr(d, attr)
            ra_base = a.base + o0 * a.strides[L]
            kw[attr] = dataclasses.replace(
                a, base=bank_base + self.slot_offs[si]
                + (ra_base - hulls[si][0]))
        comp = dataclasses.replace(d, bounds=bounds, **kw)
        wsi = self.slot_of["agu2"]
        whull = hulls[wsi]
        dma_out = [_copy(_hull_len(whull),
                         bank_base + self.slot_offs[wsi], whull[0])]
        return TileIteration(item_idx, t, bank, (o0, o1), dma_in, [comp],
                             dma_out, in_hulls, [whull], self.footprint)


class _ChainItem:
    """Group tiling of an in-place elementwise chain: the carried region
    stays bank-resident across every command of the chain within a tile
    — command fusion preserved through the tile loop (§II-E)."""

    def __init__(self, chain: Sequence[Descriptor], n: int, x_base: int,
                 t_base: int, y_bases: Sequence[int], budget: int):
        self.descs = list(chain)
        self.n, self.x_base, self.t_base = n, x_base, t_base
        self.y_bases = list(y_bases)
        # slot 0 is always the carried region T; x (when distinct) and
        # each distinct external operand get their own slot
        bases = [t_base]
        if x_base != t_base:
            bases.append(x_base)
        for b in y_bases:
            if b not in bases:
                bases.append(b)
        self.slot_bases = bases
        # T is fully written by the chain head unless the head reads it —
        # through its primary stream (in place) or a second operand — so
        # the DMA-in of T is skipped only for the pure produce case
        self.load_t = (x_base == t_base) or (t_base in self.y_bases)
        self.spill = len(bases) > budget
        self.chunk = n if self.spill else max(1, min(n, budget // len(bases)))
        self.footprint = 0 if self.spill else self.chunk * len(bases)
        self.n_tiles = 1 if self.spill else -(-n // self.chunk)

    @classmethod
    def applicable(cls, g, budget: int) -> Optional["_ChainItem"]:
        """A FusedChain group tiles as a unit iff every input stream —
        the primary ``x`` AND each external operand — is either exactly
        the carried region or disjoint from it. A *partial* overlap
        would observe earlier tiles' write-backs; those groups fall back
        to per-descriptor items, whose aliasing analysis keeps them
        resident."""
        t_span = (g.out_base, g.out_base + g.n)
        for base in [g.x_base] + list(g.y_bases):
            if base != g.out_base and spans_overlap((base, base + g.n),
                                                    t_span):
                return None
        return cls(g.descs, g.n, g.x_base, g.out_base, g.y_bases, budget)

    def materialize(self, item_idx: int, t: int, bank: int,
                    bank_base: int) -> TileIteration:
        if self.spill:
            reads = [(self.x_base, self.x_base + self.n)]
            reads += [(b, b + self.n) for b in self.y_bases]
            return TileIteration(
                item_idx, t, -1, (0, self.n), [], list(self.descs), [],
                reads, [(self.t_base, self.t_base + self.n)], 0,
                compute_stream=CommandStream(self.descs))
        o0 = t * self.chunk
        o1 = min(self.n, o0 + self.chunk)
        c = o1 - o0
        slot_addr = {b: bank_base + i * self.chunk
                     for i, b in enumerate(self.slot_bases)}
        dma_in: List[Descriptor] = []
        in_hulls: List[Span] = []
        for b in self.slot_bases:
            if b == self.t_base and not self.load_t:
                continue
            dma_in.append(_copy(c, b + o0, slot_addr[b]))
            in_hulls.append((b + o0, b + o1))
        comp: List[Descriptor] = []
        for d in self.descs:
            kw = {"bounds": (c,),
                  "agu2": dataclasses.replace(d.agu2,
                                              base=slot_addr[self.t_base])}
            if d.reads_per_iter >= 1:
                kw["agu0"] = dataclasses.replace(
                    d.agu0, base=slot_addr[d.agu0.base])
            if d.reads_per_iter >= 2:
                kw["agu1"] = dataclasses.replace(
                    d.agu1, base=slot_addr[d.agu1.base])
            comp.append(dataclasses.replace(d, **kw))
        dma_out = [_copy(c, slot_addr[self.t_base], self.t_base + o0)]
        return TileIteration(
            item_idx, t, bank, (o0, o1), dma_in, comp, dma_out, in_hulls,
            [(self.t_base + o0, self.t_base + o1)], self.footprint,
            compute_stream=CommandStream(comp))


# ----------------------------------------------------------------------
# The plan
# ----------------------------------------------------------------------
class TilePlan:
    """Rewrite of one descriptor program into double-buffered tile loops.

    The staging banks live past the end of the memory image:
    ``[scratch_base, scratch_base + 2*bank_elems)``; ``execute`` pads the
    image, runs the tile schedule and slices the scratch back off.
    ``descriptors`` is the equivalent *serial* program over the extended
    image — every tile's DMA-in, compute and DMA-out commands flattened
    in order — which is what the partition property tests check.
    """

    def __init__(self, descs: Sequence[Descriptor],
                 mem: NtxMemSpec = PAPER_MEM,
                 image_elems: Optional[int] = None):
        self.descs = list(descs)
        self.mem = mem
        spans = working_set_spans(self.descs)
        touched_hi = spans[-1][1] if spans else 0
        if image_elems is None:
            image_elems = touched_hi
        if image_elems < touched_hi:
            raise ValueError(f"image_elems {image_elems} < program "
                             f"footprint {touched_hi}")
        self.image_elems = int(image_elems)
        budget = mem.buffer_budget_elems

        items: List[object] = []
        for g in plan_stream(self.descs):
            chain = None
            if isinstance(g, FusedChain):
                chain = _ChainItem.applicable(g, budget)
            elif isinstance(g, FusedChainReduce):
                # tile the chain, keep the one-command reduction tail
                # resident: its PCS accumulator must sweep the whole
                # region in order (bit-equal accumulate order)
                body = FusedChain(g.descs[:-1], g.n, g.x_base, g.out_base,
                                  g.stages, g.y_bases)
                chain = _ChainItem.applicable(body, budget)
                if chain is not None:
                    items.append(chain)
                    items.append(_DescItem(g.descs[-1], budget))
                    continue
            if chain is not None:
                items.append(chain)
            else:
                for d in g.descs:
                    items.append(_DescItem(d, budget))
        self.items = items

        self.bank_elems = _align_up(
            max((it.footprint for it in items), default=0), 8)
        self.scratch_base = _align_up(self.image_elems, 8)
        self.total_elems = self.scratch_base + 2 * self.bank_elems

        self.tiles: List[TileIteration] = []
        g_idx = 0
        for ii, it in enumerate(items):
            for t in range(it.n_tiles):
                bank = -1 if it.spill else g_idx % 2
                base = self.scratch_base + max(0, bank) * self.bank_elems
                self.tiles.append(it.materialize(ii, t, bank, base))
                if not it.spill:
                    g_idx += 1

        # overlap legality per boundary: tile g+1's DMA-in may run ahead
        # of tile g's compute/DMA-out iff it reads nothing tile g writes
        # (the banks already differ by construction)
        self.can_prefetch = []
        for g in range(len(self.tiles) - 1):
            cur, nxt = self.tiles[g], self.tiles[g + 1]
            ok = bool(nxt.dma_in) and not any(
                spans_overlap(r, w)
                for r in nxt.in_hulls for w in cur.out_hulls)
            self.can_prefetch.append(ok)

        n_spill = sum(1 for it in items if it.spill)
        self.stats = {
            "n_descriptors": len(self.descs),
            "n_items": len(items),
            "n_tiles": len(self.tiles),
            "n_spill_items": n_spill,
            "chunk_elems": [getattr(it, "chunk", 0) for it in items],
            "bank_elems": self.bank_elems,
            "scratch_elems": 2 * self.bank_elems,
            "capacity_bytes": mem.tcdm_bytes,
            "working_set_bytes": _ELEM_BYTES * sum(hi - lo
                                                   for lo, hi in spans),
            "dma_in_bytes": sum(t.in_bytes for t in self.tiles),
            "dma_out_bytes": sum(t.out_bytes for t in self.tiles),
            "max_tile_bytes": _ELEM_BYTES * max(
                (t.footprint_elems for t in self.tiles), default=0),
            "overlap_used": None,
        }

    # -- analysis ------------------------------------------------------
    @property
    def descriptors(self) -> List[Descriptor]:
        out: List[Descriptor] = []
        for t in self.tiles:
            out.extend(t.dma_in)
            out.extend(t.compute)
            out.extend(t.dma_out)
        return out

    def fits(self) -> bool:
        return self.stats["working_set_bytes"] <= self.mem.tcdm_bytes

    # -- execution -----------------------------------------------------
    def _phase(self, mem: torch.Tensor, tile: TileIteration,
               phase: Sequence[Descriptor], is_compute: bool) -> None:
        """One phase of a tile over the extended image, in place: the
        DMA phases are the COPY descriptors ``dispatch`` sends to the
        streaming kernel."""
        from .dispatch import dispatch
        if is_compute and tile.compute_stream is not None:
            tile.compute_stream.execute(mem)
            return
        for d in phase:
            dispatch(d, mem)

    def execute(self, mem: torch.Tensor, overlap: bool = True
                ) -> torch.Tensor:
        """Run the tile schedule over the flat fp32 image ``mem``; the
        result is written back into ``mem``, which is returned.

        ``overlap=True`` is the double-buffered machine: tile i+1's
        DMA-in is issued (into the other bank) before tile i's compute
        wherever ``can_prefetch`` allows. On a CUDA image it goes on a
        copy stream, after an event that marks everything issued so far
        on the compute stream (tile i-1's DMA-out frees the bank), and
        tile i+1's compute waits on an event behind it; nothing else
        synchronizes. ``overlap=False`` is the machine with no DMA
        engine: every phase completes (``torch.cuda.synchronize``) before
        the next starts. On a CPU image both run in program order."""
        if tuple(mem.shape) != (self.image_elems,):
            raise ValueError(f"memory image has shape {tuple(mem.shape)}, "
                             f"plan was built for ({self.image_elems},)")
        self.stats["overlap_used"] = bool(overlap)
        ext = torch.zeros(self.total_elems, dtype=torch.float32,
                          device=mem.device)
        ext[:self.image_elems] = mem
        cuda = mem.is_cuda
        tiles = self.tiles
        if overlap:
            compute = copy = None
            if cuda:
                from .multistream import _copy_stream
                compute = torch.cuda.current_stream(mem.device)
                copy = _copy_stream(mem.device)
            landed = [None] * len(tiles)       # events of prefetched DMA-in
            for g, tile in enumerate(tiles):
                if landed[g] is None:
                    self._phase(ext, tile, tile.dma_in, False)
                if g + 1 < len(tiles) and self.can_prefetch[g]:
                    nxt = tiles[g + 1]
                    if cuda:
                        copy.wait_stream(compute)
                        with torch.cuda.stream(copy):
                            self._phase(ext, nxt, nxt.dma_in, False)
                        landed[g + 1] = torch.cuda.Event()
                        landed[g + 1].record(copy)
                    else:
                        self._phase(ext, nxt, nxt.dma_in, False)
                        landed[g + 1] = True
                if cuda and landed[g] is not None:
                    compute.wait_event(landed[g])
                self._phase(ext, tile, tile.compute, True)
                self._phase(ext, tile, tile.dma_out, False)
        else:
            for tile in tiles:
                for phase, is_comp in ((tile.dma_in, False),
                                       (tile.compute, True),
                                       (tile.dma_out, False)):
                    if phase:
                        self._phase(ext, tile, phase, is_comp)
                        if cuda:
                            torch.cuda.synchronize(mem.device)
        mem.copy_(ext[:self.image_elems])
        return mem
