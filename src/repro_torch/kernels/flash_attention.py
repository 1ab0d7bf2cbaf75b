"""Flash attention: the plain versions, the planners and the launchers of
``csrc/flash_attention.cu`` (forward) and ``csrc/flash_attention_bwd.cu``
(backward).

Counterpart of ``repro.kernels.flash_attention``: online-softmax
attention as the NTX MAX+MAC streaming reduction, with GQA (``h // g``),
a runtime ``kv_len`` and the causal query position ``kv_len - sq + i``.
The CUDA kernel masks ragged sequence edges itself, so unlike the
Pallas kernel it takes any sq and skv, and it reads q / k / v / o by
strides (d contiguous), so views are not copied. For training the
forward also writes each row's log-sum-exp, and the backward kernel
computes dQ, dK and dV from it: the counterpart of the flash-style VJP
of the reference's ``ref.mha_blocked`` (``ref.mha_blocked_bwd`` is its
plain version). Both kernels take q/k rows of d and v rows of dv for the
pairs in ``HEAD_PAIRS``: the GQA models' equal dims, and MLA's q/k of 192
(128 nope + 64 rope) against v of 128, which the reference sends to its
``ref.mha`` / ``ref.mha_blocked`` on every backend.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import _build
from .ref import f32, mha, mha_blocked_bwd

#: (q/k, v) head-dim pairs the CUDA kernels are instantiated for
HEAD_PAIRS = ((64, 64), (128, 128), (192, 128))
#: SMs of an H100 SXM: the planner splits the keys until the grid holds
#: about one block per SM
SMS = 132
#: keys per tile (``kTcKeys``, ``kF32Keys``) and rows per block
#: (``kF32Rows``; bf16: 16 per row warp) in ``csrc/flash_attention.cu``
TC_KEYS, F32_KEYS, F32_ROWS = 64, 32, 16
#: bf16 rows padded by 8 elements (16 bytes) for ldmatrix
PAD = 8
#: shared memory one block may use on the H100, and without opting in (the
#: fp32 route opts in above it: 53 KB at (192, 128))
MAX_SMEM, STATIC_SMEM = 232448, 48 * 1024
#: ln 2 in fp32: the kernels keep m in base 2 (``kLn2``)
LN2 = 0.6931471805599453
#: fewest key tiles a split takes, and most splits
MIN_SPLIT_TILES = 4
MAX_SPLITS = 64


def tc_warps(wr: int) -> int:
    """Warps of a tensor-core block with ``wr`` 16-row warps: 8 for the
    128-row blocks of long prefills, else 4 (4 // wr key warps a row)."""
    return max(4, wr)


def tc_stages(wr: int) -> int:
    """K/V ring depth of the tensor-core route: 2 for 64-row blocks (two
    blocks per SM), 3 for the others (one block per SM)."""
    return 2 if wr == 4 else 3


def tc_smem(d: int, wr: int, dv: int | None = None) -> int:
    """Shared memory of a tensor-core block, as ``tc_smem`` in the kernel:
    the Q rows and the K ring at d and the V ring at dv (default d) in
    bf16, or the fp32 staging of the key warps' merge (16 rows a warp of
    dv + 4, and m, l), whichever is larger."""
    dv = d if dv is None else dv
    ring = 2 * (16 * wr * (d + PAD)
                + tc_stages(wr) * TC_KEYS * (d + PAD + dv + PAD))
    rows = 16 * tc_warps(wr)
    return max(ring, 4 * (rows * (dv + 4) + 2 * rows))


def f32_smem(d: int, dv: int | None = None) -> int:
    """The fp32 route's shared memory: Q rows and a K tile (rows padded by
    one) at d, a V tile at dv (default d), in fp32."""
    dv = d if dv is None else dv
    return 4 * (F32_ROWS * d + F32_KEYS * (d + 1) + F32_KEYS * dv)


def check_head_dims(d: int, dv: int) -> None:
    """Raise ``ValueError`` for a (q/k, v) head-dim pair the kernels are
    not instantiated for."""
    if (d, dv) not in HEAD_PAIRS:
        raise ValueError(f"head dims (q/k {d}, v {dv}) not in {HEAD_PAIRS}")


@dataclasses.dataclass(frozen=True, eq=False)
class FlashPlan:
    """How ``csrc/flash_attention.cu`` cuts one call. A block takes ``gh``
    query heads of one kv head times ``qn`` queries (row r: head
    ``j0 + r // qn``, query ``q0 + r % qn``), ``rows`` rows in all (bf16:
    ``wr`` row warps of 16), and walks its key tiles of ``bk`` keys
    through a ring of ``stages``; each block's tiles are cut into
    ``splits`` contiguous ranges. Grid: ``(head_blocks * groups,
    q_tiles, splits)``. Plans compare and hash by identity (the planner
    caches them), so the launcher's argument cache is cheap to key."""

    bf16: bool
    d: int
    dv: int
    sq: int
    skv: int
    kv_len: int
    causal: bool
    g: int
    gh: int
    qn: int
    rows: int
    wr: int
    bk: int
    stages: int
    head_blocks: int
    q_tiles: int
    groups: int
    splits: int
    smem: int
    workspace: int

    @property
    def blocks(self) -> int:
        return self.head_blocks * self.groups * self.q_tiles * self.splits

    def keys(self, q_tile: int) -> tuple:
        """``(visit, full)`` of the block at query tile ``q_tile`` (from
        the first): it visits keys ``[0, visit)`` and masks none below
        ``full``, as ``geometry`` in the kernel derives them. A block
        holding a row with no valid key visits every key of the array,
        whose logits are all -1e30, as the reference does."""
        q0 = q_tile * self.qn
        qlo = self.kv_len - self.sq + q0
        qhi = qlo + min(self.qn, self.sq - q0) - 1
        lim_lo = min(self.kv_len, qlo + 1) if self.causal else self.kv_len
        lim_hi = min(self.kv_len, qhi + 1) if self.causal else self.kv_len
        visit = self.skv if lim_lo <= 0 else min(self.skv, lim_hi)
        return visit, max(0, min(self.skv, lim_lo))

    def split_ranges(self, q_tile: int) -> list:
        """The ``[start, stop)`` keys each split of the block at
        ``q_tile`` takes, in split order: split z takes key tiles
        ``[z nt // splits, (z + 1) nt // splits)`` of ``nt = ceil(visit /
        bk)``."""
        visit = self.keys(q_tile)[0]
        nt, s = -(-visit // self.bk), self.splits
        return [(min(visit, z * nt // s * self.bk),
                 min(visit, (z + 1) * nt // s * self.bk)) for z in range(s)]


@functools.lru_cache(maxsize=4096)
def flash_plan(b: int, hq: int, hkv: int, sq: int, skv: int, kv_len: int,
               d: int, dtype, causal: bool = True, lse: bool = False,
               dv: int | None = None) -> FlashPlan:
    """The kernel's plan for q (b, hq, sq, d) against k (b, hkv, skv, d) and
    v (b, hkv, skv, dv) (dv defaults to d; the pair must be in
    ``HEAD_PAIRS``), a pure function of the shapes, ``kv_len`` and the
    dtype.

    Rows: ``qn = min(sq, rows)`` queries of the largest ``gh`` dividing g
    with ``gh * qn`` within a block (bf16: 128 rows for sq >= 128, else
    64; fp32: 16): a decode step stacks the group's g heads into one
    block, a long prefill takes 128 queries of one head. bf16 row warps:
    the fewest 16-row warps that hold them. Splits: as many as fill
    ``SMS`` with one block each, with at least ``MIN_SPLIT_TILES`` key
    tiles a split, at most ``MAX_SPLITS``; ``lse`` (training: the kernel
    writes each row's log-sum-exp) never splits. The workspace holds each
    split's fp32 (m, l) and dv-wide accumulator a row. Raises for what
    the kernel cannot run."""
    dv = d if dv is None else dv
    check_head_dims(d, dv)
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash attention takes fp32 or bf16, not {dtype}")
    if min(b, sq, skv) < 0 or hq <= 0 or hkv <= 0 or hq % hkv:
        raise ValueError(f"flash attention shapes b {b} hq {hq} hkv {hkv} "
                         f"sq {sq} skv {skv}")
    bf16 = dtype == torch.bfloat16
    g = hq // hkv
    cap = (128 if sq >= 128 else 64) if bf16 else F32_ROWS
    qn = max(1, min(sq, cap))
    gh = max(j for j in range(1, g + 1) if g % j == 0 and j * qn <= cap)
    if bf16:
        wr = next(w for w in (1, 2, 4, 8) if 16 * w >= gh * qn)
        rows, bk, stages = 16 * wr, TC_KEYS, tc_stages(wr)
        smem = tc_smem(d, wr, dv)
    else:
        wr, rows, bk, stages = 1, F32_ROWS, F32_KEYS, 1
        smem = f32_smem(d, dv)
    if smem > MAX_SMEM:
        raise ValueError(f"flash attention: {smem} bytes of shared memory")
    q_tiles = -(-sq // qn) if sq else 0
    plan = FlashPlan(bf16=bf16, d=d, dv=dv, sq=sq, skv=skv, kv_len=kv_len,
                     causal=bool(causal), g=g, gh=gh, qn=qn, rows=rows,
                     wr=wr, bk=bk, stages=stages, head_blocks=g // gh,
                     q_tiles=q_tiles, groups=b * hkv, splits=1, smem=smem,
                     workspace=0)
    base = plan.blocks
    if not base or lse:
        return plan
    nt = max(-(-plan.keys(t)[0] // bk) for t in range(q_tiles))
    splits = max(1, min(SMS // base, nt // MIN_SPLIT_TILES, MAX_SPLITS))
    if splits == 1:
        return plan
    return dataclasses.replace(plan, splits=splits,
                               workspace=splits * b * hq * sq * (dv + 2))


def flash_attention_plain(q, k, v, *, causal: bool = True, scale=None,
                          kv_len: int | None = None) -> torch.Tensor:
    """Plain version: reference attention with query i at absolute
    position kv_len - sq + i (which also hides cache slots >= kv_len
    under causal masking)."""
    eff = k.shape[2] if kv_len is None else kv_len
    return mha(q, k, v, causal=causal, scale=scale,
               q_offset=eff - q.shape[2])


def flash_lse_plain(q, k, *, causal: bool = True, scale=None,
                    kv_len: int | None = None) -> torch.Tensor:
    """Plain version of the forward's ``lse`` output: each row's natural
    log-sum-exp of the scaled logits, masked as the kernel masks them
    (-1e30 for keys at or past ``kv_len`` and above the causal diagonal),
    ``m + log(l)`` as the reference's ``mha_blocked`` forward computes
    it. Returns (b, hq, sq) fp32."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    kv_len = skv if kv_len is None else kv_len
    scale = (d ** -0.5) if scale is None else scale
    qg = q.reshape(b, hkv, hq // hkv, sq, d).float()
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * f32(scale)
    kpos = torch.arange(skv, device=q.device)[None, :]
    ok = kpos < kv_len
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + (kv_len - sq)
        ok = ok & (kpos <= qpos)
    logits = torch.where(ok, logits, torch.full_like(logits, -1e30))
    return torch.logsumexp(logits, -1).reshape(b, hq, sq)


def flash_merge_plain(ws: torch.Tensor, splits: int, b: int, hq: int,
                      sq: int, d: int, dtype=torch.float32,
                      lse: bool = False):
    """Plain version of ``flash_merge``: the splits' fp32 partials (m in
    base 2, l, acc) combined in split order, the guard, one rounding; d is
    v's head dim (the accumulator's width). Returns (b, hq, sq, d) in
    ``dtype``; with ``lse`` also each row's fp32 log-sum-exp (b, hq, sq),
    ``m* ln 2 + log(max(sum_z l_z 2^(m_z - m*), 1e-30))``."""
    rows = b * hq * sq
    ml = ws[:2 * splits * rows].view(splits, rows, 2)
    acc = ws[2 * splits * rows:splits * rows * (d + 2)].view(splits, rows, d)
    mm = ml[..., 0].amax(0)
    f = torch.exp2(ml[..., 0] - mm)
    ll = (ml[..., 1] * f).sum(0)
    aa = (acc * f[..., None]).sum(0)
    out = aa / torch.where(ll == 0, torch.ones_like(ll), ll)[:, None]
    out = out.view(b, hq, sq, d).to(dtype)
    if not lse:
        return out
    lse_t = mm * LN2 + torch.log(torch.clamp_min(ll, 1e-30))
    return out, lse_t.view(b, hq, sq)


def flash_check(q, k, v) -> None:
    """Raise ``ValueError`` for operands the forward kernel refuses:
    mismatched shapes, a head-dim pair outside ``HEAD_PAIRS``, mixed
    dtypes."""
    b, hq, _, d = q.shape
    _, hkv, _, dk = k.shape
    if (k.shape[:-1] != v.shape[:-1] or dk != d or k.shape[0] != b
            or hq % hkv):
        raise ValueError(f"flash attention shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    check_head_dims(d, v.shape[-1])
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash attention takes one dtype, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")


def flash_bwd_check(q, k, v, o, lse, dout) -> None:
    """Raise ``ValueError`` for operands the backward kernel refuses."""
    b, hq, sq, d = q.shape
    _, hkv, _, dk = k.shape
    d_v = v.shape[-1]
    if (k.shape[:-1] != v.shape[:-1] or dk != d
            or o.shape != (b, hq, sq, d_v) or dout.shape != o.shape
            or hq % hkv):
        raise ValueError(f"flash backward shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} o "
                         f"{tuple(o.shape)} dout {tuple(dout.shape)}")
    if not (q.dtype == k.dtype == v.dtype == o.dtype == dout.dtype):
        raise ValueError("flash backward takes one dtype for q, k, v, o and "
                         "dout")
    if lse.shape != (b, hq, sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be fp32 (b, hq, sq), got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    check_head_dims(d, d_v)


def attention_pairs(sq: int, kv_len: int, causal: bool) -> int:
    """The unmasked (query, key) pairs of one head: query i at position
    kv_len - sq + i sees keys ``[0, min(kv_len, position + 1))`` under
    ``causal``, else all ``kv_len``."""
    if not causal:
        return sq * kv_len
    first = kv_len - sq + 1            # keys the first query sees
    if first >= 1:
        return sq * first + sq * (sq - 1) // 2
    return kv_len * (kv_len + 1) // 2


def _strides(t: torch.Tensor) -> tuple:
    return tuple(t.stride()[:3])


@functools.lru_cache(maxsize=1024)
def _params(strides: tuple, b, hq, hkv, sq, skv, d, kv_len, causal,
            plan: FlashPlan, merge: bool, dv: int):
    """The kernel's integer arguments as one host array, made once per
    call shape: a decode step issues the same one at every layer."""
    return _build.ptr_array(ctypes.c_longlong, (
        *strides, b, hq, hkv, sq, skv, d, kv_len, int(causal),
        int(plan.bf16), plan.gh, plan.qn, plan.wr, plan.stages, plan.splits,
        int(merge), dv))


def flash_attention_cuda(q, k, v, *, causal: bool = True, scale=None,
                         kv_len: int | None = None,
                         plan: FlashPlan | None = None,
                         partials: bool = False, lse: bool = False):
    """Launch ``csrc/flash_attention.cu``. q: (b, hq, sq, d); k: (b, hkv,
    skv, d); v: (b, hkv, skv, dv), all fp32 or all bf16, (d, dv) in
    ``HEAD_PAIRS``, any strides with the last dim contiguous (an operand
    whose last dim is strided is copied); o: (b, hq, sq, dv).
    ``plan`` defaults to :func:`flash_plan`; another plan is passed only
    to test that the kernel refuses it. ``partials`` (a split plan only):
    return the splits' workspace and the output, unmerged, to time the
    merge on its own. ``lse``: return ``(o, lse)`` with each row's fp32
    log-sum-exp (b, hq, sq), as :func:`flash_lse_plain` (with a split
    plan the merge writes it, as :func:`flash_merge_plain` with
    ``lse``); without ``plan`` it plans unsplit, as training does."""
    flash_check(q, k, v)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    kv_len = skv if kv_len is None else int(kv_len)
    p = plan or flash_plan(b, hq, hkv, sq, skv, kv_len, d, q.dtype,
                           bool(causal), lse, dv)
    if partials and p.splits == 1:
        raise ValueError("partials needs a plan with more than one split")
    if lse and partials:
        raise ValueError("lse comes from the merge; partials skips it")
    scale = (d ** -0.5) if scale is None else scale
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    o = torch.empty_like(q) if dv == d else q.new_empty((b, hq, sq, dv))
    ws = (torch.empty(p.workspace, dtype=torch.float32, device=q.device)
          if p.splits > 1 else None)
    lse_t = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
             if lse else None)
    params = _params(_strides(q) + _strides(k) + _strides(v) + _strides(o),
                     b, hq, hkv, sq, skv, d, kv_len, bool(causal), p,
                     not partials, dv)
    with _build.on_device(q):
        code = _build.library().ntx_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            ws.data_ptr() if ws is not None else None,
            lse_t.data_ptr() if lse else None, params, f32(scale),
            _build.stream_of(q))
    _build.check(code, "ntx_flash_attention")
    if partials:
        return ws, o
    return (o, lse_t) if lse else o


def flash_merge_cuda(ws: torch.Tensor, o: torch.Tensor, splits: int,
                     lse: torch.Tensor | None = None):
    """Launch ``flash_merge`` alone: the partials of ``splits`` splits in
    ``ws`` (as ``flash_attention_cuda(partials=True)`` leaves them) into
    ``o`` (b, hq, sq, dv), fp32 or bf16, dv contiguous; with ``lse``
    (b, hq, sq) fp32 contiguous, each row's log-sum-exp into it too, and
    returns ``(o, lse)``."""
    b, hq, sq, d = o.shape
    os_ = _build.ptr_array(ctypes.c_longlong, _strides(o))
    if lse is not None and (lse.shape != (b, hq, sq)
                            or lse.dtype != torch.float32
                            or not lse.is_contiguous()):
        raise ValueError(f"lse must be contiguous fp32 {(b, hq, sq)}")
    with _build.on_device(o):
        code = _build.library().ntx_flash_merge(
            ws.data_ptr(), o.data_ptr(),
            lse.data_ptr() if lse is not None else None, os_, b, hq, sq, d,
            splits, int(o.dtype == torch.bfloat16), _build.stream_of(o))
    _build.check(code, "ntx_flash_merge")
    return o if lse is None else (o, lse)


# ----------------------------------------------------------------------
# Backward: csrc/flash_attention_bwd.cu
# ----------------------------------------------------------------------
#: the bf16 route's consumer warpgroups a block (``kWG``), keys of a dK/dV
#: block (64 a warpgroup), queries of the tiles it walks, queries of a dQ
#: block, keys of the tiles it walks, and the ring depth (``kBk``,
#: ``kBq``, ``kDqRows``, ``kDqKeys``, ``kStages``)
BWD_WARPGROUPS = 2
BWD_KEYS, BWD_ROWS = 64 * BWD_WARPGROUPS, 64
BWD_DQ_ROWS, BWD_DQ_KEYS, BWD_STAGES = 64 * BWD_WARPGROUPS, 64, 3
#: the fp32 route's tiles (``kF32BwdKeys``, ``kF32BwdRows``) and the blocks
#: of it an SM holds (``kF32BlocksPerSm``; the bf16 route holds one)
F32_BWD_KEYS, F32_BWD_ROWS, F32_BWD_BLOCKS_PER_SM = 32, 16, 4
#: queries a tile of the row table (lse log2 e and D; ``kTile``)
BWD_ROW_TILE = 64


@dataclasses.dataclass(frozen=True)
class FlashBwdPlan:
    """How ``csrc/flash_attention_bwd.cu`` cuts one backward. The dK/dV
    pass takes one block per (batch, kv head, split of the group, tile of
    ``bk`` keys); each block walks ``g // gs`` query heads and, for each,
    its tiles of ``bq`` queries through a ring of ``stages`` (bf16:
    ``warpgroups`` consumer warpgroups of 64 keys and a producer). The dQ
    pass takes one block per (batch, q head, tile of ``dq_rows`` queries)
    over tiles of ``dq_keys`` keys. ``gs`` > 1 adds the fp32 partials of
    the splits in ``ws_bytes`` of workspace, in split order, in a merge
    launch (dK's partials of d columns, then dV's of dv). ``smem_dkdv`` /
    ``smem_dq``: the blocks' shared memory; ``rows_bytes``: the row table
    (lse log2 e and D a query, tiles of 64, an even tile count a head)."""

    bf16: bool
    bk: int
    bq: int
    dq_rows: int
    dq_keys: int
    stages: int
    warpgroups: int
    gs: int
    dkdv_grid: tuple
    dq_grid: tuple
    smem_dkdv: int
    smem_dq: int
    ws_bytes: int
    rows_bytes: int
    b: int
    hq: int
    hkv: int
    sq: int
    skv: int
    causal: bool
    d: int
    dv: int

    def dkdv_block(self, x: int, y: int) -> tuple:
        """The dK/dV block at grid (x, y) as the kernel maps it: (batch,
        kv head, split, its query heads in walking order, its keys, the
        query tiles it walks for each head)."""
        g = self.hq // self.hkv
        hps = g // self.gs
        grp, split = divmod(x, self.gs)
        bi, kvh = divmod(grp, self.hkv)
        h0 = kvh * g + split * hps
        k0 = y * self.bk
        qt0 = first_q_tile(y, self.bk, self.bq, self.skv - self.sq,
                           self.causal)
        return (bi, kvh, split, range(h0, h0 + hps),
                range(k0, min(k0 + self.bk, self.skv)),
                range(qt0, -(-self.sq // self.bq)))

    def params(self) -> tuple:
        """The plan's values as the C entry takes them."""
        return (self.bk, self.bq, self.dq_rows, self.dq_keys, self.stages,
                self.warpgroups, self.gs, self.smem_dkdv, self.smem_dq,
                self.ws_bytes, self.rows_bytes)


def first_q_tile(t: int, bk: int, bq: int, q_off: int, causal: bool) -> int:
    """The first query tile (of ``bq``) that key tile ``t`` (of ``bk``)
    meets under the causal bound (query i at position q_off + i)."""
    if not causal:
        return 0
    return max(0, (t * bk - q_off) // bq)


def group_split(b: int, hkv: int, g: int, sq: int, skv: int, bk: int,
                bq: int, causal: bool, slots: int) -> int:
    """The fewest splits ``gs`` of a GQA group (a divisor of g) whose
    longest dK/dV block (g // gs heads times the first key tile's query
    tiles) is at most the mean work of one of ``slots`` block slots, so
    the longest block does not bound the run; g where none is. Then the
    grid holds at least ``slots`` blocks wherever b hkv g key tiles do."""
    nkt, nqt = -(-skv // bk), -(-sq // bq)
    per = [nqt - first_q_tile(t, bk, bq, skv - sq, causal)
           for t in range(nkt)]
    total = b * hkv * g * sum(max(0, n) for n in per)
    longest = max(per, default=0)
    for gs in range(1, g + 1):
        if g % gs == 0 and (g // gs) * longest * slots <= total:
            return gs
    return g


@functools.lru_cache(maxsize=1024)
def flash_bwd_plan(b: int, hq: int, hkv: int, sq: int, skv: int, d: int,
                   dtype, causal: bool = True,
                   dv: int | None = None) -> FlashBwdPlan:
    """The backward kernel's plan, a pure function of the shapes. bf16:
    wgmma with two consumer warpgroups, 128-key dK/dV blocks over 64-query
    tiles, 128-query dQ blocks over 64-key tiles, a ring of 3 TMA stages,
    one block an SM. fp32: FFMA, 32-key and 16-query tiles, 4 blocks an
    SM. The group split fills the block slots (:func:`group_split`).
    q/k rows of d, v rows of dv (default d). Raises for what the kernel
    cannot run: a head-dim pair outside ``HEAD_PAIRS``, a dtype other
    than fp32 or bf16, empty sequences, causal attention with more
    queries than keys."""
    dv = d if dv is None else dv
    check_head_dims(d, dv)
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash attention takes fp32 or bf16, not {dtype}")
    if b < 0 or min(sq, skv) <= 0 or hq <= 0 or hkv <= 0 or hq % hkv:
        raise ValueError(f"flash backward shapes b {b} hq {hq} hkv {hkv} "
                         f"sq {sq} skv {skv}")
    if causal and sq > skv:
        raise ValueError(f"the causal backward takes sq <= skv, got sq {sq} "
                         f"skv {skv} (a query with no key)")
    bf16 = dtype == torch.bfloat16
    if bf16:
        bk, bq, dq_rows, dq_keys = BWD_KEYS, BWD_ROWS, BWD_DQ_ROWS, BWD_DQ_KEYS
        stages, wgs, slots = BWD_STAGES, BWD_WARPGROUPS, SMS
        bars = 8 * (2 * stages + 1)
        smem_dkdv = (1024 + 2 * bk * (d + dv)
                     + stages * (2 * bq * (d + dv) + 8 * bq) + bars)
        smem_dq = (1024 + 2 * dq_rows * (d + dv) + 8 * dq_rows
                   + stages * 2 * dq_keys * (d + dv) + bars)
    else:
        bk, bq = F32_BWD_KEYS, F32_BWD_ROWS
        dq_rows, dq_keys, stages, wgs = bq, bk, 1, 1
        slots = SMS * F32_BWD_BLOCKS_PER_SM
        ld = 4 * (d + 1 + dv + 1)          # a row of K and V (Q and dO)
        smem_dkdv = bk * ld + bq * ld + 8 * bk * (bq + 1) + 8 * bq
        smem_dq = bq * ld + bk * ld + 4 * bq * (bk + 1) + 8 * bq
    if max(smem_dkdv, smem_dq) > MAX_SMEM:
        raise ValueError(f"flash backward: {max(smem_dkdv, smem_dq)} bytes "
                         f"of shared memory")
    g = hq // hkv
    gs = group_split(b, hkv, g, sq, skv, bk, bq, causal, slots)
    row_tiles = 2 * -(-sq // (2 * BWD_ROW_TILE))
    return FlashBwdPlan(
        bf16=bf16, bk=bk, bq=bq, dq_rows=dq_rows, dq_keys=dq_keys,
        stages=stages, warpgroups=wgs, gs=gs,
        dkdv_grid=(b * hkv * gs, -(-skv // bk)),
        dq_grid=(b * hq, -(-sq // dq_rows)),
        smem_dkdv=smem_dkdv, smem_dq=smem_dq,
        ws_bytes=gs * b * hkv * skv * (d + dv) * 4 if gs > 1 else 0,
        rows_bytes=b * hq * row_tiles * 2 * BWD_ROW_TILE * 4,
        b=b, hq=hq, hkv=hkv, sq=sq, skv=skv, causal=bool(causal), d=d,
        dv=dv)


def flash_attention_bwd_plain(q, k, v, o, lse, dout, *, causal: bool = True,
                              scale=None):
    """Plain version of the backward kernel: the reference's flash-style
    VJP (``ref.mha_blocked_bwd``) with query i at position skv - sq + i.
    Returns (dq, dk, dv) in the inputs' dtype."""
    return mha_blocked_bwd(q, k, v, o, lse, dout, causal=causal,
                           scale=scale, q_offset=k.shape[2] - q.shape[2])


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` with d contiguous and, for bf16, what the kernel's tensor
    maps read: a 16-byte aligned base and positive strides in multiples of
    8 elements (a copy only where it is not so: a fresh allocation, since
    ``contiguous`` returns a contiguous view off a 16-byte boundary as it
    is)."""
    if t.stride(-1) != 1 or (t.dtype == torch.bfloat16 and (
            t.data_ptr() % 16 or any(s % 8 or s <= 0
                                     for s in t.stride()[:3]))):
        return t.clone(memory_format=torch.contiguous_format)
    return t


def flash_attention_bwd_cuda(q, k, v, o, lse, dout, *, causal: bool = True,
                             scale=None, plan: FlashBwdPlan | None = None):
    """Launch ``csrc/flash_attention_bwd.cu``: (dq, dk, dv) of attention
    with output ``o`` and row log-sum-exp ``lse`` (b, hq, sq) fp32 (the
    forward's, :func:`flash_attention_cuda` with ``lse=True``) for the
    incoming gradient ``dout``. q: (b, hq, sq, d); o, dout: (b, hq, sq,
    dv); k: (b, hkv, skv, d); v: (b, hkv, skv, dv); (d, dv) in
    ``HEAD_PAIRS``; all fp32 or all bf16, read by strides (bf16 through
    tensor maps; an operand they cannot read is copied); the gradients
    take their inputs' layouts. ``plan`` defaults to :func:`flash_bwd_plan`;
    another is passed only to test that the kernel refuses it."""
    flash_bwd_check(q, k, v, o, lse, dout)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    d_v = v.shape[-1]
    p = plan or flash_bwd_plan(b, hq, hkv, sq, skv, d, q.dtype,
                               bool(causal), d_v)
    scale = (d ** -0.5) if scale is None else scale
    q, k, v, o, dout = (_aligned(t) for t in (q, k, v, o, dout))
    lse = lse.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    rows = torch.empty(p.rows_bytes // 4, dtype=torch.float32,
                       device=q.device)
    ws = (torch.empty(p.ws_bytes // 4, dtype=torch.float32, device=q.device)
          if p.ws_bytes else None)
    params = _build.ptr_array(ctypes.c_longlong, (
        *(s for t in (q, k, v, o, dout, dq, dk, dv) for s in _strides(t)),
        b, hq, hkv, sq, skv, d, int(causal), int(p.bf16), *p.params(), d_v))
    with _build.on_device(q):
        code = _build.library().ntx_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), rows.data_ptr(),
            ws.data_ptr() if ws is not None else None, dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), params, f32(scale),
            _build.stream_of(q))
    _build.check(code, "ntx_flash_attention_bwd")
    return dq, dk, dv
