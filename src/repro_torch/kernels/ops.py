"""Public wrappers around the NTX kernels, the counterpart of
``repro.kernels.ops`` for the slice's kernels.

There is no backend switch: the device of the tensors decides. CPU
tensors go to the plain PyTorch version of the kernel (the CPU tests run
these); CUDA tensors launch the hand-written Hopper kernel from
``csrc/`` or raise. Meta tensors take the dry run's route
(``repro_torch.launch.dryrun``) in the wrappers a serving or training
step reaches (``gemm``, ``fused_mlp``, ``act_bwd``, ``attention``,
``attention_split_logits``, ``attention_split_softmax_pv``, ``ssd``,
``ssd_with_state``, ``adamw_update``): the call is checked and
planned as the card would run it, tallied in :data:`DRY` and answered
with empty meta outputs; the other wrappers raise on meta tensors.
Nothing falls back from one route to another.

The CUDA kernels mask ragged edges themselves, so unlike the Pallas
wrappers nothing here pads, and the Pallas-only machinery (block
autotuning, ``_flash_block``, the chain-reduce attention for shapes the
Pallas flash kernel cannot tile) has no counterpart.

Each wrapper counts the kernel launches it makes in :data:`LAUNCHES`
(only where it launches a kernel: the plain versions count nothing), so
a run can show that it went through the kernels.

Gradients: ``attention``, ``fused_mlp`` and ``ssd`` are
``torch.autograd.Function``s on both devices. Attention's backward is the
flash backward kernel (``csrc/flash_attention_bwd.cu``) from the
forward's row log-sum-exp; the MLP's backward runs every product on the
``ntx_gemm`` kernel and the activation's derivative on
``csrc/ntx_act_bwd.cu``; the SSD's is ``csrc/ssd_scan_bwd.cu`` from the
saved inputs. ``gemm`` called directly, ``ssd_with_state`` (prefill),
the two kernels of a decode over a cache split by head_dim, the
streaming commands, conv and the stencils have no backward (the
reference has none for conv, the stencil pass or the compensated GEMM
either, and no training path calls the others), so their CUDA routes
raise under autograd rather than return results that no gradient
reaches; their CPU routes are plain PyTorch and differentiate as such.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .flash_attention import (attention_pairs, attention_split_check,
                              attention_split_logits_cuda,
                              attention_split_logits_plain,
                              attention_split_pv_check,
                              attention_split_softmax_pv_cuda,
                              attention_split_softmax_pv_plain,
                              flash_attention_bwd_cuda,
                              flash_attention_bwd_plain,
                              flash_attention_cuda, flash_attention_plain,
                              flash_bwd_check, flash_bwd_plan, flash_check,
                              flash_lse_plain, flash_plan, split_pv_plan)
from .ntx_elementwise import (MAX_STAGES, _OPS2, act_bwd_check, act_bwd_cuda,
                              act_bwd_plain, adamw_check, adamw_cuda,
                              adamw_plain, elementwise_chain_plain,
                              elementwise_plain, normalize_stages,
                              stream_cuda)
from .ntx_conv import check_shapes, conv2d_cuda, conv2d_plain
from .ntx_gemm import (EPILOGUE_ARRAY_KINDS, _GEMM_DTYPES, ffma_plan,
                       gemm_check, gemm_cuda, gemm_kahan_plain, gemm_plain,
                       split_k_plan)
from .ntx_stencil import (LAPLACE_TAPS, as_blocks, laplace_cuda,
                          laplace_plain, laplace_shape, stencil1d_cuda,
                          stencil1d_plain)
from .ntx_reduce import REDUCE_OPS, chain_reduce_plain, reduce_plain
from .ssd_scan import (scan_plan, ssd_bwd_check, ssd_bwd_flops,
                       ssd_bwd_plan, ssd_check, ssd_flops,
                       ssd_scan_bwd_cuda, ssd_scan_bwd_plain,
                       ssd_scan_cuda, ssd_scan_plain,
                       ssd_scan_with_state_plain)

#: kernel launches per wrapper since the last :func:`reset_launches`;
#: ``ssd`` counts calls of the scan, each three kernels of
#: ``csrc/ssd_scan.cu`` (state, carry, output passes), ``ssd_state`` the
#: calls of the same three that also store the final state (prefill);
#: ``ssd_bwd`` the SSD backward's calls, each the passes of
#: ``csrc/ssd_scan_bwd.cu`` (states, local sums, reverse carry, gradients,
#: reduction); ``laplace`` counts the fused Laplace
#: launches (one per ``laplace`` call of 1-3 dimensions), ``stencil`` the
#: per-axis passes; ``attention_merge`` counts the split-kv merge launched
#: after an ``attention`` call whose plan splits the keys;
#: ``attention_bwd`` counts attention backward calls, each three kernels of
#: ``csrc/flash_attention_bwd.cu`` (D, dK/dV, dQ); ``act_bwd`` the fused
#: MLP's activation backward (the MLP backward's products count under
#: ``gemm``); ``attention_split_logits`` and ``attention_split_softmax_pv``
#: the two kernels of a decode over a cache split by head_dim
#: (``csrc/ntx_attn_split.cu``; the second's split merge, where its plan
#: splits the keys, counts with it)
LAUNCHES = {"gemm": 0, "gemm_kahan": 0, "attention": 0,
            "attention_merge": 0, "attention_bwd": 0,
            "attention_split_logits": 0, "attention_split_softmax_pv": 0,
            "act_bwd": 0,
            "elementwise": 0,
            "elementwise_chain": 0, "chain_reduce": 0, "reduce": 0,
            "ssd": 0, "ssd_state": 0, "ssd_bwd": 0, "adamw": 0, "conv2d": 0,
            "stencil": 0, "laplace": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launches() -> dict:
    return dict(LAUNCHES)


#: the dry run's tally, kept apart from :data:`LAUNCHES`: for each call on
#: meta tensors, the wrapper's family counts what its CUDA route would add
#: to ``LAUNCHES`` (``calls``), and the kernel's tensor-product operations
#: (``flops``; the elementwise kernels have none) and the bytes it must
#: move, each input read once and each output written once (``bytes``)
DRY = {"calls": dict.fromkeys(LAUNCHES, 0),
       "flops": dict.fromkeys(LAUNCHES, 0),
       "bytes": dict.fromkeys(LAUNCHES, 0)}


def reset_dry() -> None:
    for part in DRY.values():
        for k in part:
            part[k] = 0


def dry() -> dict:
    """A copy of the tally: ``{"calls", "flops", "bytes"}``, each by
    family."""
    return {k: dict(v) for k, v in DRY.items()}


def _tally(family: str, flops: int = 0, nbytes: int = 0) -> None:
    DRY["calls"][family] += 1
    DRY["flops"][family] += int(flops)
    DRY["bytes"][family] += int(nbytes)


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def _on_meta(*tensors) -> bool:
    """True where every tensor is on the meta device: the dry run's route,
    which checks and plans the call as the card would, tallies it in
    :data:`DRY` and returns empty meta outputs. A mix raises in
    :func:`_on_card`."""
    meta = [t.is_meta for t in tensors if t is not None]
    return bool(meta) and all(meta)


def _on_card(*tensors) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors
    (run the plain version); anything else, or a mix, raises."""
    cuda = [t.is_cuda for t in tensors if t is not None]
    if cuda and all(cuda):
        return True
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cpu"}:
        return False
    if kinds == {"meta"}:
        raise ValueError("meta tensors: this op has no meta route; the dry "
                         "run (repro_torch.launch.dryrun) takes the ops of a "
                         "serving or training step only")
    raise ValueError(f"tensors on {sorted(kinds)}: the NTX ops take CPU "
                     f"tensors (plain versions), CUDA tensors (kernels) or, "
                     f"in the dry run, meta tensors")


def _tracked(*tensors) -> bool:
    """True where autograd records the call: grad mode on and an input
    that requires a gradient."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


_NO_TRAINING_PATH = (
    "no training path does: dense training differentiates ops.fused_mlp "
    "and ops.attention, whose backward kernels run every product on the "
    "card; ROADMAP: ops.gemm's direct backward")


def _no_backward(name: str, *tensors, why: str = _NO_TRAINING_PATH):
    """Raise where a kernel without a backward would be launched on a
    tensor that autograd tracks: its gradient would silently be lost."""
    if _tracked(*tensors):
        raise NotImplementedError(
            f"the {name} kernel has no backward when called directly "
            f"({why}); run it under torch.no_grad() or on CPU tensors")


# ----------------------------------------------------------------------
# GEMM
# ----------------------------------------------------------------------
def _norm_epilogue(epilogue):
    """Normalize user stages to (kind, imm, operand) triples."""
    out = []
    for stage in epilogue or ():
        if isinstance(stage, str):
            stage = (stage,)
        kind = stage[0]
        if kind in EPILOGUE_ARRAY_KINDS:
            out.append((kind, 0.0, torch.as_tensor(stage[1])))
        elif kind in ("scale", "thresh"):
            out.append((kind, float(stage[1]), None))
        else:
            out.append((kind, 0.0, None))
    return out


def gemm(a: torch.Tensor, b: torch.Tensor, out_dtype=torch.float32,
         compensated: bool = False, epilogue=None) -> torch.Tensor:
    """C = epilogue(A @ B), fp32 accumulate, arbitrary shapes.

    ``epilogue``: optional fused stages applied to the accumulator at the
    store step (one rounding): ("bias", vec), ("residual", mat),
    ("mul", mat), ("sub", mat), ("mask", mat), ("scale", s),
    ("thresh", t), "relu", "silu", "gelu".

    ``compensated``: Neumaier-compensated accumulation across
    ``ntx_gemm.KAHAN_SLAB``-deep slabs of k (the reference's
    ``_gemm_kernel_kahan``, which compensates across its k blocks).

    Lanes: (L, m, k) @ (L, k, n) with (L, n) / (L, m, n) epilogue
    operands is L products in one launch (each lane's bits those of its
    own call); the compensated GEMM takes one lane.
    """
    if compensated and a.dim() == 3:
        raise ValueError("the compensated GEMM takes one (m, k) @ (k, n) "
                         "product, not lanes")
    epilogue = _norm_epilogue(epilogue)
    if not compensated and _on_meta(a, b, *(op for _, _, op in epilogue)):
        return _gemm_meta(a, b, out_dtype, epilogue)
    if not _on_card(a, b, *(op for _, _, op in epilogue)):
        plain = gemm_kahan_plain if compensated else gemm_plain
        return plain(a, b, out_dtype=out_dtype, epilogue=epilogue)
    _no_backward("gemm", a, b, *(op for _, _, op in epilogue))
    LAUNCHES["gemm_kahan" if compensated else "gemm"] += 1
    return gemm_cuda(a, b, out_dtype=out_dtype, epilogue=epilogue,
                     compensated=compensated)


def _gemm_meta(a, b, out_dtype, epilogue):
    """The meta route of :func:`gemm` (uncompensated): the kernel's checks
    and plan, ``2 m n k`` operations a lane; A, B and the epilogue's
    operands read (in the dtype the kernel reads them), C written, and a
    split product's fp32 partials written and read again."""
    _no_backward("gemm", a, b, *(op for _, _, op in epilogue))
    gemm_check(a, b, out_dtype, len(epilogue))
    m, k = a.shape[-2:]
    n = b.shape[-1]
    lanes = a.shape[0] if a.dim() == 3 else 1
    ws_bytes = 0
    if a.dtype == torch.bfloat16:
        ws_bytes = 2 * 4 * lanes * split_k_plan(m, n, k).workspace
    else:
        ffma_plan(m, n, k, False)
    c = torch.empty((*a.shape[:-2], m, n), dtype=out_dtype, device="meta")
    ops_bytes = sum(
        op.numel() * (op.element_size() if op.dtype in _GEMM_DTYPES else 4)
        for _, _, op in epilogue if op is not None)
    _tally("gemm", 2 * lanes * m * n * k,
           _nbytes(a, b, c) + ops_bytes + ws_bytes)
    return c


# ----------------------------------------------------------------------
# Fused transformer MLP: activations/gate/residual as GEMM epilogues
# ----------------------------------------------------------------------
def _mlp(x2, w1, w2, w3, act, residual):
    """The MLP's three products on (m, d) rows: the gate to fp32, w1 with
    the activation (and the gate multiply) in its store, w2 with the
    residual add in its store."""
    dt = x2.dtype
    if act == "swiglu":
        gate = gemm(x2, w3, out_dtype=torch.float32)
        h = gemm(x2, w1, out_dtype=dt, epilogue=[("silu",), ("mul", gate)])
    else:
        h = gemm(x2, w1, out_dtype=dt, epilogue=[("gelu",)])
    ep = [] if residual is None else [("residual", residual)]
    return gemm(h, w2, out_dtype=dt, epilogue=ep)


def act_bwd(act: str, dh: torch.Tensor, a1: torch.Tensor,
            gate: torch.Tensor | None, out_dtype=torch.float32):
    """The MLP activation's backward in one pass: ``(da1, dgate, h)`` in
    ``out_dtype`` from fp32 ``dh = dout @ w2^T``, ``a1 = x @ w1`` and
    (SwiGLU) ``gate = x @ w3`` (GELU: tanh form, ``dgate`` None)."""
    if _on_meta(dh, a1, gate):
        act_bwd_check(act, dh, a1, gate, out_dtype)
        da1, h = (torch.empty(dh.shape, dtype=out_dtype, device="meta")
                  for _ in range(2))
        dgate = torch.empty_like(da1) if act == "swiglu" else None
        _tally("act_bwd", 0, _nbytes(dh, a1, gate, da1, dgate, h))
        return da1, dgate, h
    if not _on_card(dh, a1, gate):
        return act_bwd_plain(act, dh, a1, gate, out_dtype)
    LAUNCHES["act_bwd"] += 1
    return act_bwd_cuda(act, dh, a1, gate, out_dtype)


class _FusedMLP(torch.autograd.Function):
    """Forward: the MLP's three ``ntx_gemm`` launches (their plain
    versions on CPU tensors), with the bits of the untracked call; saves
    x and the weights. Backward, every product on ``ntx_gemm``: a1 and
    the gate recomputed in fp32, ``dh = dout w2^T`` (fp32), the
    activation backward (``da1``, ``dgate`` and ``h`` rounded to the
    compute dtype), ``dx = da1 w1^T + dgate w3^T`` (the second product
    takes the first as its residual store), ``dw1 = x^T da1``, ``dw3 =
    x^T dgate``, ``dw2 = h^T dout`` in fp32 (autograd rounds each once
    to its weight's dtype), and ``dresidual = dout``. Transposed
    operands are contiguous copies."""

    @staticmethod
    def forward(ctx, x2, w1, w2, w3, residual, act):
        ctx.act, ctx.residual = act, residual is not None
        ctx.save_for_backward(x2, w1, w2, w3)
        return _mlp(x2, w1, w2, w3, act, residual)

    @staticmethod
    def backward(ctx, dout):
        x, w1, w2, w3 = ctx.saved_tensors
        swiglu = ctx.act == "swiglu"
        with torch.profiler.record_function("fused_mlp_bwd"):
            dout = dout.contiguous()
            a1 = gemm(x, w1)
            gate = gemm(x, w3) if swiglu else None
            dh = gemm(dout, w2.t().contiguous())
            da1, dgate, h = act_bwd(ctx.act, dh, a1, gate, x.dtype)
            del a1, gate, dh
            if swiglu:
                dx = gemm(dgate, w3.t().contiguous(), out_dtype=x.dtype,
                          epilogue=[("residual",
                                     gemm(da1, w1.t().contiguous()))])
            else:
                dx = gemm(da1, w1.t().contiguous(), out_dtype=x.dtype)
            xt = x.t().contiguous()
            dw1 = gemm(xt, da1)
            dw3 = gemm(xt, dgate) if swiglu else None
            dw2 = gemm(h.t().contiguous(), dout)
        return (dx, dw1, dw2, dw3, dout if ctx.residual else None, None)


def fused_mlp(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
              w3: torch.Tensor | None = None, act: str = "gelu",
              residual: torch.Tensor | None = None) -> torch.Tensor:
    """``(residual +) (act(x @ w1) [* (x @ w3)]) @ w2`` for (..., d) inputs.

    The activation, the SwiGLU gate multiply and the residual add run in
    the GEMM store steps (fused epilogues), as on the reference's Pallas
    backends: the gate is kept in fp32, the hidden activation is rounded
    once to x's dtype. Under autograd the call is :class:`_FusedMLP`,
    whose backward runs on the same kernels."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    res = None if residual is None else residual.reshape(-1, w2.shape[-1])
    if act == "swiglu" and w3 is None:
        raise ValueError("swiglu needs w3")
    if _tracked(x2, w1, w2, w3, res):
        out = _FusedMLP.apply(x2, w1, w2, w3, res, act)
    else:
        out = _mlp(x2, w1, w2, w3, act, res)
    return out.reshape(*lead, w2.shape[-1])


# ----------------------------------------------------------------------
# Elementwise command set
# ----------------------------------------------------------------------
def _split_ys(stages, ys):
    """Operands of each stage chunk when a chain is cut into launches of
    at most MAX_STAGES stages."""
    if len(stages) <= MAX_STAGES:
        return [(stages, ys)]
    chunks, yi = [], 0
    for i in range(0, len(stages), MAX_STAGES):
        part = stages[i:i + MAX_STAGES]
        n2 = sum(1 for op, _ in part if op in _OPS2)
        chunks.append((part, tuple(ys[yi:yi + n2])))
        yi += n2
    return chunks


def _chain_cuda(stages, x, ys, counter: str):
    """Run a chain of any length as launches of at most MAX_STAGES."""
    val = x
    for part, part_ys in _split_ys(stages, ys):
        LAUNCHES[counter] += 1
        val, _ = stream_cuda(part, val, part_ys)
    return val


def _rows_view(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the streaming kernel takes it, without a copy where it
    can: contiguous, or a (rows, n) view whose rows are contiguous and do
    not overlap — a stack of lanes in a memory image. Anything else is
    copied."""
    if t.is_contiguous() or (t.dim() == 2 and (t.shape[1] <= 1
                                               or t.stride(1) == 1)
                             and (t.shape[0] <= 1
                                  or t.stride(0) >= t.shape[1])):
        return t
    return t.contiguous()


def _like(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``y`` in ``x``'s shape, as the kernel takes it (:func:`_rows_view`)."""
    return _rows_view(y if y.shape == x.shape else y.reshape(x.shape))


def elementwise(op: str, x: torch.Tensor, y: torch.Tensor | None = None,
                imm: float = 0.0) -> torch.Tensor:
    """One streaming command over ``x`` (any shape; a (rows, n) lane stack
    may be a strided view, read in place)."""
    if not _on_card(x, y):
        return elementwise_plain(op, x, y, imm)
    _no_backward("stream", x, y)
    ys = (_like(y, x),) if op in _OPS2 else ()
    LAUNCHES["elementwise"] += 1
    out, _ = stream_cuda(((op, imm),), _rows_view(x), ys)
    return out


def axpy(a: float, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return elementwise("axpy", x, y, imm=a)


def elementwise_chain(stages, x: torch.Tensor, ys=()) -> torch.Tensor:
    """Fused chain of streaming commands: one pass over ``x``.

    ``stages``: sequence of (op, imm). Each 2-read op consumes the next
    array from ``ys``. Equivalent to folding ``elementwise`` over the
    stages, but the value never leaves registers between stages."""
    stages = normalize_stages(stages)
    ys = tuple(ys)
    if not _on_card(x, *ys):
        return elementwise_chain_plain(stages, x, ys)
    _no_backward("stream", x, *ys)
    return _chain_cuda(stages, _rows_view(x),
                       tuple(_like(y, x) for y in ys), "elementwise_chain")


def chain_reduce(stages, red: str, x: torch.Tensor, ys=()):
    """Fused chain + reduction tail over the last axis of (rows, n); x
    and the ys may be strided (rows, n) views (a lane stack).

    Returns ``(chain_out (rows, n), reduction (rows,))``: the chain value
    is written once AND reduced in the same pass. The arg tails return the
    winning int32 index (ties first-wins, like ``np.argmax``)."""
    if red not in REDUCE_OPS:
        raise ValueError(red)
    stages = normalize_stages(stages)
    ys = tuple(ys)
    if not _on_card(x, *ys):
        out, red_v = chain_reduce_plain(stages, red, x, ys)
        return out, _arg_int(red, red_v)
    _no_backward("stream", x, *ys)
    x2 = _rows_view(x)
    ys2 = tuple(_like(y, x) for y in ys)
    cut = max(0, len(stages) - MAX_STAGES)
    n_head = sum(1 for op, _ in stages[:cut] if op in _OPS2)
    if cut:
        x2 = _chain_cuda(stages[:cut], x2, ys2[:n_head], "chain_reduce")
    LAUNCHES["chain_reduce"] += 1
    return stream_cuda(stages[cut:], x2, ys2[n_head:], tail=red,
                       red_int=True)


def _arg_int(red: str, red_v: torch.Tensor) -> torch.Tensor:
    """Arg tails store fp32 indices; the wrapper returns int32 (exact
    below 2**24, far above any row length here)."""
    return red_v.to(torch.int32) if red in ("argmin", "argmax") else red_v


# ----------------------------------------------------------------------
# Reductions
# ----------------------------------------------------------------------
def reduce(op: str, x: torch.Tensor) -> torch.Tensor:
    """Reduce over the last axis of (rows, n)."""
    if op not in REDUCE_OPS:
        raise ValueError(op)
    if not _on_card(x):
        return reduce_plain(op, x)
    _no_backward("stream", x)
    two_d = x.dim() == 2
    x2 = _rows_view(x if two_d else x.reshape(-1, x.shape[-1]))
    LAUNCHES["reduce"] += 1
    _, red = stream_cuda((), x2, tail=op, write_out=False, red_int=True)
    return red if two_d else red.reshape(x.shape[:-1])


# ----------------------------------------------------------------------
# Convolution
# ----------------------------------------------------------------------
def conv2d(img: torch.Tensor, ker: torch.Tensor,
           strip_rows: int = 256) -> torch.Tensor:
    """Valid 2-D correlation of an (h, w) plane with (kh, kw) taps, fp32.

    ``strip_rows`` is the reference's host strip height. Every output
    element is computed on its own, so the strips do not change the
    result: the plain version runs over the whole plane, and on the card
    one launch covers it (its grid of tiles replaces the strip loop).
    ``strip_rows`` is only validated."""
    if strip_rows <= 0:
        raise ValueError(f"strip_rows must be positive, got {strip_rows}")
    check_shapes(img, ker)
    if not _on_card(img, ker):
        return conv2d_plain(img, ker)
    _no_backward("conv2d", img, ker)
    LAUNCHES["conv2d"] += 1
    return conv2d_cuda(img, ker)


# ----------------------------------------------------------------------
# Stencils (paper §III-B3: star stencils as per-axis passes)
# ----------------------------------------------------------------------
@functools.lru_cache(maxsize=64)
def _taps_on(values: tuple, device: torch.device) -> torch.Tensor:
    """A tap vector on the card, made once per values and device (a copy
    from the host on every call would wait for the stream)."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def stencil_axis(x: torch.Tensor, coeffs, axis: int) -> torch.Tensor:
    """Valid 1-D stencil along ``axis`` with ``len(coeffs)`` taps, fp32
    out. ``coeffs``: a sequence of floats or a tensor of taps on any
    device, rounded to fp32. On the card ``x`` is viewed as (outer, n,
    inner) around ``axis`` (a copy only if ``x`` is not contiguous) and
    one launch runs it."""
    if not _on_card(x):
        if torch.is_tensor(coeffs):
            coeffs = coeffs.detach().cpu()
        vals = [float(c) for c in np.asarray(coeffs, np.float32).reshape(-1)]
        return stencil1d_plain(x, vals, axis)
    _no_backward("stencil", x)
    axis = axis % x.dim()
    if torch.is_tensor(coeffs):
        taps = coeffs.to(device=x.device, dtype=torch.float32).reshape(-1)
    else:
        taps = _taps_on(tuple(np.asarray(coeffs, np.float32).reshape(-1)
                              .tolist()), x.device)
    LAUNCHES["stencil"] += 1
    out = stencil1d_cuda(as_blocks(x.contiguous(), axis), taps)
    shape = list(x.shape)
    shape[axis] = out.shape[1]
    return out.view(shape)


def laplace(x: torch.Tensor) -> torch.Tensor:
    """n-D discrete Laplace on the interior, the paper's decomposition:
    per axis d, a [1, -2, 1] pass over the slice that is interior on the
    other axes, the passes summed in axis order (the reference's Pallas
    route; ``ref.laplace`` sums in another order). fp32 out; an axis
    shorter than 3 gives an empty interior.

    On the card, a 1-D, 2-D or 3-D array is one ``ntx_laplace`` launch
    that computes the same per-axis terms and sums (bit-equal to
    ``laplace_plain``); x is copied only if it is not contiguous. Four or
    more dimensions take the per-axis route: one ``stencil_axis`` launch
    per axis over a contiguous copy of its interior slice, and torch adds.
    """
    if not _on_card(x):
        return laplace_plain(x)
    _no_backward("stencil", x)
    nd = x.ndim
    if 1 <= nd <= 3:
        if not x.is_contiguous():
            x = x.contiguous()
        if min(x.shape) >= 3:
            LAUNCHES["laplace"] += 1
        return laplace_cuda(x)
    if nd and min(x.shape) < 3:
        return torch.empty(laplace_shape(x.shape), dtype=torch.float32,
                           device=x.device)
    taps = _taps_on(LAPLACE_TAPS, x.device)
    out = None
    for d in range(nd):
        sl = [slice(1, -1)] * nd
        sl[d] = slice(None)
        term = stencil_axis(x[tuple(sl)], taps, d)
        out = term if out is None else out + term
    return out


# ----------------------------------------------------------------------
# Attention
# ----------------------------------------------------------------------
class _Attention(torch.autograd.Function):
    """Attention under autograd, at the training shapes (keys = the whole
    array, no split). Forward: the flash kernel with each row's
    log-sum-exp (CPU tensors: the plain attention and
    :func:`flash_lse_plain`); saves q, k, v, o and lse. Backward: the
    flash backward kernel (CPU tensors: ``ref.mha_blocked_bwd``, the
    reference's flash-style VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        ctx.causal, ctx.scale = causal, scale
        if not q.shape[1]:
            o, lse = _no_heads(q, v)
        elif _on_meta(q, k, v):
            o, lse = _attention_meta(q, k, v, causal, None, lse=True)
        elif _on_card(q, k, v):
            b, hq, sq, d = q.shape
            hkv, skv = k.shape[1], k.shape[2]
            plan = flash_plan(b, hq, hkv, sq, skv, skv, d, q.dtype, causal,
                              lse=True, dv=v.shape[-1])
            LAUNCHES["attention"] += 1
            o, lse = flash_attention_cuda(q, k, v, causal=causal,
                                          scale=scale, plan=plan, lse=True)
        else:
            o = flash_attention_plain(q, k, v, causal=causal, scale=scale)
            lse = flash_lse_plain(q, k, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        kw = dict(causal=ctx.causal, scale=ctx.scale)
        if not q.shape[1]:
            return (torch.zeros_like(q), torch.zeros_like(k),
                    torch.zeros_like(v), None, None)
        if _on_meta(q, k, v, do):
            return (*_attention_bwd_meta(q, k, v, o, lse, do, ctx.causal),
                    None, None)
        if not _on_card(q, k, v, do):
            return (*flash_attention_bwd_plain(q, k, v, o, lse, do, **kw),
                    None, None)
        LAUNCHES["attention_bwd"] += 1
        return (*flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw),
                None, None)


def _no_heads(q, v):
    """(o, lse) of a call without heads (a model rank holding none): empty,
    and nothing launched (a grid with a 0 dimension is a CUDA error)."""
    b, _, sq, _ = q.shape
    return (q.new_empty((b, 0, sq, v.shape[-1])),
            torch.empty((b, 0, sq), dtype=torch.float32, device=q.device))


def attention(q, k, v, *, causal: bool = True, scale=None,
              kv_len: int | None = None, return_lse: bool = False):
    """q: (b, hq, sq, d); k: (b, hkv, skv, d); v: (b, hkv, skv, dv), dv
    equal to d or, for MLA, (d, dv) = (192, 128) on the card
    (``flash_attention.HEAD_PAIRS``; another pair raises ``ValueError``
    there, as the reference computes any pair with its plain attention on
    every backend). Under autograd the call is :class:`_Attention` and
    takes the training shapes: ``kv_len`` None (or skv) and, if causal,
    sq <= skv; anything else raises. A q without heads (a model rank
    that holds none) gives an empty output and launches nothing.

    ``return_lse`` (outside autograd only): return ``(o, lse)``, each
    row's fp32 natural log-sum-exp of the scaled logits (b, hq, sq) beside
    o, from the same plan (a split one writes it in the merge), so that
    partial results over blocks of the keys can be merged
    (``models.common.merge_partials``). CPU tensors: the plain attention
    and :func:`flash_lse_plain`. ``kv_len`` must be at least 1: a block
    without a valid key is the caller's (o 0, lse -inf)."""
    if return_lse:
        return _attention_lse(q, k, v, bool(causal), scale, kv_len)
    if _tracked(q, k, v):
        skv = k.shape[2]
        if (kv_len is not None and kv_len != skv) or (
                causal and q.shape[2] > skv):
            raise NotImplementedError(
                f"attention under autograd takes the training shapes (keys "
                f"= the whole array, sq <= skv if causal), got sq "
                f"{q.shape[2]} skv {skv} kv_len {kv_len}; run decode under "
                f"torch.no_grad()")
        return _Attention.apply(q, k, v, bool(causal), scale)
    if not q.shape[1]:
        return _no_heads(q, v)[0]
    if _on_meta(q, k, v):
        return _attention_meta(q, k, v, bool(causal), kv_len)
    if not _on_card(q, k, v):
        # the reference's ref branch; its mha_blocked switch for long
        # sequences computes the same forward as mha
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     kv_len=kv_len)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    plan = flash_plan(b, hq, hkv, sq, skv, skv if kv_len is None else
                      int(kv_len), d, q.dtype, bool(causal),
                      dv=v.shape[-1])
    LAUNCHES["attention"] += 1
    if plan.splits > 1:
        LAUNCHES["attention_merge"] += 1
    return flash_attention_cuda(q, k, v, causal=causal, scale=scale,
                                kv_len=kv_len, plan=plan)


def _attention_lse(q, k, v, causal: bool, scale, kv_len):
    """``attention(..., return_lse=True)``: (o, lse) by the serving plan
    (splits allowed; the merge writes lse)."""
    if _tracked(q, k, v):
        raise NotImplementedError("attention's lse output is for decode "
                                  "merges; run it under torch.no_grad()")
    if not q.shape[1]:
        return _no_heads(q, v)
    skv = k.shape[2]
    kv = skv if kv_len is None else int(kv_len)
    if kv < 1:
        raise ValueError(f"attention with lse over kv_len {kv}: a block "
                         f"without keys has o 0 and lse -inf")
    if _on_meta(q, k, v):
        return _attention_meta(q, k, v, causal, kv_len, lse=True,
                               split=True)
    if not _on_card(q, k, v):
        return (flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                      kv_len=kv_len),
                flash_lse_plain(q, k, causal=causal, scale=scale,
                                kv_len=kv_len))
    b, hq, sq, d = q.shape
    plan = flash_plan(b, hq, k.shape[1], sq, skv, kv, d, q.dtype, causal,
                      dv=v.shape[-1])
    LAUNCHES["attention"] += 1
    if plan.splits > 1:
        LAUNCHES["attention_merge"] += 1
    return flash_attention_cuda(q, k, v, causal=causal, scale=scale,
                                kv_len=kv_len, plan=plan, lse=True)


def _attention_meta(q, k, v, causal: bool, kv_len, lse: bool = False,
                    split: bool = False):
    """The meta route of the flash forward: the kernel's checks and
    :func:`flash_plan`; ``2 (d + dv)`` operations an unmasked (query, key)
    pair; q and the first ``kv_len`` keys and values read. An unsplit
    plan writes o (and ``lse``: each row's fp32 log-sum-exp); a split one
    writes its partials, which the merge (``attention_merge``) reads and
    turns into o (and lse). ``split``: plan as serving does, splits
    allowed, even with ``lse`` (training's lse plans unsplit)."""
    flash_check(q, k, v)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    kv = skv if kv_len is None else int(kv_len)
    plan = flash_plan(b, hq, hkv, sq, skv, kv, d, q.dtype, causal,
                      lse and not split, dv)
    o = torch.empty((b, hq, sq, dv), dtype=q.dtype, device="meta")
    lse_t = (torch.empty((b, hq, sq), dtype=torch.float32, device="meta")
             if lse else None)
    pairs = b * hq * attention_pairs(sq, kv, causal)
    kv_bytes = b * hkv * min(kv, skv) * (d + dv) * k.element_size()
    ws_bytes = 4 * plan.workspace
    out_bytes = ws_bytes if plan.splits > 1 else _nbytes(o, lse_t)
    _tally("attention", 2 * pairs * (d + dv),
           _nbytes(q) + kv_bytes + out_bytes)
    if plan.splits > 1:
        _tally("attention_merge", 0, ws_bytes + _nbytes(o, lse_t))
    return (o, lse_t) if lse else o


def _attention_bwd_meta(q, k, v, o, lse, do, causal: bool):
    """The meta route of the flash backward: the kernel's checks and
    :func:`flash_bwd_plan`; 5 products an unmasked pair (S = Q K^T, dP =
    dO V^T, dV += P^T dO, dQ += dS K, dK += dS^T Q); q, k, v, o, dO and
    lse read, dq, dk and dv written."""
    flash_bwd_check(q, k, v, o, lse, do)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    flash_bwd_plan(b, hq, hkv, sq, skv, d, q.dtype, causal, dv)
    grads = tuple(torch.empty(t.shape, dtype=t.dtype, device="meta")
                  for t in (q, k, v))
    pairs = b * hq * attention_pairs(sq, skv, causal)
    _tally("attention_bwd", 2 * pairs * (3 * d + 2 * dv),
           _nbytes(q, k, v, o, lse, do, *grads))
    return grads


_SPLIT_DECODE = "a decode step runs it under torch.no_grad()"


def attention_split_logits(q: torch.Tensor, k: torch.Tensor,
                           kv_len: int) -> torch.Tensor:
    """The partial logits of a decode over a cache split by head_dim: q
    (b, hq, s, db) and k (b, hkv, S, db), this rank's block of head_dim,
    -> fp32 (b, hq, s, kv_len), ``sum_d q k`` over the block for the first
    ``kv_len`` keys, unscaled (summed over the model ranks, the whole
    logits). On the card ``csrc/ntx_attn_split.cu``'s logits kernel."""
    if _on_meta(q, k):
        attention_split_check(q, k, kv_len)
        b, hq, s, db = q.shape
        out = torch.empty((b, hq, s, kv_len), dtype=torch.float32,
                          device="meta")
        _tally("attention_split_logits", 2 * b * hq * s * kv_len * db,
               _nbytes(q, out) + b * k.shape[1] * kv_len * db
               * k.element_size())
        return out
    if not _on_card(q, k):
        return attention_split_logits_plain(q, k, kv_len)
    _no_backward("attention_split_logits", q, k, why=_SPLIT_DECODE)
    LAUNCHES["attention_split_logits"] += 1
    return attention_split_logits_cuda(q, k, kv_len)


def attention_split_softmax_pv(logits: torch.Tensor, v: torch.Tensor,
                               q_pos: int, scale: float,
                               causal: bool = True) -> torch.Tensor:
    """The attention output over this rank's block of head_dim from the
    whole logits (b, hq, s, kv_len) fp32 (:func:`attention_split_logits`
    summed over the model ranks): the softmax of ``logits * scale``, query
    row i seeing keys <= ``q_pos + i`` when ``causal``, times the first
    kv_len rows of v (b, hkv, S, db) -> (b, hq, s, db) in v's dtype. On
    the card ``csrc/ntx_attn_split.cu``'s softmax-PV kernel (and its
    split merge)."""
    if _on_meta(logits, v):
        attention_split_pv_check(logits, v, q_pos, causal)
        b, hq, s, kv = logits.shape
        db = v.shape[-1]
        o = torch.empty((b, hq, s, db), dtype=v.dtype, device="meta")
        ws = split_pv_plan(b, hq, v.shape[1], s, kv, db).workspace
        _tally("attention_split_softmax_pv", 2 * b * hq * s * kv * db,
               _nbytes(logits, o) + b * v.shape[1] * kv * db
               * v.element_size() + 2 * 4 * ws)
        return o
    if not _on_card(logits, v):
        return attention_split_softmax_pv_plain(logits, v, q_pos, scale,
                                                causal)
    _no_backward("attention_split_softmax_pv", logits, v,
                 why=_SPLIT_DECODE)
    LAUNCHES["attention_split_softmax_pv"] += 1
    return attention_split_softmax_pv_cuda(logits, v, q_pos, scale, causal)


def _ssd_meta(x, dt, A, B, C, chunk: int, final_state: bool = False):
    """The meta route of the SSD kernel: its checks and :func:`scan_plan`,
    the scan's operations on this data (:func:`ssd_flops`); x, dt, A, B, C
    read, y (and the fp32 final state) written."""
    ssd_check(x, dt, A, B, C)
    b, l, h, dh = x.shape
    n = B.shape[-1]
    scan_plan(b, l, h, dh, n, chunk, x.dtype == torch.bfloat16)
    y = torch.empty(x.shape, dtype=x.dtype, device="meta")
    s = (torch.empty((b, h, n, dh), dtype=torch.float32, device="meta")
         if final_state else None)
    _tally("ssd_state" if final_state else "ssd",
           ssd_flops(b, l, h, dh, n, chunk), _nbytes(x, dt, A, B, C, y, s))
    return (y, s) if final_state else y


# ----------------------------------------------------------------------
# SSD scan
# ----------------------------------------------------------------------
class _SSD(torch.autograd.Function):
    """Forward: the SSD kernel (CUDA tensors) or its plain version (CPU
    tensors). Backward: ``csrc/ssd_scan_bwd.cu`` (CUDA tensors) or its
    plain version (CPU tensors), from the saved inputs: the reference
    differentiates its jnp chunked form outside any Pallas kernel, so the
    backward kernel has no TPU counterpart."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        ctx.chunk = chunk
        ctx.save_for_backward(x, dt, A, B, C)
        if _on_meta(x, dt, A, B, C):
            return _ssd_meta(x, dt, A, B, C, chunk)
        if not _on_card(x, dt, A, B, C):
            return ssd_scan_plain(x, dt, A, B, C, chunk=chunk)
        if any(ctx.needs_input_grad):
            # a shape the backward refuses raises here, before the step
            b, l, h, dh = x.shape
            ssd_bwd_plan(b, l, h, dh, B.shape[-1], chunk,
                         x.dtype == torch.bfloat16)
        LAUNCHES["ssd"] += 1
        return ssd_scan_cuda(x, dt, A, B, C, chunk=chunk)

    @staticmethod
    def backward(ctx, gy):
        saved = ctx.saved_tensors
        with torch.profiler.record_function("ssd_bwd"):
            if _on_meta(*saved, gy):
                grads = _ssd_bwd_meta(*saved, gy, ctx.chunk)
            elif not _on_card(*saved, gy):
                grads = ssd_scan_bwd_plain(*saved, gy, chunk=ctx.chunk)
            else:
                LAUNCHES["ssd_bwd"] += 1
                grads = ssd_scan_bwd_cuda(*saved, gy, chunk=ctx.chunk)
        return (*(g if need else None
                  for g, need in zip(grads, ctx.needs_input_grad)), None)


def _ssd_bwd_meta(x, dt, A, B, C, gy, chunk: int):
    """The meta route of the SSD backward kernel: its checks and
    :func:`ssd_bwd_plan`, the backward's operations on this data
    (:func:`ssd_bwd_flops`); x, dt, A, B, C and gy read, the five
    gradients written."""
    ssd_bwd_check(x, dt, A, B, C, gy)
    b, l, h, dh = x.shape
    n = B.shape[-1]
    ssd_bwd_plan(b, l, h, dh, n, chunk, x.dtype == torch.bfloat16)
    grads = tuple(torch.empty(t.shape, dtype=t.dtype, device="meta")
                  for t in (x, dt, A, B, C))
    _tally("ssd_bwd", ssd_bwd_flops(b, l, h, dh, n, chunk),
           _nbytes(x, dt, A, B, C, gy, *grads))
    return grads


def ssd(x, dt, A, B, C, chunk: int = 64,
        work_dtype=torch.float32) -> torch.Tensor:
    """Mamba-2 SSD scan. x: (b, l, h, dh); dt: (b, l, h); A: (h,); B/C:
    (b, l, n). Any l (a ragged last chunk is masked). ``work_dtype`` is
    accepted for the reference's signature and, as on its Pallas path,
    not used: the kernel and its plain version compute in fp32 (the
    kernel's bf16 route splits each fp32 operand exactly into bf16 parts
    for the tensor cores)."""
    del work_dtype
    return _SSD.apply(x, dt, A, B, C, chunk)


def ssd_with_state(x, dt, A, B, C, chunk: int = 64):
    """The SSD scan that prefill runs: (y, the recurrent state after the
    last step, (b, h, n, dh) fp32), which decode continues from. The
    kernel's y is bit-equal to :func:`ssd`'s; the state comes from its
    carry pass. The kernel has no backward: prefill runs under inference
    mode, and training differentiates :func:`ssd`."""
    meta = _on_meta(x, dt, A, B, C)
    if not meta and not _on_card(x, dt, A, B, C):
        return ssd_scan_with_state_plain(x, dt, A, B, C, chunk=chunk)
    _no_backward("ssd_with_state", x, dt, A, B, C,
                 why="prefill runs it under inference mode; training "
                     "differentiates ops.ssd")
    if meta:
        return _ssd_meta(x, dt, A, B, C, chunk, final_state=True)
    LAUNCHES["ssd_state"] += 1
    return ssd_scan_cuda(x, dt, A, B, C, chunk=chunk, final_state=True)


# ----------------------------------------------------------------------
# Fused optimizer
# ----------------------------------------------------------------------
def adamw_update(p, g, m, v, step, *, lr, b1=0.9, b2=0.999, eps=1e-8,
                 wd=0.01):
    """One fused AdamW step over same-shaped tensors; returns new
    ``(p, m, v)`` (p in its dtype, m and v fp32). ``lr`` is a float or a
    0-d tensor on the CPU and enters the kernel as a launch argument."""
    lr = float(lr)
    if _on_meta(p, g, m, v):
        adamw_check(p, g, m, v)
        outs = (torch.empty(p.shape, dtype=p.dtype, device="meta"),
                *(torch.empty(p.shape, dtype=torch.float32, device="meta")
                  for _ in range(2)))
        reads = p.numel() * (p.element_size() + 12)     # p; fp32 g, m, v
        _tally("adamw", 0, reads + _nbytes(*outs))
        return outs
    if not _on_card(p, g, m, v):
        return adamw_plain(p, g, m, v, step, lr=lr, b1=b1, b2=b2, eps=eps,
                           wd=wd)
    LAUNCHES["adamw"] += 1
    return adamw_cuda(p, g, m, v, step, lr=lr, b1=b1, b2=b2, eps=eps, wd=wd)
