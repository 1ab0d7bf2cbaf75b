"""The SSD scan's backward (``ssd_scan.ssd_scan_bwd_plain``, the plain
version of ``csrc/ssd_scan_bwd.cu``, and ``ops.ssd``'s backward on CPU
tensors) against autograd of the port's plain forward and ``jax.grad`` of
the JAX reference's oracles; the backward kernel's plan.

Inputs are numpy draws from a seed, as ``tests/test_torch_ssd.py`` makes
them. Gradients are compared relative to their largest entry: against
autograd of ``ssd_scan_plain`` at 1e-5 (both fp32, differing only in
summation order), against the reference at 1e-3 (the tolerance of
``test_backward_matches_jax_grad_of_sequential``).
"""
import re
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.kernels import ref as jref

from repro_torch import configs
from repro_torch.kernels import ops, ssd_scan

from test_torch_ssd import _inputs, _strong_case

CSRC = Path(ssd_scan.__file__).resolve().parent / "csrc"

#: (b, l, h, dh, n, chunk)
CASES = [
    (2, 80, 3, 16, 32, 16),
    (2, 80, 3, 16, 32, 40),
    (1, 100, 3, 24, 16, 40),      # ragged: 2 x 40 + 20
    (2, 20, 1, 16, 16, 32),       # l < chunk
    (2, 1, 3, 16, 32, 16),        # one step
    (1, 64, 9, 24, 32, 64),       # l = chunk; 9 heads cross HEADS_PER_BLOCK
    (1, 48, 9, 16, 16, 16),
]
NAMES = ("dx", "ddt", "dA", "dB", "dC")


def _case(shape, seed=5):
    b, l, h, dh, n, _ = shape
    arrs = _inputs(seed, b, l, h, dh, n)
    gy = np.random.default_rng(seed + 100).standard_normal(
        arrs[0].shape).astype(np.float32)
    return arrs, gy


def _autograd(ins, gy, chunk):
    xs = [t.detach().clone().requires_grad_() for t in ins]
    y = ssd_scan.ssd_scan_plain(*xs, chunk=chunk)
    return torch.autograd.grad(y, xs, gy)


def _close(got, want, rel, name):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    assert np.isfinite(got).all(), name
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (name, err, scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", CASES)
def test_plain_backward_matches_autograd(shape, dtype):
    """Every gradient within 1e-5 of its largest entry. With bf16 x, B, C
    both sides round dx, dB, dC from fp32 once, so those may also sit one
    bf16 ulp (at most 2**-7 of the value) apart."""
    arrs, gy = _case(shape)
    dt_ = getattr(torch, dtype)
    ins = [torch.from_numpy(a) for a in arrs]
    ins = [t.to(dt_) if i in (0, 3, 4) else t for i, t in enumerate(ins)]
    g = torch.from_numpy(gy).to(dt_)
    got = ssd_scan.ssd_scan_bwd_plain(*ins, g, chunk=shape[-1])
    want = _autograd(ins, g, shape[-1])
    for i, (a, w) in enumerate(zip(got, want)):
        assert a.dtype == w.dtype == ins[i].dtype, NAMES[i]
        a, w = a.float(), w.float()
        if dtype == "bfloat16" and i in (0, 3, 4):
            assert bool(((a - w).abs() <= 2.0 ** -7 * w.abs()
                         + 1e-5 * w.abs().max()).all()), NAMES[i]
        else:
            _close(a, w, 1e-5, NAMES[i])


def _jax_grads(fn, arrs, gy):
    def loss(*a):
        return jnp.sum(fn(*a) * gy)
    return jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in arrs))


@pytest.mark.parametrize("shape", CASES)
def test_plain_backward_matches_jax_grad(shape):
    """Against ``jax.grad`` of the reference's sequential scan, and of its
    jnp chunked form where the length is a multiple of the chunk (the
    form asserts it) and its gradients are finite."""
    arrs, gy = _case(shape)
    chunk = shape[-1]
    got = ssd_scan.ssd_scan_bwd_plain(*(torch.from_numpy(a) for a in arrs),
                                      torch.from_numpy(gy), chunk=chunk)
    want = _jax_grads(jref.ssd_scan, arrs, gy)
    for name, a, w in zip(NAMES, got, want):
        _close(a.numpy(), w, 1e-3, name)
    if shape[1] % chunk == 0:
        chunked = _jax_grads(lambda *a: jref.ssd_scan_chunked(*a, chunk=chunk),
                             arrs, gy)
        assert all(np.isfinite(np.asarray(w)).all() for w in chunked)
        for name, a, w in zip(NAMES, got, chunked):
            _close(a.numpy(), w, 1e-3, name)


def test_strong_decay_chunk128_matches_sequential_oracle():
    """The model's own distributions at the real chunk of 128 (ROADMAP
    queue 3 record 2): the reference's jnp chunked form is NaN there, so
    only its sequential scan is the oracle; the masked exponents keep the
    plain backward finite and on it."""
    arrs = _strong_case()
    gy = np.random.default_rng(9).standard_normal(
        arrs[0].shape).astype(np.float32)
    got = ssd_scan.ssd_scan_bwd_plain(*(torch.from_numpy(a) for a in arrs),
                                      torch.from_numpy(gy), chunk=128)
    want = _jax_grads(jref.ssd_scan, arrs, gy)
    for name, a, w in zip(NAMES, got, want):
        _close(a.numpy(), w, 1e-3, name)
    auto = _autograd([torch.from_numpy(a) for a in arrs],
                     torch.from_numpy(gy), 128)
    for name, a, w in zip(NAMES, got, auto):
        _close(a, w, 1e-5, name)


@pytest.mark.parametrize("requires", [(True,) * 5,
                                      (True, False, False, True, True)])
def test_ops_ssd_backward_on_cpu_is_the_plain_version(requires):
    """``ops.ssd``'s backward on CPU tensors returns the plain backward's
    gradients, bit for bit, for the inputs that need them (None for the
    rest), and counts no launch."""
    shape = CASES[2]
    arrs, gy = _case(shape)
    ins = [torch.from_numpy(a).requires_grad_(r)
           for a, r in zip(arrs, requires)]
    ops.reset_launches()
    y = ops.ssd(*ins, chunk=shape[-1])
    need = [t for t in ins if t.requires_grad]
    got = iter(torch.autograd.grad(y, need, torch.from_numpy(gy)))
    want = ssd_scan.ssd_scan_bwd_plain(*(t.detach() for t in ins),
                                       torch.from_numpy(gy), chunk=shape[-1])
    for t, w in zip(ins, want):
        if t.requires_grad:
            assert torch.equal(next(got), w)
    assert ops.launches()["ssd_bwd"] == 0


def test_plain_backward_of_an_empty_sequence():
    x = torch.zeros(2, 0, 3, 16)
    dt, B = torch.zeros(2, 0, 3), torch.zeros(2, 0, 8)
    got = ssd_scan.ssd_scan_bwd_plain(x, dt, -torch.ones(3), B, B, x,
                                      chunk=16)
    assert [tuple(g.shape) for g in got] == [(2, 0, 3, 16), (2, 0, 3), (3,),
                                             (2, 0, 8), (2, 0, 8)]
    assert not got[2].any()


def test_bwd_flops_sum_over_chunks():
    """``ssd_bwd_flops`` per chunk of L steps: L (L + 1) (3 n + 2 dh) over
    the pairs and 10 L n dh for the state products, a short last chunk at
    its own length."""
    b, h, dh, n = 2, 3, 16, 32
    per = lambda L: L * (L + 1) * (3 * n + 2 * dh) + 10 * L * n * dh
    assert ssd_scan.ssd_bwd_flops(b, 100, h, dh, n, 40) == b * h * (
        2 * per(40) + per(20))
    assert ssd_scan.ssd_bwd_flops(b, 0, h, dh, n, 40) == 0


def _const(name: str) -> int:
    got = re.search(rf"constexpr int {name} = (\d+);",
                    (CSRC / "ssd_scan_bwd.cu").read_text())
    return int(got.group(1))


def test_bwd_constants_match_the_kernel_source():
    assert _const("kMaxHeadDim") == ssd_scan.MAX_HEAD_DIM
    src = (CSRC / "ssd_scan_bwd.cu").read_text()
    assert '#include "ssd_scan.cuh"' in src
    assert "int ntx_ssd_scan_bwd(" in src


def _ssm_shapes():
    """(name, h, dh, n, chunk) of every SSM config at full size and at an
    8-way model axis's shard (``ssd:tp8``)."""
    out = []
    for arch in ("mamba2-1.3b", "jamba-v0.1-52b"):
        cfg = configs.get(arch)
        for tp in (1, 8):
            out.append((f"{arch}/tp{tp}", cfg.ssm_heads // tp,
                        cfg.ssm_headdim, cfg.d_state, cfg.ssm_chunk))
    return out


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("name,h,dh,n,chunk", _ssm_shapes())
def test_bwd_plan_fits_at_the_ssm_shapes(name, h, dh, n, chunk, bf16):
    """The full configs (mamba2-1.3b 64 heads, jamba 128 heads at d_state
    16) and their 8-way shards (8 / 16 heads) at batch 8 x 1024: the plan
    fits a block's shared memory with all of d_state staged at once."""
    p = ssd_scan.ssd_bwd_plan(8, 1024, h, dh, n, chunk, bf16)
    assert p.smem == ssd_scan.grad_smem(bf16, p.lp, p.dp, p.nb, p.heads)
    assert p.smem <= ssd_scan.MAX_SMEM
    assert (p.lp, p.dp, p.heads) == (128, 64, 8)
    assert p.head_groups == h // 8 and p.fwd.nc == 8
    if bf16:
        assert (p.nb, p.n_tiles) == (-(-n // 16) * 16, 1)


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("chunk", [1, 16, 50, 128])
@pytest.mark.parametrize("n", [16, 100, 128, 256])
@pytest.mark.parametrize("dh", [16, 48, 128])
def test_bwd_plan_takes_what_the_forward_takes(bf16, chunk, n, dh):
    """Every shape the forward's plan takes, the backward's takes too,
    staging d_state in the widest multiple of 16 that fits; its n-tiles
    cover d_state."""
    try:
        ssd_scan.scan_plan(2, 300, 12, dh, n, chunk, bf16)
    except ValueError:
        return
    p = ssd_scan.ssd_bwd_plan(2, 300, 12, dh, n, chunk, bf16)
    assert p.nb % 16 == 0 and 16 <= p.nb <= p.fwd.np
    assert p.n_tiles * p.nb >= p.fwd.np > (p.n_tiles - 1) * p.nb
    assert p.smem <= ssd_scan.MAX_SMEM
    if p.nb < p.fwd.np:     # all of d_state would not fit
        assert ssd_scan.grad_smem(bf16, p.lp, p.dp, p.fwd.np,
                                  p.heads) > ssd_scan.MAX_SMEM


@pytest.mark.parametrize("args", [dict(chunk=0), dict(chunk=129),
                                  dict(dh=129), dict(n=0)])
def test_bwd_plan_refuses_what_the_kernel_cannot_run(args):
    shape = dict(b=1, l=256, h=4, dh=64, n=128, chunk=128)
    shape.update(args)
    for bf16 in (True, False):
        with pytest.raises(ValueError):
            ssd_scan.ssd_bwd_plan(**shape, bf16=bf16)
