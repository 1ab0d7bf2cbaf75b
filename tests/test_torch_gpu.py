"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``gpu`` marker and skips where no CUDA
device is visible (decided in a fixture, so every worker collects the
same tests). The file imports only torch and the port, so it runs on a
machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ntx_elementwise as tew
from repro_torch.kernels import ntx_gemm as tgemm
from repro_torch.kernels import ntx_reduce as tred
from repro_torch.kernels import ops

RNG = np.random.default_rng(11)
pytestmark = pytest.mark.gpu


def _t(shape, dev, scale=1.0):
    return torch.from_numpy(
        (RNG.standard_normal(shape) * scale).astype(np.float32)).to(dev)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [3, 70])
def test_gemm_kernel(cuda, dtype, m):
    dt = getattr(torch, dtype)
    a, b = _t((m, 300), cuda).to(dt), _t((300, 90), cuda, 0.1).to(dt)
    ep = ops._norm_epilogue([("bias", _t((90,), cuda)), "silu",
                             ("residual", _t((m, 90), cuda))])
    got = tgemm.gemm_cuda(a, b, torch.float32, ep)
    want = tgemm.gemm_plain(a, b, torch.float32, ep)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,skv,kv_len", [(37, 77, 60), (1, 56, 9),
                                           (16, 16, 16)])
def test_flash_kernel(cuda, dtype, sq, skv, kv_len):
    dt = getattr(torch, dtype)
    q = _t((2, 8, sq, 128), cuda, 0.3).to(dt)
    k = _t((2, 2, skv, 128), cuda, 0.3).to(dt)
    v = _t((2, 2, skv, 128), cuda).to(dt)
    got = tfa.flash_attention_cuda(q, k, v, causal=True, kv_len=kv_len)
    want = tfa.flash_attention_plain(q, k, v, causal=True, kv_len=kv_len)
    tol = 1e-4 if dtype == "float32" else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("red", ["min", "max", "argmin", "argmax"])
def test_stream_kernel_bit_equal(cuda, red):
    x, y = _t((4, 5000), cuda), _t((4, 5000), cuda)
    x[:, [7, 4000]] = x.max() + 1          # ties across threads
    x[:, [9, 4500]] = x.min() - 1
    stages = [("axpy", 1.25), ("thresh", 0.1)]
    out, r = tew.stream_cuda(stages, x, (y,), tail=red)
    w_out, w_r = tred.chain_reduce_plain(stages, red, x, (y,))
    assert torch.equal(out, w_out) and torch.equal(r, w_r)


def test_ops_route_cuda_tensors_to_the_kernels(cuda):
    ops.reset_launches()
    x = _t((2, 300), cuda)
    ops.reduce("argmax", x)
    ops.elementwise_chain([("relu", 0.0)] * 10, x)
    assert ops.launches()["reduce"] == 1
    assert ops.launches()["elementwise_chain"] == 2    # 10 stages: 8 + 2


def test_dispatch_engine_fallback_stays_on_the_card(cuda):
    """A nest no kernel matches runs on the torch engine on the card and
    agrees with the numpy engine; a prefix-store nest raises there."""
    import importlib
    from repro_torch.core import descriptor as d
    from repro_torch.core import engine
    dispatch = importlib.import_module("repro_torch.core.dispatch")
    nest = d.laplace1d(50, 0, 200, 1024)
    mem = _t((4096,), "cpu")
    want = engine.execute_vectorized(nest, mem.numpy())
    dispatch.reset_engine_fallbacks()
    got = dispatch.dispatch(nest, mem.to(cuda))
    assert got.is_cuda and dispatch.engine_fallbacks == 1
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    running_dot = d.Descriptor(
        bounds=(5,), opcode=d.Opcode.MAC, init_level=1, store_level=0,
        agu0=d.Agu(0, (1,)), agu1=d.Agu(100, (1,)), agu2=d.Agu(1000, (1,)))
    with pytest.raises(NotImplementedError):
        dispatch.dispatch(running_dot, mem.to(cuda))
    assert dispatch.engine_fallbacks == 1


def _ssd_inputs(dev, b, l, h, dh, n, dtype):
    rng = np.random.default_rng(5)
    f = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    x = f(rng.standard_normal((b, l, h, dh))).to(dtype)
    dt = f(np.log1p(np.exp(rng.standard_normal((b, l, h)))))
    A = f(-np.exp(rng.uniform(np.log(0.25), np.log(4.0), h)))
    B = f(0.3 * rng.standard_normal((b, l, n))).to(dtype)
    C = f(0.3 * rng.standard_normal((b, l, n))).to(dtype)
    return x, dt, A, B, C


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("l,chunk,h,dh,n", [(256, 128, 4, 64, 128),
                                            (200, 64, 3, 16, 32),
                                            (96, 16, 2, 32, 32)])
def test_ssd_kernel(cuda, dtype, l, chunk, h, dh, n):
    """The SSD kernel against its plain version: the reference's 1e-3 in
    fp32; in bf16 both round an fp32 result, so one bf16 ulp apart."""
    from repro_torch.kernels import ssd_scan
    ins = _ssd_inputs(cuda, 2, l, h, dh, n, getattr(torch, dtype))
    got = ssd_scan.ssd_scan_cuda(*ins, chunk=chunk)
    want = ssd_scan.ssd_scan_plain(*ins, chunk=chunk)
    tol = 1e-3 if dtype == "float32" else 1e-2
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("p_dtype", ["float32", "bfloat16"])
def test_adamw_kernel(cuda, p_dtype):
    """The fused AdamW kernel against its plain version, at the
    reference's 1e-5 / 1e-6 (p in bf16: one bf16 ulp, <= 2**-7 of p)."""
    p = _t((33, 4501), cuda, 0.02).to(getattr(torch, p_dtype))
    g, m = _t((33, 4501), cuda, 1e-3), _t((33, 4501), cuda, 1e-4)
    v = _t((33, 4501), cuda, 1e-7).abs()
    got = tew.adamw_cuda(p, g, m, v, 7, lr=3e-4)
    want = tew.adamw_plain(p, g, m, v, 7, lr=3e-4)
    assert got[0].dtype == p.dtype
    rtol = 1e-5 if p_dtype == "float32" else 2.0 ** -7
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), rtol=rtol, atol=1e-6)


def test_kernels_without_backward_raise_under_autograd(cuda):
    """A CUDA route without a backward refuses tensors that autograd
    tracks, instead of returning a result no gradient reaches."""
    a = _t((8, 64), cuda).requires_grad_()
    b = _t((64, 16), cuda)
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.gemm(a, b)
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.reduce("sum", a)
    with torch.no_grad():
        ops.gemm(a, b)
    q = _t((1, 2, 4, 64), cuda).requires_grad_()
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.attention(q, q.detach(), q.detach())


def test_ssd_gradient_on_the_card(cuda):
    """ops.ssd on the card: the kernel forward, the PyTorch backward,
    both against the CPU."""
    ins = _ssd_inputs("cpu", 1, 160, 2, 16, 32, torch.float32)
    outs = []
    for dev in (cuda, "cpu"):
        xs = [t.to(dev).requires_grad_() for t in ins]
        y = ops.ssd(*xs, chunk=64)
        grads = torch.autograd.grad((y * y).sum(), xs)
        outs.append([y.cpu(), *(g.cpu() for g in grads)])
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3)


def test_train_step_on_the_card(cuda):
    """Two layers of the reduced mamba2 config: the gradients, leaf by
    leaf, and one build_step_fn step on the card and on the CPU from the
    same weights and batch."""
    import copy
    from repro_torch import configs
    from repro_torch.data import SyntheticLM
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.runtime import build_step_fn
    cfg = configs.get_reduced("mamba2-1.3b").scaled(
        n_layers=2, compute_dtype="float32", param_dtype="float32")
    model = Model(cfg)
    p_cpu = model.init(0, device="cpu", trainable=True)
    p_gpu = copy.deepcopy(p_cpu).to(cuda)
    batch = SyntheticLM(cfg, 2, 48, seed=0).batch_at(0)
    opt_cfg = AdamWConfig(warmup_steps=1, total_steps=10)
    ops.reset_launches()
    res = []
    for dev, params in ((cuda, p_gpu), ("cpu", p_cpu)):
        named = dict(params.named_parameters())
        b = {k: v.to(dev) for k, v in batch.items()}
        loss, _ = model.loss(params, b)
        grads = {n: g.cpu() for n, g in zip(named, torch.autograd.grad(
            loss, list(named.values())))}
        _, state, loss, _ = build_step_fn(cfg, opt_cfg)(
            params, init_opt_state(named), b)
        res.append((float(loss), grads, {n: p.detach().cpu()
                                         for n, p in named.items()}))
    assert ops.launches()["ssd"] == 4 * cfg.n_layers
    assert abs(res[0][0] - res[1][0]) <= 1e-4 * abs(res[1][0])
    # fp32 on both sides: each leaf's gradient within 1e-4 relative L2
    for n, want in res[1][1].items():
        err = float((res[0][1][n] - want).norm() / want.norm())
        assert err <= 1e-4, (n, err)
    for n, want in res[1][2].items():
        # the first AdamW step moves every element by about +-lr whatever
        # its gradient (held above), so near-zero gradients may go either
        # way: this holds the update's size and finiteness
        torch.testing.assert_close(res[0][2][n], want, rtol=1e-5,
                                   atol=2 * 3e-4)
