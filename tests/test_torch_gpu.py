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
    torch.backends.cudnn.allow_tf32 = False
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


# ----------------------------------------------------------------------
# The paper's kernel suite: conv, the stencil pass, the compensated GEMM
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("img_shape,ker_shape", [
    ((64, 96), (3, 3)), ((64, 96), (7, 7)), ((130, 70), (5, 5)),
    ((9, 9), (7, 7)), ((1, 50), (1, 3)), ((50, 1), (3, 1)),
    # taps past the 48 KB halo tile: chunks of tap columns, of tap rows
    ((70, 300), (3, 200)), ((400, 40), (300, 5))])
def test_conv_kernel_bit_equal(cuda, dtype, img_shape, ker_shape):
    """The conv kernel pins every product's rounding, so it is bit-equal
    to its plain version, ragged edges, bf16 planes and chunked taps
    included."""
    from repro_torch.kernels import ntx_conv
    img = _t(img_shape, cuda).to(getattr(torch, dtype))
    ker = _t(ker_shape, cuda, 0.3)
    got = ntx_conv.conv2d_cuda(img, ker)
    want = ntx_conv.conv2d_plain(img, ker)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,axis,k", [
    ((12, 14, 16), 0, 3), ((12, 14, 16), 1, 5), ((12, 14, 16), 2, 3),
    ((1, 50), 1, 3), ((50, 1), 0, 3), ((7, 9), 1, 7), ((3, 5000, 2), 1, 4),
    ((40, 33, 70), 2, 70)])
def test_stencil_kernel_bit_equal(cuda, dtype, shape, axis, k):
    """The stencil pass along any axis of a contiguous block (a view as
    (outer, n, inner)), bit-equal to its plain version."""
    x = _t(shape, cuda).to(getattr(torch, dtype))
    coeffs = [float(c) for c in RNG.standard_normal(k).astype(np.float32)]
    ops.reset_launches()
    got = ops.stencil_axis(x, coeffs, axis)
    assert ops.launches()["stencil"] == 1
    from repro_torch.kernels import ntx_stencil
    want = ntx_stencil.stencil1d_plain(x, coeffs, axis)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_stencil_axis_takes_taps_on_the_card(cuda):
    """A tensor of taps already on the card, as the reference's
    ``ops.stencil_axis`` takes an array of taps: the same result as the
    same floats, in one launch each."""
    x = _t((12, 14, 16), cuda)
    coeffs = [float(c) for c in RNG.standard_normal(5).astype(np.float32)]
    ops.reset_launches()
    got = ops.stencil_axis(x, torch.tensor(coeffs, device=cuda), 1)
    want = ops.stencil_axis(x, coeffs, 1)
    assert ops.launches()["stencil"] == 2
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", [(300,), (40, 50), (12, 14, 16),
                                   (3, 1000, 4)])
def test_laplace_on_the_card_matches_the_cpu(cuda, shape):
    """One stencil launch per axis; the passes are bit-equal to the
    plain versions and the sums are the same torch adds, so the card
    gives the CPU's values."""
    x = _t(shape, "cpu")
    ops.reset_launches()
    got = ops.laplace(x.to(cuda))
    assert ops.launches()["stencil"] == len(shape)
    assert torch.equal(got.cpu(), ops.laplace(x))


def test_conv2d_on_the_card_ignores_strip_rows(cuda):
    img, ker = _t((300, 200), "cpu"), _t((5, 5), "cpu")
    ops.reset_launches()
    got = [ops.conv2d(img.to(cuda), ker.to(cuda), strip_rows=r).cpu()
           for r in (17, 256)]
    assert ops.launches()["conv2d"] == 2
    want = ops.conv2d(img, ker, strip_rows=17)
    assert torch.equal(got[0], want) and torch.equal(got[1], want)
    with pytest.raises(ValueError, match="strip_rows"):
        ops.conv2d(img.to(cuda), ker.to(cuda), strip_rows=0)


@pytest.mark.parametrize("m,k,n,scale", [(128, 2048, 128, 100.0),
                                         (3, 4000, 90, 1.0),
                                         (70, 3000, 130, 1.0)])
def test_compensated_gemm_kernel(cuda, m, k, n, scale):
    """Against an fp64 product the compensated kernel's max error is at
    most half the uncompensated kernel's (the reference's property asks
    for no more than x 1.01, which a kernel that skipped compensation
    would meet; 0.08-0.13 was measured at 4096**3 and at these x100
    inputs). Against its plain version: within 1e-5 of the product's
    standard deviation, scale**2 sqrt(k) (measured difference 0)."""
    a, b = _t((m, k), cuda, scale), _t((k, n), cuda, scale)
    ref64 = a.double() @ b.double()
    ops.reset_launches()
    comp = ops.gemm(a, b, compensated=True)
    plain = ops.gemm(a, b)
    assert ops.launches()["gemm_kahan"] == 1
    assert ops.launches()["gemm"] == 1
    err_c = float((comp.double() - ref64).abs().max())
    err_p = float((plain.double() - ref64).abs().max())
    assert err_c <= 0.5 * err_p
    want = tgemm.gemm_kahan_plain(a, b)
    torch.testing.assert_close(comp, want, rtol=0.0,
                               atol=1e-5 * scale ** 2 * k ** 0.5)


@pytest.mark.parametrize("epilogue", [False, True])
@pytest.mark.parametrize("m,k,n", [(64, 4096, 48), (70, 1000, 130),
                                   (3, 300, 90)])
def test_compensated_gemm_kernel_rounds_exact_slabs_once(cuda, m, k, n,
                                                         epilogue):
    """On inputs whose every slab product is exact in fp32 but whose slab
    sums lose low bits (integers, the first slab's times 2**16), the
    compensated kernel is the fp64 product rounded once, bit for bit,
    and so equal to its plain version; the uncompensated kernel is not.
    A kernel that dropped the compensation term fails here."""
    rng = np.random.default_rng(m + k + n)
    a = rng.integers(-8, 9, (m, k)).astype(np.float32)
    a[:, :tgemm.KAHAN_SLAB] *= 2.0 ** 16
    b = rng.integers(-8, 9, (k, n)).astype(np.float32)
    ref64 = torch.from_numpy(a.astype(np.float64) @ b.astype(np.float64))
    want = (ref64 * 0.5).clamp_min(0.0) if epilogue else ref64
    a, b = torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda)
    ep = [("scale", 0.5), "relu"] if epilogue else None
    ops.reset_launches()
    got = ops.gemm(a, b, compensated=True, epilogue=ep).cpu()
    plain = ops.gemm(a, b, epilogue=ep).cpu()
    assert ops.launches()["gemm_kahan"] == 1
    assert torch.equal(got, want.float())
    assert torch.equal(got, tgemm.gemm_kahan_plain(
        a, b, epilogue=ops._norm_epilogue(ep)).cpu())
    assert float((plain.double() - want).abs().max()) > float(
        (got.double() - want).abs().max()) + 1.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compensated_gemm_kernel_with_epilogue(cuda, dtype):
    dt = getattr(torch, dtype)
    a, b = _t((70, 700), cuda).to(dt), _t((700, 90), cuda, 0.1).to(dt)
    ep = ops._norm_epilogue([("bias", _t((90,), cuda)), "relu",
                             ("residual", _t((70, 90), cuda))])
    got = tgemm.gemm_cuda(a, b, torch.float32, ep, compensated=True)
    want = tgemm.gemm_kahan_plain(a, b, torch.float32, ep)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    got16 = tgemm.gemm_cuda(a, b, torch.bfloat16, ep, compensated=True)
    torch.testing.assert_close(got16.float(), want, rtol=1e-2, atol=1e-2)


def test_suite_routes_raise_under_autograd(cuda):
    """conv, the stencil pass and the compensated GEMM have no backward
    (neither has the reference): their CUDA routes refuse tracked
    tensors."""
    img = _t((20, 20), cuda).requires_grad_()
    ker = _t((3, 3), cuda)
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.conv2d(img, ker)
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.stencil_axis(img, [1.0, -2.0, 1.0], 0)
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.laplace(img)
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.gemm(img, ker.new_ones(20, 4), compensated=True)
    with torch.no_grad():
        ops.conv2d(img, ker)


def test_rmse_study_on_the_card_equals_the_cpu(cuda):
    from repro_torch.core import precision
    got = precision.conv_layer_rmse_study(n_outputs=16, device=cuda)
    assert got == precision.conv_layer_rmse_study(n_outputs=16,
                                                  device="cpu")
