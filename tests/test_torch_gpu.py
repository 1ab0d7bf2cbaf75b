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


def test_attention_without_heads_launches_nothing(cuda):
    """A model rank holding no heads (more ranks than heads): empty
    outputs, no launch (a grid with a 0 dimension is a CUDA error), and
    under autograd empty gradients that keep the graph whole."""
    q = torch.zeros((2, 0, 16, 128), device=cuda, dtype=torch.bfloat16)
    k, v = q.clone(), q.clone()
    ops.reset_launches()
    assert ops.attention(q, k, v).shape == (2, 0, 16, 128)
    o, lse = ops.attention(q, k, v, kv_len=9, return_lse=True)
    assert o.shape == (2, 0, 16, 128) and lse.shape == (2, 0, 16)
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    ops.attention(qg, kg, vg).sum().backward()
    assert qg.grad.shape == q.shape and kg.grad.shape == k.shape
    assert not any(ops.launches().values())


def test_dispatch_engine_fallback_stays_on_the_card(cuda):
    """A nest no kernel matches runs on the torch engine on the card and
    agrees with the numpy engine; so does a prefix-store nest (running
    sums), against the cycle-faithful engine."""
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
    got = dispatch.dispatch(running_dot, mem.to(cuda))
    assert got.is_cuda and dispatch.engine_fallbacks == 2
    np.testing.assert_allclose(got.cpu().numpy(),
                               engine.execute(running_dot, mem.numpy()),
                               rtol=1e-5, atol=1e-5)


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
    tracks, instead of returning a result no gradient reaches; attention,
    which has a backward kernel, gives the plain version's gradient."""
    a = _t((8, 64), cuda).requires_grad_()
    b = _t((64, 16), cuda)
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.gemm(a, b)
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.reduce("sum", a)
    with torch.no_grad():
        ops.gemm(a, b)
    q = _t((1, 2, 4, 64), cuda).requires_grad_()
    go = _t((1, 2, 4, 64), cuda)
    got = torch.autograd.grad(ops.attention(q, q.detach(), q.detach()), q,
                              go)[0]
    qc = q.detach().cpu().requires_grad_()
    want = torch.autograd.grad(ops.attention(qc, qc.detach(), qc.detach()),
                               qc, go.cpu())[0]
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


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
@pytest.mark.parametrize("img_shape,ker_shape", [
    ((256, 256), (3, 3)), ((256, 256), (5, 5)), ((256, 256), (7, 7)),
    ((70, 133), (3, 3)), ((65, 97), (7, 7)), ((40, 90), (5, 9)),
    ((1000, 1000), (3, 3)), ((1100, 1030), (5, 5)), ((1024, 1024), (7, 7)),
    ((2000, 1400), (3, 700)), ((300, 77), (2, 11))])
def test_conv_kernel_tile_edges_bit_equal(cuda, dtype, img_shape,
                                          ker_shape):
    """Shapes across the kernel's plans and edges: the 256^2 plane, an
    output width that is not a multiple of the 4-column run (and one that
    is even but not a multiple of 4), taps wider than the run, rows that
    are not 16-byte aligned (4-byte copies), the large-tile plan with
    ragged tiles, and taps chunked by columns."""
    from repro_torch.kernels import ntx_conv
    img = _t(img_shape, cuda).to(getattr(torch, dtype))
    ker = _t(ker_shape, cuda, 0.3)
    got = ntx_conv.conv2d_cuda(img, ker)
    want = ntx_conv.conv2d_plain(img, ker)
    assert got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_conv_kernel_on_a_view_and_other_tap_dtypes(cuda):
    """A plane that is a strided view and taps in another dtype are made
    fp32 and contiguous by the wrapper."""
    from repro_torch.kernels import ntx_conv
    img = _t((90, 200), cuda)[:, ::2]
    ker = _t((3, 3), cuda).double()
    got = ntx_conv.conv2d_cuda(img, ker)
    assert torch.equal(got, ntx_conv.conv2d_plain(img, ker.float()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("img_shape,ker_shape,blocks", [
    ((256, 256), (3, 3), 7), ((1100, 1030), (5, 5), 64),
    ((1024, 1024), (7, 7), 264), ((65, 97), (7, 7), 1),
    ((400, 40), (300, 5), 2), ((2000, 1400), (3, 700), 5)])
def test_conv_kernel_persistent_grid_bit_equal(cuda, dtype, img_shape,
                                               ker_shape, blocks):
    """A grid smaller than the tile count: each block walks its tiles
    through the two-stage ring, the next tile's copy in flight, with one
    tap chunk or several; bit-equal all the same."""
    from repro_torch.kernels import ntx_conv
    img = _t(img_shape, cuda).to(getattr(torch, dtype))
    ker = _t(ker_shape, cuda, 0.3)
    (h, w), (kh, kw) = img_shape, ker_shape
    plan = ntx_conv.tile_plan(h - kh + 1, w - kw + 1, kh, kw)
    plan = plan._replace(blocks=min(blocks, plan.tiles))
    got = ntx_conv.conv2d_cuda(img, ker, plan=plan)
    want = ntx_conv.conv2d_plain(img, ker)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("change", [
    dict(ci=2, cj=2), dict(ci=1, cj=2), dict(ci=4), dict(cj=0),
    dict(tx=5), dict(tx=128, ty=4), dict(rpt=4), dict(blocks=0),
    dict(blocks=10 ** 6), dict(tx=64, ty=4, rpt=8, ci=300)])
def test_conv_kernel_refuses_a_plan_it_cannot_run(cuda, change):
    """The launch checks the plan it is given: tap chunks that would break
    the i-outer, j-inner order or the 16-byte copies, more taps than the
    kernel has, a block that is not whole warps or past 256 threads, rows
    per thread it was not compiled for, a grid past the tiles, a stage
    past the shared-memory budget."""
    from repro_torch.kernels import ntx_conv
    img, ker = _t((400, 400), cuda), _t((300, 5), cuda)
    if "ci" in change and change["ci"] != 300:
        ker = _t((3, 3), cuda)
    kh, kw = ker.shape
    plan = ntx_conv.tile_plan(401 - kh, 401 - kw, kh, kw)
    with pytest.raises(RuntimeError, match="ntx_conv2d"):
        ntx_conv.conv2d_cuda(img, ker, plan=plan._replace(**change))
    torch.cuda.synchronize()


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,axis,k", [
    ((20, 30, 64), 1, 3), ((16, 8, 12), 0, 5), ((9, 21, 4), 1, 2),
    ((512, 8), 0, 3), ((37, 300), 1, 3), ((5, 1000), 1, 9),
    ((3, 7), 1, 7), ((700, 3), 1, 3), ((64, 64, 64), 2, 3)])
def test_stencil_pass_vector_and_flat_routes_bit_equal(cuda, dtype, shape,
                                                        axis, k):
    """The pass's 4-wide route (inner a multiple of 4) and its flat route
    (inner == 1, outputs of many rows in one run), ragged edges
    included."""
    from repro_torch.kernels import ntx_stencil
    x = _t(shape, cuda).to(getattr(torch, dtype))
    coeffs = [float(c) for c in RNG.standard_normal(k).astype(np.float32)]
    got = ops.stencil_axis(x, coeffs, axis)
    want = ntx_stencil.stencil1d_plain(x, coeffs, axis)
    assert got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stencil_pass_at_an_odd_offset(cuda, dtype):
    """A contiguous view that starts one element into its storage: the
    4-wide loads are not aligned, so the pass takes its scalar route."""
    from repro_torch.kernels import ntx_stencil
    base = _t((1 + 6 * 10 * 8,), cuda).to(getattr(torch, dtype))
    x = base[1:].view(6, 10, 8)
    coeffs = [1.0, -2.0, 1.0]
    for axis in range(3):
        got = ops.stencil_axis(x, coeffs, axis)
        want = ntx_stencil.stencil1d_plain(x, coeffs, axis)
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
    """One fused Laplace launch for 1-3 dimensions; it computes the
    per-axis terms and their sums in the plain version's order, so the
    card gives the CPU's values."""
    x = _t(shape, "cpu")
    ops.reset_launches()
    got = ops.laplace(x.to(cuda))
    assert ops.launches()["laplace"] == 1
    assert ops.launches()["stencil"] == 0
    assert torch.equal(got.cpu(), ops.laplace(x))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(300,), (40, 50), (12, 14, 16),
                                   (3, 1000, 4), (130, 3, 67), (5000,),
                                   (3, 3), (70, 530), (19, 37, 300),
                                   (2, 40, 40)])
def test_fused_laplace_bit_equal(cuda, dtype, shape):
    """``ntx_laplace`` against ``laplace_plain`` bit for bit, on shapes
    that are not multiples of its runs and tiles (an empty interior for
    an axis shorter than 3, with no launch)."""
    from repro_torch.kernels import ntx_stencil
    x = _t(shape, cuda).to(getattr(torch, dtype))
    ops.reset_launches()
    got = ops.laplace(x)
    want = ntx_stencil.laplace_plain(x)
    assert ops.launches()["laplace"] == (1 if min(shape) >= 3 else 0)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("shape", [(4, 5, 6, 7), (3, 9, 2, 5)])
def test_laplace_4d_takes_the_per_axis_route(cuda, shape):
    """Four dimensions: one stencil pass per axis and torch adds, as the
    reference's route; an axis shorter than 3 launches nothing."""
    from repro_torch.kernels import ntx_stencil
    x = _t(shape, cuda)
    ops.reset_launches()
    got = ops.laplace(x)
    launched = len(shape) if min(shape) >= 3 else 0
    assert ops.launches()["stencil"] == launched
    assert ops.launches()["laplace"] == 0
    want = ntx_stencil.laplace_plain(x)
    assert got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_laplace_of_a_strided_view(cuda):
    """A view that is not contiguous is copied once, then fused."""
    from repro_torch.kernels import ntx_stencil
    x = _t((40, 60), cuda)[:, ::2]
    got = ops.laplace(x)
    assert torch.equal(got, ntx_stencil.laplace_plain(x))


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


# ----------------------------------------------------------------------
# The streaming kernel with rows split across blocks
# ----------------------------------------------------------------------
CHUNK = tew.STREAM_CHUNK
LONG_ROWS = [(1, (1 << 20) + 3), (4, (1 << 20) + 3), (1, 128256),
             (4, 128256)]


def _plant_ties(x, lo, hi):
    """Equal maxima on both sides of a chunk boundary and at the first
    element of a later chunk, equal minima at the first elements of two
    chunks and across a later boundary: the lowest index must win."""
    for c in (5 * CHUNK, 2 * CHUNK, 2 * CHUNK - 1):
        x[:, c] = hi
    for c in (7 * CHUNK, 4 * CHUNK, 4 * CHUNK - 1, 3 * CHUNK):
        x[:, c] = lo
    return x


@pytest.mark.parametrize("red", ["min", "max", "argmin", "argmax"])
@pytest.mark.parametrize("rows,n", LONG_ROWS)
def test_stream_kernel_long_rows_bit_equal(cuda, rows, n, red):
    """Rows over many blocks (257 or 32 chunks): the chain output and the
    MIN/MAX/arg tails bit-equal to the plain version, planted ties across
    chunks resolved first-wins."""
    x = _plant_ties(_t((rows, n), cuda), -40.0, 40.0)
    y = torch.zeros_like(x)
    stages = [("axpy", 1.0), ("thresh", -100.0)]
    out, r = tew.stream_cuda(stages, x, (y,), tail=red)
    w_out, w_r = tred.chain_reduce_plain(stages, red, x, (y,))
    assert torch.equal(out, w_out) and torch.equal(r, w_r)
    if red == "argmax":
        assert r.tolist() == [float(2 * CHUNK - 1)] * rows
    if red == "argmin":
        assert r.tolist() == [float(3 * CHUNK)] * rows


@pytest.mark.parametrize("rows,n", LONG_ROWS)
def test_stream_kernel_long_rows_sum(cuda, rows, n):
    """SUM over rows split into chunks: within the reference's 1e-5 of
    sum |v|, and the same bits from call to call (partials merged in
    chunk order, no atomics)."""
    x, y = _t((rows, n), cuda), _t((rows, n), cuda)
    stages = [("axpy", 0.5), ("relu", 0.0)]
    got = [tew.stream_cuda(stages, x, (y,), tail="sum") for _ in range(2)]
    w_out, w_r = tred.chain_reduce_plain(stages, "sum", x, (y,))
    assert torch.equal(got[0][0], w_out)
    assert torch.equal(got[0][1], got[1][1])
    scale = w_out.abs().double().sum(-1)
    err = (got[0][1].double() - w_out.double().sum(-1)).abs()
    assert bool((err <= 1e-5 * scale).all())


def test_stream_kernel_tail_scratch_is_reused(cuda):
    """Tails over rows of several lengths and row counts, in turns, reuse
    one per-stream scratch: each row's last block merges its partials and
    sets its counter back to 0, so every result stays exact and the
    counters end at 0."""
    xs = [_t((rows, n), cuda) for rows, n in LONG_ROWS]
    for _ in range(3):
        for x in xs:
            for red in ("argmax", "sum"):
                out, r = tew.stream_cuda([("relu", 0.0)], x, tail=red)
                w_out, w_r = tred.chain_reduce_plain([("relu", 0.0)], red, x)
                assert torch.equal(out, w_out)
                if red == "argmax":
                    assert torch.equal(r, w_r)
    torch.cuda.synchronize()
    for counters, _ in tew._TAIL_SCRATCH.values():
        assert int(counters.abs().sum()) == 0


@pytest.mark.parametrize("red", ["sum", "min", "max", "argmin", "argmax"])
def test_stream_kernel_n_valid_across_chunks(cuda, red):
    """Columns at or past n_valid (mid-chunk, three chunks in) add the
    tail's identity: extremes planted there do not win."""
    n, n_valid = 5 * CHUNK + 11, 3 * CHUNK + 17
    x = _t((4, n), cuda)
    x[:, n_valid + 3] = 100.0
    x[:, n_valid + 5] = -100.0
    out, r = tew.stream_cuda([("copy", 0.0)], x, tail=red, n_valid=n_valid)
    w_out, w_r = tred.chain_reduce_plain([("copy", 0.0)], red, x,
                                         n_valid=n_valid)
    assert torch.equal(out, w_out)
    if red == "sum":
        scale = x[:, :n_valid].abs().double().sum(-1)
        assert bool(((r.double() - w_r.double()).abs() <= 1e-5 * scale)
                    .all())
    else:
        assert torch.equal(r, w_r)


@pytest.mark.parametrize("tail", [None, "argmax", "min"])
def test_stream_kernel_on_views_at_an_odd_offset(cuda, tail):
    """Views one element into their storage (as descriptor programs hand
    them over) take the scalar instantiation: the same bits as the
    plain version and as aligned copies on the vector path."""
    rows, n = 2, 3 * CHUNK + 5
    flat = _t((3 * rows * n + 1,), cuda)
    x, y1, y2 = (flat[1 + i * rows * n:1 + (i + 1) * rows * n].view(rows, n)
                 for i in range(3))
    assert x.data_ptr() % 16 != 0
    stages = [("axpy", 0.75), ("mul", 0.0), ("thresh", 0.05)]
    got = tew.stream_cuda(stages, x, (y1, y2), tail=tail)
    aligned = tew.stream_cuda(stages, x.clone(), (y1.clone(), y2.clone()),
                              tail=tail)
    if tail is None:
        want = tew.elementwise_chain_plain(stages, x, (y1, y2))
        assert torch.equal(got[0], want) and torch.equal(aligned[0], want)
    else:
        want = tred.chain_reduce_plain(stages, tail, x, (y1, y2))
        for out, r in (got, aligned):
            assert torch.equal(out, want[0]) and torch.equal(r, want[1])


@pytest.mark.parametrize("op", ["axpy", "thresh", "set"])
@pytest.mark.parametrize("n", [(1 << 22) + 3, 1001])
def test_elementwise_long_stream_bit_equal(cuda, op, n):
    """One command over a long row: the grid-stride float4 pass and its
    scalar remainder, bit-equal to the plain version."""
    x, y = _t((1, n), cuda), _t((1, n), cuda)
    ops.reset_launches()
    got = ops.elementwise(op, x, y if op in tew._OPS2 else None, imm=0.3)
    assert ops.launches()["elementwise"] == 1
    want = tew.elementwise_plain(op, x, y if op in tew._OPS2 else None, 0.3)
    assert torch.equal(got, want)


def test_serial_and_fused_sum_programs_bit_equal(cuda):
    """AXPY -> RELU -> SUM as one ntx.Program: the serial policy (two
    elementwise launches, then the reduce kernel) and the fused one (one
    chain-reduce launch) give the same bits."""
    import ntx_torch as ntx
    n = (1 << 20) + 3
    xs, ys = _t((n,), cuda), _t((n,), cuda)
    with ntx.Program() as prog:
        x = prog.buffer((n,), name="x")
        y = prog.buffer((n,), name="y")
        t = prog.axpy(0.5, x, y)
        prog.relu(t, out=t)
        total = prog.reduce("sum", t, name="total")
    res = {}
    for policy in ("serial", "fused"):
        ops.reset_launches()
        run = ntx.Executor(policy, device=cuda).run(prog,
                                                    inputs={x: xs, y: ys})
        res[policy] = (run.read_tensor(total).clone(),
                       run.read_tensor(t).clone(), ops.launches())
    assert res["serial"][2]["reduce"] == 1
    assert res["fused"][2]["chain_reduce"] == 1
    assert res["fused"][2]["reduce"] == 0
    assert torch.equal(res["serial"][1], res["fused"][1])
    assert torch.equal(res["serial"][0], res["fused"][0])


# ----------------------------------------------------------------------
# The bf16 GEMM on the tensor cores
# ----------------------------------------------------------------------
def _all_epilogue_kinds(dev, m, n):
    """Every epilogue kind once. THRESH at 0 is continuous there, so a
    last-bit difference in the product cannot move a value across it."""
    mask = (_t((m, n), dev) > 0).float()
    return ops._norm_epilogue([
        ("bias", _t((n,), dev)), ("residual", _t((m, n), dev).bfloat16()),
        ("mul", _t((m, n), dev)), ("sub", _t((m, n), dev, 0.1).bfloat16()),
        ("scale", 0.5), "gelu", "silu", ("mask", mask), ("thresh", 0.0),
        "relu"])


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,n", [(1007, 1003), (14336, 1000)])
@pytest.mark.parametrize("m", [1, 4, 16, 70, 128])
def test_bf16_gemm_tensor_cores(cuda, m, k, n, out_dtype):
    """The tensor-core route, split over k as split_k_plan says (both
    tiles, ragged m and n, k and n off the 16-byte copies at k = 1007),
    with every epilogue kind, against its plain version at the existing
    tolerances; two calls give the same bits."""
    odt = getattr(torch, out_dtype)
    a = _t((m, k), cuda).bfloat16()
    b = _t((k, n), cuda, k ** -0.5).bfloat16()
    ep = _all_epilogue_kinds(cuda, m, n)
    got = tgemm.gemm_cuda(a, b, odt, ep)
    again = tgemm.gemm_cuda(a, b, odt, ep)
    want = tgemm.gemm_plain(a, b, odt, ep)
    assert got.dtype == odt and torch.equal(got, again)
    tol = 1e-4 if out_dtype == "float32" else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("m", [4, 70])
def test_bf16_gemm_operand_at_an_odd_offset(cuda, m):
    """An operand one element into its storage takes the masked-load
    instantiation; the tiles it builds are the same, so the result has
    the same bits as the 16-byte-copy path on aligned copies."""
    k, n = 4096, 1024
    flat = _t((m * k + 1,), cuda).bfloat16()
    a = flat[1:].view(m, k)
    b = _t((k, n), cuda, k ** -0.5).bfloat16()
    assert a.data_ptr() % 16 != 0
    assert tgemm.split_k_plan(m, n, k).splits > 1
    got = tgemm.gemm_cuda(a, b, torch.bfloat16, [])
    assert torch.equal(got, tgemm.gemm_cuda(a.clone(), b, torch.bfloat16, []))
    torch.testing.assert_close(
        got.float(), tgemm.gemm_plain(a, b, torch.bfloat16).float(),
        rtol=1e-2, atol=1e-2)


def test_fused_mlp_on_the_card(cuda):
    """ops.fused_mlp's three products (gate to fp32, w1 with silu * gate,
    w2 with the bf16 residual) as the serving path runs them, against the
    plain versions of the same three calls."""
    d, f, m = 512, 1536, 4
    x = _t((m, d), cuda).bfloat16()
    w1, w3 = (_t((d, f), cuda, d ** -0.5).bfloat16() for _ in range(2))
    w2 = _t((f, d), cuda, f ** -0.5).bfloat16()
    res = _t((m, d), cuda).bfloat16()
    ops.reset_launches()
    got = ops.fused_mlp(x, w1, w2, w3, act="swiglu", residual=res)
    assert ops.launches()["gemm"] == 3
    gate = tgemm.gemm_plain(x, w3)
    h = tgemm.gemm_plain(x, w1, torch.bfloat16, ops._norm_epilogue(
        [("silu",), ("mul", gate)]))
    want = tgemm.gemm_plain(h, w2, torch.bfloat16,
                            ops._norm_epilogue([("residual", res)]))
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


# ----------------------------------------------------------------------
# The SSD scan's three passes and the vectorised AdamW step
# ----------------------------------------------------------------------
_SSD_TOL = {"float32": 1e-3, "bfloat16": 1e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,l,h,dh,n,chunk", [
    (2, 256, 8, 64, 128, 128),       # the training head shape
    (1, 1000, 3, 64, 128, 128),      # ragged last chunk (1000 = 7*128+104)
    (1, 200, 11, 32, 32, 64),        # h not a multiple of 8 heads a block
    (2, 96, 2, 16, 32, 16),
    (1, 130, 4, 128, 128, 128),      # dh 128: the widest head-dim tile
    (1, 200, 5, 128, 32, 64),
    (1, 77, 3, 48, 40, 50),          # chunk, n, dh off the tile sizes
    (1, 1, 2, 16, 32, 128)])         # one step
def test_ssd_kernel_sweep(cuda, dtype, b, l, h, dh, n, chunk):
    """The three-pass SSD kernel against its plain version over chunk
    16/50/64/128, head dim 16-128, d_state 32-128, ragged lengths and head
    counts that leave the last head group short, at the same tolerances
    as test_ssd_kernel (fp32 1e-3; bf16 output rounded once, one ulp)."""
    from repro_torch.kernels import ssd_scan
    ins = _ssd_inputs(cuda, b, l, h, dh, n, getattr(torch, dtype))
    got = ssd_scan.ssd_scan_cuda(*ins, chunk=chunk)
    want = ssd_scan.ssd_scan_plain(*ins, chunk=chunk)
    assert torch.isfinite(got.float()).all()
    tol = _SSD_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel_strong_decay_stays_finite(cuda, dtype):
    """dt * A down to about -80 a step at chunk 128: the exponent is
    masked before exp, so the kernel stays finite and on the plain
    version (ROADMAP queue 3, record 2)."""
    from repro_torch.kernels import ssd_scan
    x, dt, A, B, C = _ssd_inputs(cuda, 1, 256, 4, 64, 128,
                                 getattr(torch, dtype))
    dt = dt * 5.0
    got = ssd_scan.ssd_scan_cuda(x, dt, A, B, C, chunk=128)
    want = ssd_scan.ssd_scan_plain(x, dt, A, B, C, chunk=128)
    assert torch.isfinite(got.float()).all()
    tol = _SSD_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel_plans_agree_bit_for_bit(cuda, dtype):
    """Narrower head-dim tiles and fewer heads per block change only which
    block computes an output, not its arithmetic: the same bits."""
    import dataclasses
    from repro_torch.kernels import ssd_scan
    bf16 = dtype == "bfloat16"
    b, l, h, dh, n = 1, 300, 5, 128, 64
    ins = _ssd_inputs(cuda, b, l, h, dh, n, getattr(torch, dtype))
    base = ssd_scan.scan_plan(b, l, h, dh, n, 64, bf16)
    want = ssd_scan.ssd_scan_cuda(*ins, chunk=64)
    for dtile in ssd_scan.D_TILES[bf16]:
        if dtile >= dh:
            continue
        for heads in (1, 3):
            p = dataclasses.replace(base, dtile=dtile, heads=heads)
            assert torch.equal(ssd_scan.ssd_scan_cuda(*ins, chunk=64, plan=p),
                               want), (dtile, heads)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("change", ["lp", "np", "dtile", "heads_0",
                                    "heads_65", "smem"])
def test_ssd_kernel_refuses_a_plan_it_cannot_run(cuda, dtype, change):
    """A plan that does not match the shapes, or that needs more shared
    memory than a block has, is refused before any launch."""
    import dataclasses
    from repro_torch.kernels import ssd_scan
    bf16 = dtype == "bfloat16"
    ins = _ssd_inputs(cuda, 1, 256, 4, 128, 128, getattr(torch, dtype))
    p = ssd_scan.scan_plan(1, 256, 4, 128, 128, 128, bf16)
    bad = {"lp": dict(lp=p.lp - 16), "np": dict(np=p.np + 16),
           "dtile": dict(dtile=48), "heads_0": dict(heads=0),
           "heads_65": dict(heads=65),
           "smem": dict(dtile=128, heads=64)}[change]
    with pytest.raises(RuntimeError, match="ntx_ssd_scan"):
        ssd_scan.ssd_scan_cuda(*ins, chunk=128,
                               plan=dataclasses.replace(p, **bad))


def _offset_view(t, off):
    """t's values in a tensor that starts ``off`` elements into its
    storage (off 0: a fresh, aligned copy)."""
    flat = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    view = flat[off:off + t.numel()].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("p_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [0, 1, 3, 4, 7, 1001, 65539])
@pytest.mark.parametrize("offsets", [(0, 0, 0, 0), (1, 1, 1, 1),
                                     (3, 3, 3, 3), (0, 1, 2, 3),
                                     (2, 0, 0, 0), (0, 0, 0, 3)])
def test_adamw_kernel_offsets_and_lengths(cuda, p_dtype, n, offsets):
    """Operands 0-3 elements off a 16-byte boundary (together: a scalar
    head, then 16-byte vectors; apart: element by element) and lengths
    that leave a tail: within the reference's 1e-5 / 1e-6 of the plain
    version (bf16 p one ulp), and bit-equal to aligned copies of the same
    values, which take the vector route."""
    dt = getattr(torch, p_dtype)
    p = _offset_view(_t((n,), cuda, 0.02).to(dt), offsets[0])
    g = _offset_view(_t((n,), cuda, 1e-3), offsets[1])
    m = _offset_view(_t((n,), cuda, 1e-4), offsets[2])
    v = _offset_view(_t((n,), cuda, 1e-7).abs(), offsets[3])
    got = tew.adamw_cuda(p, g, m, v, 7, lr=3e-4)
    aligned = tew.adamw_cuda(*(t.clone() for t in (p, g, m, v)), 7, lr=3e-4)
    want = tew.adamw_plain(p, g, m, v, 7, lr=3e-4)
    rtol = 1e-5 if p_dtype == "float32" else 2.0 ** -7
    for a, al, b in zip(got, aligned, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, al)
        torch.testing.assert_close(a.float(), b.float(), rtol=rtol, atol=1e-6)


def test_adamw_kernel_plan_routes(cuda):
    """The wrapper's outputs share the inputs' phase, so operands off a
    16-byte boundary together keep the vector route; operands apart take
    the element route."""
    n = 4099
    ins = [_offset_view(_t((n,), cuda, 1e-3).abs(), 1) for _ in range(4)]
    po, mo, vo = tew.adamw_cuda(*ins, 7, lr=3e-4)
    phases = tuple(tew._phase(t) for t in (*ins, po, mo, vo))
    assert phases == (1,) * 7
    plan = tew.adamw_plan(n, phases, torch.cuda.get_device_properties(
        0).multi_processor_count)
    assert (plan.head, plan.vecs, plan.tail) == (3, 1024, 0)
    apart = [ins[0], _offset_view(ins[1], 2), ins[2], ins[3]]
    assert tew.adamw_plan(n, tuple(tew._phase(t) for t in apart),
                          132).vecs == 0
    got = tew.adamw_cuda(*apart, 7, lr=3e-4)
    for a, b in zip(got, (po, mo, vo)):
        assert torch.equal(a, b)


# ----------------------------------------------------------------------
# Flash attention: tensor cores (bf16), the causal tile bound, strides,
# the grouped split-kv decode
# ----------------------------------------------------------------------
def _attention_want(q, k, v, kv_len):
    """``flash_attention_plain``, except for rows with no valid key (query
    position kv_len - sq + i < 0): there the reference kernel's logits
    are all -1e30, so each key of the array weighs 1 and the row is the
    mean of v (the plain softmax over no key gives NaN)."""
    want = tfa.flash_attention_plain(q, k, v, causal=True,
                                     kv_len=kv_len).float()
    b, hq, sq, _ = q.shape
    hkv = k.shape[1]
    dead = sq - kv_len                       # rows 0 .. dead - 1
    if dead > 0:
        mean = v.float().mean(2, keepdim=True)            # (b, hkv, 1, d)
        mean = mean.repeat_interleave(hq // hkv, 1)
        want[:, :, :dead] = mean.expand(-1, -1, min(dead, sq), -1)
    return want


def _bhsd(shape, dev, dt, scale, layout):
    """A (b, h, s, d) operand: contiguous, the (b, s, h, d) projection
    viewed as (b, h, s, d), or contiguous one element into its storage
    (off the 16-byte boundary)."""
    b, h, s, d = shape
    if layout == "bshd":
        return _t((b, s, h, d), dev, scale).to(dt).transpose(1, 2)
    if layout == "offset":
        flat = _t((b * h * s * d + 1,), dev, scale).to(dt)
        return flat[1:].view(b, h, s, d)
    return _t(shape, dev, scale).to(dt)


ATTN_SHAPES = [(1, 4099, 4000), (15, 77, 60), (17, 200, 200), (63, 63, 63),
               (65, 130, 100), (300, 301, 300), (65, 130, 40)]


@pytest.mark.parametrize("sq,skv,kv_len", ATTN_SHAPES)
@pytest.mark.parametrize("hq,hkv", [(8, 8), (8, 4), (8, 2), (8, 1)])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_sweep(cuda, dtype, d, hq, hkv, sq, skv, kv_len):
    """Ragged sq and skv, kv_len < skv, rows with no valid key (sq 65 at
    kv_len 40), split-kv decode (sq 1 over 4000 keys), every GQA ratio,
    both head dims and dtypes, q as the strided (b, s, h, d) view, against
    the plain version at phase 2's tolerances; two calls, the same bits."""
    dt = getattr(torch, dtype)
    q = _bhsd((2, hq, sq, d), cuda, dt, 0.5, "bshd")
    k = _bhsd((2, hkv, skv, d), cuda, dt, 0.5, "contiguous")
    v = _bhsd((2, hkv, skv, d), cuda, dt, 1.0, "bshd")
    got = tfa.flash_attention_cuda(q, k, v, causal=True, kv_len=kv_len)
    again = tfa.flash_attention_cuda(q, k, v, causal=True, kv_len=kv_len)
    assert got.shape == q.shape and got.dtype == dt
    assert torch.equal(got, again)
    tol = 1e-4 if dtype == "float32" else 1e-2
    torch.testing.assert_close(got.float(), _attention_want(q, k, v, kv_len),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("layout", ["contiguous", "bshd", "offset"])
@pytest.mark.parametrize("sq,skv,kv_len", [(1, 2000, 1999), (100, 100, 100)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_layouts(cuda, dtype, sq, skv, kv_len, layout):
    """q, k and v in each layout (an operand off the 16-byte boundary
    takes the masked-load instantiation): the same values give the same
    bits as contiguous copies."""
    dt = getattr(torch, dtype)
    q, k, v = (_bhsd(shape, cuda, dt, s, layout) for shape, s in (
        ((2, 8, sq, 128), 0.5), ((2, 2, skv, 128), 0.5),
        ((2, 2, skv, 128), 1.0)))
    got = tfa.flash_attention_cuda(q, k, v, causal=True, kv_len=kv_len)
    same = tfa.flash_attention_cuda(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal=True, kv_len=kv_len)
    tol = 1e-4 if dtype == "float32" else 1e-2
    torch.testing.assert_close(got.float(), _attention_want(q, k, v, kv_len),
                               rtol=tol, atol=tol)
    assert torch.equal(got.contiguous(), same)


def test_flash_decode_splits_and_counts(cuda):
    """The serving-style decode (b 4, hq 32, hkv 8, sq 1, kv_len 4000 of
    4096) takes the grouped split-kv plan: one block per (b, kv head,
    split) filling the SMs, and ops.attention counts the merge."""
    q = _t((4, 32, 1, 128), cuda, 0.5).bfloat16()
    k, v = (_t((4, 8, 4096, 128), cuda, 0.5).bfloat16() for _ in range(2))
    plan = tfa.flash_plan(4, 32, 8, 1, 4096, 4000, 128, torch.bfloat16)
    assert (plan.gh, plan.qn, plan.wr, plan.splits) == (4, 1, 1, 4)
    ops.reset_launches()
    got = ops.attention(q, k, v, causal=True, kv_len=4000)
    assert ops.launches()["attention"] == 1
    assert ops.launches()["attention_merge"] == 1
    torch.testing.assert_close(got.float(), _attention_want(q, k, v, 4000),
                               rtol=1e-2, atol=1e-2)
    ws, o = tfa.flash_attention_cuda(q, k, v, kv_len=4000, partials=True)
    merged = tfa.flash_merge_cuda(ws, o, plan.splits)
    assert torch.equal(merged, got)
    torch.testing.assert_close(
        merged.float(), tfa.flash_merge_plain(ws, plan.splits, 4, 32, 1, 128
                                              ).float(), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("change", ["wr_3", "stages", "gh_3", "rows",
                                    "splits_0", "splits_65", "fp32_wr"])
def test_flash_kernel_refuses_a_plan_it_cannot_run(cuda, change):
    import dataclasses
    dt = torch.float32 if change == "fp32_wr" else torch.bfloat16
    q = _t((1, 8, 40, 128), cuda).to(dt)
    k = v = _t((1, 2, 80, 128), cuda).to(dt)
    p = tfa.flash_plan(1, 8, 2, 40, 80, 80, 128, dt)
    bad = {"wr_3": dict(wr=3), "stages": dict(stages=p.stages + 1),
           "gh_3": dict(gh=3), "rows": dict(qn=p.rows + 1),
           "splits_0": dict(splits=0), "splits_65": dict(splits=65),
           "fp32_wr": dict(wr=2)}[change]
    with pytest.raises(RuntimeError, match="ntx_flash_attention"):
        tfa.flash_attention_cuda(q, k, v, plan=dataclasses.replace(p, **bad))


# ----------------------------------------------------------------------
# The fp32 FFMA route: the register-tiled 128-row tile
# ----------------------------------------------------------------------
@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("m,k,n", [(2047, 1001, 1153), (1023, 4097, 1001),
                                   (4096, 512, 4096)])
def test_ffma_gemm_ragged_and_misaligned(cuda, m, k, n, offset, compensated):
    """Ragged shapes on either FFMA tile (ffma_plan picks), operands one
    element off the 16-byte boundary (the masked instantiation), against
    the plain versions: the compensated product within 1e-5 of the
    product's standard deviation, the plain one at f_tol."""
    a = _offset_view(_t((m, k), cuda), offset)
    b = _offset_view(_t((k, n), cuda, k ** -0.5), offset)
    ep = ops._norm_epilogue([("bias", _t((n,), cuda)), "relu"])
    got = tgemm.gemm_cuda(a, b, torch.float32, ep, compensated=compensated)
    assert torch.equal(got, tgemm.gemm_cuda(a.clone(), b.clone(),
                                            torch.float32, ep,
                                            compensated=compensated))
    if compensated:
        want = tgemm.gemm_kahan_plain(a, b, torch.float32, ep)
        # 1e-5 of the product's standard deviation, sqrt(k) k**-0.5 = 1
        torch.testing.assert_close(got, want, rtol=0.0, atol=1e-5)
    else:
        want = tgemm.gemm_plain(a, b, torch.float32, ep)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    got16 = tgemm.gemm_cuda(a, b, torch.bfloat16, ep, compensated=compensated)
    torch.testing.assert_close(got16.float(), want, rtol=1e-2, atol=1e-2)


def test_ffma_large_tile_rounds_exact_slabs_once(cuda):
    """The compensated 128-row tile on exact slabs (as phase 2's check):
    the fp64 product rounded once, bit for bit; the uncompensated one
    off by more."""
    rng = np.random.default_rng(5)
    m, k, n = 2048, 1024, 2048
    assert tgemm.ffma_plan(m, n, k, True).tile == 2
    a = rng.integers(-8, 9, (m, k)).astype(np.float32)
    a[:, :tgemm.KAHAN_SLAB] *= 2.0 ** 16
    b = rng.integers(-8, 9, (k, n)).astype(np.float32)
    want = torch.from_numpy(a.astype(np.float64) @ b.astype(np.float64))
    a, b = torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda)
    got = ops.gemm(a, b, compensated=True).cpu()
    plain = ops.gemm(a, b).cpu()
    assert torch.equal(got, want.float())
    assert float((plain.double() - want).abs().max()) > float(
        (got.double() - want).abs().max()) + 1.0


@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("m,n,tile", [(4096, 4096, 1), (4096, 4096, 0),
                                      (256, 256, 2), (8, 4096, 2)])
def test_ffma_gemm_refuses_a_foreign_tile(cuda, compensated, m, n, tile):
    a, b = _t((m, 64), cuda), _t((64, n), cuda)
    assert tgemm.ffma_plan(m, n, 64, compensated).tile != tile
    with pytest.raises(RuntimeError, match="ntx_gemm"):
        tgemm.gemm_cuda(a, b, compensated=compensated, tile=tile)


# ----------------------------------------------------------------------
# Lane-batched launches: the Executor's multistream/pipeline vmap
# transport runs one launch for L uniform lanes
# ----------------------------------------------------------------------
def _lanes(dev, lanes, n, spacing, offset):
    """(lanes, n) rows ``spacing`` elements apart, the first ``offset``
    elements into a flat buffer: a lane stack of a memory image."""
    flat = _t((offset + lanes * spacing + n,), dev)
    return flat.as_strided((lanes, n), (spacing, 1), offset)


LANE_LAYOUTS = [
    (1003, 1008, 0),               # 16-byte rows: the float4 row path
    (1003, 1009, 1),               # odd stride and base: scalar
    (4096, 4099, 2),               # one chunk exactly, misaligned
    (5 * CHUNK + 7, 5 * CHUNK + 16, 4),   # many chunks, ragged last one
    (128256, 128264, 0),           # the greedy sampler's rows
]


@pytest.mark.parametrize("tail", [None, "sum", "min", "max", "argmin",
                                  "argmax"])
@pytest.mark.parametrize("n,spacing,offset", LANE_LAYOUTS)
def test_stream_lanes_bit_equal_to_single_lane_launches(cuda, n, spacing,
                                                        offset, tail):
    """A launch over L strided rows (x and y at different strides) gives
    each lane the bits of a one-lane launch of the same kernel, and the
    plain version's (a SUM within 1e-5 of sum |v|)."""
    lanes = 4
    x = _lanes(cuda, lanes, n, spacing, offset)
    y = _lanes(cuda, lanes, n, spacing + 4, offset + 3)
    stages = [("axpy", 0.75), ("thresh", -0.2)]
    out, r = tew.stream_cuda(stages, x, (y,), tail=tail)
    assert out.is_contiguous() and out.shape == (lanes, n)
    for lane in range(lanes):
        o1, r1 = tew.stream_cuda(stages, x[lane:lane + 1].clone(),
                                 (y[lane:lane + 1].clone(),), tail=tail)
        assert torch.equal(out[lane], o1[0])
        if tail is not None:
            assert torch.equal(r[lane], r1[0])
    if tail is None:
        assert torch.equal(out, tew.elementwise_chain_plain(stages, x, (y,)))
        return
    w_out, w_r = tred.chain_reduce_plain(stages, tail, x, (y,))
    assert torch.equal(out, w_out)
    if tail == "sum":
        scale = w_out.abs().double().sum(-1)
        assert bool(((r.double() - w_r.double()).abs() <= 1e-5 * scale)
                    .all())
    else:
        assert torch.equal(r, w_r)


@pytest.mark.parametrize("op", ["copy", "axpy", "set"])
def test_ops_take_lane_views_without_a_copy(cuda, op):
    """``ops.elementwise``/``ops.reduce`` launch once on a strided lane
    stack, reading it in place: the result equals the plain version's,
    and equals a launch on a contiguous copy."""
    x = _lanes(cuda, 4, 1003, 1009, 1)
    y = _lanes(cuda, 4, 1003, 1012, 0) if op == "axpy" else None
    ops.reset_launches()
    got = ops.elementwise(op, x, y, imm=0.5)
    red = ops.reduce("argmax", x)
    assert ops.launches()["elementwise"] == 1 and ops.launches()["reduce"] == 1
    assert torch.equal(got, tew.elementwise_plain(op, x, y, 0.5))
    assert torch.equal(got, ops.elementwise(
        op, x.contiguous(), None if y is None else y.contiguous(), imm=0.5))
    assert torch.equal(red, torch.argmax(x, -1).to(torch.int32))


def _gemm_lanes(dev, lanes, m, k, n, dt, pad):
    """(lanes, m, k) and (lanes, k, n) stacks ``pad`` elements apart."""
    a = _t((lanes * (m * k + pad),), dev).to(dt).as_strided(
        (lanes, m, k), (m * k + pad, k, 1))
    b = _t((lanes * (k * n + pad),), dev, k ** -0.5).to(dt).as_strided(
        (lanes, k, n), (k * n + pad, n, 1))
    return a, b


GEMM_LANES = [
    ("bfloat16", 4, 4096, 1024, 8),     # decode tile, split k
    ("bfloat16", 70, 1007, 1003, 5),    # masked loads, large tile
    ("bfloat16", 128, 4096, 512, 0),    # large tile, split k
    ("float32", 512, 512, 512, 0),      # phase 9's lanes
    ("float32", 16, 40, 72, 3),         # the 16 x 128 tile
    ("float32", 2048, 256, 1280, 4),    # the register-tiled 128 rows
]


@pytest.mark.parametrize("dtype,m,k,n,pad", GEMM_LANES)
def test_gemm_lanes_bit_equal_to_single_lane_launches(cuda, dtype, m, k, n,
                                                      pad):
    """One ``ntx_gemm`` launch over 3 lanes at a lane stride (bias and
    residual epilogues per lane, relu) gives each lane the bits of its
    one-lane launch, whatever route, tile and split the plan takes; and
    the plain version's result within the route's tolerance."""
    lanes, dt = 3, getattr(torch, dtype)
    a, b = _gemm_lanes(cuda, lanes, m, k, n, dt, pad)
    bias = _lanes(cuda, lanes, n, n + pad, 0)
    res = _t((lanes, m, n), cuda)
    ep = ops._norm_epilogue([("bias", bias), ("residual", res), "relu"])
    got = tgemm.gemm_cuda(a, b, torch.float32, ep)
    assert got.shape == (lanes, m, n)
    for lane in range(lanes):
        ep1 = ops._norm_epilogue([("bias", bias[lane]),
                                  ("residual", res[lane]), "relu"])
        one = tgemm.gemm_cuda(a[lane].clone(), b[lane].clone(),
                              torch.float32, ep1)
        assert torch.equal(got[lane], one), lane
    tol = 1e-3 if dtype == "float32" else 5e-2
    torch.testing.assert_close(got, tgemm.gemm_plain(a, b, torch.float32, ep),
                               rtol=tol, atol=tol)


def test_compensated_gemm_refuses_lanes(cuda):
    """The compensated route takes one lane, at the wrapper and in the
    kernel (no quiet loop over lanes)."""
    a, b = _gemm_lanes(cuda, 2, 70, 300, 90, torch.float32, 1)
    with pytest.raises(ValueError, match="one lane"):
        tgemm.gemm_cuda(a, b, torch.float32, [], compensated=True)
    with pytest.raises(ValueError, match="compensated"):
        ops.gemm(a, b, compensated=True)


def _lane_program(lanes, n, seed=0):
    import repro_torch.core as core
    rng = np.random.default_rng(seed)
    prog = core.Program()
    for i in range(lanes):
        x = prog.buffer((n,), name=f"x{i}",
                        init=rng.standard_normal(n).astype(np.float32))
        y = prog.buffer((n,), name=f"y{i}",
                        init=rng.standard_normal(n).astype(np.float32))
        t = prog.axpy(0.5, x, y)
        prog.relu(t, out=t)
        prog.reduce("sum", t, name=f"s{i}")
    return prog


def test_every_policy_on_the_card_bit_equal_to_serial(cuda):
    """An 8-lane AXPY -> RELU -> SUM program on a CUDA image under every
    policy and transport: the serial policy's bits, and under
    multistream/vmap one chain-reduce launch for the 8 lanes."""
    import repro_torch.core as core
    prog = _lane_program(8, 3 * CHUNK + 5)
    base = core.Executor("serial", device=cuda).run(prog).mem
    tiny = core.NtxMemSpec(tcdm_bytes=1 << 16)
    runs = [("fused", {}), ("auto", {}),
            ("multistream", {"transport": "vmap"}),
            ("multistream", {"transport": "interleave"}),
            ("multistream", {"transport": "serial"}),
            ("pipeline", {"transport": "vmap"}),
            ("pipeline", {"transport": "interleave"}),
            ("pipeline", {"transport": "overlap"}),
            ("tiled", {"mem": tiny, "dma_overlap": True}),
            ("tiled", {"mem": tiny, "dma_overlap": False})]
    for pol, kw in runs:
        ops.reset_launches()
        got = core.Executor(pol, device=cuda, **kw).run(prog).mem
        assert torch.equal(got, base), (pol, kw)
        if (pol, kw.get("transport")) == ("multistream", "vmap"):
            assert ops.launches()["chain_reduce"] == 1
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="shard_map"):
            core.Executor("multistream", device=cuda,
                          transport="shard_map").run(prog)


# ----------------------------------------------------------------------
# Dense training: the flash backward, the forward's lse, the activation
# backward and the fused MLP's backward
# ----------------------------------------------------------------------
def _rel_l2(got, want):
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp_min(1e-30))


#: chip_smoke's GRAD_RTOL: the worst relative L2 error of dQ / dK / dV
_GRAD_RTOL = {"float32": 1e-4, "bfloat16": 5e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hkv,s,causal", [(32, 8, 256, True),
                                             (32, 4, 256, True),
                                             (8, 2, 1000, True),
                                             (8, 8, 130, False)])
def test_flash_backward_kernel(cuda, dtype, hq, hkv, s, causal):
    """The backward kernel against its plain version (``ref.mha_blocked``'s
    VJP) from the kernel forward's o and lse: GQA groups of 4 and 8, a
    ragged length, non-causal; the last key tile (whose causal bound
    admits only the last query tile) checked on its own."""
    dt = getattr(torch, dtype)
    q = _t((1, s, hq, 128), cuda, 0.5).to(dt).transpose(1, 2)
    k = _t((1, s, hkv, 128), cuda, 0.5).to(dt).transpose(1, 2)
    v = _t((1, s, hkv, 128), cuda).to(dt).transpose(1, 2)
    plan = tfa.flash_plan(1, hq, hkv, s, s, s, 128, dt, causal, lse=True)
    o, lse = tfa.flash_attention_cuda(q, k, v, causal=causal, plan=plan,
                                      lse=True)
    do = _t((1, hq, s, 128), cuda).to(dt)
    got = tfa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal)
    want = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == dt and g.shape == w.shape
        assert _rel_l2(g, w) < _GRAD_RTOL[dtype]
    assert _rel_l2(got[1][:, :, -32:], want[1][:, :, -32:]) < \
        _GRAD_RTOL[dtype]
    assert float(got[1][:, :, -32:].float().abs().sum()) > 0


def test_flash_backward_refuses_a_plan_it_did_not_make(cuda):
    """The launcher recomputes the planner's plan (tiles, ring stages,
    group splits, shared memory) and refuses a plan that differs, as the
    forward does."""
    import dataclasses
    q = _t((1, 64, 8, 128), cuda).bfloat16().transpose(1, 2)
    k = _t((1, 64, 2, 128), cuda).bfloat16().transpose(1, 2)
    plan = tfa.flash_plan(1, 8, 2, 64, 64, 64, 128, torch.bfloat16, True,
                          lse=True)
    o, lse = tfa.flash_attention_cuda(q, k, k, plan=plan, lse=True)
    good = tfa.flash_bwd_plan(1, 8, 2, 64, 64, 128, torch.bfloat16)
    for bad in ({"bk": 32}, {"smem_dq": good.smem_dq + 16},
                {"smem_dkdv": good.smem_dkdv - 1024},
                {"stages": good.stages - 1}, {"gs": good.gs // 2},
                {"warpgroups": 1}):
        with pytest.raises(RuntimeError, match="ntx_flash_attention_bwd"):
            tfa.flash_attention_bwd_cuda(q, k, k, o, lse, q.detach(),
                                         plan=dataclasses.replace(good, **bad))


def _bwd_inputs(cuda, b, hq, hkv, s, d, dt, causal, views=True):
    """q, k, v, dO as the model hands them ((b, s, h, d) viewed as (b, h,
    s, d); dO a view too), o and lse from the kernel forward."""
    def make(h, scale):
        t = _t((b, s, h, d), cuda, scale).to(dt)
        return t.transpose(1, 2) if views else t.transpose(1, 2).contiguous()
    q, k, v, do = make(hq, 0.5), make(hkv, 0.5), make(hkv, 1.0), make(hq, 1.0)
    plan = tfa.flash_plan(b, hq, hkv, s, s, s, d, dt, causal, lse=True)
    o, lse = tfa.flash_attention_cuda(q, k, v, causal=causal, plan=plan,
                                      lse=True)
    return q, k, v, o, lse, do


def _check_bwd(got, want, dtype):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert bool(torch.isfinite(g.float()).all())
        assert _rel_l2(g, w) < _GRAD_RTOL[dtype]
    assert _rel_l2(got[1][:, :, -32:], want[1][:, :, -32:]) < \
        _GRAD_RTOL[dtype]
    assert float(got[1][:, :, -32:].float().abs().sum()) > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hkv,s,causal", [(8, 2, 200, True),
                                             (8, 8, 130, False)])
def test_flash_backward_kernel_d64(cuda, dtype, hq, hkv, s, causal):
    """Head dim 64 (one 64-column panel a tile on the bf16 route)."""
    dt = getattr(torch, dtype)
    args = _bwd_inputs(cuda, 2, hq, hkv, s, 64, dt, causal)
    got = tfa.flash_attention_bwd_cuda(*args, causal=causal)
    _check_bwd(got, tfa.flash_attention_bwd_plain(*args, causal=causal),
               dtype)


@pytest.mark.parametrize("b,hkv,gs_more_than_one", [(2, 4, True),
                                                    (4, 8, False)])
def test_flash_backward_training_shapes(cuda, b, hkv, gs_more_than_one):
    """yi's group of 8 at b 2, s 2048, whose plan splits the group (the
    fp32 partials added in split order by the merge launch), and the path
    shape (b 4, hkv 8, s 2048), whose plan keeps whole groups."""
    plan = tfa.flash_bwd_plan(b, 32, hkv, 2048, 2048, 128, torch.bfloat16)
    assert (plan.gs > 1) == gs_more_than_one
    args = _bwd_inputs(cuda, b, 32, hkv, 2048, 128, torch.bfloat16, True)
    got = tfa.flash_attention_bwd_cuda(*args)
    _check_bwd(got, tfa.flash_attention_bwd_plain(*args), "bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_backward_strided_and_misaligned(cuda, dtype):
    """Operands as strided views give the bits of their contiguous copies;
    one that starts off a 16-byte boundary (the tensor maps cannot read
    it, so the launcher copies it) gives them too."""
    dt = getattr(torch, dtype)
    q, k, v, o, lse, do = _bwd_inputs(cuda, 1, 8, 2, 300, 128, dt, True)
    got = tfa.flash_attention_bwd_cuda(q, k, v, o, lse, do)
    cont = tfa.flash_attention_bwd_cuda(q.contiguous(), k.contiguous(),
                                        v.contiguous(), o, lse,
                                        do.contiguous())
    buf = torch.empty(do.numel() + 1, dtype=dt, device=cuda)
    off = buf[1:].view(do.shape).copy_(do)
    assert off.data_ptr() % 16
    shifted = tfa.flash_attention_bwd_cuda(q, k, v, o, lse, off)
    for g, c, sh in zip(got, cont, shifted):
        assert torch.equal(g, c) and torch.equal(g, sh)
    _check_bwd(got, tfa.flash_attention_bwd_plain(q, k, v, o, lse, do),
               dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hkv,s", [(32, 8, 256), (8, 2, 1000),
                                      (32, 4, 640)])
def test_flash_backward_two_calls_bit_equal(cuda, dtype, hq, hkv, s):
    """Deterministic: every output element is summed in a fixed order (no
    atomics; the group splits' partials added in split order), so two
    calls on the same inputs give the same bits."""
    dt = getattr(torch, dtype)
    args = _bwd_inputs(cuda, 1, hq, hkv, s, 128, dt, True)
    first = tfa.flash_attention_bwd_cuda(*args)
    second = tfa.flash_attention_bwd_cuda(*args)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_forward_lse(cuda, dtype):
    """The forward's lse output against ``flash_lse_plain``; the output o
    keeps the bits of the call without lse."""
    dt = getattr(torch, dtype)
    q = _t((2, 100, 8, 128), cuda, 0.5).to(dt).transpose(1, 2)
    k, v = (_t((2, 100, 2, 128), cuda, 0.5).to(dt).transpose(1, 2)
            for _ in range(2))
    plan = tfa.flash_plan(2, 8, 2, 100, 100, 100, 128, dt, True, lse=True)
    o, lse = tfa.flash_attention_cuda(q, k, v, plan=plan, lse=True)
    torch.testing.assert_close(lse, tfa.flash_lse_plain(q, k), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(o, tfa.flash_attention_cuda(q, k, v, plan=plan))


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(333, 1001), (64, 2048)])
def test_act_bwd_kernel_bit_equal(cuda, act, dtype, shape):
    """The activation backward kernel bit-equal to its plain version on
    the card (every operation rounded on its own), on a ragged length
    (scalar loop) and a 16-byte one."""
    dt = getattr(torch, dtype)
    dh, gate = _t(shape, cuda), _t(shape, cuda)
    a1 = _t(shape, cuda, 3.0)
    g = gate if act == "swiglu" else None
    got = tew.act_bwd_cuda(act, dh, a1, g, dt)
    want = tew.act_bwd_plain(act, dh, a1, g, dt)
    for x, y in zip(got, want):
        assert (x is None) == (y is None)
        if x is not None:
            assert x.dtype == dt and torch.equal(x, y)


def test_act_bwd_h_is_the_forward_hidden(cuda):
    """The SwiGLU hidden h that the activation backward writes (for dw2)
    has the bits of the forward's w1 GEMM with its silu * gate store
    epilogue, from the same fp32 a1 and gate (the same operations)."""
    x = _t((96, 512), cuda).bfloat16()
    w1, w3 = (_t((512, 1536), cuda, 512 ** -0.5).bfloat16() for _ in range(2))
    gate = ops.gemm(x, w3)
    h = ops.gemm(x, w1, out_dtype=torch.bfloat16,
                 epilogue=[("silu",), ("mul", gate)])
    a1 = ops.gemm(x, w1)
    _, _, h2 = ops.act_bwd("swiglu", torch.zeros_like(a1), a1, gate,
                           torch.bfloat16)
    assert torch.equal(h, h2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_mlp_backward_on_the_card(cuda, dtype):
    """``ops.fused_mlp`` under autograd on the card (the ``_FusedMLP``
    backward: 8 ntx_gemm launches and one activation backward) against the
    same Function's plain backward on the CPU: fp32 1e-4, bf16 GRAD_RTOL
    by relative L2."""
    dt = getattr(torch, dtype)
    d, f, m = 256, 768, 96
    ins = [_t((m, d), cuda).to(dt), _t((d, f), cuda, d ** -0.5).to(dt),
           _t((f, d), cuda, f ** -0.5).to(dt),
           _t((d, f), cuda, d ** -0.5).to(dt), _t((m, d), cuda).to(dt)]
    go = _t((m, d), cuda).to(dt)
    outs = []
    for dev in (cuda, "cpu"):
        xs = [t.to(dev).requires_grad_() for t in ins]
        ops.reset_launches()
        out = ops.fused_mlp(*xs[:4], act="swiglu", residual=xs[4])
        grads = torch.autograd.grad(out, xs, go.to(dev))
        outs.append((ops.launches(), [g.cpu() for g in grads]))
    (counts, got), (_, want) = outs
    assert counts["gemm"] == 3 + 8 and counts["act_bwd"] == 1
    for g, w in zip(got, want):
        assert g.dtype == dt
        if dtype == "float32":
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
        else:
            assert _rel_l2(g, w) < _GRAD_RTOL[dtype]


def test_attention_backward_counts_and_refuses_decode(cuda):
    """ops.attention under autograd on the card: one forward launch with
    lse, one backward call; a kv_len (decode) raises instead of going to
    a plain version."""
    q = _t((1, 8, 64, 128), cuda).bfloat16().requires_grad_()
    k = _t((1, 2, 64, 128), cuda).bfloat16().requires_grad_()
    ops.reset_launches()
    out = ops.attention(q, k, k)
    torch.autograd.grad(out.float().sum(), (q, k))
    assert (ops.launches()["attention"], ops.launches()["attention_bwd"]) \
        == (1, 1)
    with pytest.raises(NotImplementedError, match="training shapes"):
        ops.attention(q, k, k, kv_len=40)


# ----------------------------------------------------------------------
# MLA's head dims: q/k 192 (128 nope + 64 rope), v 128
# ----------------------------------------------------------------------
def _mla_qkv(cuda, b, h, sq, skv, dt, hkv=None):
    """q and k as MLA makes them (concatenations of the nope and rope
    parts: contiguous (b, h, s, 192)), v the latent's up-projection viewed
    as (b, h, s, 128)."""
    hkv = hkv or h
    q = _t((b, h, sq, 192), cuda, 0.5).to(dt)
    k = _t((b, hkv, skv, 192), cuda, 0.5).to(dt)
    v = _t((b, skv, hkv, 128), cuda).to(dt).transpose(1, 2)
    return q, k, v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,skv,kv_len,hkv", [
    (32, 32, 32, 16), (300, 300, 300, 16), (1, 56, 40, 16),
    (1, 2064, 2049, 16), (65, 130, 40, 16), (37, 77, 60, 4),
    (1, 4099, 4000, 2)])
def test_flash_mla_forward(cuda, dtype, sq, skv, kv_len, hkv):
    """The (192, 128) route against the plain version at phase 2's
    tolerances: prefill (causal, ragged), decode with kv_len, the long
    decode whose plan splits the keys (and its merge at dv 128), rows with
    no valid key, GQA groups; o is (b, hq, sq, 128); two calls, the same
    bits; ops.attention launches it (and counts the merge)."""
    dt = getattr(torch, dtype)
    q, k, v = _mla_qkv(cuda, 2, 16, sq, skv, dt, hkv)
    got = tfa.flash_attention_cuda(q, k, v, causal=True, kv_len=kv_len)
    assert got.shape == (2, 16, sq, 128) and got.dtype == dt
    assert torch.equal(got, tfa.flash_attention_cuda(q, k, v, causal=True,
                                                     kv_len=kv_len))
    tol = 1e-4 if dtype == "float32" else 1e-2
    torch.testing.assert_close(got.float(), _attention_want(q, k, v, kv_len),
                               rtol=tol, atol=tol)
    plan = tfa.flash_plan(2, 16, hkv, sq, skv, kv_len, 192, dt, dv=128)
    ops.reset_launches()
    via_ops = ops.attention(q, k, v, causal=True, kv_len=kv_len,
                            scale=192 ** -0.5)
    assert ops.launches()["attention"] == 1
    assert ops.launches()["attention_merge"] == int(plan.splits > 1)
    assert torch.equal(via_ops, got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_mla_forward_not_causal_and_split_merge(cuda, dtype):
    """Non-causal attention at (192, 128); the long decode's split
    partials merged alone (flash_merge_cuda at dv 128) give the bits of
    the merged call and agree with ``flash_merge_plain``."""
    dt = getattr(torch, dtype)
    q, k, v = _mla_qkv(cuda, 1, 16, 70, 70, dt)
    got = tfa.flash_attention_cuda(q, k, v, causal=False)
    tol = 1e-4 if dtype == "float32" else 1e-2
    torch.testing.assert_close(
        got.float(), tfa.flash_attention_plain(q, k, v, causal=False).float(),
        rtol=tol, atol=tol)
    q, k, v = _mla_qkv(cuda, 1, 16, 1, 2064, dt)
    plan = tfa.flash_plan(1, 16, 16, 1, 2064, 2049, 192, dt, dv=128)
    assert plan.splits > 1 and plan.workspace == plan.splits * 16 * 130
    whole = tfa.flash_attention_cuda(q, k, v, kv_len=2049)
    ws, o = tfa.flash_attention_cuda(q, k, v, kv_len=2049, partials=True)
    merged = tfa.flash_merge_cuda(ws, o, plan.splits)
    assert torch.equal(merged, whole)
    torch.testing.assert_close(
        merged.float(), tfa.flash_merge_plain(ws, plan.splits, 1, 16, 1, 128
                                              ).float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dq,dv", [(192, 64), (128, 64), (64, 128),
                                   (96, 96)])
def test_flash_refuses_other_head_pairs(cuda, dq, dv):
    """Any other (q/k, v) pair raises ValueError on the card; nothing goes
    to the plain version."""
    q, k = (_t((1, 4, 8, dq), cuda).bfloat16() for _ in range(2))
    v = _t((1, 4, 8, dv), cuda).bfloat16()
    with pytest.raises(ValueError, match="head dims"):
        ops.attention(q, k, v)
    with pytest.raises(ValueError, match="head dims"):
        ops.attention(q.requires_grad_(), k, v)


@pytest.mark.parametrize("dtype,b,h,hkv,s,causal", [
    (dt, *shape) for dt in ("float32", "bfloat16")
    for shape in ((1, 16, 16, 256, True), (2, 8, 2, 300, True),
                  (1, 4, 4, 130, False))] + [
    ("bfloat16", 1, 16, 16, 2048, True)])
def test_flash_mla_backward(cuda, dtype, b, h, hkv, s, causal):
    """The (192, 128) backward against its plain version (the reference's
    flash-style VJP) at chip_smoke's gradient limits (5e-2 bf16, 1e-4
    fp32 relative L2); dq and dk are 192 wide, dv 128; the last key tile
    on its own; two calls, the same bits."""
    dt = getattr(torch, dtype)
    q, k, v = _mla_qkv(cuda, b, h, s, s, dt, hkv)
    plan = tfa.flash_plan(b, h, hkv, s, s, s, 192, dt, causal, lse=True,
                          dv=128)
    o, lse = tfa.flash_attention_cuda(q, k, v, causal=causal, plan=plan,
                                      lse=True)
    do = _t((b, s, h, 128), cuda).to(dt).transpose(1, 2)
    got = tfa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal)
    want = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
    assert [g.shape[-1] for g in got] == [192, 192, 128]
    _check_bwd(got, want, dtype)
    again = tfa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


def test_flash_mla_backward_group_split(cuda):
    """A plan that splits the GQA group (fp32 partials of dK at 192 and dV
    at 128, added in split order by the merge launch)."""
    plan = tfa.flash_bwd_plan(1, 16, 2, 512, 512, 192, torch.bfloat16,
                              True, 128)
    assert plan.gs > 1 and plan.ws_bytes == plan.gs * 2 * 512 * 320 * 4
    q, k, v = _mla_qkv(cuda, 1, 16, 512, 512, torch.bfloat16, 2)
    plan_f = tfa.flash_plan(1, 16, 2, 512, 512, 512, 192, torch.bfloat16,
                            True, lse=True, dv=128)
    o, lse = tfa.flash_attention_cuda(q, k, v, plan=plan_f, lse=True)
    do = _t((1, 16, 512, 128), cuda).bfloat16()
    got = tfa.flash_attention_bwd_cuda(q, k, v, o, lse, do)
    _check_bwd(got, tfa.flash_attention_bwd_plain(q, k, v, o, lse, do),
               "bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_mla_autograd_on_the_card(cuda, dtype):
    """ops.attention at (192, 128) under autograd: the forward with lse and
    the backward kernel, one launch each, gradients against the CPU's
    plain route."""
    dt = getattr(torch, dtype)
    q, k, v = _mla_qkv(cuda, 1, 4, 100, 100, dt)
    go = _t((1, 4, 100, 128), cuda).to(dt)
    outs = []
    for dev in (cuda, "cpu"):
        xs = [t.detach().to(dev).requires_grad_() for t in (q, k, v)]
        ops.reset_launches()
        out = ops.attention(*xs, scale=192 ** -0.5)
        grads = torch.autograd.grad(out, xs, go.to(dev))
        outs.append((ops.launches(), [g.cpu() for g in grads]))
    (counts, got), (_, want) = outs
    assert (counts["attention"], counts["attention_bwd"]) == (1, 1)
    for g, w in zip(got, want):
        assert g.dtype == dt and g.shape == w.shape
        assert _rel_l2(g, w) < _GRAD_RTOL[dtype]


# ----------------------------------------------------------------------
# MoE training: deepseek-v2-lite-16b (MLA) and phi3.5-moe-42b (GQA)
# ----------------------------------------------------------------------
def _moe_small(arch):
    """The MoE config narrowed but keeping the head dims the kernels take
    (MLA q/k 192 = 128 + 64, v 128; GQA 128): 2 layers, fp32, one
    microbatch."""
    from repro_torch import configs
    narrow = {"deepseek-v2-lite-16b": dict(
        d_model=256, n_heads=4, n_kv_heads=4, kv_lora_rank=64, n_experts=8,
        top_k=2, d_ff_expert=64, n_shared_experts=1),
        "phi3.5-moe-42b": dict(d_model=256, n_heads=2, n_kv_heads=1,
                               n_experts=4, d_ff_expert=128)}[arch]
    return configs.get(arch).scaled(
        n_layers=2, vocab=512, grad_accum=1, compute_dtype="float32",
        param_dtype="float32", **narrow)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "phi3.5-moe-42b"])
def test_moe_training_step_card_vs_cpu(cuda, arch):
    """A head-dim-preserving small MoE model's loss, every leaf's gradient
    and one build_step_fn step on the card and on the CPU from the same
    weights and batch (fp32): every MoE routing identical on both, the
    loss at 1e-5, each leaf within 1e-4 relative L2 (chip_smoke's
    limit); the attention forward with lse and its recompute, and the
    backward kernel, launched once a layer each."""
    import copy
    from repro_torch.data import SyntheticLM
    from repro_torch.models import Model, moe
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.runtime import build_step_fn
    cfg = _moe_small(arch)
    model = Model(cfg)
    p_cpu = model.init(0, device="cpu", trainable=True)
    p_gpu = copy.deepcopy(p_cpu).to(cuda)
    batch = SyntheticLM(cfg, 2, 64, seed=0).batch_at(0)
    route, res = moe.route, []
    for dev, params in ((cuda, p_gpu), ("cpu", p_cpu)):
        experts = []

        def recording(c, p, x):
            out = route(c, p, x)
            experts.append(out[2].cpu())
            return out
        named = dict(params.named_parameters())
        b = {k: v.to(dev) for k, v in batch.items()}
        ops.reset_launches()
        moe.route = recording
        try:
            loss, _ = model.loss(params, b)
            grads = {n: g.cpu() for n, g in zip(named, torch.autograd.grad(
                loss, list(named.values())))}
            counts = ops.launches()
            build_step_fn(cfg, AdamWConfig(warmup_steps=1, total_steps=10))(
                params, init_opt_state(named), b)
        finally:
            moe.route = route
        res.append((float(loss.detach()), grads, experts, counts,
                    {n: p.detach().cpu() for n, p in named.items()}))
    (lg, gg, eg, counts, pg), (lc, gc, ec, _, pc) = res
    assert (counts["attention"], counts["attention_bwd"]) == (
        2 * cfg.n_layers, cfg.n_layers)
    assert len(eg) == len(ec) == 4 * cfg.n_layers
    assert all(torch.equal(a, b) for a, b in zip(eg, ec))
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    for n, want in gc.items():
        assert _rel_l2(gg[n], want) <= _GRAD_RTOL["float32"], n
    for n, want in pc.items():
        torch.testing.assert_close(pg[n], want, rtol=1e-5, atol=2 * 3e-4)


def test_attention_mla_lse_under_remat(cuda):
    """ops.attention at (192, 128) under autograd inside remat_wrap (the
    MoE layers' full remat, non-reentrant checkpoint): the forward with
    lse runs twice (the forward and the recompute), the backward kernel
    once; gradients against the CPU's plain route."""
    from repro_torch import configs
    from repro_torch.models.common import remat_wrap
    cfg = configs.get("deepseek-v2-lite-16b")
    assert cfg.remat == "full"
    q, k, v = _mla_qkv(cuda, 1, 4, 200, 200, torch.bfloat16)
    go = _t((1, 4, 200, 128), cuda).bfloat16()
    fn = remat_wrap(cfg, lambda a, b, c: ops.attention(a, b, c,
                                                       scale=192 ** -0.5))
    outs = []
    for dev in (cuda, "cpu"):
        xs = [t.detach().to(dev).requires_grad_() for t in (q, k, v)]
        ops.reset_launches()
        grads = torch.autograd.grad(fn(*xs), xs, go.to(dev))
        outs.append((ops.launches(), [g.cpu() for g in grads]))
    (counts, got), (_, want) = outs
    assert (counts["attention"], counts["attention_bwd"]) == (2, 1)
    for g, w in zip(got, want):
        assert g.shape == w.shape and _rel_l2(g, w) < _GRAD_RTOL["bfloat16"]


# ----------------------------------------------------------------------
# SSM serving: the SSD kernel's final state, mamba2 and jamba on the card
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,l,h,dh,n,chunk", [
    (4, 32, 64, 64, 128, 128),       # mamba2's serving prefill (ragged)
    (1, 2048, 64, 64, 128, 128),     # a long prompt: 16 chunks carried
    (4, 32, 128, 64, 16, 128),       # jamba's widths
    (2, 1, 4, 64, 128, 128), (2, 129, 4, 64, 128, 128),
    (3, 17, 2, 32, 32, 16)])         # ragged: l 1 and chunk + 1
def test_ssd_state_kernel(cuda, dtype, b, l, h, dh, n, chunk):
    """The final-state route against its plain version (y as
    test_ssd_kernel holds it; the fp32 state in both routes at 1e-3
    elementwise and at a relative L2 of 1e-4, chip_smoke's
    SSM_STATE_L2["float32"]: every product exact or fp32, every sum fp32,
    so only the order of the sums differs); y bit-equal to the call
    without the state."""
    from repro_torch.kernels import ssd_scan
    ins = _ssd_inputs(cuda, b, l, h, dh, n, getattr(torch, dtype))
    y, s = ssd_scan.ssd_scan_cuda(*ins, chunk=chunk, final_state=True)
    want_y, want_s = ssd_scan.ssd_scan_with_state_plain(*ins, chunk=chunk)
    assert s.shape == (b, h, n, dh) and s.dtype == torch.float32
    tol = 1e-3 if dtype == "float32" else 1e-2
    torch.testing.assert_close(y.float(), want_y.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(s, want_s, rtol=1e-3, atol=1e-3)
    assert _rel_l2(s, want_s) <= 1e-4
    assert torch.equal(y, ssd_scan.ssd_scan_cuda(*ins, chunk=chunk))


def test_ssd_with_state_counts_and_refuses_a_gradient(cuda):
    """ops.ssd_with_state launches the kernel (counted under ssd_state,
    not ssd) and refuses tensors that autograd tracks."""
    ins = _ssd_inputs(cuda, 1, 40, 2, 16, 32, torch.bfloat16)
    ops.reset_launches()
    y, s = ops.ssd_with_state(*ins, chunk=16)
    assert ops.launches()["ssd_state"] == 1 and ops.launches()["ssd"] == 0
    assert torch.equal(y, ops.ssd(*ins, chunk=16))
    x = ins[0].clone().requires_grad_()
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.ssd_with_state(x, *ins[1:], chunk=16)
    with torch.no_grad():
        ops.ssd_with_state(x, *ins[1:], chunk=16)


def _ssm_small(arch):
    """The config narrowed to d_model 256 but keeping the SSM's head dim,
    d_state and chunk and GQA's head dim 128 (the flash kernel's): mamba2
    at 2 layers, jamba at one whole period of 8 (its attention layer
    included, 4 experts), fp32."""
    from repro_torch import configs
    narrow = {"mamba2-1.3b": dict(n_layers=2),
              "jamba-v0.1-52b": dict(n_layers=8, n_heads=2, n_kv_heads=1,
                                     d_ff=256, n_experts=4,
                                     d_ff_expert=128)}[arch]
    return configs.get(arch).scaled(
        d_model=256, vocab=512, compute_dtype="float32",
        param_dtype="float32", **narrow)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-v0.1-52b"])
def test_ssm_serving_card_vs_cpu(cuda, arch):
    """A small mamba2 and jamba (``_ssm_small``): prefill logits and every
    cache leaf, then 4 decode steps' logits, card against CPU from the
    same weights; the prefill runs the state route once per Mamba-2 layer
    and never ops.ssd. fp32 logits and the state at the SSD kernel's 1e-3,
    the bf16 cache leaves at 1e-2."""
    import copy
    from repro_torch.models import Model
    cfg = _ssm_small(arch)
    n_layers = cfg.n_layers
    model = Model(cfg)
    p_cpu = model.init(0, device="cpu")
    p_gpu = copy.deepcopy(p_cpu).to(cuda)
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 20))).long()
    # the decode steps' tokens, the same on both sides
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 2, 1))).long()
    n_ssm = sum(not cfg.is_attn_layer(i) for i in range(n_layers))
    res = []
    for dev, params in ((cuda, p_gpu), ("cpu", p_cpu)):
        ops.reset_launches()
        with torch.inference_mode():
            logits, cache, fill = model.prefill(
                params, {"tokens": toks.to(dev)}, cache_len=32)
            counts = ops.launches()
            steps = [logits.cpu()]
            cache0 = [{k: v.cpu().clone() for k, v in c.items()}
                      for c in cache]
            for tok in nxt:
                logits, cache = model.decode(params, tok.to(dev), cache,
                                             fill)
                fill += 1
                steps.append(logits[:, 0].cpu())
        res.append((steps, cache0, counts))
    (sg, cg, counts), (sc, cc, _) = res
    assert counts["ssd_state"] == n_ssm and counts["ssd"] == 0
    for a, b in zip(sg, sc):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3)
    for a, b in zip(cg, cc):
        assert a.keys() == b.keys()
        for k in a:
            tol = 1e-3 if a[k].dtype == torch.float32 else 1e-2
            torch.testing.assert_close(a[k].float(), b[k].float(), rtol=tol,
                                       atol=tol)


# ----------------------------------------------------------------------
# the encoder-decoder (whisper) and the VLM (qwen2-vl)
# ----------------------------------------------------------------------
def _cross_inputs(cuda, b, hq, hkv, sq, skv, d, dt, causal):
    """q and dO of sq rows, k and v of skv rows, as the model hands them
    ((b, s, h, d) viewed as (b, h, s, d)); o and lse from the kernel
    forward."""
    view = lambda s, h, scale: _t((b, s, h, d), cuda, scale).to(
        dt).transpose(1, 2)
    q, k, v = view(sq, hq, 0.5), view(skv, hkv, 0.5), view(skv, hkv, 1.0)
    do = view(sq, hq, 1.0)
    plan = tfa.flash_plan(b, hq, hkv, sq, skv, skv, d, dt, causal, lse=True)
    o, lse = tfa.flash_attention_cuda(q, k, v, causal=causal, plan=plan,
                                      lse=True)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("b,h,sq,skv", [(2, 4, 100, 300), (2, 4, 300, 100),
                                        (1, 4, 448, 1500)])
def test_flash_backward_cross_attention(cuda, dtype, d, b, h, sq, skv):
    """The backward at sq != skv, non-causal (the encoder-decoder's
    cross-attention: 448 decoder queries against 1500 encoder keys, both
    tiles ragged), d 64 and 128, against its plain version: each gradient
    by relative L2 (GRAD_RTOL), the last key tile on its own."""
    dt = getattr(torch, dtype)
    args = _cross_inputs(cuda, b, h, h, sq, skv, d, dt, False)
    got = tfa.flash_attention_bwd_cuda(*args, causal=False)
    want = tfa.flash_attention_bwd_plain(*args, causal=False)
    assert got[0].shape == (b, h, sq, d) and got[1].shape == (b, h, skv, d)
    _check_bwd(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,skv,causal,gs", [(1, 64, 3000, False, 3),
                                                (2, 256, 256, True, 6)])
def test_flash_backward_group_of_six(cuda, dtype, b, sq, skv, causal, gs):
    """qwen2-vl's GQA group of 6 (12 / 2 heads of 128): the plan splits
    the group into 3 (a long non-causal key run) or 6 (causal), the
    splits' fp32 partials added in split order; against the plain
    version by relative L2."""
    dt = getattr(torch, dtype)
    plan = tfa.flash_bwd_plan(b, 12, 2, sq, skv, 128, dt, causal)
    assert plan.gs == gs and 6 % plan.gs == 0
    args = _cross_inputs(cuda, b, 12, 2, sq, skv, 128, dt, causal)
    got = tfa.flash_attention_bwd_cuda(*args, causal=causal)
    _check_bwd(got, tfa.flash_attention_bwd_plain(*args, causal=causal),
               dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_cross_decode_split_merge_d64(cuda, dtype):
    """The encoder-decoder's decode cross-attention: one query a request
    (g 1) against all 1500 cached encoder keys, non-causal, d 64. The
    plan splits the keys and ``ops.attention`` launches the split kernel
    and the merge; against the plain version (fp32 1e-4, bf16 1e-2)."""
    dt = getattr(torch, dtype)
    q = _t((4, 16, 1, 64), cuda, 0.5).to(dt)
    k = _t((4, 16, 1500, 64), cuda, 0.5).to(dt)
    v = _t((4, 16, 1500, 64), cuda).to(dt)
    plan = tfa.flash_plan(4, 16, 16, 1, 1500, 1500, 64, dt, False)
    assert plan.splits > 1
    ops.reset_launches()
    got = ops.attention(q, k, v, causal=False)
    counts = ops.launches()
    assert (counts["attention"], counts["attention_merge"]) == (1, 1)
    want = tfa.flash_attention_plain(q, k, v, causal=False)
    tol = 1e-4 if dtype == "float32" else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_gelu_mlp_with_residual_on_the_card(cuda, dtype):
    """whisper's MLP (d 1024 -> 4096, tanh GELU in the first product's
    store, the residual in the second's) under autograd on the card
    against the same Function on the CPU: the output and every gradient
    (fp32 1e-4, bf16 by relative L2), 2 + 5 GEMM launches and one
    activation backward."""
    dt = getattr(torch, dtype)
    d, f, m = 1024, 4096, 64
    ins = [_t((m, d), cuda).to(dt), _t((d, f), cuda, d ** -0.5).to(dt),
           _t((f, d), cuda, f ** -0.5).to(dt), _t((m, d), cuda).to(dt)]
    go = _t((m, d), cuda).to(dt)
    outs = []
    for dev in (cuda, "cpu"):
        xs = [t.to(dev).requires_grad_() for t in ins]
        ops.reset_launches()
        out = ops.fused_mlp(xs[0], xs[1], xs[2], act="gelu", residual=xs[3])
        grads = torch.autograd.grad(out, xs, go.to(dev))
        outs.append((ops.launches(), out.detach().cpu(),
                     [g.cpu() for g in grads]))
    (counts, og, got), (_, oc, want) = outs
    assert counts["gemm"] == 2 + 5 and counts["act_bwd"] == 1
    for g, w in zip([og, *got], [oc, *want]):
        assert g.dtype == dt
        if dtype == "float32":
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
        else:
            assert _rel_l2(g, w) < _GRAD_RTOL[dtype]


def _family_small(arch):
    """whisper or qwen2-vl narrowed to d_model 256 with the flash kernel's
    head dims (whisper 4 heads of 64; qwen 2 / 1 heads of 128, M-RoPE
    sections summing to 64), 2 layers (whisper 2 + 2, 128 frames; qwen
    16 patches), fp32."""
    from repro_torch import configs
    narrow = {"whisper-medium": dict(n_layers=2, n_enc_layers=2, n_heads=4,
                                     n_kv_heads=4, d_ff=512, enc_seq=128),
              "qwen2-vl-2b": dict(n_layers=2, n_heads=2, n_kv_heads=1,
                                  d_ff=512, n_patches=16,
                                  mrope_sections=(16, 24, 24))}[arch]
    return configs.get(arch).scaled(
        d_model=256, vocab=512, compute_dtype="float32",
        param_dtype="float32", **narrow)


def _family_extra(cfg, b, s):
    """The stub inputs, drawn with numpy: frames, or patches and pos3."""
    rng = np.random.default_rng(3)
    if cfg.encoder_decoder:
        return {"enc_embeds": torch.from_numpy(rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model)) * 0.02).to(torch.bfloat16)}
    pos = np.arange(s) + (np.arange(s) >= cfg.n_patches) * 3
    pos3 = np.stack([pos, pos // 2, pos % 7])[:, None].repeat(b, 1)
    return {"img_embeds": torch.from_numpy(rng.standard_normal(
        (b, cfg.n_patches, cfg.d_model)) * 0.02).to(torch.bfloat16),
        "pos3": torch.from_numpy(pos3)}


@pytest.mark.parametrize("arch", ["whisper-medium", "qwen2-vl-2b"])
def test_family_serving_card_vs_cpu(cuda, arch):
    """A small whisper and qwen2-vl (``_family_small``) through ``Model``:
    prefill logits and every cache leaf (whisper's k, v, ck, cv), then 4
    decode steps' logits, card against CPU from the same weights and stub
    inputs; every attention layer a flash launch (whisper: encoder, self
    and cross). fp32 logits at 1e-3, the bf16 cache leaves at 1e-2."""
    import copy
    from repro_torch.models import Model
    cfg = _family_small(arch)
    model = Model(cfg)
    p_cpu = model.init(0, device="cpu")
    p_gpu = copy.deepcopy(p_cpu).to(cuda)
    rng = np.random.default_rng(2)
    s = 24 if cfg.encoder_decoder else cfg.n_patches + 8
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, s))).long()
    extra = _family_extra(cfg, 2, s)
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 2, 1))).long()
    res = []
    for dev, params in ((cuda, p_gpu), ("cpu", p_cpu)):
        ops.reset_launches()
        batch = {"tokens": toks.to(dev),
                 **{k: v.to(dev) for k, v in extra.items()}}
        with torch.inference_mode():
            logits, cache, fill = model.prefill(params, batch,
                                                cache_len=s + 8)
            counts = ops.launches()
            steps = [logits.cpu()]
            cache0 = [{k: v.cpu().clone() for k, v in c.items()}
                      for c in cache]
            for tok in nxt:
                logits, cache = model.decode(params, tok.to(dev), cache,
                                             fill)
                fill += 1
                steps.append(logits[:, 0].cpu())
        res.append((steps, cache0, counts))
    (sg, cg, counts), (sc, cc, _) = res
    n_attn = (cfg.n_enc_layers + 2 * cfg.n_layers if cfg.encoder_decoder
              else cfg.n_layers)
    assert counts["attention"] == n_attn
    for a, b in zip(sg, sc):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3)
    for a, b in zip(cg, cc):
        assert a.keys() == b.keys()
        for k in a:
            torch.testing.assert_close(a[k].float(), b[k].float(), rtol=1e-2,
                                       atol=1e-2)


@pytest.mark.parametrize("arch", ["whisper-medium", "qwen2-vl-2b"])
def test_family_training_card_vs_cpu(cuda, arch):
    """The small models' loss and every leaf's gradient on the card and on
    the CPU from the same weights and pipeline batch (fp32): the loss at
    1e-5, each leaf within 1e-4 relative L2; the flash forward with lse
    and its recompute, and the backward kernel, once an attention layer
    each; the activation backward once an MLP."""
    import copy
    from repro_torch.data import SyntheticLM
    from repro_torch.models import Model
    cfg = _family_small(arch)
    model = Model(cfg)
    p_cpu = model.init(0, device="cpu", trainable=True)
    p_gpu = copy.deepcopy(p_cpu).to(cuda)
    batch = SyntheticLM(cfg, 2, 48, seed=0).batch_at(0)
    res = []
    for dev, params in ((cuda, p_gpu), ("cpu", p_cpu)):
        named = dict(params.named_parameters())
        ops.reset_launches()
        loss, _ = model.loss(params, {k: v.to(dev) for k, v in batch.items()})
        grads = {n: g.cpu() for n, g in zip(named, torch.autograd.grad(
            loss, list(named.values())))}
        res.append((float(loss.detach()), grads, ops.launches()))
    (lg, gg, counts), (lc, gc, _) = res
    n_attn = (cfg.n_enc_layers + 2 * cfg.n_layers if cfg.encoder_decoder
              else cfg.n_layers)
    n_mlp = cfg.n_layers + (cfg.n_enc_layers if cfg.encoder_decoder else 0)
    assert (counts["attention"], counts["attention_bwd"],
            counts["act_bwd"]) == (2 * n_attn, n_attn, n_mlp)
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    for n, want in gc.items():
        assert _rel_l2(gg[n], want) <= _GRAD_RTOL["float32"], n


def _card_legal(arch: str):
    """The reduced config at head dims the card's kernels take (64; MLA's
    192 / 128), two layers, one microbatch."""
    from repro_torch import configs
    cfg = configs.get_reduced(arch).scaled(n_layers=2, grad_accum=1)
    if cfg.mla:
        return cfg.scaled(nope_head_dim=128, rope_head_dim=64,
                          v_head_dim=128)
    return cfg.scaled(head_dim=64)


@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-v2-lite-16b"])
def test_dry_run_calls_equal_the_cards_launches(cuda, arch):
    """One training step on the card launches, family by family, what
    the dry run of the same step on the meta device tallies."""
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import dryrun
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.runtime import build_step_fn
    cfg = _card_legal(arch)
    b, s = 2, 128
    params = Model(cfg).init(0, device=cuda, trainable=True)
    opt = init_opt_state(dict(params.named_parameters()))
    batch = {k: v.to(cuda) for k, v in
             SyntheticLM(cfg, b, s, seed=0).batch_at(0).items()}
    ops.reset_launches()
    ops.reset_dry()
    build_step_fn(cfg, AdamWConfig())(params, opt, batch)
    torch.cuda.synchronize()
    card = {k: v for k, v in ops.launches().items() if v}
    assert sum(ops.dry()["calls"].values()) == 0   # no call went to meta
    fn, args = dryrun.train_step(cfg, b, s)
    assert dryrun.trace(fn, *args)["launches"] == card
    assert card["attention"] == 2 * cfg.n_layers and \
        card["attention_bwd"] == cfg.n_layers


def test_cuda_tensors_never_take_the_meta_route(cuda):
    """Every wrapper with a meta route counts its launch on CUDA tensors
    and leaves the dry run's tally untouched."""
    bf = torch.bfloat16
    ops.reset_launches()
    ops.reset_dry()
    a, w = _t((8, 64), cuda).to(bf), _t((64, 64), cuda, 0.1).to(bf)
    ops.gemm(a, w)
    ops.fused_mlp(a, w, w, w, act="swiglu")
    dh = _t((8, 64), cuda)
    ops.act_bwd("swiglu", dh, dh, dh, bf)
    q = _t((1, 2, 16, 64), cuda, 0.3).to(bf)
    ops.attention(q, q, q)
    x = _t((1, 32, 2, 16), cuda)
    dt = _t((1, 32, 2), cuda).abs()
    A = -torch.ones(2, device=cuda)
    Bm = _t((1, 32, 16), cuda, 0.3)
    with torch.no_grad():
        ops.ssd(x, dt, A, Bm, Bm, chunk=16)
        ops.ssd_with_state(x, dt, A, Bm, Bm, chunk=16)
    p = _t((8, 8), cuda)
    ops.adamw_update(p, p, p.abs(), p.abs(), 1, lr=1e-3)
    got = ops.launches()
    assert (got["gemm"], got["act_bwd"], got["attention"], got["ssd"],
            got["ssd_state"], got["adamw"]) == (4, 1, 1, 1, 1, 1)
    assert sum(ops.dry()["calls"].values()) == 0


def test_one_rank_nccl_mesh_step_matches_the_plain_step(cuda, tmp_path):
    """The mesh step on a 1-rank NCCL process group (a FileStore under
    tmp_path): two steps of reduced llama3-8b at a kernel-legal width in
    bf16 with the sequence-parallel context set, against build_step_fn
    from the same seed: the same kernel launches, losses within 1e-4
    relative, the first batch's gradients (``build_mesh_grad_fn``
    against autograd of the plain loss) leaf by leaf within a relative
    L2 error of 5e-2 and their global norm within 2e-3 relative (phase
    10's bf16 limits in chip_smoke), parameters within 2 lr a step plus
    one bf16 ulp."""
    import datetime
    import torch.distributed as dist
    from repro_torch.data import SyntheticLM
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import Model
    from repro_torch.models.common import set_activation_sharding
    from repro_torch.optim import (AdamWConfig, global_norm, init_opt_state,
                                   lr_schedule)
    from repro_torch.runtime import build_step_fn
    from repro_torch.runtime.train import (build_mesh_grad_fn,
                                           init_sharded_opt_state,
                                           make_train_step)
    cfg = _card_legal("llama3-8b")
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    data = SyntheticLM(cfg, 2, 128, seed=0)
    batches = [data.batch_at(i) for i in range(2)]
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh_for(1)
        set_activation_sharding(mesh, ("data",), "model")
        params = Model(cfg).init(0, device=cuda, trainable=True)
        shd.shard_params(params, mesh, shd.named_param_specs(
            cfg, dict(params.named_parameters())))
        opt = init_sharded_opt_state(mesh, cfg, params)
        _, _, m_grads, m_norm = build_mesh_grad_fn(cfg, mesh)(params,
                                                              batches[0])
        m_grads = {n: g.full_tensor().float() for n, g in m_grads.items()}
        step = make_train_step(cfg, opt_cfg, mesh)
        ops.reset_launches()
        m_losses = []
        for b in batches:
            params, opt, loss, _ = step(params, opt, b)
            m_losses.append(float(loss))
        m_counts = ops.launches()
        got = shd.gather_params(params)
    finally:
        set_activation_sharding()
        dist.destroy_process_group()
    plain = Model(cfg).init(0, device=cuda, trainable=True)
    named = dict(plain.named_parameters())
    loss, _ = Model(cfg).loss(plain, {k: v.to(cuda)
                                      for k, v in batches[0].items()})
    p_grads = dict(zip(named, torch.autograd.grad(loss, list(
        named.values()))))
    p_norm = float(global_norm(p_grads))
    assert abs(float(m_norm) - p_norm) <= 2e-3 * p_norm
    for n, g in p_grads.items():
        want = g.float()
        err = float((m_grads[n] - want).norm()) / max(float(want.norm()),
                                                       1e-30)
        assert err <= 5e-2, (n, err)
    del m_grads, p_grads
    popt = init_opt_state(named)
    pstep = build_step_fn(cfg, opt_cfg)
    ops.reset_launches()
    p_losses = []
    for b in batches:
        plain, popt, loss, _ = pstep(plain, popt,
                                     {k: v.to(cuda) for k, v in b.items()})
        p_losses.append(float(loss))
    assert ops.launches() == m_counts and m_counts["attention_bwd"] > 0
    np.testing.assert_allclose(m_losses, p_losses, rtol=1e-4)
    lr2 = sum(float(lr_schedule(opt_cfg, i + 1)) for i in range(2))
    for n, p in plain.named_parameters():
        want = p.detach().float()
        diff = (got[n].float() - want).abs()
        assert bool((diff <= 2 * lr2 + 2.0 ** -7 * want.abs()).all()), n


# ----------------------------------------------------------------------
# Context and cache parallelism: the split merge's lse, the rectangular
# causal shapes, the mesh serving steps on one rank
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,skv,kv_len", [(4, 4000, 4000), (2, 3000, 1777)])
def test_merge_lse_of_a_split_decode(cuda, dtype, b, skv, kv_len):
    """A decode step whose plan splits the keys: with lse the merge writes
    each row's log-sum-exp beside o (``flash_attention_cuda(lse=True)``
    on a split plan), held against ``flash_lse_plain``; o keeps the bits
    of the call without lse; the merge alone with lse
    (``flash_merge_cuda``) gives the same o and lse and agrees with
    ``flash_merge_plain(lse=True)``."""
    dt = getattr(torch, dtype)
    q = _t((b, 32, 1, 128), cuda, 0.3).to(dt)
    k = _t((b, 8, skv, 128), cuda, 0.3).to(dt)
    v = _t((b, 8, skv, 128), cuda).to(dt)
    plan = tfa.flash_plan(b, 32, 8, 1, skv, kv_len, 128, dt, True)
    assert plan.splits > 1
    o, lse = tfa.flash_attention_cuda(q, k, v, kv_len=kv_len, plan=plan,
                                      lse=True)
    o_plain = tfa.flash_attention_cuda(q, k, v, kv_len=kv_len, plan=plan)
    assert torch.equal(o, o_plain)
    torch.testing.assert_close(lse, tfa.flash_lse_plain(q, k, kv_len=kv_len),
                               rtol=1e-5, atol=1e-4)
    ws, mo = tfa.flash_attention_cuda(q, k, v, kv_len=kv_len, plan=plan,
                                      partials=True)
    buf = torch.empty_like(lse)
    mo, mlse = tfa.flash_merge_cuda(ws, mo, plan.splits, buf)
    assert torch.equal(mo, o) and torch.equal(mlse, lse)
    want_o, want_lse = tfa.flash_merge_plain(ws, plan.splits, b, 32, 1, 128,
                                             dt, lse=True)
    torch.testing.assert_close(mo.float(), want_o.float(),
                               rtol=1e-2 if dtype == "bfloat16" else 1e-5,
                               atol=1e-2 if dtype == "bfloat16" else 1e-5)
    torch.testing.assert_close(mlse, want_lse, rtol=1e-6, atol=1e-5)
    with pytest.raises(ValueError, match="partials"):
        tfa.flash_attention_cuda(q, k, v, kv_len=kv_len, plan=plan,
                                 partials=True, lse=True)


@pytest.mark.parametrize("sq", [1, 2])
def test_merge_lse_blocks_of_a_sharded_cache(cuda, sq):
    """A decode step over a cache cut into 8 blocks of 1024 slots, as a
    sequence-sharded cache's ranks hold it, filled to 6.5 blocks (the
    last one empty), block z's keys scaled by 0.5 (z + 1) so that the
    blocks' lse differ by units: each block's (o, lse) by
    ``attend_block`` (split plans: the merge writes lse) merged by
    ``combine_partials`` (``merge_partials``' body) equals the plain
    attention over the whole cache within two bf16 epsilons of max|o|,
    and the logsumexp of the blocks' lse is ``flash_lse_plain``'s."""
    from repro_torch.models.attention import attend_block
    from repro_torch.models.common import combine_partials
    dt, blk, fill = torch.bfloat16, 1024, 6656
    scale = (0.5 * torch.arange(1, 9, device=cuda)).repeat_interleave(blk)
    q = _t((4, 32, sq, 128), cuda).to(dt)
    k = (_t((4, 8, 8 * blk, 128), cuda) * scale[:, None]).to(dt)
    v = _t((4, 8, 8 * blk, 128), cuda).to(dt)
    ops.reset_launches()
    parts = [attend_block(q, k[:, :, lo:lo + blk], v[:, :, lo:lo + blk],
                          lo, lo + blk, fill - sq)
             for lo in range(0, 8 * blk, blk)]
    assert ops.launches()["attention_merge"] >= 6
    lse = torch.stack([p[1] for p in parts])
    assert torch.isneginf(lse[-1]).all()
    top = lse[:7].amax(dim=(1, 2, 3))
    assert float(top.max() - top.min()) > 2, top
    got = combine_partials(torch.stack([p[0] for p in parts]), lse)
    want = tfa.flash_attention_plain(q, k, v, kv_len=fill)
    assert torch.isfinite(got).all()
    err = float((got.float() - want.float()).abs().max())
    assert err <= 2.0 ** -6 * float(want.float().abs().max()), err
    want_lse = tfa.flash_lse_plain(q, k, kv_len=fill)
    torch.testing.assert_close(torch.logsumexp(lse, 0), want_lse, rtol=0,
                               atol=1e-4 * (1 + float(want_lse.abs().max())))


@pytest.mark.parametrize("sq,skv", [(64, 64), (64, 128), (64, 256),
                                    (100, 300)])
def test_ctx_parallel_rectangular_causal_forward_and_backward(cuda, sq,
                                                               skv):
    """A context-parallel rank's shapes: its query block against the keys
    up to the end of its block, the causal diagonal bottom-right. The
    forward with lse against the plain versions, the backward's dQ, dK,
    dV by relative L2 against ``flash_attention_bwd_plain`` (bf16,
    32 / 8 heads)."""
    dt = torch.bfloat16
    q = _t((1, 32, sq, 128), cuda, 0.5).to(dt)
    k = _t((1, 8, skv, 128), cuda, 0.5).to(dt)
    v = _t((1, 8, skv, 128), cuda).to(dt)
    do = _t((1, 32, sq, 128), cuda).to(dt)
    plan = tfa.flash_plan(1, 32, 8, sq, skv, skv, 128, dt, True, lse=True)
    o, lse = tfa.flash_attention_cuda(q, k, v, plan=plan, lse=True)
    torch.testing.assert_close(o.float(), tfa.flash_attention_plain(
        q, k, v).float(), rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(lse, tfa.flash_lse_plain(q, k), rtol=1e-5,
                               atol=1e-4)
    got = tfa.flash_attention_bwd_cuda(q, k, v, o, lse, do)
    want = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do)
    for g, w in zip(got, want):
        rel = float((g.float() - w.float()).norm() / w.float().norm())
        assert rel < 5e-2, rel


def test_ctx_parallel_attention_return_lse_counts_its_launches(cuda):
    """``ops.attention(return_lse=True)`` on the card: the kernel's (o,
    lse), the merge counted where the plan splits, nothing launched for
    kv_len 0 (refused)."""
    dt = torch.bfloat16
    q = _t((4, 32, 1, 128), cuda, 0.3).to(dt)
    k = _t((4, 8, 4096, 128), cuda, 0.3).to(dt)
    v = _t((4, 8, 4096, 128), cuda).to(dt)
    ops.reset_launches()
    o, lse = ops.attention(q, k, v, kv_len=4000, return_lse=True)
    n = ops.launches()
    assert n["attention"] == 1 and n["attention_merge"] == 1
    torch.testing.assert_close(o.float(), tfa.flash_attention_plain(
        q, k, v, kv_len=4000).float(), rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(lse, tfa.flash_lse_plain(q, k, kv_len=4000),
                               rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError, match="kv_len 0"):
        ops.attention(q, k, v, kv_len=0, return_lse=True)
    assert ops.launches() == n


def test_ctx_parallel_one_rank_nccl_mesh_serving(cuda, tmp_path):
    """``build_mesh_prefill_fn`` / ``build_mesh_decode_fn`` on a 1-rank
    NCCL mesh (the cache split by the sequence over the 1-rank model
    axis): a card-legal reduced llama3-8b in bf16, prompt 100 into a
    cache of 200, steps of 1, 2 and 1 tokens, against ``Model.prefill`` /
    ``decode`` from the same weights: the same launches, logits and
    every cache leaf within one bf16 rounding."""
    import datetime
    import torch.distributed as dist
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import Model
    from repro_torch.runtime.serve import (build_mesh_decode_fn,
                                           build_mesh_prefill_fn)
    cfg = _card_legal("llama3-8b")
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 100)),
                           device=cuda)
    steps = [torch.as_tensor(rng.integers(0, cfg.vocab, (2, n)),
                             device=cuda) for n in (1, 2, 1)]
    model = Model(cfg)
    params = model.init(0, device=cuda)

    def run(prefill, decode, whole):
        ops.reset_launches()
        logits, cache, fill = prefill()
        out = [whole(logits)]
        for t in steps:
            logits, cache = decode(t, cache, fill)
            fill += t.shape[1]
            out.append(whole(logits))
        return out, [{k: whole(v) for k, v in c.items()} for c in cache], \
            ops.launches()
    with torch.no_grad():
        want = run(lambda: model.prefill(params, {"tokens": toks},
                                         cache_len=200),
                   lambda t, c, f: model.decode(params, t, c, f),
                   lambda x: x)
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh_for(1)
        shd.shard_params(params, mesh, shd.named_param_specs(
            cfg, dict(params.named_parameters())))
        pre, dec = build_mesh_prefill_fn(cfg, mesh), build_mesh_decode_fn(
            cfg, mesh)
        got = run(lambda: pre(params, {"tokens": toks}, 200),
                  lambda t, c, f: dec(params, t, c, f),
                  lambda x: x.full_tensor())
    finally:
        dist.destroy_process_group()
    assert got[2] == want[2] and got[2]["attention"] > 0
    for g, w in zip(got[0], want[0]):
        torch.testing.assert_close(g.float(), w.float(), rtol=1e-2,
                                   atol=1e-2)
    for gc_, wc in zip(got[1], want[1]):
        for k in wc:
            torch.testing.assert_close(gc_[k].float(), wc[k].float(),
                                       rtol=2 ** -7, atol=1e-3)


#: (b, hq, hkv, s, S, kv_len, db, causal) of a decode over a cache split
#: by head_dim: llama3-8b's 16-way rank block with one split and with
#: five, qwen2-vl's group of 6 over 2 queries (16 rows a block), the
#: 1-rank block of head_dim 128, whisper's cross-attention, blocks of 20
#: and 5 (4- and 1-element loads), 36 rows in three row groups
SPLIT_SHAPES = [(2, 32, 8, 1, 3000, 2999, 8, True),
                (8, 32, 8, 1, 32768, 32768, 8, True),
                (2, 12, 2, 2, 5000, 4001, 16, True),
                (1, 32, 8, 2, 4100, 4100, 128, True),
                (3, 16, 16, 1, 1500, 1500, 4, False),
                (1, 8, 2, 1, 700, 650, 4, True),
                (1, 48, 4, 3, 2100, 2100, 12, True),
                (1, 4, 1, 1, 200000, 199990, 8, True)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SPLIT_SHAPES)
def test_attn_split_kernels(cuda, dtype, shape):
    """``csrc/ntx_attn_split.cu``'s logits kernel against its plain
    version (fp32 sums of db products: rtol 1e-5, atol 1e-4) and its
    softmax-PV kernel (and split merge) on the plain logits (fp32 1e-5;
    bf16 o rounded once, 1e-2)."""
    b, hq, hkv, s, S, kv_len, db, causal = shape
    dt = getattr(torch, dtype)
    q = _t((b, hq, s, db), cuda).to(dt)
    k, v = _t((b, hkv, S, db), cuda).to(dt), _t((b, hkv, S, db), cuda).to(dt)
    got = tfa.attention_split_logits_cuda(q, k, kv_len)
    want = tfa.attention_split_logits_plain(q, k, kv_len)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    q_pos, scale = (kv_len - s if causal else 0), (db * 16) ** -0.5
    got = tfa.attention_split_softmax_pv_cuda(want * 4, v, q_pos, scale,
                                              causal)
    ref = tfa.attention_split_softmax_pv_plain(want * 4, v, q_pos, scale,
                                               causal)
    tol = 1e-5 if dtype == "float32" else 1e-2
    assert got.dtype == dt
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)


def test_attn_split_kernels_on_strided_blocks(cuda):
    """A block of head_dim cut from a whole cache (row stride 128, d
    contiguous) is read in place, the result that of a contiguous copy,
    as is a block whose base fits no load width (copied); the wrappers
    count one launch each and refuse autograd."""
    big = _t((2, 8, 3000, 128), cuda).to(torch.bfloat16)
    q = _t((2, 32, 1, 8), cuda).to(torch.bfloat16)
    k = big[..., 16:24]
    ops.reset_launches()
    lg = ops.attention_split_logits(q, k, 2500)
    torch.testing.assert_close(lg, tfa.attention_split_logits_cuda(
        q, k.contiguous(), 2500), rtol=0, atol=0)
    o = ops.attention_split_softmax_pv(lg, big[..., 40:48], 2499, 0.1)
    torch.testing.assert_close(o, tfa.attention_split_softmax_pv_cuda(
        lg, big[..., 40:48].contiguous(), 2499, 0.1), rtol=0, atol=0)
    assert ops.launches()["attention_split_logits"] == 1
    assert ops.launches()["attention_split_softmax_pv"] == 1
    torch.testing.assert_close(
        tfa.attention_split_logits_cuda(q, big[..., 2:10], 2500),
        tfa.attention_split_logits_cuda(q, big[..., 2:10].contiguous(), 2500),
        rtol=0, atol=0)
    torch.testing.assert_close(
        tfa.attention_split_softmax_pv_cuda(lg, big[..., 2:10], 2499, 0.1),
        tfa.attention_split_softmax_pv_cuda(lg, big[..., 2:10].contiguous(),
                                            2499, 0.1), rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.attention_split_logits(q.float().requires_grad_(),
                                   k.float(), 100)
