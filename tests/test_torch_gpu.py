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
