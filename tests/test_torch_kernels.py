"""The port's kernel wrappers (``repro_torch.kernels.ops``) against the JAX
reference's, on the same seeded numpy inputs.

On the CPU the port runs each kernel's plain PyTorch version; the JAX
side runs its Pallas kernels in interpret mode (``pallas_interpret``) or
its plain oracles (``ref``). Tolerances are the reference's own
(``tests/test_kernels.py``); the streaming commands, MIN/MAX and the arg
reductions must be bit-equal. The CUDA kernels themselves are held
against these plain versions on the card by ``tests/test_torch_gpu.py``
and ``chip_smoke.py``.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ntx_gemm as tgemm
from repro_torch.kernels import ntx_reduce as tred

RNG = np.random.default_rng(42)
STREAM_OPS = ["axpy", "add", "sub", "mul", "mask", "relu", "thresh", "copy",
              "set"]
TWO_READ = {"axpy", "add", "sub", "mul", "mask"}


def _np(shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


def _both(a, dtype="float32"):
    """The same values as a jax array and a torch CPU tensor."""
    j = jnp.asarray(a).astype(dtype)
    t = torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype))
    return j, t


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ----------------------------------------------------------------------
# GEMM and its epilogues
# ----------------------------------------------------------------------
@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 384, 128),
                                   (100, 70, 50), (8, 16, 24)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemm_sweep(m, k, n, dtype):
    ja, ta = _both(_np((m, k)), dtype)
    jb, tb = _both(_np((k, n)), dtype)
    with jops.backend("pallas_interpret"):
        want = jops.gemm(ja, jb)
    got = tops.gemm(ta, tb)
    tol = 1e-3 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol * 10)


EPILOGUES = [("bias",), ("residual",), ("mul",), ("sub",), ("mask",),
             ("scale", 0.7), ("relu",), ("thresh", 0.2), ("silu",),
             ("gelu",)]


@pytest.mark.parametrize("stage", EPILOGUES, ids=[s[0] for s in EPILOGUES])
def test_gemm_epilogue_stage(stage):
    m, k, n = 24, 40, 56
    a, b = _np((m, k)), _np((k, n), scale=0.3)
    kind = stage[0]
    if kind in tgemm.EPILOGUE_ARRAY_KINDS:
        op = _np((n,)) if kind == "bias" else _np((m, n))
        if kind == "mask":
            op = (op > 0).astype(np.float32)
        jst, tst = (kind, jnp.asarray(op)), (kind, torch.from_numpy(op))
    else:
        jst = tst = stage
    with jops.backend("pallas_interpret"):
        want = jops.gemm(jnp.asarray(a), jnp.asarray(b), epilogue=[jst])
    got = tops.gemm(torch.from_numpy(a), torch.from_numpy(b), epilogue=[tst])
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-3, atol=1e-2)


def test_gemm_epilogue_chain_bf16_out():
    """Several stages in order, one rounding to bf16 at the store."""
    m, k, n = 40, 64, 72
    a, b = _np((m, k)), _np((k, n), scale=0.2)
    bias, res = _np((n,)), _np((m, n))
    jep = [("bias", jnp.asarray(bias)), ("gelu",), ("scale", 1.5),
           ("residual", jnp.asarray(res)), ("thresh", -0.1)]
    tep = [("bias", torch.from_numpy(bias)), ("gelu",), ("scale", 1.5),
           ("residual", torch.from_numpy(res)), ("thresh", -0.1)]
    with jops.backend("pallas_interpret"):
        want = jops.gemm(jnp.asarray(a), jnp.asarray(b),
                         out_dtype=jnp.bfloat16, epilogue=jep)
    got = tops.gemm(torch.from_numpy(a), torch.from_numpy(b),
                    out_dtype=torch.bfloat16, epilogue=tep)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=5e-2, atol=5e-2)


def test_gelu_is_the_tanh_form():
    """``gelu`` is jax.nn.gelu's default tanh approximation, not the exact
    erf form torch.nn.functional.gelu defaults to."""
    x = np.linspace(-6, 6, 4001, dtype=np.float32)
    got = tgemm.apply_epilogue(torch.from_numpy(x), (("gelu", 0.0),), [])
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - want).max() > 1e-4


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_fused_mlp(act):
    d, ff = 48, 80
    x, res = _np((2, 5, d)), _np((2, 5, d))
    w1, w2, w3 = _np((d, ff), 0.2), _np((ff, d), 0.2), _np((d, ff), 0.2)
    with jops.backend("pallas_interpret"):
        want = jops.fused_mlp(jnp.asarray(x), jnp.asarray(w1),
                              jnp.asarray(w2), jnp.asarray(w3), act=act,
                              residual=jnp.asarray(res))
    t = torch.from_numpy
    got = tops.fused_mlp(t(x), t(w1), t(w2), t(w3), act=act, residual=t(res))
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-3, atol=1e-3)


# ----------------------------------------------------------------------
# Attention
# ----------------------------------------------------------------------
@pytest.mark.parametrize("hq,hkv,sq,skv", [(4, 2, 128, 128), (8, 8, 64, 128),
                                           (4, 1, 32, 96)])
def test_flash_attention_sweep(hq, hkv, sq, skv):
    q, k, v = _np((2, hq, sq, 64), 0.2), _np((2, hkv, skv, 64), 0.2), \
        _np((2, hkv, skv, 64))
    with jops.backend("pallas_interpret"):
        want = jops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=True)
    t = torch.from_numpy
    got = tops.attention(t(q), t(k), t(v), causal=True)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-3, atol=2e-3)


def test_flash_decode_with_partial_cache():
    q, k, v = _np((2, 4, 8, 64), 0.2), _np((2, 2, 512, 64), 0.2), \
        _np((2, 2, 512, 64))
    with jops.backend("pallas_interpret"):
        want = jops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=True, kv_len=300)
    t = torch.from_numpy
    got = tops.attention(t(q), t(k), t(v), causal=True, kv_len=300)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-3, atol=2e-3)


def test_single_token_decode_gqa_bf16():
    """sq = 1 against a partly filled cache, bf16 in and out, as the
    serving decode step calls it."""
    q, k, v = _np((3, 8, 1, 64), 0.2), _np((3, 2, 40, 64), 0.2), \
        _np((3, 2, 40, 64))
    jq, tq = _both(q, "bfloat16")
    jk, tk = _both(k, "bfloat16")
    jv, tv = _both(v, "bfloat16")
    with jops.backend("pallas_interpret"):
        want = jops.attention(jq, jk, jv, causal=True, kv_len=23)
    got = tops.attention(tq, tk, tv, causal=True, kv_len=23)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-2, atol=2e-2)


# ----------------------------------------------------------------------
# Streaming commands: bit-equal
# ----------------------------------------------------------------------
SHAPES = [(3, 700), (1, 1000), (5, 128)]


@pytest.mark.parametrize("op", STREAM_OPS)
@pytest.mark.parametrize("shape", SHAPES)
def test_elementwise_bit_equal(op, shape):
    """Every command bit-equal to the reference's oracle (``ref``), whose
    AXPY/MUL carry the product-rounding pin the CUDA kernel pins too."""
    x, y = _np(shape), _np(shape)
    y[..., ::5] = 0.0                                  # MASK sees zeros
    y2 = y if op in TWO_READ else None
    with jops.backend("ref"):
        want = jops.elementwise(op, jnp.asarray(x),
                                None if y2 is None else jnp.asarray(y2),
                                imm=0.3)
    got = tops.elementwise(op, torch.from_numpy(x),
                           None if y2 is None else torch.from_numpy(y2),
                           imm=0.3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if op == "axpy":
        np.testing.assert_array_equal(
            tops.axpy(0.3, torch.from_numpy(x), torch.from_numpy(y)).numpy(),
            np.asarray(want))


@pytest.mark.parametrize("op", STREAM_OPS)
def test_elementwise_against_pallas_interpret(op):
    """Against the Pallas kernel itself: bit-equal, except that in
    interpret mode XLA contracts the Pallas AXPY (``imm * x + y``, no
    rounding pin) into an FMA. Against the pinned product-then-sum that
    moves the result by at most half an ulp of the product plus one
    rounding of the sum (ROADMAP queue 3)."""
    x, y = _np((3, 700)), _np((3, 700))
    y2 = y if op in TWO_READ else None
    with jops.backend("pallas_interpret"):
        want = np.asarray(jops.elementwise(
            op, jnp.asarray(x), None if y2 is None else jnp.asarray(y2),
            imm=0.3))
    got = tops.elementwise(op, torch.from_numpy(x),
                           None if y2 is None else torch.from_numpy(y2),
                           imm=0.3).numpy()
    if op == "axpy":
        product = np.abs(np.float32(0.3) * x)
        bound = 0.5 * np.spacing(product) + np.spacing(np.abs(want))
        assert (np.abs(got - want) <= bound).all()
    else:
        np.testing.assert_array_equal(got, want)


CHAIN = [("thresh", 0.1), ("axpy", 1.25), ("mul", 0.0), ("relu", 0.0),
         ("mask", 0.0), ("sub", 0.0), ("add", 0.0), ("copy", 0.0),
         ("axpy", -0.7), ("set", 2.5), ("axpy", 0.5)]


def test_elementwise_chain_bit_equal():
    """An 11-stage chain (longer than one CUDA launch takes) on ragged n."""
    x = _np((2, 333))
    n_ys = sum(1 for op, _ in CHAIN if op in TWO_READ)
    ys = [_np((2, 333)) for _ in range(n_ys)]
    ys[2][:, ::3] = 0.0
    with jops.backend("ref"):
        want = jops.elementwise_chain(CHAIN, jnp.asarray(x),
                                      [jnp.asarray(a) for a in ys])
    got = tops.elementwise_chain(CHAIN, torch.from_numpy(x),
                                 [torch.from_numpy(a) for a in ys])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------------------------
# Reductions: min/max/arg bit-equal, sums within 1e-5
# ----------------------------------------------------------------------
def _tied(shape):
    """Rows with planted first-wins ties for both the max and the min."""
    x = _np(shape)
    rows, n = shape
    for r in range(rows):
        hi, lo = x[r].max() + 1, x[r].min() - 1
        x[r, [r % n, n - 1 - r % 3]] = hi
        x[r, [(r + 1) % n, n - 2 - r % 3]] = lo
    return x


@pytest.mark.parametrize("op", ["sum", "min", "max", "argmin", "argmax"])
@pytest.mark.parametrize("shape", [(8, 1000), (1, 513), (16, 2048)])
def test_reduce(op, shape):
    x = _tied(shape)
    with jops.backend("pallas_interpret"):
        want = np.asarray(jops.reduce(op, jnp.asarray(x)))
    got = tops.reduce(op, torch.from_numpy(x)).numpy()
    if op == "sum":
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(x).sum(-1).max())
    else:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("red", ["sum", "min", "max", "argmin", "argmax"])
def test_chain_reduce(red):
    """Chain value bit-equal, tail as in test_reduce; ragged n."""
    stages = [("relu", 0.0), ("mul", 0.0), ("thresh", 0.05)]
    x, y = _tied((4, 700)), _np((4, 700))
    with jops.backend("pallas_interpret"):
        jout, jred = jops.chain_reduce(stages, red, jnp.asarray(x),
                                       [jnp.asarray(y)])
    tout, tred_ = tops.chain_reduce(stages, red, torch.from_numpy(x),
                                    [torch.from_numpy(y)])
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    if red == "sum":
        np.testing.assert_allclose(tred_.numpy(), np.asarray(jred),
                                   rtol=1e-5, atol=1e-5)
    else:
        assert tred_.numpy().dtype == np.asarray(jred).dtype
        np.testing.assert_array_equal(tred_.numpy(), np.asarray(jred))


def test_chain_reduce_n_valid_masks_padding():
    x = _np((2, 64))
    x[:, 50:] = 100.0                      # padding that must not win
    _, red = tred.chain_reduce_plain([("copy", 0.0)], "argmax",
                                     torch.from_numpy(x), n_valid=50)
    np.testing.assert_array_equal(red.numpy(),
                                  np.argmax(x[:, :50], -1).astype(np.float32))


# ----------------------------------------------------------------------
# Device decides; nothing falls back
# ----------------------------------------------------------------------
def test_mixed_devices_raise():
    x = torch.zeros(4)
    with pytest.raises(ValueError):
        tops._on_card(x, torch.zeros(4, device="meta"))
