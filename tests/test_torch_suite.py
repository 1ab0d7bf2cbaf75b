"""The paper's kernel suite (§III-B) in the port against the JAX reference,
on the same seeded numpy inputs: direct 2-D convolution, the star
stencils as per-axis passes, the diffusion stencil and the compensated
(Kahan) GEMM.

On the CPU the port runs each kernel's plain PyTorch version. Its
oracles (``repro_torch.kernels.ref``) must be bit-equal to the
reference's eager oracles, which take the same operations in the same
order. Against the reference's Pallas kernels in ``pallas_interpret``
the tolerance is the reference's own 1e-4 (``tests/test_kernels.py``):
XLA contracts the Pallas tap loops' ``acc + c * x`` into FMAs there, so
they differ from the oracles by a few ulps (ROADMAP queue 3). The CUDA
kernels are held against these plain versions on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ntx_gemm as tgemm
from repro_torch.kernels import ntx_stencil as tst
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

RNG = np.random.default_rng(8)
SHAPES_3D = (12, 14, 16)


def _np(shape, scale=1.0, seed=None):
    rng = RNG if seed is None else np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pallas(fn, *args, **kw):
    with jops.backend("pallas_interpret"):
        return np.asarray(fn(*args, **kw))


# ----------------------------------------------------------------------
# The oracles: bit-equal to the reference's
# ----------------------------------------------------------------------
@pytest.mark.parametrize("k", [3, 5, 7])
def test_ref_conv2d_bit_equal(k):
    img, ker = _np((64, 96)), _np((k, k))
    want = np.asarray(jref.conv2d(jnp.asarray(img), jnp.asarray(ker)))
    got = tref.conv2d(_t(img), _t(ker)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_ref_stencil_axis_bit_equal(axis, k):
    x, c = _np(SHAPES_3D), _np((k,))
    want = np.asarray(jref.stencil_axis(jnp.asarray(x), list(c), axis))
    got = tref.stencil_axis(_t(x), list(c), axis).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(300,), (40, 50), SHAPES_3D])
def test_ref_laplace_bit_equal(shape):
    x = _np(shape)
    want = np.asarray(jref.laplace(jnp.asarray(x)))
    np.testing.assert_array_equal(tref.laplace(_t(x)).numpy(), want)


def test_ref_diffusion_bit_equal():
    x = _np((48, 48))
    want = np.asarray(jref.diffusion(jnp.asarray(x)))
    got = tref.diffusion(_t(x)).numpy()
    assert got.shape == (44, 44)
    np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------------------
# The ops routes against the reference's Pallas kernels
# ----------------------------------------------------------------------
@pytest.mark.parametrize("k", [3, 5, 7])
def test_ops_conv2d_matches_pallas_interpret(k):
    """The reference's own sweep (shape, strip_rows 17, tolerance 1e-4);
    the port is also bit-equal to the reference's eager oracle."""
    img, ker = _np((64, 96)), _np((k, k))
    want = _pallas(jops.conv2d, jnp.asarray(img), jnp.asarray(ker),
                   strip_rows=17)
    got = tops.conv2d(_t(img), _t(ker), strip_rows=17).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(
        got, np.asarray(jref.conv2d(jnp.asarray(img), jnp.asarray(ker))))


@pytest.mark.parametrize("k", [3, 5, 7])
def test_ops_conv2d_does_not_depend_on_strip_rows(k):
    img, ker = _t(_np((64, 96))), _t(_np((k, k)))
    want = tops.conv2d(img, ker, strip_rows=256)
    for rows in (1, 17, 58):
        assert torch.equal(tops.conv2d(img, ker, strip_rows=rows), want)


@pytest.mark.parametrize("img_shape,ker_shape", [((9, 9), (7, 7)),
                                                 ((1, 50), (1, 3)),
                                                 ((50, 1), (3, 1)),
                                                 ((9, 30), (9, 2))])
def test_ops_conv2d_ragged_shapes(img_shape, ker_shape):
    img, ker = _np(img_shape), _np(ker_shape)
    want = np.asarray(jref.conv2d(jnp.asarray(img), jnp.asarray(ker)))
    got = tops.conv2d(_t(img), _t(ker), strip_rows=4).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_ops_conv2d_rejects_bad_arguments():
    img, ker = torch.zeros(8, 8), torch.zeros(3, 3)
    with pytest.raises(ValueError, match="strip_rows"):
        tops.conv2d(img, ker, strip_rows=0)
    with pytest.raises(ValueError, match="do not fit"):
        tops.conv2d(img, torch.zeros(9, 3))
    with pytest.raises(ValueError):
        tops.conv2d(img[0], ker)


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_ops_stencil_axis_matches_pallas_interpret(axis, k):
    x, c = _np(SHAPES_3D), _np((k,))
    want = _pallas(jops.stencil_axis, jnp.asarray(x), jnp.asarray(c), axis)
    got = tops.stencil_axis(_t(x), c, axis).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(
        got, np.asarray(jref.stencil_axis(jnp.asarray(x), list(c), axis)))


def test_ops_stencil_axis_bf16_and_strided_input():
    """bf16 is widened exactly to fp32 (the Pallas kernel's cast); a
    strided view gives the same values as its contiguous copy."""
    x, c = _np((10, 40)), _np((4,))
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = _pallas(jops.stencil_axis, xb, jnp.asarray(c), 1)
    got = tops.stencil_axis(_t(x).to(torch.bfloat16), c, 1)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    xt = _t(x).t()
    assert torch.equal(tops.stencil_axis(xt, c, 0),
                       tops.stencil_axis(xt.contiguous(), c, 0))


@pytest.mark.parametrize("shape,axis", [((1, 50), 1), ((50, 1), 0),
                                        ((7, 9), 1)])
def test_stencil_plain_ragged_shapes(shape, axis):
    """Rows of one, columns of one, and 7 taps on a 9-wide axis."""
    x = _np(shape)
    c = _np((7 if shape == (7, 9) else 3,))
    want = np.asarray(jref.stencil_axis(jnp.asarray(x), list(c), axis))
    got = tst.stencil1d_plain(_t(x), list(c), axis).numpy()
    np.testing.assert_array_equal(got, want)


def test_ops_stencil_axis_takes_a_tensor_of_taps():
    """As the reference's ``ops.stencil_axis`` takes an array of taps:
    a tensor of taps gives what the same floats give."""
    x, c = _t(_np(SHAPES_3D)), _np((5,))
    want = tops.stencil_axis(x, [float(v) for v in c], 1)
    assert torch.equal(tops.stencil_axis(x, _t(c), 1), want)
    assert torch.equal(tops.stencil_axis(x, _t(c).double(), 1), want)


def test_queue3_fault4_inputs():
    """ROADMAP queue 3, fault 4 (numpy default_rng(0): a (64, 96) plane,
    taps of 3, 5 and 7, then a (12, 14, 16) volume with k = 3 and 5 taps
    along each axis, drawn in that order): the port's routes are the
    oracles bit for bit; the reference's contracted Pallas kernels stay
    within its 1e-4."""
    rng = np.random.default_rng(0)
    img = rng.standard_normal((64, 96)).astype(np.float32)
    for k in (3, 5, 7):
        ker = rng.standard_normal((k, k)).astype(np.float32)
        oracle = np.asarray(jref.conv2d(jnp.asarray(img), jnp.asarray(ker)))
        pallas = _pallas(jops.conv2d, jnp.asarray(img), jnp.asarray(ker),
                         strip_rows=17)
        got = tops.conv2d(_t(img), _t(ker), strip_rows=17).numpy()
        np.testing.assert_array_equal(got, oracle)
        assert np.abs(pallas - oracle).max() <= 1e-4
    x = rng.standard_normal(SHAPES_3D).astype(np.float32)
    for k in (3, 5):
        c = rng.standard_normal(k).astype(np.float32)
        for axis in range(3):
            oracle = np.asarray(jref.stencil_axis(jnp.asarray(x), list(c),
                                                  axis))
            pallas = _pallas(jops.stencil_axis, jnp.asarray(x),
                             jnp.asarray(c), axis)
            got = tops.stencil_axis(_t(x), c, axis).numpy()
            np.testing.assert_array_equal(got, oracle)
            assert np.abs(pallas - oracle).max() <= 1e-4


def test_as_blocks_is_a_view_for_every_axis():
    x = _t(_np(SHAPES_3D))
    for axis, want in ((0, (1, 12, 224)), (1, (12, 14, 16)),
                       (2, (168, 16, 1)), (-1, (168, 16, 1))):
        v = tst.as_blocks(x, axis)
        assert tuple(v.shape) == want and v.data_ptr() == x.data_ptr()


@pytest.mark.parametrize("shape", [(300,), (40, 50), SHAPES_3D])
def test_ops_laplace_matches_pallas_interpret(shape):
    """The reference's sweep at its 1e-4. The [1, -2, 1] products are
    exact, so contraction cannot move them and the per-axis route is
    bit-equal to the reference's Pallas route; ``ref.laplace`` sums in
    another order and differs by a few ulps."""
    x = _np(shape)
    want = _pallas(jops.laplace, jnp.asarray(x))
    got = tops.laplace(_t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, tref.laplace(_t(x)).numpy(), rtol=1e-5,
                               atol=1e-5)


def test_cpu_routes_launch_nothing():
    tops.reset_launches()
    tops.conv2d(torch.ones(8, 8), torch.ones(3, 3))
    tops.laplace(torch.ones(6, 6))
    tops.laplace(torch.ones(5, 6, 7))
    tops.laplace(torch.ones(4, 4, 4, 4))
    tops.laplace(torch.ones(2, 6))
    tops.stencil_axis(torch.ones(6, 6), (1.0, 2.0), 1)
    tops.gemm(torch.ones(4, 4), torch.ones(4, 4), compensated=True)
    assert all(v == 0 for v in tops.launches().values())


# ----------------------------------------------------------------------
# Compensated (Kahan) GEMM
# ----------------------------------------------------------------------
def _gemm_inputs(m, k, n, scale):
    rng = np.random.default_rng(42)
    return (_np((m, k), scale, seed=rng.integers(1 << 30)),
            _np((k, n), scale, seed=rng.integers(1 << 30)))


def test_gemm_compensated_precision():
    """The reference's property (``test_gemm_compensated_precision``) at
    its inputs, against the port's own uncompensated ``ops.gemm``."""
    a, b = _gemm_inputs(128, 2048, 128, 100.0)
    ref64 = a.astype(np.float64) @ b.astype(np.float64)
    plain = tops.gemm(_t(a), _t(b)).double().numpy()
    comp = tops.gemm(_t(a), _t(b), compensated=True).double().numpy()
    assert np.abs(comp - ref64).max() <= np.abs(plain - ref64).max() * 1.01


def test_gemm_compensated_no_less_accurate_than_reference():
    """At the same inputs the port compensates over 128-deep slabs, the
    reference over its 512-deep k blocks: the port's max error against
    fp64 is at most the reference's compensated one (x 1.01)."""
    a, b = _gemm_inputs(128, 2048, 128, 100.0)
    ref64 = a.astype(np.float64) @ b.astype(np.float64)
    want = _pallas(jops.gemm, jnp.asarray(a), jnp.asarray(b),
                   compensated=True).astype(np.float64)
    got = tops.gemm(_t(a), _t(b), compensated=True).double().numpy()
    assert np.abs(got - ref64).max() <= np.abs(want - ref64).max() * 1.01


@pytest.mark.parametrize("epilogue", [False, True])
@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 384, 128),
                                   (100, 70, 50), (128, 2048, 128)])
def test_gemm_compensated_matches_reference(m, k, n, epilogue):
    """Against the reference's compensated Pallas GEMM at its fp32 GEMM
    tolerance (rtol 1e-3 / atol 1e-2, ``test_gemm_sweep``), with and
    without a bias + relu epilogue."""
    a, b = _gemm_inputs(m, k, n, 1.0)
    bias = _np((n,), seed=m + k + n)
    ep_j = [("bias", jnp.asarray(bias)), "relu"] if epilogue else None
    ep_t = [("bias", _t(bias)), "relu"] if epilogue else None
    want = _pallas(jops.gemm, jnp.asarray(a), jnp.asarray(b),
                   compensated=True, epilogue=ep_j)
    got = tops.gemm(_t(a), _t(b), compensated=True, epilogue=ep_t).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-2)


def _exact_slab_inputs(m, k, n, seed):
    """Integers in [-8, 8], the first KAHAN_SLAB columns of ``a`` times
    2**16. Every slab's product is then exact in fp32 in any summation
    order (the first slab's partial sums are multiples of 2**16 below
    2**29, the others' integers below 2**13), while adding a later slab
    to the first one's sum, near 2**24, rounds its low bits away. The
    compensation carries those bits exactly, so the compensated result
    is the fp64 product rounded once to fp32; an uncompensated sum, or
    slabs added without their compensation term, is not."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-8, 9, (m, k)).astype(np.float32)
    a[:, :tgemm.KAHAN_SLAB] *= 2.0 ** 16
    return a, rng.integers(-8, 9, (k, n)).astype(np.float32)


@pytest.mark.parametrize("epilogue", [False, True])
@pytest.mark.parametrize("m,k,n", [(64, 4096, 48), (33, 1000, 17)])
def test_gemm_compensated_rounds_exact_slabs_once(m, k, n, epilogue):
    """Where compensation matters the plain compensated GEMM is strictly
    more accurate than the plain GEMM: on exact slabs it is the fp64
    product rounded once (with an exact scale + relu epilogue after the
    compensation), and the uncompensated product is not."""
    a, b = _exact_slab_inputs(m, k, n, seed=m + k + n)
    ref64 = a.astype(np.float64) @ b.astype(np.float64)
    ep = [("scale", 0.5), "relu"] if epilogue else None
    want = np.maximum(ref64 * 0.5, 0.0) if epilogue else ref64
    got = tops.gemm(_t(a), _t(b), compensated=True, epilogue=ep).numpy()
    np.testing.assert_array_equal(got, want.astype(np.float32))
    np.testing.assert_array_equal(
        tgemm.gemm_kahan_plain(_t(a), _t(b), epilogue=tops._norm_epilogue(
            ep)).numpy(), got)
    plain = tops.gemm(_t(a), _t(b), epilogue=ep).numpy()
    assert (np.abs(plain - want).max()
            > np.abs(got - want).max() + 1.0)


def test_gemm_compensated_one_slab_is_the_plain_product():
    """With k <= KAHAN_SLAB there is one slab: acc = x, comp = 0, so the
    compensated result is the uncompensated one, epilogue and all."""
    a, b = _t(_np((33, tgemm.KAHAN_SLAB))), _t(_np((tgemm.KAHAN_SLAB, 17)))
    ep = [("scale", 0.5), "gelu"]
    assert torch.equal(tops.gemm(a, b, compensated=True, epilogue=ep,
                                 out_dtype=torch.bfloat16),
                       tops.gemm(a, b, epilogue=ep,
                                 out_dtype=torch.bfloat16))


def test_kahan_add_exact_branch():
    """Neumaier keeps the low part whichever operand is larger: 1e8 + 1
    - 1e8 loses the 1 in fp32 and the compensation carries it."""
    acc = comp = torch.zeros(2)
    for v in ([1e8, 1.0], [1.0, 1e8], [-1e8, -1e8]):
        acc, comp = tgemm.kahan_add(acc, comp, torch.tensor(v))
    assert torch.equal(acc + comp, torch.tensor([1.0, 1.0]))
