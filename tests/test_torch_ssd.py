"""The port's SSD scan (``repro_torch.kernels``: ``ops.ssd``, its plain
version and the ``ref`` oracles) against the JAX reference's.

Inputs are numpy draws from a seed, handed to both packages. The
tolerance is the reference's own for SSD (``tests/test_kernels.py::
test_ssd_sweep``, 1e-3) unless a test states another.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch.kernels import ops, ref
from repro_torch.kernels.ssd_scan import ssd_scan_plain

TOL = dict(rtol=1e-3, atol=1e-3)


def _inputs(seed, b, l, h, dh, n, strong=False):
    """x, dt, A, B, C as numpy fp32. ``strong``: the model's own
    distributions (dt = softplus(N(0, 1)), A = -exp(U(log 1/4, log 4)),
    B and C 0.3 N(0, 1)); otherwise ``test_ssd_sweep``'s."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, dh))
    if strong:
        dt = np.log1p(np.exp(rng.standard_normal((b, l, h))))
        A = -np.exp(rng.uniform(np.log(0.25), np.log(4.0), h))
    else:
        dt = rng.uniform(0.01, 0.2, (b, l, h))
        A = -rng.uniform(0.5, 2.0, h)
    B = 0.3 * rng.standard_normal((b, l, n))
    C = 0.3 * rng.standard_normal((b, l, n))
    return [a.astype(np.float32) for a in (x, dt, A, B, C)]


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("l,chunk", [(128, 32), (64, 64), (96, 16)])
def test_ssd_sweep_matches_reference(l, chunk):
    arrs = _inputs(42, 2, l, 3, 16, 32)
    got = ops.ssd(*_t(arrs), chunk=chunk).numpy()
    with jops.backend("pallas_interpret"):
        pallas = np.asarray(jops.ssd(*_j(arrs), chunk=chunk))
    seq = np.asarray(jref.ssd_scan(*_j(arrs)))
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, seq, **TOL)
    np.testing.assert_allclose(ref.ssd_scan(*_t(arrs)).numpy(), seq, **TOL)
    np.testing.assert_allclose(
        ref.ssd_scan_chunked(*_t(arrs), chunk=chunk).numpy(),
        np.asarray(jref.ssd_scan_chunked(*_j(arrs), chunk=chunk)), **TOL)


@pytest.mark.parametrize("l", [64, 60])
def test_chunked_with_state_matches_reference(l):
    """y and the final state; a length that is not a multiple of the
    chunk takes the sequential scan in both packages."""
    arrs = _inputs(7, 1, l, 2, 8, 16)
    y, s = ref.ssd_scan_chunked_with_state(*_t(arrs), chunk=16)
    jy, js = jref.ssd_scan_chunked_with_state(*_j(arrs), chunk=16)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)


def test_ragged_length_plain_matches_sequential():
    """The plain version (and so the kernel's contract) takes any length:
    a shorter last chunk, as the CUDA kernel masks it."""
    arrs = _inputs(3, 2, 100, 3, 16, 32)
    seq = np.asarray(jref.ssd_scan(*_j(arrs)))
    for chunk in (16, 64, 128):
        np.testing.assert_allclose(
            ssd_scan_plain(*_t(arrs), chunk=chunk).numpy(), seq, **TOL)


def _strong_case():
    return _inputs(0, 1, 256, 4, 16, 32, strong=True)


def test_strong_decay_chunk128_is_finite_where_reference_chunked_is_nan():
    """At the real chunk length the reference's jnp chunked form takes
    exp of positive exponents above the diagonal and returns NaN
    (ROADMAP queue 3); the port masks first, stays finite and equals the
    sequential oracle and the Pallas kernel."""
    arrs = _strong_case()
    chunked = np.asarray(jref.ssd_scan_chunked(*_j(arrs), chunk=128))
    assert np.isnan(chunked).any()
    seq = np.asarray(jref.ssd_scan(*_j(arrs)))
    with jops.backend("pallas_interpret"):
        pallas = np.asarray(jops.ssd(*_j(arrs), chunk=128))
    assert np.isfinite(seq).all() and np.isfinite(pallas).all()
    for got in (ops.ssd(*_t(arrs), chunk=128),
                ssd_scan_plain(*_t(arrs), chunk=128),
                ref.ssd_scan_chunked(*_t(arrs), chunk=128)):
        got = got.numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, seq, **TOL)
        np.testing.assert_allclose(got, pallas, **TOL)


@pytest.mark.parametrize("strong,chunk", [(False, 16), (True, 128),
                                          (False, 40)])
def test_backward_matches_jax_grad_of_sequential(strong, chunk):
    """The port's backward (autograd of the masked chunked form, a ragged
    tail padded) against ``jax.grad`` of the sequential oracle, for all
    five inputs. Gradients are compared relative to their largest entry
    (1e-3): the two sum the same terms in other orders."""
    arrs = _strong_case() if strong else _inputs(5, 2, 80, 3, 16, 32)
    w = np.random.default_rng(9).standard_normal(
        arrs[0].shape).astype(np.float32)

    def jloss(*a):
        return jnp.sum(jref.ssd_scan(*a) * w)
    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*_j(arrs))
    xs = [t.requires_grad_() for t in _t(arrs)]
    got = torch.autograd.grad((ops.ssd(*xs, chunk=chunk)
                               * torch.from_numpy(w)).sum(), xs)
    for g, jg in zip(got, want):
        jg = np.asarray(jg)
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-3,
                                   atol=1e-3 * np.abs(jg).max())
