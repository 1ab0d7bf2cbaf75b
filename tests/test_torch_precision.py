"""The port's wide-accumulator (PCS) precision module against the
reference's (``repro.core.precision``), on the same seeded numpy inputs.

Every function is bit-equal to the reference's: the host accumulators
are the same numpy code, and the compensated sum takes the same Neumaier
steps in the same order (a PyTorch loop in place of ``lax.scan``).
"""
import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.core import precision as jp
from repro_torch.core import precision as tp


def _np(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kahan_sum_bit_equal_1d(seed):
    x = _np(2048, seed, 100.0)
    want = np.asarray(jp.kahan_sum(jnp.asarray(x)))
    got = tp.kahan_sum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("axis", [0, 1, 2, -1])
def test_kahan_sum_bit_equal_along_each_axis(axis):
    x = _np((7, 300, 5), 3, 10.0)
    want = np.asarray(jp.kahan_sum(jnp.asarray(x), axis))
    got = tp.kahan_sum(torch.from_numpy(x), axis).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [4, 5])
def test_kahan_add_and_dot_bit_equal(seed):
    a, b, c = _np(64, seed), _np(64, seed + 10), _np(64, seed + 20)
    ja, jc = jp.kahan_add(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c))
    ta, tc = tp.kahan_add(torch.from_numpy(a), torch.from_numpy(b),
                          torch.from_numpy(c))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    want = np.asarray(jp.kahan_dot(jnp.asarray(a), jnp.asarray(b)))
    got = tp.kahan_dot(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 6, 7])
@pytest.mark.parametrize("fn", ["dot_pcs", "dot_fp32_chained", "dot_f64"])
def test_host_dots_bit_equal(fn, seed):
    a, b = _np(576, seed), _np(576, seed + 100, 0.04)
    want = getattr(jp, fn)(a, b)
    got = getattr(tp, fn)(a, b)
    assert type(got) is type(want) and got == want


def test_pcs_catastrophic_cancellation():
    """The deferred-rounding accumulator survives cancellation that kills
    a chained fp32 accumulator; so does the compensated sum."""
    a = np.array([1e8, 1.0, -1e8, 1.0], np.float32)
    b = np.ones(4, np.float32)
    assert float(tp.dot_pcs(a, b)) == 2.0
    assert float(tp.dot_fp32_chained(a, b)) != 2.0
    assert float(tp.kahan_dot(torch.from_numpy(a), torch.from_numpy(b))) \
        == 2.0


@pytest.mark.parametrize("seed,n_outputs,reduction", [(0, 32, 576),
                                                      (3, 8, 100)])
def test_rmse_study_equals_reference(seed, n_outputs, reduction):
    """The study's dict, value for value, and the paper's direction: PCS
    and Kahan both below the chained fp32 FPU."""
    want = jp.conv_layer_rmse_study(seed, n_outputs, reduction)
    got = tp.conv_layer_rmse_study(seed, n_outputs, reduction, device="cpu")
    assert got == want
    assert got["rmse_pcs"] < got["rmse_fp32_chained"]
    assert got["rmse_kahan"] < got["rmse_fp32_chained"]
    assert all(math.isfinite(v) for v in got.values())
