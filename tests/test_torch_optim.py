"""The port's AdamW (``repro_torch.optim`` and the fused kernel's plain
version) against the JAX reference's.

Inputs are numpy draws from a seed, handed to both packages. The
tolerance is the reference's own for the fused update
(``tests/test_kernels.py::test_adamw_fused_matches_ref``: rtol 1e-5,
atol 1e-6); bf16 params may round one bf16 ulp apart, which is at most
2**-7 of the value.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.kernels import ntx_elementwise as jew
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import apply_updates as japply
from repro.optim import global_norm as jglobal_norm
from repro.optim import init_opt_state as jinit
from repro.optim import lr_schedule as jlr

from repro_torch.kernels import ntx_elementwise as ew
from repro_torch.kernels import ops, ref
from repro_torch.optim import (AdamWConfig, apply_updates, global_norm,
                               init_opt_state, lr_schedule)

TOL = dict(rtol=1e-5, atol=1e-6)
RNG = np.random.default_rng(21)


def _f32(shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


def test_adamw_plain_matches_pallas_interpret():
    """``adamw_plain`` (the kernel's arithmetic: reciprocal bias
    corrections multiplied in) against the reference's ``adamw_pallas``
    in interpret mode, given a float lr (a jnp lr is the reference's
    captured-constant fault, ROADMAP queue 3)."""
    p, g, m = _f32((8, 2048)), _f32((8, 2048)), _f32((8, 2048), 0.1)
    v = np.abs(_f32((8, 2048), 0.01))
    want = jew.adamw_pallas(*(jnp.asarray(a) for a in (p, g, m, v)), 3,
                            lr=1e-3, interpret=True)
    got = ew.adamw_plain(*(torch.from_numpy(a) for a in (p, g, m, v)), 3,
                         lr=1e-3)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("shape", [(33, 45), (4, 5, 6)])
def test_ops_adamw_update_matches_ref(shape):
    """``ops.adamw_update`` on CPU tensors against the reference oracle
    ``ref.adamw_update`` (and the port's own copy of it)."""
    p, g = _f32(shape), _f32(shape)
    m, v = np.zeros_like(p), np.zeros_like(p)
    got = ops.adamw_update(*(torch.from_numpy(a) for a in (p, g, m, v)), 3,
                           lr=1e-3)
    want = jref.adamw_update(*(jnp.asarray(a) for a in (p, g, m, v)), 3,
                             1e-3)
    mine = ref.adamw_update(*(torch.from_numpy(a) for a in (p, g, m, v)), 3,
                            1e-3)
    for a, b, c in zip(got, want, mine):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
        np.testing.assert_allclose(c.numpy(), np.asarray(b), **TOL)


def test_lr_schedule_and_global_norm_match_reference():
    cfg = dict(lr=1e-2, warmup_steps=3, total_steps=8)
    for step in range(0, 10):
        np.testing.assert_allclose(
            float(lr_schedule(AdamWConfig(**cfg), step)),
            float(jlr(JAdamWConfig(**cfg), jnp.int32(step))), rtol=1e-6)
    grads = {"a": _f32((7, 9)), "b": _f32((5,))}
    np.testing.assert_allclose(
        float(global_norm({k: torch.from_numpy(a) for k, a in
                           grads.items()})),
        float(jglobal_norm(grads)), rtol=1e-6)


@pytest.mark.parametrize("use_fused", [False, True])
def test_apply_updates_matches_reference_over_steps(use_fused):
    """Six steps through the warmup and the cosine decay, the gradients'
    norm above the clip on some steps and below it on others, against
    the reference's ``apply_updates`` on its ``ref`` backend. bf16 and
    fp32 leaves, 2-D ones (fused when asked) and others."""
    shapes = {"w": ((33, 45), "bfloat16"), "b": ((45,), "bfloat16"),
              "s": ((4, 8, 6), "float32"), "e": ((16, 24), "float32")}
    init = {k: _f32(s, 0.5) for k, (s, _) in shapes.items()}
    jparams = {k: jnp.asarray(a, dtype=shapes[k][1]) for k, a in init.items()}
    tparams = {k: torch.from_numpy(np.array(jparams[k], np.float32))
               .to(getattr(torch, shapes[k][1])) for k in init}
    kw = dict(lr=1e-2, warmup_steps=3, total_steps=8, grad_clip=1.0)
    jcfg, tcfg = JAdamWConfig(**kw), AdamWConfig(**kw)
    jstate, tstate = jinit(jparams), init_opt_state(tparams)
    for step in range(6):
        scale = 0.5 if step % 2 else 0.02          # clipped, then not
        grads = {k: _f32(s, scale) for k, (s, _) in shapes.items()}
        jparams, jstate = japply(jcfg, jparams, {k: jnp.asarray(a) for k, a
                                                 in grads.items()}, jstate,
                                 use_fused=use_fused)
        tparams, tstate = apply_updates(tcfg, tparams, {
            k: torch.from_numpy(a) for k, a in grads.items()}, tstate,
            use_fused=use_fused)
        assert tstate["step"] == int(jstate["step"]) == step + 1
        for part in ("master", "m", "v"):
            for k in shapes:
                np.testing.assert_allclose(
                    tstate[part][k].numpy(), np.asarray(jstate[part][k]),
                    **TOL, err_msg=f"step {step + 1} {part}[{k}]")
        for k, (_, dtype) in shapes.items():
            assert tparams[k].dtype == getattr(torch, dtype)
            np.testing.assert_allclose(
                tparams[k].float().numpy(),
                np.asarray(jparams[k], np.float32),
                rtol=2.0 ** -7 if dtype == "bfloat16" else 1e-5,
                atol=1e-6)


def test_fused_update_reaches_the_ops_wrapper_for_2d_tensors_only():
    """use_fused routes exactly the 2-D tensors through ops.adamw_update
    (counted here by wrapping it: CPU tensors launch no kernel)."""
    calls = []
    real = ops.adamw_update

    def spy(p, *a, **k):
        calls.append(tuple(p.shape))
        return real(p, *a, **k)
    params = {"w": torch.zeros(3, 4), "b": torch.zeros(4),
              "s": torch.zeros(2, 3, 4)}
    grads = {k: torch.ones_like(v) for k, v in params.items()}
    ops.adamw_update = spy
    try:
        apply_updates(AdamWConfig(), params, grads, init_opt_state(params),
                      use_fused=True)
    finally:
        ops.adamw_update = real
    assert calls == [(3, 4)]
