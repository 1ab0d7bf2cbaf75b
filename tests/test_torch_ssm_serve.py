"""The port's Mamba-2 serving path against the JAX reference, on the CPU:
prefill that hands the SSD scan's final state to decode, the recurrent
single-token step, and ``Server.generate`` on reduced mamba2-1.3b.

Weights come from the reference (``ssm_params`` or ``Model(cfg).init(0)``)
through ``convert``; inputs from numpy seeds. fp32 compute and parameters.
Tolerances, as ``tests/test_torch_serve.py`` holds the dense serving path:
fp32 outputs, logits and the fp32 state at rtol = atol = 1e-4, the bf16
conv tails of a model's cache at 1e-2 (one bf16 rounding of fp32 values
that agree to 1e-6), the decode-vs-prefill continuation at the
reference's own 2e-2 (``tests/test_models.py``).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import configs as jconfigs
from repro.kernels import ref as jref
from repro.models import Model as JModel
from repro.models import ssm as jssm
from repro.runtime import ServeConfig as JServeConfig
from repro.runtime import Server as JServer

from repro_torch import configs as tconfigs
from repro_torch.kernels import ops, ref
from repro_torch.models import Model
from repro_torch.models import convert
from repro_torch.models import ssm as tssm
from repro_torch.models.transformer import layer_schedule
from repro_torch.runtime import ServeConfig, Server

ARCH = "mamba2-1.3b"
B, NEW = 2, 6
TAILS = ("cx", "cb", "cc")


def _cfgs(dtype="float32", **kw):
    over = dict(compute_dtype=dtype, param_dtype=dtype, **kw)
    return (jconfigs.get_reduced(ARCH).scaled(**over),
            tconfigs.get_reduced(ARCH).scaled(**over))


def _np(a):
    return np.array(a, np.float32)


@pytest.fixture(scope="module")
def fp32():
    jc, tc = _cfgs()
    jparams = JModel(jc).init(0)
    tparams = convert.from_reference(jax.tree.map(_np, jparams), tc,
                                     device="cpu")
    return jc, tc, jparams, tparams


@pytest.fixture(scope="module")
def mixer():
    """One Mamba-2 mixer's reference parameters and the port's module."""
    jc, tc = _cfgs()
    jp = jssm.ssm_params(jc, jax.random.PRNGKey(1))
    tp = tssm.SSM(**{k: torch.from_numpy(_np(v)) for k, v in jp.items()})
    return jc, tc, jp, tp


def _close(got, want, tol=1e-4, msg=""):
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=tol,
                               atol=tol, err_msg=msg)


def _prompts(cfg, plen, n=B, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, plen) for _ in range(n)]


def test_config_matches_reference():
    assert tconfigs.get(ARCH).__dict__ == jconfigs.get(ARCH).__dict__
    assert tconfigs.get_reduced(ARCH).__dict__ == jconfigs.get_reduced(
        ARCH).__dict__


# ----------------------------------------------------------------------
# the scan with its final state
# ----------------------------------------------------------------------
def _ssd_inputs(b, l, h, dh, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, dh)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    A = -np.exp(rng.uniform(np.log(0.25), np.log(4.0), h)).astype(np.float32)
    B_ = (0.3 * rng.standard_normal((b, l, n))).astype(np.float32)
    C_ = (0.3 * rng.standard_normal((b, l, n))).astype(np.float32)
    return [torch.from_numpy(a) for a in (x, dt, A, B_, C_)]


@pytest.mark.parametrize("l,chunk", [(64, 16), (60, 16), (17, 16), (1, 16),
                                     (0, 16), (40, 128)])
def test_ssd_with_state_matches_the_sequential_scan(l, chunk):
    """``ops.ssd_with_state`` on CPU tensors (the plain version: the masked
    chunked form with the ragged tail padded by dt = 0, x = 0) against the
    step-by-step recurrence: y and the final state at 1e-4; its y is
    bit-equal to ``ops.ssd``'s, as the kernel's is on the card."""
    ins = _ssd_inputs(2, l, 3, 8, 16)
    y, s = ops.ssd_with_state(*ins, chunk=chunk)
    y_seq, s_seq = ref._ssd_sequential(*ins)
    assert y.shape == ins[0].shape and s.shape == (2, 3, 16, 8)
    assert s.dtype == torch.float32
    _close(y, y_seq.numpy())
    _close(s, s_seq.numpy())
    assert torch.equal(y, ops.ssd(*ins, chunk=chunk))


def test_ssd_with_state_matches_the_reference_scan():
    """Against the reference's own ``ssd_scan_chunked_with_state`` at a
    whole number of chunks (its chunked form) and a ragged length (its
    sequential fallback), and in bf16 (y rounded once: 1e-2)."""
    for l in (48, 45):
        ins = _ssd_inputs(2, l, 4, 8, 16, seed=l)
        jy, js = jref.ssd_scan_chunked_with_state(
            *(jnp.asarray(t.numpy()) for t in ins), chunk=16)
        y, s = ops.ssd_with_state(*ins, chunk=16)
        _close(y, jy, msg=f"y l {l}")
        _close(s, js, msg=f"state l {l}")
    x, dt, A, B_, C_ = _ssd_inputs(1, 45, 4, 8, 16, seed=7)
    bf = [t.to(torch.bfloat16) for t in (x, B_, C_)]
    y, s = ops.ssd_with_state(bf[0], dt, A, bf[1], bf[2], chunk=16)
    y_seq, s_seq = ref._ssd_sequential(bf[0], dt, A, bf[1], bf[2])
    assert y.dtype == torch.bfloat16
    _close(y, y_seq.numpy(), tol=1e-2)
    _close(s, s_seq.numpy())


def test_ssd_with_state_on_the_cpu_differentiates_as_plain_pytorch():
    """The CPU route is plain PyTorch (the card's route refuses a gradient,
    ``tests/test_torch_gpu.py``): the state's gradient reaches x."""
    ins = _ssd_inputs(1, 20, 2, 4, 8)
    x = ins[0].requires_grad_()
    _, s = ops.ssd_with_state(x, *ins[1:], chunk=16)
    (g,) = torch.autograd.grad(s.sum(), x)
    assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0


# ----------------------------------------------------------------------
# one mixer: prefill with state, then decode
# ----------------------------------------------------------------------
@pytest.mark.parametrize("l", [64, 60, 2])
def test_ssm_forward_return_state(mixer, l):
    """y and the four cache leaves (the state; x, B and C's last d_conv - 1
    pre-conv rows, zeros before the first) at l 64 (whole chunks of 16),
    60 (the reference's sequential fallback) and 2 (fewer rows than the
    conv tail)."""
    jc, tc, jp, tp = mixer
    u = np.random.default_rng(l).standard_normal(
        (2, l, jc.d_model)).astype(np.float32)
    jy, jcache = jssm.ssm_forward(jc, jp, jnp.asarray(u), return_state=True)
    with torch.inference_mode():
        ty, tcache = tssm.ssm_forward(tc, tp, torch.from_numpy(u),
                                      return_state=True)
        plain = tssm.ssm_forward(tc, tp, torch.from_numpy(u))
    _close(ty, jy, msg="y")
    assert torch.equal(ty, plain)
    assert set(tcache) == {"s", *TAILS}
    assert tcache["s"].dtype == torch.float32
    assert tcache["cx"].shape == (2, tc.d_conv - 1, tc.d_inner)
    for k in tcache:
        _close(tcache[k], jcache[k], msg=k)


@pytest.mark.parametrize("tail_dtype,tol", [("float32", 1e-4),
                                            ("bfloat16", 1e-2)])
def test_ssm_decode_four_steps(mixer, tail_dtype, tol):
    """Four recurrent steps from the reference's prefilled cache: each
    step's output and the cache the port updates in place (the state in
    fp32, the tails cast to the cache's dtype)."""
    jc, tc, jp, tp = mixer
    rng = np.random.default_rng(11)
    u = rng.standard_normal((2, 20, jc.d_model)).astype(np.float32)
    _, jcache = jssm.ssm_forward(jc, jp, jnp.asarray(u), return_state=True)
    jcache = dict(jcache, **{k: jcache[k].astype(tail_dtype) for k in TAILS})
    tcache = {k: torch.from_numpy(_np(v)).to(getattr(torch, tail_dtype)
                                             if k in TAILS else torch.float32)
              for k, v in jcache.items()}
    leaves = {k: v for k, v in tcache.items()}
    for step in range(4):
        u1 = rng.standard_normal((2, 1, jc.d_model)).astype(np.float32)
        jo, jcache = jssm.ssm_decode(jc, jp, jnp.asarray(u1), jcache)
        with torch.inference_mode():
            to, tcache = tssm.ssm_decode(tc, tp, torch.from_numpy(u1),
                                         tcache)
        assert to.shape == (2, 1, tc.d_model)
        _close(to, jo, tol, msg=f"step {step} out")
        for k in tcache:
            assert tcache[k] is leaves[k]             # updated in place
            assert tcache[k].dtype == (torch.float32 if k == "s" else
                                       getattr(torch, tail_dtype))
            _close(tcache[k], jcache[k], tol, msg=f"step {step} {k}")


def test_ssm_init_cache_matches_reference():
    jc, tc = _cfgs()
    jcache = jssm.ssm_init_cache(jc, 3, jnp.bfloat16)
    tcache = tssm.ssm_init_cache(tc, 3, torch.bfloat16, device="cpu")
    assert set(tcache) == set(jcache)
    for k, v in jcache.items():
        assert tuple(tcache[k].shape) == v.shape
        assert str(tcache[k].dtype)[6:] == str(v.dtype)
        assert not bool(tcache[k].any())


# ----------------------------------------------------------------------
# the model and the server
# ----------------------------------------------------------------------
@pytest.mark.parametrize("plen", [12, 32])
def test_prefill_and_decode_logits_fp32(fp32, plen):
    """Prefill logits at 1e-4 at a ragged prompt (12 of chunk 16) and at
    two whole chunks; each layer's cache (the fp32 state at 1e-4, the
    bf16 tails at 1e-2); then a decode step from the reference's own cache
    bytes at 1e-4."""
    jc, tc, jparams, tparams = fp32
    toks = np.stack(_prompts(jc, plen)).astype(np.int32)
    jm, tm = JModel(jc), Model(tc)
    jl, jcache, jfill = jm.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                   cache_len=plen + 8)
    with torch.inference_mode():
        tl, tcache, tfill = tm.prefill(
            tparams, {"tokens": torch.from_numpy(toks).long()},
            cache_len=plen + 8)
    assert tfill == jfill and len(tcache) == tc.n_layers
    _close(tl, jl, msg="prefill logits")
    jcs = jcache["ssm_none"]
    for i, c in enumerate(tcache):
        assert c["s"].dtype == torch.float32 and c["cx"].dtype == \
            torch.bfloat16
        _close(c["s"], jcs["s"][i], msg=f"layer {i} s")
        for k in TAILS:
            _close(c[k], jcs[k][i], 1e-2, msg=f"layer {i} {k}")
    nxt = np.argmax(_np(jl), -1)[:, None].astype(np.int32)
    jl2, _ = jm.decode(jparams, jnp.asarray(nxt), jcache, jnp.int32(jfill))
    with torch.inference_mode():
        for i, c in enumerate(tcache):
            for k in c:
                c[k].copy_(torch.from_numpy(_np(jcs[k][i])))
        tl2, _ = tm.decode(tparams, torch.from_numpy(nxt).long(), tcache,
                           tfill)
    _close(tl2, jl2, msg="decode logits")


def test_decode_matches_prefill_continuation(fp32):
    """``tests/test_models.py::test_ssm_decode_matches_prefill_
    continuation`` on the port: decoding token 17 from a 16-token prefill
    (the conv tails cached in bf16) matches prefilling 17 tokens at
    2e-2."""
    _, tc, _, tparams = fp32
    model = Model(tc)
    t = torch.from_numpy(np.random.default_rng(4).integers(
        0, tc.vocab, (1, 17))).long()
    with torch.inference_mode():
        full, _, _ = model.prefill(tparams, {"tokens": t}, cache_len=32)
        _, cache, fill = model.prefill(tparams, {"tokens": t[:, :16]},
                                       cache_len=32)
        step, _ = model.decode(tparams, t[:, 16:17], cache, fill)
    np.testing.assert_allclose(full.numpy(), step[:, 0].numpy(), rtol=2e-2,
                               atol=2e-2)


def test_decode_refuses_more_than_one_token(fp32):
    """A Mamba-2 layer's step takes one token: decode refuses (b, 2)
    tokens instead of dropping the second one."""
    _, tc, _, tparams = fp32
    model = Model(tc)
    t = torch.from_numpy(np.random.default_rng(6).integers(
        0, tc.vocab, (1, 10))).long()
    with torch.inference_mode():
        _, cache, fill = model.prefill(tparams, {"tokens": t[:, :8]},
                                       cache_len=16)
        with pytest.raises(ValueError, match="one token a step"):
            model.decode(tparams, t[:, 8:10], cache, fill)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_generate_matches_reference_fp32(fp32, temperature):
    jc, tc, jparams, tparams = fp32
    kw = dict(max_seq=12 + NEW + 8, max_new_tokens=NEW, eos_token=-1,
              temperature=temperature, seed=5)
    want = JServer(jc, jparams, JServeConfig(**kw)).generate(
        _prompts(jc, 12))
    got = Server(tc, tparams, ServeConfig(**kw)).generate(_prompts(jc, 12))
    assert got["completions"] == want["completions"]
    assert all(len(c) == NEW for c in got["completions"])


def test_convert_round_trip(fp32):
    jc, tc, jparams, tparams = fp32
    assert layer_schedule(tc)[0] == ["ssm_none"] * tc.n_layers
    back = convert.to_reference(dict(tparams.named_parameters()), tc)
    flat_t = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), back)))
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(flat_j) == len(flat_t)
    for path, leaf in flat_j:
        np.testing.assert_array_equal(flat_t[path], np.asarray(leaf))


def test_reduced_bf16_serves():
    """The reduced config at its own dtypes (bf16), ``Model.init``
    weights: finite logits through prefill and two decode steps."""
    cfg = tconfigs.get_reduced(ARCH)
    model = Model(cfg)
    params = model.init(0, device="cpu")
    t = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 20))).long()
    with torch.inference_mode():
        logits, cache, fill = model.prefill(params, {"tokens": t})
        for _ in range(2):
            logits, cache = model.decode(params, logits.argmax(-1).reshape(
                2, 1), cache, fill)
            fill += 1
    assert logits.shape == (2, 1, cfg.padded_vocab)
    assert bool(torch.isfinite(logits.float()).all())


def test_launch_serve_mamba2_on_cpu(capsys):
    from repro_torch.launch import serve as launch
    assert launch.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                        "--prompt-len", "8", "--new-tokens", "3"]) == 0
    out = capsys.readouterr().out
    assert "tok/s" in out and out.count("req") == 2
