"""The port's encoder-decoder (whisper-medium: LayerNorm, GELU MLPs,
sinusoidal positions, non-causal encoder self-attention and decoder
cross-attention) against the JAX reference, on the CPU.

The reduced config (2 encoder + 2 decoder layers, d_model 128, 4 heads,
enc_seq 64) carries the reference's own weights (``Model(cfg).init(0)``)
through ``convert.from_reference``; inputs come from numpy seeds and
``SyntheticLM.batch_at``. fp32 compute and parameters unless a test says
otherwise. Tolerances, as ``tests/test_torch_hybrid.py`` holds the other
families: the common functions at 1e-6, logits and the encoder states at
1e-4, the bf16 cache leaves at 1e-2 (one bf16 rounding of fp32 values
that agree to ~1e-6), the loss at 1e-5 and every gradient leaf at rtol
1e-4 / atol 1e-4 max|g| against ``jax.grad``, the decode-vs-prefill
continuation at the reference's own 2e-2.
"""
import functools
import json
import shutil

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import configs as jconfigs
from repro.checkpoint import load_pytree as jload_pytree
from repro.data import SyntheticLM as JSyntheticLM
from repro.kernels import ops as jops
from repro.models import Model as JModel
from repro.models import common as jcommon
from repro.models import encdec as jencdec
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import init_opt_state as jinit_opt_state
from repro.runtime import ServeConfig as JServeConfig
from repro.runtime import Server as JServer
from repro.runtime import TrainConfig as JTrainConfig
from repro.runtime import Trainer as JTrainer
from repro.runtime.train import build_step_fn as jbuild_step_fn

from repro_torch import configs as tconfigs
from repro_torch.data import SyntheticLM
from repro_torch.kernels import ops as tops
from repro_torch.models import Model
from repro_torch.models import common as tcommon
from repro_torch.models import convert
from repro_torch.models import encdec as tencdec
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.runtime import (ServeConfig, Server, TrainConfig, Trainer,
                                 build_step_fn)

ARCH = "whisper-medium"
B, PLEN, NEW = 2, 12, 6
MAX_SEQ = PLEN + NEW + 8
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=20)
CACHE_KEYS = ("k", "v", "ck", "cv")


def _cfgs(dtype="float32", **kw):
    over = dict(compute_dtype=dtype, param_dtype=dtype, **kw)
    return (jconfigs.get_reduced(ARCH).scaled(**over),
            tconfigs.get_reduced(ARCH).scaled(**over))


@functools.lru_cache(maxsize=None)
def _jparams(**kw):
    return jax.jit(lambda: JModel(_cfgs(**kw)[0]).init(0))()


def _np(a):
    return np.asarray(a, np.float32)


def _tparams(trainable=False, **kw):
    params = convert.from_reference(jax.tree.map(_np, _jparams(**kw)),
                                    _cfgs(**kw)[1], device="cpu")
    return params.requires_grad_(trainable)


def _leaves(tree):
    return {jax.tree_util.keystr(p): _np(a)
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _ported(named, tc):
    """Port tensors keyed by name as the reference tree's leaves."""
    return _leaves(jax.tree.map(lambda t: t.detach().float().numpy(),
                                convert.to_reference(dict(named), tc)))


def _tbatch(batch):
    """A reference batch as the port's: int64 ids, bf16 frames."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.array(v, np.float32))
        out[k] = (t.long() if k in ("tokens", "labels")
                  else t.to(torch.bfloat16) if k == "enc_embeds" else t)
    return out


def _frames(cfg, n=B, seed=7):
    a = np.random.default_rng(seed).standard_normal(
        (n, cfg.enc_seq, cfg.d_model)) * 0.02
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(
        torch.bfloat16)


def _prompts(cfg, n=B, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, PLEN) for _ in range(n)]


def _check_cache(tcache, jcache):
    """The port's per-layer cache against the reference's stacked one:
    every leaf bf16, at 1e-2."""
    assert len(tcache) == jcache["k"].shape[0]
    for i, c in enumerate(tcache):
        assert set(c) == set(CACHE_KEYS)
        for k in CACHE_KEYS:
            assert c[k].dtype == torch.bfloat16
            np.testing.assert_allclose(c[k].float().numpy(), _np(jcache[k][i]),
                                       rtol=1e-2, atol=1e-2,
                                       err_msg=f"layer {i} {k}")


def _assert_grads(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)


def _loss_and_grads(tc, params, batch):
    loss, metrics = Model(tc).loss(params, batch)
    named = dict(params.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    return loss, metrics, grads


# ----------------------------------------------------------------------
# config and the common functions
# ----------------------------------------------------------------------
def test_config_matches_reference():
    assert tconfigs.get(ARCH).__dict__ == jconfigs.get(ARCH).__dict__
    assert tconfigs.get_reduced(ARCH).__dict__ == jconfigs.get_reduced(
        ARCH).__dict__
    assert tconfigs.get("whisper_medium") is tconfigs.get(ARCH)


@pytest.mark.parametrize("shape", [(3, 5, 128), (2, 1024)])
def test_layernorm_matches_reference(shape):
    """LayerNorm (eps 1e-5, statistics and affine in fp32) on numpy
    inputs with an offset mean, at 1e-6."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(shape) * 3 + 1.5).astype(np.float32)
    scale = rng.standard_normal(shape[-1]).astype(np.float32)
    bias = rng.standard_normal(shape[-1]).astype(np.float32)
    want = jcommon.layernorm(*map(jnp.asarray, (x, scale, bias)))
    got = tcommon.layernorm(*map(torch.from_numpy, (x, scale, bias)))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-6, atol=1e-6)


def test_layernorm_params_and_dispatch():
    """``norm_params`` gives LayerNorm a zero bias beside the unit scale,
    and ``apply_norm`` dispatches on ``cfg.norm``."""
    _, tc = _cfgs()
    p = tcommon.norm_params(tc, 8, "cpu")
    assert torch.equal(p.scale, torch.ones(8)) and torch.equal(
        p.bias, torch.zeros(8))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, 8)).astype(np.float32))
    assert torch.equal(tcommon.apply_norm(tc, p, x),
                       tcommon.layernorm(x, p.scale, p.bias))
    rms = tc.scaled(norm="rmsnorm")
    assert tcommon.norm_params(rms, 8, "cpu").bias is None
    assert torch.equal(tcommon.apply_norm(rms, p, x),
                       tcommon.rmsnorm(x, p.scale))


@pytest.mark.parametrize("seq,d", [(64, 128), (1500, 1024)])
def test_sinusoidal_pos_matches_reference(seq, d):
    """The encoder's table, built in float64 numpy and rounded once: the
    reference's bits."""
    got = tcommon.sinusoidal_pos(seq, d)
    assert got.dtype == torch.float32 and got.shape == (seq, d)
    np.testing.assert_array_equal(got.numpy(),
                                  _np(jcommon.sinusoidal_pos(seq, d)))


@pytest.mark.parametrize("start,s", [(0, 12), (17, 1), (440, 8)])
def test_sinusoidal_at_matches_reference(start, s):
    """The decoder's fp32 sinusoids at ``start + arange(s)``, at 1e-6."""
    pos = np.arange(s) + start
    want = jencdec._sinusoidal_at(jnp.asarray(pos), 128)
    got = tencdec._sinusoidal_at(torch.from_numpy(pos), 128)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------------------
# attention at a key length no 8-aligned block divides
# ----------------------------------------------------------------------
def _qkv(sq, skv, seed=11):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 4, sq, 32)).astype(np.float32),
            rng.standard_normal((2, 4, skv, 32)).astype(np.float32),
            rng.standard_normal((2, 4, skv, 32)).astype(np.float32))


@pytest.mark.parametrize("sq", [8, 100])
def test_attention_matches_chain_reduce_route(sq):
    """At skv 100 the reference's Pallas flash kernel finds no 8-aligned
    block that divides the keys and composes the attention from its
    streaming MAX and MASK -> SUM reductions (``_attention_chain_reduce``,
    the route whisper's 1500 keys take on the TPU); the port's
    ``ops.attention`` (one flash launch on the card) computes the same
    function, non-causal, at 1e-5."""
    q, k, v = _qkv(sq, 100)
    assert jops._flash_block(100, 128) == 0
    with jops.backend("pallas_interpret"):
        want = jops.attention(*map(jnp.asarray, (q, k, v)), causal=False)
    got = tops.attention(*map(torch.from_numpy, (q, k, v)), causal=False)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sq", [8, 100])
def test_attention_gradient_at_ragged_keys(sq):
    """Under autograd, non-causal at skv 100: the port's forward with lse
    and the flash-style backward's plain version against ``jax.grad`` of
    the reference's ``ops.attention`` (the chain-reduce route has no
    gradient rule, so the reference trains through its ``ref`` backend),
    at 1e-5."""
    q, k, v = _qkv(sq, 100, seed=12)
    w = np.random.default_rng(13).standard_normal(
        (2, 4, sq, 32)).astype(np.float32)

    def jloss(q, k, v):
        return (jops.attention(q, k, v, causal=False) * w).sum()
    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tops.attention(*ts, causal=False)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), ts)
    for g, wt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(wt), rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------------
# parameters and conversion
# ----------------------------------------------------------------------
def test_convert_round_trip():
    """The reference tree -> the port's modules -> the reference tree, bit
    for bit: the encoder and decoder stacks, LayerNorm biases, the final
    norms; names map to their stack at the layer's index."""
    _, tc = _cfgs()
    named = dict(_tparams().named_parameters())
    assert convert.reference_path("dec_layers.1.cross_attn.wq", tc) == (
        ("dec_layers", "cross_attn", "wq"), 1)
    assert convert.reference_path("enc_layers.0.norm2.bias", tc) == (
        ("enc_layers", "norm2", "bias"), 0)
    assert convert.reference_path("dec_norm.bias", tc) == (
        ("dec_norm", "bias"), None)
    back = _leaves(convert.to_reference(named, tc))
    want = _leaves(_jparams())
    assert back.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_array_equal(back[k], w, err_msg=k)


def test_init_matches_reference_shapes():
    """``Model.init`` draws the reference's tree: the same leaves and
    shapes; LayerNorms at (1, 0)."""
    _, tc = _cfgs()
    params = Model(tc).init(0, device="cpu")
    assert isinstance(params, tencdec.EncDec)
    got = convert.to_reference(dict(params.named_parameters()), tc)
    got = {k: v.shape for k, v in _leaves(jax.tree.map(
        lambda t: t.numpy(), got)).items()}
    assert got == {k: v.shape for k, v in _leaves(_jparams()).items()}
    assert torch.equal(params.dec_layers[1].norm_x.bias,
                       torch.zeros(tc.d_model))
    assert not any(p.requires_grad for p in params.parameters())


# ----------------------------------------------------------------------
# serving
# ----------------------------------------------------------------------
def test_encode_matches_reference():
    jc, tc = _cfgs()
    jf, tf = _frames(jc)
    want = jencdec.encode(jc, _jparams(), jf)
    with torch.inference_mode():
        got = tencdec.encode(tc, _tparams(), tf)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4, atol=1e-4)


def test_prefill_and_decode_steps_match_reference():
    """Prefill logits at 1e-4 and every cache leaf (k, v at the prompt's
    slots, ck, cv at the encoder's) at 1e-2; then 4 decode steps, each
    from the reference's cache bytes, written in place: logits at 1e-4,
    the caches at 1e-2."""
    jc, tc = _cfgs()
    jf, tf = _frames(jc)
    toks = np.stack(_prompts(jc)).astype(np.int32)
    jm, tm = JModel(jc), Model(tc)
    jparams, tparams = _jparams(), _tparams()
    jl, jcache, jfill = jm.prefill(
        jparams, {"tokens": jnp.asarray(toks), "enc_embeds": jf},
        cache_len=MAX_SEQ)
    with torch.inference_mode():
        tl, tcache, tfill = tm.prefill(
            tparams, {"tokens": torch.from_numpy(toks).long(),
                      "enc_embeds": tf}, cache_len=MAX_SEQ)
    assert tfill == jfill == PLEN
    assert tuple(tcache[0]["k"].shape) == (B, tc.n_kv_heads, MAX_SEQ, tc.hd)
    assert tuple(tcache[0]["ck"].shape) == (B, tc.n_kv_heads, tc.enc_seq,
                                            tc.hd)
    np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=1e-4, atol=1e-4)
    _check_cache(tcache, jcache)
    rng = np.random.default_rng(5)
    fill = jfill
    for _ in range(4):
        nxt = rng.integers(0, jc.vocab, (B, 1)).astype(np.int32)
        with torch.inference_mode():
            for i, c in enumerate(tcache):
                for k in CACHE_KEYS:
                    c[k].copy_(torch.from_numpy(_np(jcache[k][i])))
            before = [c["k"].data_ptr() for c in tcache]
            tl2, tcache = tm.decode(tparams, torch.from_numpy(nxt).long(),
                                    tcache, fill)
        jl2, jcache = jm.decode(jparams, jnp.asarray(nxt), jcache,
                                jnp.int32(fill))
        assert [c["k"].data_ptr() for c in tcache] == before
        np.testing.assert_allclose(tl2.numpy(), _np(jl2), rtol=1e-4,
                                   atol=1e-4)
        _check_cache(tcache, jcache)
        fill += 1


def test_decode_matches_prefill_continuation():
    """``tests/test_models.py``'s continuation on whisper: token 17
    decoded from a 16-token prefill (bf16 keys and values, the encoder's
    keys and values cached in bf16) matches a 17-token prefill at 2e-2."""
    _, tc = _cfgs()
    model, params = Model(tc), _tparams()
    _, tf = _frames(tc, 1)
    t = torch.from_numpy(np.random.default_rng(3).integers(
        0, tc.vocab, (1, 17))).long()
    with torch.inference_mode():
        full, _, _ = model.prefill(params, {"tokens": t, "enc_embeds": tf},
                                   cache_len=32)
        _, cache, fill = model.prefill(
            params, {"tokens": t[:, :16], "enc_embeds": tf}, cache_len=32)
        step, _ = model.decode(params, t[:, 16:17], cache, fill)
    np.testing.assert_allclose(full.numpy(), step[:, 0].numpy(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_generate_matches_reference(temperature):
    """``Server.generate(prompts, extra={"enc_embeds": ...})`` greedy and
    at temperature 0.8 gives the reference's completions."""
    jc, tc = _cfgs()
    jf, tf = _frames(jc)
    kw = dict(max_seq=MAX_SEQ, max_new_tokens=NEW, eos_token=-1,
              temperature=temperature, seed=5)
    want = JServer(jc, _jparams(), JServeConfig(**kw)).generate(
        _prompts(jc), extra={"enc_embeds": jf})
    got = Server(tc, _tparams(), ServeConfig(**kw)).generate(
        _prompts(tc), extra={"enc_embeds": tf})
    assert got["completions"] == want["completions"]
    assert all(len(c) == NEW for c in got["completions"])


def test_reduced_bf16_serves():
    """The reduced config at its own dtypes (bf16), ``Model.init``
    weights: finite logits through prefill and a decode step."""
    cfg = tconfigs.get_reduced(ARCH)
    model = Model(cfg)
    params = model.init(0, device="cpu")
    _, tf = _frames(cfg)
    t = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, 20))).long()
    with torch.inference_mode():
        logits, cache, fill = model.prefill(
            params, {"tokens": t, "enc_embeds": tf}, cache_len=24)
        logits, _ = model.decode(params, logits.argmax(-1)[:, None], cache,
                                 fill)
    assert logits.shape == (B, 1, cfg.padded_vocab)
    assert bool(torch.isfinite(logits.float()).all())


# ----------------------------------------------------------------------
# training
# ----------------------------------------------------------------------
def test_loss_and_grads_match_reference():
    """The loss at 1e-5 (its aux 0) and every gradient leaf against
    ``jax.grad``: both stacks' attention (the cross-attention's keys and
    values carry the decoder's gradient into the encoder), LayerNorm
    scales and biases, GELU MLPs."""
    jc, tc = _cfgs()
    batch = JSyntheticLM(jc, 2, 24, seed=4).batch_at(0)
    (jl, jm), jg = jax.jit(jax.value_and_grad(JModel(jc).loss, has_aux=True))(
        _jparams(), batch)
    tl, tm, tg = _loss_and_grads(tc, _tparams(trainable=True),
                                 _tbatch(batch))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    assert float(tm["moe_aux"]) == float(jm["moe_aux"]) == 0.0
    _assert_grads(_ported(tg, tc), _leaves(jg))


def test_remat_dots_equals_full():
    """``remat="dots"`` (the products' outputs saved, the rest
    recomputed) and ``"none"`` give the loss and every gradient of
    ``"full"`` exactly."""
    _, tc = _cfgs()
    batch = _tbatch(JSyntheticLM(_cfgs()[0], 2, 16, seed=6).batch_at(0))
    params = _tparams(trainable=True)
    out = {}
    for remat in ("full", "dots", "none"):
        loss, _, grads = _loss_and_grads(tc.scaled(remat=remat), params,
                                         batch)
        out[remat] = [loss.detach(), *grads.values()]
    for remat in ("dots", "none"):
        for a, b in zip(out["full"], out[remat]):
            assert torch.equal(a, b), remat


def test_tied_embeddings_match_reference():
    """``tie_embeddings``: no ``unembed``, the table's transpose unembeds
    (and takes both gradients); the loss at 1e-5, every gradient leaf
    against ``jax.grad``, prefill logits at 1e-4."""
    jc, tc = _cfgs(tie_embeddings=True)
    jparams = _jparams(tie_embeddings=True)
    tparams = _tparams(trainable=True, tie_embeddings=True)
    assert tparams.embed.unembed is None and "unembed" not in jparams["embed"]
    batch = JSyntheticLM(jc, 2, 16, seed=8).batch_at(0)
    (jl, _), jg = jax.jit(jax.value_and_grad(JModel(jc).loss, has_aux=True))(
        jparams, batch)
    tl, _, tg = _loss_and_grads(tc, tparams, _tbatch(batch))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    _assert_grads(_ported(tg, tc), _leaves(jg))
    jlog, _, _ = JModel(jc).prefill(jparams, batch, cache_len=24)
    with torch.inference_mode():
        tlog, _, _ = Model(tc).prefill(tparams, _tbatch(batch), cache_len=24)
    np.testing.assert_allclose(tlog.numpy(), _np(jlog), rtol=1e-4,
                               atol=1e-4)
    assert "embed.unembed" not in dict(Model(tc).init(
        0, device="cpu").named_parameters())


def test_step_with_grad_accum_matches_reference():
    """One ``build_step_fn`` step at grad_accum 2 (the frames split with
    the tokens), against the reference's: loss at 1e-5, new params within
    2 lr and 1e-5 relative."""
    jc, tc = _cfgs(grad_accum=2)
    batch = JSyntheticLM(jc, 4, 16, seed=2).batch_at(0)
    jparams = _jparams()
    jp, js, jl, _ = jax.jit(jbuild_step_fn(jc, JAdamWConfig(**OPT)))(
        jparams, jinit_opt_state(jparams), batch)
    tparams = _tparams(trainable=True)
    tp, ts, tl, _ = build_step_fn(tc, AdamWConfig(**OPT))(
        tparams, init_opt_state(dict(tparams.named_parameters())),
        _tbatch(batch))
    assert ts["step"] == int(js["step"]) == 1
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    want = _leaves(jp)
    for k, got in _ported(tp.named_parameters(), tc).items():
        np.testing.assert_allclose(got, want[k], rtol=1e-5,
                                   atol=2 * OPT["lr"] / 2, err_msg=k)


def test_pipeline_matches_reference():
    """``SyntheticLM.batch_at`` draws the reference's tokens and then its
    frame embeddings from the same rng: bf16 bit for bit (numpy's float64
    rounded as ``jnp.asarray`` rounds it)."""
    jc, tc = _cfgs()
    want = JSyntheticLM(jc, 3, 20, seed=9).batch_at(4)
    got = SyntheticLM(tc, 3, 20, seed=9).batch_at(4)
    assert got.keys() == want.keys() == {"tokens", "labels", "enc_embeds"}
    assert got["enc_embeds"].dtype == torch.bfloat16
    assert tuple(got["enc_embeds"].shape) == (3, tc.enc_seq, tc.d_model)
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k]
        if k == "enc_embeds":
            np.testing.assert_array_equal(
                g.view(torch.int16).numpy().view(np.uint16),
                w.view(np.uint16))
        else:
            np.testing.assert_array_equal(g.numpy(), w)


STEPS, RESUME_AT = 3, 2


def _train_cfg(cls, d):
    return cls(steps=STEPS, log_every=0, ckpt_every=1, ckpt_dir=d,
               global_batch=2, seq_len=16, multistream_plan=False)


def test_port_resumes_reference_checkpoint(tmp_path):
    """The reference Trainer on reduced whisper writes a checkpoint every
    step; the port's Trainer resumes its step-RESUME_AT one and continues
    its loss stream at 1e-4, and writes its own last checkpoint in the
    reference's layout (the same leaf names, in order), which the
    reference's ``load_pytree`` reads close to its own."""
    jc, tc = _cfgs()
    run = JTrainer(jc, JAdamWConfig(**OPT), _train_cfg(
        JTrainConfig, str(tmp_path / "ref"))).run()
    d = tmp_path / "port"
    d.mkdir()
    name = f"step_{RESUME_AT:09d}"
    shutil.copytree(tmp_path / "ref" / name, d / name)
    r = Trainer(tc, AdamWConfig(**OPT), _train_cfg(TrainConfig, str(d)),
                device="cpu").run()
    assert r["resumed_from"] == RESUME_AT and r["bad_steps"] == 0
    np.testing.assert_allclose(r["losses"], run["losses"][RESUME_AT:],
                               rtol=1e-4)
    last = f"step_{STEPS:09d}"
    with open(d / last / "manifest.json") as f:
        port_names = [m["name"] for m in json.load(f)]
    with open(tmp_path / "ref" / last / "manifest.json") as f:
        assert port_names == [m["name"] for m in json.load(f)]
    like = {"params": run["params"], "opt": run["opt"],
            "data_step": jnp.zeros((), jnp.int32)}
    got = _leaves(jload_pytree(str(d / last), like))
    want = _leaves(jload_pytree(str(tmp_path / "ref" / last), like))
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(w).max(), 1e-30),
                                   err_msg=k)


# ----------------------------------------------------------------------
# launchers
# ----------------------------------------------------------------------
def test_launch_serve_refuses_with_the_reference_message(capsys):
    """The serving launcher refuses the encoder-decoder as the
    reference's does (its prompts carry no frames), pointing to
    ``Server.generate(extra=...)``."""
    from repro_torch.launch import serve as launch
    assert launch.main(["--arch", ARCH, "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "needs frontend inputs" in out and "Server.generate" in out


def test_launch_train_on_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch whisper-medium
    --reduced --device cpu``: the pipeline draws the frames; finite
    losses."""
    from repro_torch.launch import train as launch_train
    assert launch_train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                              "--steps", "2", "--global-batch", "2", "--seq",
                              "16", "--ckpt", str(tmp_path), "--resume",
                              "none"]) == 0
    out = capsys.readouterr().out
    first, last = (float(x) for x in out.split("done: loss ")[1]
                   .split(",")[0].split(" -> "))
    assert np.isfinite(first) and np.isfinite(last)
