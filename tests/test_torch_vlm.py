"""The port's VLM (qwen2-vl-2b: M-RoPE, the patch stub, q/k/v biases,
GQA group 2 reduced / 6 full) against the JAX reference, on the CPU.

The reduced config (4 layers, d_model 128, 4 / 2 heads of 32, M-RoPE
sections (8, 4, 4), 16 patches) carries the reference's own weights
(``Model(cfg).init(0)``, its ``img_proj`` the identity) through
``convert.from_reference``; inputs come from numpy seeds and
``SyntheticLM.batch_at``. The position streams ``pos3`` are drawn to
differ from one another (an image's (t, h, w) grid over the patches,
then text), so a stream taken for another shows. fp32 compute and
parameters unless a test says otherwise. Tolerances, as
``tests/test_torch_hybrid.py`` holds the other families: M-RoPE at 1e-6,
logits at 1e-4, the bf16 cache at 1e-2, the loss at 1e-5 and every
gradient leaf at rtol 1e-4 / atol 1e-4 max|g| against ``jax.grad``, the
decode-vs-prefill continuation at the reference's own 2e-2.
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
from repro.models import Model as JModel
from repro.models import common as jcommon
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import init_opt_state as jinit_opt_state
from repro.runtime import ServeConfig as JServeConfig
from repro.runtime import Server as JServer
from repro.runtime import TrainConfig as JTrainConfig
from repro.runtime import Trainer as JTrainer
from repro.runtime.train import build_step_fn as jbuild_step_fn
from repro.runtime.train import microbatches as jmicrobatches

from repro_torch import configs as tconfigs
from repro_torch.data import SyntheticLM
from repro_torch.models import Model
from repro_torch.models import common as tcommon
from repro_torch.models import convert
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.runtime import (ServeConfig, Server, TrainConfig, Trainer,
                                 build_step_fn)
from repro_torch.runtime.train import microbatches

ARCH = "qwen2-vl-2b"
B, NEW = 2, 6
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=20)


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
    return _leaves(jax.tree.map(lambda t: t.detach().float().numpy(),
                                convert.to_reference(dict(named), tc)))


def _tbatch(batch):
    """A reference batch as the port's: int64 ids and positions, bf16
    patches, the fp32 mask."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.array(v, np.float32))
        out[k] = (t.long() if k in ("tokens", "labels", "pos3")
                  else t.to(torch.bfloat16) if k == "img_embeds" else t)
    return out


def _pos3(cfg, b, s):
    """(3, b, s) M-RoPE positions: the patches on a (t, h, w) grid of 1 x
    4 x n/4, the text after them, every stream advancing from the
    grid's largest position, each row shifted by its index."""
    n = cfg.n_patches
    side = n // 4
    t = np.zeros(n, np.int64)
    h = np.arange(n) // side
    w = np.arange(n) % side
    text = np.arange(s - n) + max(h.max(), w.max()) + 1
    pos = np.stack([np.concatenate([a, text]) for a in (t, h, w)])
    return np.stack([pos + i for i in range(b)], 1)


def _inputs(cfg, b=B, s=24, seed=3):
    """tokens, patch embeddings (bf16) and pos3 as numpy arrays."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    img = rng.standard_normal((b, cfg.n_patches, cfg.d_model)) * 0.02
    return toks, img, _pos3(cfg, b, s)


def _jb(toks, img, pos3):
    return {"tokens": jnp.asarray(toks),
            "img_embeds": jnp.asarray(img, jnp.bfloat16),
            "pos3": jnp.asarray(pos3, jnp.int32)}


def _tb(toks, img, pos3):
    return {"tokens": torch.from_numpy(toks).long(),
            "img_embeds": torch.from_numpy(img).to(torch.bfloat16),
            "pos3": torch.from_numpy(pos3)}


def _check_cache(tcache, jcache):
    """The port's per-layer cache against the reference's per-kind
    stacked one (one kind, ``attn_mlp``), bf16 at 1e-2."""
    stack = jcache["attn_mlp"]
    assert len(tcache) == stack["k"].shape[0]
    for i, c in enumerate(tcache):
        for k in ("k", "v"):
            assert c[k].dtype == torch.bfloat16
            np.testing.assert_allclose(c[k].float().numpy(),
                                       _np(stack[k][i]), rtol=1e-2,
                                       atol=1e-2, err_msg=f"layer {i} {k}")


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


def _train_batch(jc, b=B, s=24, seed=4):
    """The pipeline's batch (patches, loss_mask) with drawn pos3."""
    batch = dict(JSyntheticLM(jc, b, s, seed=seed).batch_at(0))
    batch["pos3"] = jnp.asarray(_pos3(jc, b, s), jnp.int32)
    return batch


# ----------------------------------------------------------------------
# config and M-RoPE
# ----------------------------------------------------------------------
def test_config_matches_reference():
    assert tconfigs.get(ARCH).__dict__ == jconfigs.get(ARCH).__dict__
    assert tconfigs.get_reduced(ARCH).__dict__ == jconfigs.get_reduced(
        ARCH).__dict__
    full = tconfigs.get(ARCH)
    assert full.hd == 128 and sum(full.mrope_sections) == full.hd // 2
    assert full.n_heads // full.n_kv_heads == 6


@pytest.mark.parametrize("d,sections", [(32, (8, 4, 4)),
                                        (128, (16, 24, 24))])
def test_apply_mrope_matches_reference(d, sections):
    """Each frequency slot rotated by its section's position stream, on
    numpy inputs at 1e-6 (positions up to 1000, theta 1e6)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 10, d)).astype(np.float32)
    pos3 = rng.integers(0, 1000, (3, 2, 10))
    want = jcommon.apply_mrope(jnp.asarray(x), jnp.asarray(pos3, jnp.int32),
                               1e6, sections)
    got = tcommon.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3),
                              1e6, sections)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-6, atol=1e-6)


def test_apply_mrope_with_equal_streams_is_rope():
    """With the three streams equal, M-RoPE is RoPE; sections that do not
    sum to hd / 2 raise."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((1, 2, 6, 32)).astype(
        np.float32))
    pos = torch.from_numpy(rng.integers(0, 50, (1, 6)))
    np.testing.assert_allclose(
        tcommon.apply_mrope(x, pos[None].expand(3, 1, 6), 1e4, (8, 4, 4)),
        tcommon.apply_rope(x, pos, 1e4), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="sections"):
        tcommon.apply_mrope(x, pos[None].expand(3, 1, 6), 1e4, (8, 4, 8))


# ----------------------------------------------------------------------
# parameters and conversion
# ----------------------------------------------------------------------
def test_convert_round_trip():
    """The reference tree -> the port's modules -> the reference tree, bit
    for bit, ``img_proj`` and the q/k/v biases included."""
    _, tc = _cfgs()
    named = dict(_tparams().named_parameters())
    assert convert.reference_path("img_proj", tc) == (("img_proj",), None)
    assert convert.reference_path("layers.2.mixer.bk", tc) == (
        ("layers", "attn_mlp", "mixer", "bk"), 2)
    back = _leaves(convert.to_reference(named, tc))
    want = _leaves(_jparams())
    assert back.keys() == want.keys()
    assert any("img_proj" in k for k in want)
    for k, w in want.items():
        np.testing.assert_array_equal(back[k], w, err_msg=k)


def test_init_builds_img_proj_and_biases():
    _, tc = _cfgs()
    params = Model(tc).init(0, device="cpu")
    assert torch.equal(params.img_proj, torch.eye(tc.d_model))
    assert torch.equal(params.layers[0].mixer.bq,
                       torch.zeros(tc.n_heads * tc.hd))
    shapes = {k: v.shape for k, v in _leaves(jax.tree.map(
        lambda t: t.numpy(), convert.to_reference(
            dict(params.named_parameters()), tc))).items()}
    assert shapes == {k: v.shape for k, v in _leaves(_jparams()).items()}


# ----------------------------------------------------------------------
# serving
# ----------------------------------------------------------------------
def test_prefill_and_decode_steps_match_reference():
    """Prefill with patches and drawn pos3: logits at 1e-4, every cache
    leaf at 1e-2; then 4 decode steps (pos3 = fill + arange in all three
    streams, as the reference's decode builds it), each from the
    reference's cache bytes: logits at 1e-4, caches at 1e-2."""
    jc, tc = _cfgs()
    toks, img, pos3 = _inputs(jc)
    max_seq = toks.shape[1] + 8
    jm, tm = JModel(jc), Model(tc)
    jparams, tparams = _jparams(), _tparams()
    jl, jcache, fill = jm.prefill(jparams, _jb(toks, img, pos3),
                                  cache_len=max_seq)
    with torch.inference_mode():
        tl, tcache, tfill = tm.prefill(tparams, _tb(toks, img, pos3),
                                       cache_len=max_seq)
    assert tfill == fill
    np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=1e-4, atol=1e-4)
    _check_cache(tcache, jcache)
    rng = np.random.default_rng(5)
    for _ in range(4):
        nxt = rng.integers(0, jc.vocab, (B, 1)).astype(np.int32)
        with torch.inference_mode():
            for i, c in enumerate(tcache):
                for k in ("k", "v"):
                    c[k].copy_(torch.from_numpy(_np(
                        jcache["attn_mlp"][k][i])))
            tl2, tcache = tm.decode(tparams, torch.from_numpy(nxt).long(),
                                    tcache, fill)
        jl2, jcache = jm.decode(jparams, jnp.asarray(nxt), jcache,
                                jnp.int32(fill))
        np.testing.assert_allclose(tl2.numpy(), _np(jl2), rtol=1e-4,
                                   atol=1e-4)
        _check_cache(tcache, jcache)
        fill += 1


def test_positions_default_to_arange_in_three_streams():
    """Without ``pos3`` the prefill's positions are arange(s) in all
    three streams: the logits of a batch given that pos3 explicitly."""
    _, tc = _cfgs()
    toks, img, _ = _inputs(tc)
    b, s = toks.shape
    batch = _tb(toks, img, np.broadcast_to(np.arange(s), (3, b, s)).copy())
    params = _tparams()
    with torch.inference_mode():
        want, _, _ = Model(tc).prefill(params, batch, cache_len=s)
        del batch["pos3"]
        got, _, _ = Model(tc).prefill(params, batch, cache_len=s)
    assert torch.equal(got, want)


def test_decode_matches_prefill_continuation():
    """Token s + 1 decoded from an s-token prefill (bf16 keys and values)
    matches an (s + 1)-token prefill at 2e-2, the positions arange in
    all three streams."""
    _, tc = _cfgs()
    model, params = Model(tc), _tparams()
    toks, img, _ = _inputs(tc, b=1, s=25)
    t = torch.from_numpy(toks).long()
    imgs = torch.from_numpy(img).to(torch.bfloat16)
    with torch.inference_mode():
        full, _, _ = model.prefill(params, {"tokens": t, "img_embeds": imgs},
                                   cache_len=32)
        _, cache, fill = model.prefill(
            params, {"tokens": t[:, :24], "img_embeds": imgs}, cache_len=32)
        step, _ = model.decode(params, t[:, 24:25], cache, fill)
    np.testing.assert_allclose(full.numpy(), step[:, 0].numpy(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_generate_matches_reference(temperature):
    """``Server.generate(prompts, extra={"img_embeds", "pos3"})`` greedy
    and at temperature 0.8 gives the reference's completions."""
    jc, tc = _cfgs()
    toks, img, pos3 = _inputs(jc, s=20)
    kw = dict(max_seq=32, max_new_tokens=NEW, eos_token=-1,
              temperature=temperature, seed=5)
    jx = _jb(toks, img, pos3)
    want = JServer(jc, _jparams(), JServeConfig(**kw)).generate(
        list(toks), extra={k: jx[k] for k in ("img_embeds", "pos3")})
    tx = _tb(toks, img, pos3)
    got = Server(tc, _tparams(), ServeConfig(**kw)).generate(
        list(toks), extra={k: tx[k] for k in ("img_embeds", "pos3")})
    assert got["completions"] == want["completions"]
    assert all(len(c) == NEW for c in got["completions"])


def test_chunked_prefill_splits_pos3():
    """``prefill_microbatch`` 2 over 4 requests: ``pos3`` split along its
    batch axis (1) with the rest along 0; the reference's chunked logits
    at 1e-4, the unchunked prefill's logits and caches at 1e-4 / 1e-2."""
    jc, tc = _cfgs(prefill_microbatch=2)
    toks, img, pos3 = _inputs(jc, b=4)
    jl, jcache, _ = JModel(jc).prefill(_jparams(), _jb(toks, img, pos3),
                                       cache_len=32)
    params = _tparams()
    with torch.inference_mode():
        l2, c2, _ = Model(tc).prefill(params, _tb(toks, img, pos3),
                                      cache_len=32)
        l1, c1, _ = Model(tc.scaled(prefill_microbatch=1)).prefill(
            params, _tb(toks, img, pos3), cache_len=32)
    np.testing.assert_allclose(l2.numpy(), _np(jl), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(l2.numpy(), l1.numpy(), rtol=1e-4, atol=1e-4)
    _check_cache(c2, jcache)
    for a, b in zip(c2, c1):
        for k in ("k", "v"):
            assert a[k].shape[0] == 4
            np.testing.assert_allclose(a[k].float().numpy(),
                                       b[k].float().numpy(), rtol=1e-2,
                                       atol=1e-2)


def test_reduced_bf16_serves():
    cfg = tconfigs.get_reduced(ARCH)
    model = Model(cfg)
    params = model.init(0, device="cpu")
    toks, img, pos3 = _inputs(cfg)
    with torch.inference_mode():
        logits, cache, fill = model.prefill(params, _tb(toks, img, pos3),
                                            cache_len=32)
        logits, _ = model.decode(params, logits.argmax(-1)[:, None], cache,
                                 fill)
    assert logits.shape == (B, 1, cfg.padded_vocab)
    assert bool(torch.isfinite(logits.float()).all())


# ----------------------------------------------------------------------
# training
# ----------------------------------------------------------------------
def test_loss_and_grads_match_reference():
    """The loss (the patches masked out by ``loss_mask``) at 1e-5 and
    every gradient leaf against ``jax.grad``, ``img_proj`` and the q/k/v
    biases included."""
    jc, tc = _cfgs()
    batch = _train_batch(jc)
    (jl, _), jg = jax.jit(jax.value_and_grad(JModel(jc).loss, has_aux=True))(
        _jparams(), batch)
    tl, tm, tg = _loss_and_grads(tc, _tparams(trainable=True),
                                 _tbatch(batch))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    assert float(tm["moe_aux"]) == 0.0
    assert float(tg["img_proj"].abs().max()) > 0
    _assert_grads(_ported(tg, tc), _leaves(jg))


def test_remat_dots_equals_full():
    """``remat="dots"`` and ``"none"`` give the loss and every gradient of
    ``"full"`` exactly."""
    jc, tc = _cfgs()
    batch = _tbatch(_train_batch(jc, s=20, seed=6))
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
    """``tie_embeddings`` on the decoder: the loss at 1e-5 and every
    gradient leaf against ``jax.grad`` (the table's gradient sums its
    embedding and unembedding parts)."""
    jc, tc = _cfgs(tie_embeddings=True)
    tparams = _tparams(trainable=True, tie_embeddings=True)
    assert tparams.embed.unembed is None
    batch = _train_batch(jc, seed=8)
    (jl, _), jg = jax.jit(jax.value_and_grad(JModel(jc).loss, has_aux=True))(
        _jparams(tie_embeddings=True), batch)
    tl, _, tg = _loss_and_grads(tc, tparams, _tbatch(batch))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    _assert_grads(_ported(tg, tc), _leaves(jg))


def test_microbatches_split_pos3_on_its_batch_axis():
    """``microbatches`` splits ``pos3`` (3, b, s) on axis 1 and the rest on
    axis 0, as the reference's does."""
    jc, _ = _cfgs()
    batch = _train_batch(jc, b=4)
    want = jmicrobatches(batch, 2)
    got = microbatches(_tbatch(batch), 2)
    assert tuple(got["pos3"].shape) == (2, 3, 2, 24)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].float().numpy(), _np(w),
                                      err_msg=k)


def test_step_with_grad_accum_matches_reference():
    """One ``build_step_fn`` step at grad_accum 2 (pos3 split on its batch
    axis), against the reference's: loss at 1e-5, new params within 2 lr
    and 1e-5 relative."""
    jc, tc = _cfgs(grad_accum=2)
    batch = _train_batch(jc, b=4, s=20, seed=2)
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
    """``SyntheticLM.batch_at`` draws the reference's tokens, then its
    patch embeddings (bf16 bit for bit), the loss mask (0 on the
    patches) and arange positions in three streams."""
    jc, tc = _cfgs()
    want = JSyntheticLM(jc, 3, 24, seed=9).batch_at(4)
    got = SyntheticLM(tc, 3, 24, seed=9).batch_at(4)
    assert got.keys() == want.keys() == {"tokens", "labels", "img_embeds",
                                         "loss_mask", "pos3"}
    assert got["img_embeds"].dtype == torch.bfloat16
    assert float(got["loss_mask"][:, :tc.n_patches].sum()) == 0.0
    for k, w in want.items():
        w = np.asarray(w)
        if k == "img_embeds":
            np.testing.assert_array_equal(
                got[k].view(torch.int16).numpy().view(np.uint16),
                w.view(np.uint16))
        else:
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)


STEPS, RESUME_AT = 3, 2


def _train_cfg(cls, d):
    return cls(steps=STEPS, log_every=0, ckpt_every=1, ckpt_dir=d,
               global_batch=2, seq_len=24, multistream_plan=False)


def test_port_resumes_reference_checkpoint(tmp_path):
    """The reference Trainer on reduced qwen2-vl writes a checkpoint every
    step; the port's Trainer resumes its step-RESUME_AT one (``img_proj``
    included) and continues its loss stream at 1e-4, and writes its last
    checkpoint in the reference's layout, close to the reference's own."""
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
    lr_steps = OPT["lr"] * (STEPS - RESUME_AT)
    for k, w in want.items():
        if "['bk']" in k:
            # the key bias's gradient is 0 in exact arithmetic (softmax
            # ignores a shift shared by every key): both packages hand
            # AdamW rounding noise, which it scales to steps of up to lr
            if "['m']" in k or "['v']" in k:
                assert np.isfinite(got[k]).all(), k
            else:
                np.testing.assert_allclose(got[k], w, rtol=0,
                                           atol=lr_steps, err_msg=k)
            continue
        np.testing.assert_allclose(got[k], w, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(w).max(), 1e-30),
                                   err_msg=k)


# ----------------------------------------------------------------------
# launchers
# ----------------------------------------------------------------------
def test_launch_serve_refuses_with_the_reference_message(capsys):
    from repro_torch.launch import serve as launch
    assert launch.main(["--arch", ARCH, "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "needs frontend inputs" in out and "Server.generate" in out


def test_launch_train_on_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch qwen2-vl-2b --reduced
    --device cpu``: the pipeline draws the patches, the mask and pos3;
    finite losses."""
    from repro_torch.launch import train as launch_train
    assert launch_train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                              "--steps", "2", "--global-batch", "2", "--seq",
                              "24", "--ckpt", str(tmp_path), "--resume",
                              "none"]) == 0
    out = capsys.readouterr().out
    first, last = (float(x) for x in out.split("done: loss ")[1]
                   .split(",")[0].split(" -> "))
    assert np.isfinite(first) and np.isfinite(last)
