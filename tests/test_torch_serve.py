"""The port's serving path (``repro_torch.models`` + ``runtime.serve``)
against the JAX reference's, with the reference's own weights.

The reduced ``llama3-8b`` config runs in fp32 (``compute_dtype`` and
``param_dtype``): weights come from the JAX ``Model(cfg).init(0)``
through ``convert.from_reference``, prefill and decode logits must match
the JAX ``ref`` backend at 1e-4 and ``Server.generate`` must give equal
completions, greedy and at temperature 0.8 (the Gumbel noise is numpy's
in both). One bf16 check holds the served dtype to a looser tolerance,
stated where it is used.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import configs as jconfigs
from repro.models import Model as JModel
from repro.runtime import ServeConfig as JServeConfig
from repro.runtime import Server as JServer
from repro.runtime import serve as jserve

from repro_torch.core.stream import FusedChainReduce, plan_stream
from repro_torch.runtime import serve as tserve

from repro_torch import configs as tconfigs
from repro_torch.models import Model as TModel
from repro_torch.models.convert import from_reference
from repro_torch.runtime import ServeConfig, Server

B, PLEN, NEW = 2, 12, 6
MAX_SEQ = PLEN + NEW + 8


def _cfg(dtype="float32"):
    return jconfigs.get_reduced("llama3-8b").scaled(
        compute_dtype=dtype, param_dtype=dtype)


@pytest.fixture(scope="module")
def fp32_pair():
    cfg = _cfg()
    jparams = JModel(cfg).init(0)
    tparams = from_reference(jax.tree.map(np.asarray, jparams),
                             tconfigs.get_reduced("llama3-8b").scaled(
                                 compute_dtype="float32",
                                 param_dtype="float32"), device="cpu")
    return cfg, jparams, tparams


def _prompts(cfg):
    rng = np.random.default_rng(3)
    return [rng.integers(0, cfg.vocab, PLEN) for _ in range(B)]


def test_config_matches_reference():
    assert tconfigs.get("llama3-8b").__dict__ == jconfigs.get(
        "llama3-8b").__dict__
    assert tconfigs.get_reduced("llama3-8b").__dict__ == jconfigs.get_reduced(
        "llama3-8b").__dict__


def test_prefill_and_decode_logits_fp32(fp32_pair):
    cfg, jparams, tparams = fp32_pair
    tcfg = tconfigs.get_reduced("llama3-8b").scaled(
        compute_dtype="float32", param_dtype="float32")
    toks = np.stack(_prompts(cfg)).astype(np.int32)
    jm, tm = JModel(cfg), TModel(tcfg)
    jl, jcache, jfill = jm.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                   cache_len=MAX_SEQ)
    with torch.inference_mode():
        tl, tcache, tfill = tm.prefill(
            tparams, {"tokens": torch.from_numpy(toks).long()},
            cache_len=MAX_SEQ)
    assert tfill == jfill
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    # the bf16 KV cache as the reference fills it
    jk = np.asarray(jcache["attn_mlp"]["k"], np.float32)
    for i, c in enumerate(tcache):
        np.testing.assert_allclose(c["k"].float().numpy(), jk[i], rtol=1e-2,
                                   atol=1e-2)
    # decode from the reference's own cache: a bf16 cache rounds the fp32
    # keys, so a 1e-7 difference at a rounding boundary moves a key by one
    # bf16 ulp; starting from the same bytes holds the step itself to 1e-4
    nxt = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
    jl2, _ = jm.decode(jparams, jnp.asarray(nxt), jcache, jnp.int32(jfill))
    with torch.inference_mode():
        for i, c in enumerate(tcache):
            for kv in ("k", "v"):
                c[kv].copy_(torch.from_numpy(
                    np.asarray(jcache["attn_mlp"][kv][i], np.float32)))
        tl2, _ = tm.decode(tparams, torch.from_numpy(nxt).long(), tcache,
                           tfill)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_generate_matches_reference_fp32(fp32_pair, temperature):
    cfg, jparams, tparams = fp32_pair
    tcfg = tconfigs.get_reduced("llama3-8b").scaled(
        compute_dtype="float32", param_dtype="float32")
    kw = dict(max_seq=MAX_SEQ, max_new_tokens=NEW, eos_token=-1,
              temperature=temperature, seed=5)
    want = JServer(cfg, jparams, JServeConfig(**kw)).generate(_prompts(cfg))
    got = Server(tcfg, tparams, ServeConfig(**kw)).generate(_prompts(cfg))
    assert got["completions"] == want["completions"]
    assert all(len(c) == NEW for c in got["completions"])


def test_prefill_logits_bf16():
    """The served dtype. The port follows the reference's fused-epilogue
    MLP (gate kept fp32, the SwiGLU product rounded once to bf16) where
    the reference's ``ref`` backend rounds x@w1, x@w3 and the product to
    bf16 separately, and bf16 matmul outputs round at 2**-8 relative, so
    the logits (|logit| < ~2 here) agree to a few bf16 ulps: 3e-2."""
    cfg = _cfg("bfloat16")
    jparams = JModel(cfg).init(0)
    tparams = from_reference(jax.tree.map(np.asarray, jparams),
                             tconfigs.get_reduced("llama3-8b"), device="cpu")
    assert tparams.layers[0].mixer.wq.dtype == torch.bfloat16
    toks = np.stack(_prompts(cfg)).astype(np.int32)
    jl, _, _ = JModel(cfg).prefill(jparams, {"tokens": jnp.asarray(toks)},
                                   cache_len=MAX_SEQ)
    with torch.inference_mode():
        tl, _, _ = TModel(tconfigs.get_reduced("llama3-8b")).prefill(
            tparams, {"tokens": torch.from_numpy(toks).long()},
            cache_len=MAX_SEQ)
    np.testing.assert_allclose(tl.float().numpy(),
                               np.asarray(jl, np.float32), rtol=3e-2,
                               atol=3e-2)


def test_init_draws_the_reference_distributions():
    """Model.init(seed, device): truncated normal at +-2 sigma, scaled by
    1/sqrt(fan_in) (0.02 for the embedding), ones for the norms."""
    cfg = tconfigs.get_reduced("llama3-8b").scaled(param_dtype="float32")
    p = TModel(cfg).init(0, device="cpu")
    sd_unit = 0.8796                      # std of N(0,1) cut at +-2
    for w, fan_in in ((p.layers[0].mixer.wq, cfg.d_model),
                      (p.layers[1].ffn.w2, cfg.d_ff),
                      (p.embed.unembed, cfg.d_model)):
        z = w.numpy() * np.sqrt(fan_in)
        assert np.abs(z).max() <= 2.0 + 1e-5
        assert abs(z.std() - sd_unit) < 0.03
    e = p.embed.embed.numpy() / 0.02
    assert np.abs(e).max() <= 2.0 + 1e-5 and abs(e.std() - sd_unit) < 0.03
    assert (p.final_norm.scale.numpy() == 1).all()
    q = TModel(cfg).init(0, device="cpu")
    assert torch.equal(p.layers[0].mixer.wq, q.layers[0].mixer.wq)


def test_entry_points_default_to_the_card():
    import inspect
    from repro_torch.core import Executor
    assert inspect.signature(TModel.init).parameters["device"].default == \
        "cuda"
    assert Executor().device.type == "cuda"
    # every family of the registry is ported (the encoder-decoder and the
    # VLM since whisper-medium and qwen2-vl-2b serve); a combination no
    # family has is refused
    with pytest.raises(NotImplementedError):
        TModel(tconfigs.get("llama3-8b").scaled(encoder_decoder=True,
                                                 mla=True))


def test_launch_serve_on_cpu(capsys):
    from repro_torch.launch import serve as launch
    assert launch.main(["--device", "cpu", "--batch", "2", "--prompt-len",
                        "8", "--new-tokens", "3"]) == 0
    out = capsys.readouterr().out
    assert "tok/s" in out and out.count("req") == 2


# ----------------------------------------------------------------------
# the temperature sampler: tests/test_serve_sampling.py on the port
# ----------------------------------------------------------------------
def _sample(logits, T, g, min_logit=None):
    """The port's tokens, held to the reference's on the same noise."""
    got = tserve.temperature_sample_multistream(logits, T, g, min_logit,
                                                device="cpu")
    want = jserve.temperature_sample_multistream(logits, T, g, min_logit)
    np.testing.assert_array_equal(got, want)
    return got


def test_empirical_distribution_tracks_softmax():
    """600 draws of 8 rows over 6 tokens at T 1.3, each equal to the
    reference's draw on the same Gumbel noise, track ``jax.nn.softmax``
    within the reference test's 0.08."""
    rng = np.random.default_rng(42)
    b, vocab, T, n_draws = 8, 6, 1.3, 600
    logits = rng.standard_normal((b, vocab)).astype(np.float32)
    p_ref = np.asarray(jax.nn.softmax(jnp.asarray(logits) / T, axis=-1))
    gs = rng.gumbel(size=(n_draws, b, vocab)).astype(np.float32)
    counts = np.zeros((b, vocab))
    for g in gs:
        counts[np.arange(b), _sample(logits, T, g)] += 1
    np.testing.assert_allclose(counts / n_draws, p_ref, atol=0.08)


def test_min_logit_threshold_prunes():
    """The THRESH stage: the winner is the argmax over the perturbed
    scaled logits above the floor, as the reference picks it; a floor
    above all of them leaves all-zero rows and index 0; the THRESH
    variant is cached apart and fuses its 3-stage chain per request."""
    rng = np.random.default_rng(43)
    b, vocab, T = 3, 32, 1.0
    logits = (rng.standard_normal((b, vocab)) * 3.0).astype(np.float32)
    g = rng.gumbel(size=(b, vocab)).astype(np.float32)
    z = logits / T + g
    floor = float(np.quantile(z, 0.6))
    tok = _sample(logits, T, g, floor)
    np.testing.assert_array_equal(
        tok, np.argmax(np.where(z > floor, z, -np.inf), axis=-1))
    assert (_sample(logits, T, g, 500.0) == 0).all()
    ent = tserve._TEMPERATURE_PROGRAMS[(b, vocab, T, floor,
                                        torch.device("cpu"))]
    groups = plan_stream(ent[0].descriptors)
    assert len(groups) == b and all(
        isinstance(gr, FusedChainReduce) and len(gr.descs) == 3
        for gr in groups)


def test_min_logit_all_negative_survivors():
    """Every perturbed logit negative: the one survivor of the floor wins,
    not a pruned token (THRESH zeroes prunes, so the chain runs shifted
    positive)."""
    logits = np.full((1, 8), -10.0, np.float32)
    logits[0, 3] = -2.0
    assert _sample(logits, 1.0, np.zeros((1, 8), np.float32), -5.0)[0] == 3
