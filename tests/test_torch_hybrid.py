"""The port's hybrid family (jamba-v0.1-52b: Mamba-2 and GQA layers on a
period of 8, dense and MoE FFNs) against the JAX reference, on the CPU.

The reduced config (16 layers, d_model 128, 4 experts top-2, chunk 16)
holds two periods of the three layer kinds ``ssm_mlp``, ``ssm_moe`` and
``attn_mlp``. Weights come from the reference's ``Model(cfg).init(0)``
through ``convert.from_reference``; inputs from numpy seeds. fp32 compute
and parameters. Tolerances, as ``tests/test_torch_serve.py`` and
``tests/test_torch_moe_train.py`` hold the other families: logits and
the fp32 SSM state at 1e-4, the bf16 caches (attention keys and values,
conv tails) at 1e-2, the loss at 1e-5 and every gradient leaf at rtol
1e-4 / atol 1e-4 max|g| against ``jax.grad``, the decode-vs-prefill
continuation at the reference's own 2e-2.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import configs as jconfigs
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import Model as JModel
from repro.models import transformer as jtransformer
from repro.runtime import ServeConfig as JServeConfig
from repro.runtime import Server as JServer

from repro_torch import configs as tconfigs
from repro_torch.models import Model
from repro_torch.models import convert
from repro_torch.models import transformer as ttransformer
from repro_torch.runtime import ServeConfig, Server

ARCH = "jamba-v0.1-52b"
B, PLEN, NEW = 2, 12, 6
MAX_SEQ = PLEN + NEW + 8
KINDS = ("ssm_mlp", "ssm_moe", "attn_mlp")


def _cfgs(dtype="float32", **kw):
    over = dict(compute_dtype=dtype, param_dtype=dtype, **kw)
    return (jconfigs.get_reduced(ARCH).scaled(**over),
            tconfigs.get_reduced(ARCH).scaled(**over))


@functools.lru_cache(maxsize=None)
def _jparams():
    return jax.jit(lambda: JModel(_cfgs()[0]).init(0))()


def _np(a):
    return np.array(a, np.float32)


def _tparams(trainable=False):
    params = convert.from_reference(jax.tree.map(_np, _jparams()),
                                    _cfgs()[1], device="cpu")
    return params.requires_grad_(trainable)


def _leaves(tree):
    return {jax.tree_util.keystr(p): _np(a)
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _prompts(cfg, n=B, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, PLEN) for _ in range(n)]


def _ref_cache(jcache, cfg, i):
    """Layer i's entry of the reference's per-kind stacked cache."""
    sched, _, idx = ttransformer.layer_schedule(cfg)
    return {k: _np(v[idx[i]]) for k, v in jcache[sched[i]].items()}


def _check_cache(tcache, jcache, cfg):
    for i, c in enumerate(tcache):
        want = _ref_cache(jcache, cfg, i)
        assert set(c) == set(want)
        for k, w in want.items():
            fp32 = k == "s"
            assert c[k].dtype == (torch.float32 if fp32 else torch.bfloat16)
            tol = 1e-4 if fp32 else 1e-2
            np.testing.assert_allclose(c[k].float().numpy(), w, rtol=tol,
                                       atol=tol, err_msg=f"layer {i} {k}")


# ----------------------------------------------------------------------
# config, schedule, conversion
# ----------------------------------------------------------------------
def test_config_matches_reference():
    assert tconfigs.get(ARCH).__dict__ == jconfigs.get(ARCH).__dict__
    assert tconfigs.get_reduced(ARCH).__dict__ == jconfigs.get_reduced(
        ARCH).__dict__


@pytest.mark.parametrize("reduced", [False, True])
def test_layer_schedule_matches_reference(reduced):
    """The period-8 schedule: attention at position 4, the MoE on odd
    positions, a dense MLP elsewhere."""
    jc = jconfigs.get_reduced(ARCH) if reduced else jconfigs.get(ARCH)
    tc = tconfigs.get_reduced(ARCH) if reduced else tconfigs.get(ARCH)
    got = ttransformer.layer_schedule(tc)
    assert got == jtransformer.layer_schedule(jc)
    assert got[0][:8] == ["ssm_mlp", "ssm_moe", "ssm_mlp", "ssm_moe",
                          "attn_mlp", "ssm_moe", "ssm_mlp", "ssm_moe"]
    assert got[1] == list(KINDS)


def test_convert_round_trip():
    """The reference tree -> the port's modules -> the reference tree, bit
    for bit, the three kinds' stacks included; each layer's name maps to
    its kind's stack at its index within the kind."""
    _, tc = _cfgs()
    params = _tparams()
    named = dict(params.named_parameters())
    assert convert.reference_path("layers.12.mixer.wq", tc) == (
        ("layers", "attn_mlp", "mixer", "wq"), 1)
    assert convert.reference_path("layers.13.ffn.router", tc) == (
        ("layers", "ssm_moe", "ffn", "router"), 6)
    assert convert.reference_path("layers.6.mixer.A_log", tc) == (
        ("layers", "ssm_mlp", "mixer", "A_log"), 2)
    back = _leaves(convert.to_reference(named, tc))
    want = _leaves(_jparams())
    assert back.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_array_equal(back[k], w, err_msg=k)


def test_init_builds_every_kind():
    """``Model.init`` draws each layer by its kind: a Mamba-2 or GQA mixer,
    then an MLP or the MoE, with norm2 before either."""
    cfg = tconfigs.get_reduced(ARCH)
    params = Model(cfg).init(0, device="cpu")
    names = dict(params.named_parameters())
    assert "layers.0.mixer.wz" in names and "layers.0.ffn.w3" in names
    assert "layers.1.ffn.router" in names and "layers.1.norm2.scale" in names
    assert "layers.4.mixer.wq" in names and "layers.4.ffn.w1" in names
    want = _leaves(_jparams())
    assert {tuple(v.shape) for v in convert.to_reference(
        names, cfg)["layers"]["ssm_moe"]["ffn"].values()} == {
        w.shape for k, w in want.items() if "'ssm_moe'" in k and
        "'ffn'" in k}


# ----------------------------------------------------------------------
# serving
# ----------------------------------------------------------------------
def test_prefill_and_decode_logits_and_caches():
    """Prefill logits at 1e-4 and every layer's cache (the SSM state fp32
    at 1e-4; attention keys / values and conv tails, bf16, at 1e-2); then
    a decode step from the reference's own cache bytes at 1e-4."""
    jc, tc = _cfgs()
    toks = np.stack(_prompts(jc)).astype(np.int32)
    jm, tm = JModel(jc), Model(tc)
    jparams, tparams = _jparams(), _tparams()
    jl, jcache, jfill = jm.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                   cache_len=MAX_SEQ)
    with torch.inference_mode():
        tl, tcache, tfill = tm.prefill(
            tparams, {"tokens": torch.from_numpy(toks).long()},
            cache_len=MAX_SEQ)
    assert tfill == jfill and len(tcache) == tc.n_layers
    np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=1e-4, atol=1e-4)
    _check_cache(tcache, jcache, tc)
    nxt = np.argmax(_np(jl), -1)[:, None].astype(np.int32)
    jl2, jcache2 = jm.decode(jparams, jnp.asarray(nxt), jcache,
                             jnp.int32(jfill))
    with torch.inference_mode():
        for i, c in enumerate(tcache):
            for k, w in _ref_cache(jcache, tc, i).items():
                c[k].copy_(torch.from_numpy(w))
        tl2, tcache2 = tm.decode(tparams, torch.from_numpy(nxt).long(),
                                 tcache, tfill)
    np.testing.assert_allclose(tl2.numpy(), _np(jl2), rtol=1e-4, atol=1e-4)
    _check_cache(tcache2, jcache2, tc)


def test_chunked_prefill_at_eight_requests():
    """The config's prefill_microbatch 8 prefills 8 requests one a chunk:
    the reference's (chunked) logits at 1e-4, the unchunked prefill's at
    1e-4 and its caches (SSM states at 1e-4, bf16 leaves at 1e-2), the
    batch joined along every leaf's first axis."""
    jc, tc = _cfgs()
    assert tc.prefill_microbatch == 8
    toks = np.stack(_prompts(tc, 8)).astype(np.int32)
    jl, jcache, _ = JModel(jc).prefill(_jparams(),
                                       {"tokens": jnp.asarray(toks)},
                                       cache_len=24)
    params = _tparams()
    t = {"tokens": torch.from_numpy(toks).long()}
    with torch.inference_mode():
        l8, c8, _ = Model(tc).prefill(params, t, cache_len=24)
        l1, c1, _ = Model(tc.scaled(prefill_microbatch=1)).prefill(
            params, t, cache_len=24)
    np.testing.assert_allclose(l8.numpy(), _np(jl), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(l8.numpy(), l1.numpy(), atol=1e-4)
    _check_cache(c8, jcache, tc)
    for a, b in zip(c8, c1):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].shape == b[k].shape and a[k].shape[0] == 8
            tol = 1e-4 if k == "s" else 1e-2
            np.testing.assert_allclose(a[k].float().numpy(),
                                       b[k].float().numpy(), rtol=tol,
                                       atol=tol)


def test_decode_matches_prefill_continuation():
    """``tests/test_models.py``'s continuation on jamba: token 17 decoded
    from a 16-token prefill (bf16 keys, values and conv tails) matches a
    17-token prefill at 2e-2. Every expert gets room for all entries
    (capacity factor e / k), so the prefill drops none that the decode
    keeps, as the phi3.5-moe mirror does."""
    _, tc = _cfgs(capacity_factor=2.0)
    assert tc.capacity_factor == tc.n_experts / tc.top_k
    model = Model(tc)
    params = _tparams()
    t = torch.from_numpy(np.random.default_rng(3).integers(
        0, tc.vocab, (1, 17))).long()
    with torch.inference_mode():
        full, _, _ = model.prefill(params, {"tokens": t}, cache_len=32)
        _, cache, fill = model.prefill(params, {"tokens": t[:, :16]},
                                       cache_len=32)
        step, _ = model.decode(params, t[:, 16:17], cache, fill)
    np.testing.assert_allclose(full.numpy(), step[:, 0].numpy(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_generate_matches_reference(temperature):
    jc, tc = _cfgs()
    kw = dict(max_seq=MAX_SEQ, max_new_tokens=NEW, eos_token=-1,
              temperature=temperature, seed=5)
    want = JServer(jc, _jparams(), JServeConfig(**kw)).generate(
        _prompts(jc))
    got = Server(tc, _tparams(), ServeConfig(**kw)).generate(_prompts(tc))
    assert got["completions"] == want["completions"]
    assert all(len(c) == NEW for c in got["completions"])


def test_reduced_bf16_serves():
    """The reduced config at its own dtypes (bf16), ``Model.init``
    weights: finite logits through prefill and a decode step."""
    cfg = tconfigs.get_reduced(ARCH)
    model = Model(cfg)
    params = model.init(0, device="cpu")
    t = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 20))).long()
    with torch.inference_mode():
        logits, cache, fill = model.prefill(params, {"tokens": t},
                                            cache_len=24)
        logits, _ = model.decode(params, logits.argmax(-1)[:, None], cache,
                                 fill)
    assert logits.shape == (2, 1, cfg.padded_vocab)
    assert bool(torch.isfinite(logits.float()).all())


# ----------------------------------------------------------------------
# the loss and its gradients
# ----------------------------------------------------------------------
def test_loss_and_grads_match_reference():
    """The loss (cross-entropy + 0.01 x the MoE aux loss) at 1e-5 and every
    leaf's gradient against ``jax.grad``: the SSD backward of the Mamba-2
    layers, GQA's and the MoE's through one model."""
    jc, tc = _cfgs()
    batch = JSyntheticLM(jc, 2, 24, seed=4).batch_at(0)
    (jl, jm), jg = jax.jit(jax.value_and_grad(JModel(jc).loss, has_aux=True))(
        _jparams(), batch)
    tparams = _tparams(trainable=True)
    tl, tm = Model(tc).loss(tparams, {k: torch.from_numpy(np.array(v)).long()
                                      for k, v in batch.items()})
    named = dict(tparams.named_parameters())
    tg = dict(zip(named, torch.autograd.grad(tl, list(named.values()))))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tm["moe_aux"].detach()),
                               float(jm["moe_aux"]), rtol=1e-5)
    got = _leaves(jax.tree.map(lambda t: t.detach().numpy(),
                               convert.to_reference(tg, tc)))
    want = _leaves(jg)
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)


def test_launch_serve_jamba_on_cpu(capsys):
    from repro_torch.launch import serve as launch
    assert launch.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                        "--prompt-len", "8", "--new-tokens", "3", "--set",
                        "n_layers=8"]) == 0
    out = capsys.readouterr().out
    assert "tok/s" in out and out.count("req") == 2
