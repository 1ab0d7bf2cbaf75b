"""The port's MLA, MoE and deepseek-v2-lite-16b serving path against the
JAX reference's, with the reference's own weights.

The reduced ``deepseek-v2-lite-16b`` config runs in fp32 (compute and
parameter dtype): weights come from the JAX ``Model(cfg).init(0)``
through ``convert.from_reference``, inputs from numpy. ``apply_moe``,
MLA (expanded and absorbed) and ``ops.attention`` at unequal head dims
match at 1e-5, prefill and decode logits at 1e-4 (as
``tests/test_torch_serve.py`` holds llama), ``Server.generate`` gives
equal completions. The router cases pin the bits that decide which
tokens an expert keeps: a capacity overflow (most tokens pick expert 0)
and an all-ties router (top-k takes ties in index order). The reference
tests mirrored here keep their own tolerances; the bf16 case states its
tolerance where it is used.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import configs as jconfigs
from repro.kernels import ops as jops
from repro.models import Model as JModel
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.runtime import ServeConfig as JServeConfig
from repro.runtime import Server as JServer

from repro_torch import configs as tconfigs
from repro_torch.kernels import ops as tops
from repro_torch.models import Model as TModel
from repro_torch.models import attention as tattn
from repro_torch.models import convert
from repro_torch.models import moe as tmoe
from repro_torch.runtime import ServeConfig, Server

ARCH = "deepseek-v2-lite-16b"
B, PLEN, NEW = 2, 12, 6
MAX_SEQ = PLEN + NEW + 8


def _cfgs(dtype="float32", **kw):
    over = dict(compute_dtype=dtype, param_dtype=dtype, **kw)
    return (jconfigs.get_reduced(ARCH).scaled(**over),
            tconfigs.get_reduced(ARCH).scaled(**over))


def _pair(dtype="float32", **kw):
    jcfg, tcfg = _cfgs(dtype, **kw)
    jparams = JModel(jcfg).init(0)
    tparams = convert.from_reference(jax.tree.map(np.asarray, jparams), tcfg,
                                     device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def fp32():
    return _pair()


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


def _np(a):
    return np.asarray(a, np.float32)


def _prompts(cfg, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, PLEN) for _ in range(B)]


# ----------------------------------------------------------------------
# config
# ----------------------------------------------------------------------
def test_config_matches_reference():
    assert tconfigs.get(ARCH).__dict__ == jconfigs.get(ARCH).__dict__
    assert tconfigs.get_reduced(ARCH).__dict__ == jconfigs.get_reduced(
        ARCH).__dict__
    assert "deepseek_v2_lite_16b" in tconfigs.ARCHS


def _n_params(cfg):
    """Parameters of an MLA + MoE decoder, from its config's shapes."""
    d, h, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    e, ffe = cfg.n_experts, cfg.d_ff_expert
    mla = d * h * (dn + dr) + d * (r + dr) + r * h * (dn + dv) + h * dv * d + r
    moe = d * e + 3 * e * d * ffe + 3 * d * ffe * cfg.n_shared_experts
    return cfg.n_layers * (mla + moe + 2 * d) + 2 * cfg.padded_vocab * d + d


def test_full_config_size(fp32):
    """The count formula holds on the reduced model ``Model.init`` and the
    converter build; the full model has ~15.8 B parameters in its layers
    and ~16.2 B in all, ~32.4 GB in bf16: one 80 GB card at full depth."""
    _, tcfg, _, tparams = fp32
    assert sum(p.numel() for p in tparams.parameters()) == _n_params(tcfg)
    made = TModel(tcfg).init(0, device="cpu")
    assert sum(p.numel() for p in made.parameters()) == _n_params(tcfg)
    full = tconfigs.get(ARCH)
    assert 16.1e9 < _n_params(full) < 16.3e9
    assert 2 * _n_params(full) < 33e9


# ----------------------------------------------------------------------
# MoE
# ----------------------------------------------------------------------
def _moe_pair(fp32, router=None):
    jcfg, tcfg, jparams, tparams = fp32
    jp = _layer0(jparams["layers"]["attn_moe"]["ffn"])
    tp = tparams.layers[0].ffn
    if router is not None:
        jp = dict(jp, router=jnp.asarray(router))
        tp = tmoe.MoE(torch.from_numpy(router), tp.w1, tp.w2, tp.w3,
                      tp.shared)
    return jcfg, tcfg, jp, tp


def _moe_check(jcfg, tcfg, jp, tp, x):
    jy, jaux = jmoe.apply_moe(jcfg, jp, jnp.asarray(x))
    ty, taux = tmoe.apply_moe(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), _np(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5,
                               atol=1e-6)
    return ty


@pytest.mark.parametrize("s", [1, 16, 37])
def test_apply_moe_matches_reference(fp32, s):
    """Output and aux loss at 1e-5 with the reference's layer-0 weights:
    decode (s 1: capacity top_k), a prefill chunk, a ragged length."""
    jcfg, tcfg, jp, tp = _moe_pair(fp32)
    x = np.random.default_rng(s).standard_normal(
        (3, s, jcfg.d_model)).astype(np.float32)
    _moe_check(jcfg, tcfg, jp, tp, x)


def test_apply_moe_capacity_overflow(fp32):
    """A router under which most tokens pick expert 0: more entries than
    its capacity, so the first-wins drop decides the output. The kept
    and dropped sets must be the reference's (a sort that is not stable
    keeps others and moves the output by O(1))."""
    jcfg, tcfg, jp, tp = _moe_pair(fp32)
    d, e = jcfg.d_model, jcfg.n_experts
    rng = np.random.default_rng(7)
    router = (rng.standard_normal((d, e)) * 0.02).astype(np.float32)
    router[:, 0] = 0.3
    x = (rng.standard_normal((2, 16, d)) + 0.5).astype(np.float32)
    jcfg, tcfg, jp, tp = _moe_pair(fp32, router)
    _, _, expert = tmoe.route(tcfg, tp, torch.from_numpy(x))
    cap = tmoe._capacity(tcfg, 16)
    picks = (expert == 0).sum((1, 2))
    assert bool((picks > cap).all()), (picks, cap)
    _moe_check(jcfg, tcfg, jp, tp, x)


def test_apply_moe_all_ties(fp32):
    """A zero router: every expert ties for every token, so top-k takes
    experts 0..k-1 (``jax.lax.top_k`` breaks ties toward the lower index)
    and both overflow their capacity."""
    jcfg, tcfg, jp, tp = _moe_pair(fp32, np.zeros(
        (fp32[0].d_model, fp32[0].n_experts), np.float32))
    x = np.random.default_rng(8).standard_normal(
        (2, 16, jcfg.d_model)).astype(np.float32)
    _, gate, expert = tmoe.route(tcfg, tp, torch.from_numpy(x))
    assert bool((expert == torch.arange(tcfg.top_k)).all())
    assert torch.allclose(gate, torch.full_like(gate, 1 / tcfg.top_k))
    _moe_check(jcfg, tcfg, jp, tp, x)


# ----------------------------------------------------------------------
# MLA
# ----------------------------------------------------------------------
def _mla_pair(fp32):
    jcfg, tcfg, jparams, tparams = fp32
    return (jcfg, tcfg, _layer0(jparams["layers"]["attn_moe"]["mixer"]),
            tparams.layers[0].mixer)


def test_mla_forward_matches_reference(fp32):
    jcfg, tcfg, jp, tp = _mla_pair(fp32)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 20, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(20)[None], (2, 20))
    jo, (jc, jr) = jattn.mla_forward(jcfg, jp, jnp.asarray(x),
                                     jnp.asarray(pos))
    to, (tc, tr) = tattn.mla_forward(tcfg, tp, torch.from_numpy(x),
                                     torch.from_numpy(pos.copy()))
    for t, j in ((to, jo), (tc, jc), (tr, jr)):
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(t.numpy(), _np(j), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("absorbed", [False, True])
def test_mla_decode_matches_reference(fp32, absorbed):
    """One decode step from the same bf16 latent cache (the reference's
    prefix, its bytes copied): the output at 1e-5 and the cache written
    at ``fill``, expanded and absorbed."""
    jcfg, tcfg, jp, tp = _mla_pair(fp32)
    rng = np.random.default_rng(10)
    b, fill, S = 2, 13, 24
    x = rng.standard_normal((b, fill + 1, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(fill + 1)[None], (b, fill + 1)).copy()
    _, (jc, jr) = jattn.mla_forward(jcfg, jp, jnp.asarray(x[:, :fill]),
                                    jnp.asarray(pos[:, :fill]))
    jcache = jattn.mla_init_cache(jcfg, b, S, jnp.bfloat16)
    jcache = {"c_kv": jcache["c_kv"].at[:, :fill].set(
        jc.astype(jnp.bfloat16)),
        "k_rope": jcache["k_rope"].at[:, :, :fill].set(
            jr.astype(jnp.bfloat16))}
    tcache = {k: torch.from_numpy(_np(v)).bfloat16()
              for k, v in jcache.items()}
    jo, jnew = jattn.mla_decode(jcfg, jp, jnp.asarray(x[:, fill:]),
                                jnp.asarray(pos[:, fill:]), jcache,
                                jnp.int32(fill), absorbed=absorbed)
    to, tnew = tattn.mla_decode(tcfg, tp, torch.from_numpy(x[:, fill:]),
                                torch.from_numpy(pos[:, fill:]), tcache,
                                fill, absorbed=absorbed)
    np.testing.assert_allclose(to.numpy(), _np(jo), rtol=1e-5, atol=1e-5)
    # the new entry rounds an fp32 latent to bf16: a 1e-7 difference at a
    # rounding boundary moves it by one bf16 ulp
    for k in ("c_kv", "k_rope"):
        np.testing.assert_allclose(tnew[k].float().numpy(), _np(jnew[k]),
                                   rtol=1e-2, atol=1e-2)


# ----------------------------------------------------------------------
# ops.attention at unequal head dims (q/k 48, v 32)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("sq,skv,kv_len", [(24, 24, None), (1, 30, 17),
                                           (5, 30, 22)])
def test_attention_unequal_head_dims_forward(sq, skv, kv_len):
    rng = np.random.default_rng(11)
    q = rng.standard_normal((2, 4, sq, 48)).astype(np.float32)
    k = rng.standard_normal((2, 2, skv, 48)).astype(np.float32)
    v = rng.standard_normal((2, 2, skv, 32)).astype(np.float32)
    want = jops.attention(*map(jnp.asarray, (q, k, v)), causal=True,
                          scale=0.17, kv_len=kv_len)
    got = tops.attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                         scale=0.17, kv_len=kv_len)
    assert tuple(got.shape) == (2, 4, sq, 32)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


def test_attention_unequal_head_dims_gradient():
    """Under autograd the port's route is the forward with lse and the
    flash-style backward's plain version; against ``jax.grad`` of the
    reference's ``ops.attention`` at 1e-5."""
    rng = np.random.default_rng(12)
    q = rng.standard_normal((1, 4, 24, 48)).astype(np.float32)
    k = rng.standard_normal((1, 2, 24, 48)).astype(np.float32)
    v = rng.standard_normal((1, 2, 24, 32)).astype(np.float32)
    w = rng.standard_normal((1, 4, 24, 32)).astype(np.float32)

    def jloss(q, k, v):
        return (jops.attention(q, k, v, causal=True, scale=0.2) * w).sum()
    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tops.attention(*ts, causal=True, scale=0.2)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), ts)
    for g, wt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(wt), rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------
def test_prefill_and_decode_logits_fp32(fp32):
    jcfg, tcfg, jparams, tparams = fp32
    toks = np.stack(_prompts(jcfg)).astype(np.int32)
    jm, tm = JModel(jcfg), TModel(tcfg)
    jl, jcache, jfill = jm.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                   cache_len=MAX_SEQ)
    with torch.inference_mode():
        tl, tcache, tfill = tm.prefill(
            tparams, {"tokens": torch.from_numpy(toks).long()},
            cache_len=MAX_SEQ)
    assert tfill == jfill and len(tcache) == tcfg.n_layers
    np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=1e-4, atol=1e-4)
    jc = jcache["attn_moe"]
    for i, c in enumerate(tcache):
        assert set(c) == {"c_kv", "k_rope"} and c["c_kv"].dtype == \
            torch.bfloat16
        for key in c:
            np.testing.assert_allclose(c[key].float().numpy(),
                                       _np(jc[key][i]), rtol=1e-2, atol=1e-2)
    # decode from the reference's own cache bytes (a bf16 cache rounds the
    # fp32 latent: a 1e-7 difference at a rounding boundary moves one
    # entry by a bf16 ulp)
    nxt = np.argmax(_np(jl), -1)[:, None].astype(np.int32)
    jl2, _ = jm.decode(jparams, jnp.asarray(nxt), jcache, jnp.int32(jfill))
    with torch.inference_mode():
        for i, c in enumerate(tcache):
            for key in c:
                c[key].copy_(torch.from_numpy(_np(jc[key][i])))
        tl2, _ = tm.decode(tparams, torch.from_numpy(nxt).long(), tcache,
                           tfill)
    np.testing.assert_allclose(tl2.numpy(), _np(jl2), rtol=1e-4, atol=1e-4)


def test_loss_matches_reference(fp32):
    """The fp32 ``Model.loss`` (cross-entropy + 0.01 x the MoE aux loss
    summed over the layers), forward only."""
    jcfg, tcfg, jparams, tparams = fp32
    rng = np.random.default_rng(13)
    toks = rng.integers(0, jcfg.vocab, (2, 16)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab, (2, 16)).astype(np.int32)
    jtot, jm = JModel(jcfg).loss(jparams, {"tokens": jnp.asarray(toks),
                                           "labels": jnp.asarray(labels)})
    with torch.no_grad():
        ttot, tm = TModel(tcfg).loss(tparams, {
            "tokens": torch.from_numpy(toks).long(),
            "labels": torch.from_numpy(labels).long()})
    assert float(tm["moe_aux"]) > 0
    for t, j in ((ttot, jtot), (tm["xent"], jm["xent"]),
                 (tm["moe_aux"], jm["moe_aux"])):
        np.testing.assert_allclose(float(t), float(j), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_generate_matches_reference_fp32(fp32, temperature):
    jcfg, tcfg, jparams, tparams = fp32
    kw = dict(max_seq=MAX_SEQ, max_new_tokens=NEW, eos_token=-1,
              temperature=temperature, seed=5)
    want = JServer(jcfg, jparams, JServeConfig(**kw)).generate(
        _prompts(jcfg))
    got = Server(tcfg, tparams, ServeConfig(**kw)).generate(_prompts(jcfg))
    assert got["completions"] == want["completions"]
    assert all(len(c) == NEW for c in got["completions"])


def test_convert_round_trip(fp32):
    """The reference tree -> the port's modules -> the reference tree, bit
    for bit, MLA and MoE leaves (the shared experts' subtree) included;
    every port parameter maps to a reference leaf."""
    jcfg, tcfg, jparams, tparams = fp32
    named = dict(tparams.named_parameters())
    assert "layers.2.ffn.shared.w3" in named
    assert convert.reference_path("layers.1.mixer.wuk", tcfg) == (
        ("layers", "attn_moe", "mixer", "wuk"), 1)
    back = convert.to_reference(named, tcfg)
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    flat_t = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), back)))
    assert len(flat_j) == len(flat_t)
    for path, leaf in flat_j:
        np.testing.assert_array_equal(flat_t[path], np.asarray(leaf))


def test_convert_round_trip_bf16():
    """bf16 leaves load into bf16 parameters and come back with the same
    bits."""
    jcfg, tcfg = _cfgs("bfloat16")
    jparams = JModel(jcfg).init(1)
    tparams = convert.from_reference(jax.tree.map(np.asarray, jparams), tcfg,
                                     device="cpu")
    assert tparams.layers[0].ffn.w1.dtype == torch.bfloat16
    back = convert.to_reference(dict(tparams.named_parameters()), tcfg)
    ref = jparams["layers"]["attn_moe"]
    for name, t in (("w2", back["layers"]["attn_moe"]["ffn"]["w2"]),
                    ("wdkv", back["layers"]["attn_moe"]["mixer"]["wdkv"])):
        leaf = ref["ffn"][name] if name == "w2" else ref["mixer"][name]
        np.testing.assert_array_equal(t.float().numpy(), _np(leaf))


# ----------------------------------------------------------------------
# mirrors of the reference's own tests (their tolerances)
# ----------------------------------------------------------------------
def test_decode_matches_prefill_continuation(fp32):
    """tests/test_models.py::test_decode_matches_prefill_continuation on
    deepseek: decoding token s+1 from a prefilled (bf16) latent cache
    matches prefilling s+1 tokens, at 2e-2. At the config's capacity
    (1.25) the 17-token prefill drops entries that a one-token decode
    keeps, in the reference as in the port (a 2.147 logit gap in both),
    so this mirror gives every expert room for all entries: capacity
    factor e / k."""
    _, tcfg, _, tparams = fp32
    tcfg = tcfg.scaled(capacity_factor=tcfg.n_experts / tcfg.top_k)
    model = TModel(tcfg)
    toks = np.random.default_rng(3).integers(0, tcfg.vocab, (1, 17))
    t = torch.from_numpy(toks).long()
    with torch.inference_mode():
        full, _, _ = model.prefill(tparams, {"tokens": t}, cache_len=32)
        _, cache, fill = model.prefill(tparams, {"tokens": t[:, :16]},
                                       cache_len=32)
        step, _ = model.decode(tparams, t[:, 16:17], cache, fill)
    np.testing.assert_allclose(full.numpy(), step[:, 0].numpy(), rtol=2e-2,
                               atol=2e-2)


def test_mla_absorbed_equals_expanded(fp32):
    """tests/test_optimized_layouts.py::test_mla_absorbed_equals_expanded:
    the absorbed decode's logits equal the expanded one's at 1e-3."""
    _, tcfg, _, tparams = fp32
    model = TModel(tcfg)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, tcfg.vocab, (2, 16))).long()
    tok = torch.from_numpy(rng.integers(0, tcfg.vocab, (2, 1))).long()
    with torch.inference_mode():
        _, cache, fill = model.prefill(tparams, {"tokens": toks},
                                       cache_len=24)
        l1, _ = model.decode(tparams, tok, [dict(c) for c in cache], fill)
        cache2 = [{k: v.clone() for k, v in c.items()} for c in cache]
        l2, _ = model.decode(tparams, tok, cache2, fill, absorbed_mla=True)
    np.testing.assert_allclose(l1.numpy(), l2.numpy(), rtol=1e-3, atol=1e-3)


def test_prefill_microbatch_parity(fp32):
    """tests/test_system.py::test_prefill_microbatch_parity on deepseek
    (whose config sets prefill_microbatch 2): chunked prefill gives the
    plain one's logits at 1e-4 and its bf16 caches at 1e-2."""
    _, tcfg, _, tparams = fp32
    assert tcfg.prefill_microbatch == 2
    m1 = TModel(tcfg.scaled(prefill_microbatch=1))
    m2 = TModel(tcfg)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, tcfg.vocab, (4, 16))).long()
    with torch.inference_mode():
        l1, c1, _ = m1.prefill(tparams, {"tokens": toks}, cache_len=24)
        l2, c2, _ = m2.prefill(tparams, {"tokens": toks}, cache_len=24)
    np.testing.assert_allclose(l1.numpy(), l2.numpy(), atol=1e-4)
    for a, b in zip(c1, c2):
        for k in a:
            assert a[k].shape == b[k].shape
            np.testing.assert_allclose(a[k].float().numpy(),
                                       b[k].float().numpy(), rtol=1e-2,
                                       atol=1e-2)


# ----------------------------------------------------------------------
# bf16 and the launcher
# ----------------------------------------------------------------------
def test_bf16_moe_and_mla_layers():
    """The served dtype on one layer, the same bf16 inputs to both: the MoE
    (bf16 expert products, the combine's scatter-add in bf16, whose order
    of adds may differ) and MLA's forward agree within 3e-2, a few bf16
    ulps of outputs of order 1."""
    jcfg, tcfg, jparams, tparams = _pair("bfloat16")
    rng = np.random.default_rng(14)
    x = rng.standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).bfloat16()
    lj = jparams["layers"]["attn_moe"]
    jy, _ = jmoe.apply_moe(jcfg, _layer0(lj["ffn"]), xj)
    ty, _ = tmoe.apply_moe(tcfg, tparams.layers[0].ffn, xt)
    assert ty.dtype == torch.bfloat16
    np.testing.assert_allclose(ty.float().numpy(), _np(jy), rtol=3e-2,
                               atol=3e-2)
    pos = np.broadcast_to(np.arange(16)[None], (2, 16)).copy()
    jo, _ = jattn.mla_forward(jcfg, _layer0(lj["mixer"]), xj,
                              jnp.asarray(pos))
    to, _ = tattn.mla_forward(tcfg, tparams.layers[0].mixer, xt,
                              torch.from_numpy(pos))
    np.testing.assert_allclose(to.float().numpy(), _np(jo), rtol=3e-2,
                               atol=3e-2)


def test_launch_serve_deepseek_on_cpu(capsys):
    from repro_torch.launch import serve as launch
    assert launch.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                        "--prompt-len", "8", "--new-tokens", "3"]) == 0
    out = capsys.readouterr().out
    assert "tok/s" in out and out.count("req") == 2
