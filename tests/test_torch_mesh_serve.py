"""Prefill and decode on a (data, model) mesh in the port, the cache placed
as the reference's ``cache_specs`` places it, on the CPU with gloo,
against the reference's single-device ``Model.prefill`` /
``Model.decode``.

Reduced configs in fp32 on 8 gloo ranks, all in one world started before
the reference runs: llama3-8b on (2, 4) with the cache split by the
sequence (``cache_shard="seq"``: its 2 kv heads do not divide over 4
ranks) and by kv heads (4 kv heads, ``"heads"``), and on a (2, 2, 2) mesh
over ("pod", "data", "model"); deepseek-v2-lite (MLA) with the latent
split by the sequence and by its feature axes (``"latent"``), each in the
expanded and the absorbed form; mamba2 (the SSM state split by heads, the
x conv tail by d_inner); jamba cut to one period of 8 layers; whisper
(the cross-attention's keys and values split by frames) and qwen2-vl
(M-RoPE, the patch stub), also on (1, 8), where 4 of its ranks hold no
head; and the GQA caches split by head_dim (``cache_shard="latent"``:
llama3-8b on (2, 4), 2 kv heads on 4 ranks, 4 of its 16 head_dim
columns a rank, with the 2-token step; whisper's k / v and ck / cv on (2,
4); qwen2-vl on (1, 8), whose ranks without heads still compute every
head's partial logits), each leaf asserted ``Shard(3)``. A prompt of 30
tokens fills a cache of 64, so
with 4 model ranks the blocks are [0, 16), [16, 32), [32, 48), [48, 64):
the decode steps cross the boundary at 32, and the last block stays
empty; llama3-8b's steps include a 2-token step across it (its queries
fall in two blocks).

Prefill: the logits (the batch over the data axes, the vocabulary over
``model``, gathered) within 1e-4 of the reference's, and every cache leaf
gathered whole against the reference's cache. Each decode step runs on
the mesh's own cache and is held against the reference's decode from the
same cache bytes (the mesh's, gathered): logits within 1e-4 and every
leaf of the updated cache. The fp32 SSM state is held at 1e-4; the bf16
leaves at one bf16 rounding (2^-7 relative, 1e-4 absolute) with at most
1 % of the elements off by one: the two sides' fp32 values before the
rounding differ in their last bits (the mesh sums its products in other
orders), which moves a value that lies near a rounding boundary to the
neighbouring bf16. Each leaf's placements are its ``layer_cache_specs``,
and its block on a rank has the shape they give.

Without a world: the plain merge of partial ``(o, lse)`` pairs
(``combine_partials``) against the plain attention and
``flash_lse_plain`` over the whole cache, empty blocks included;
``attend_block`` over each block of a cache, queries before, inside and
past a block; ``ops.attention(return_lse=True)`` on CPU tensors; and the
per-layer cache specs against the reference's ``cache_specs`` for all ten
configs and the three ``cache_shard`` values.
"""
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.configs import shapes as ref_shapes
from repro.distributed import sharding as ref_shd
from repro.models import Model as JModel
from repro_torch import configs
from repro_torch.configs import shapes
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (flash_attention_plain,
                                                 flash_lse_plain)
from repro_torch.models import transformer
from repro_torch.models.attention import attend_block
from repro_torch.models.common import combine_partials
from torch_mesh_worker import join_world, mesh_serve_rank, start_world

F32 = dict(compute_dtype="float32", param_dtype="float32")
B, PLEN, CACHE = 4, 30, 64
TOL = 1e-4
BF16_RTOL = 2.0 ** -7
BF16_OFF = 0.01

#: case -> (arch, overrides, mesh shape, tokens of each decode step)
CASES = {
    "llama_seq": ("llama3-8b", F32, (2, 4), (1, 2, 1, 1)),
    "llama_heads": ("llama3-8b", dict(F32, n_kv_heads=4,
                                      cache_shard="heads"), (2, 4),
                    (1, 2, 1, 1)),
    "llama_pod": ("llama3-8b", F32, (2, 2, 2), (1, 2, 1, 1)),
    "deepseek_seq": ("deepseek-v2-lite-16b", F32, (2, 4), (1, 1, 1, 1)),
    "deepseek_seq_absorbed": ("deepseek-v2-lite-16b",
                              dict(F32, mla_absorb=True), (2, 4),
                              (1, 1, 1, 1)),
    "deepseek_latent": ("deepseek-v2-lite-16b",
                        dict(F32, cache_shard="latent"), (2, 4),
                        (1, 1, 1, 1)),
    "deepseek_latent_absorbed": ("deepseek-v2-lite-16b",
                                 dict(F32, cache_shard="latent",
                                      mla_absorb=True), (2, 4),
                                 (1, 1, 1, 1)),
    "mamba2": ("mamba2-1.3b", F32, (2, 4), (1, 1, 1, 1)),
    "jamba": ("jamba-v0.1-52b", dict(F32, n_layers=8), (2, 4),
              (1, 1, 1, 1)),
    "whisper": ("whisper-medium", F32, (2, 4), (1, 1, 1, 1)),
    "qwen2_vl": ("qwen2-vl-2b", F32, (2, 4), (1, 1, 1, 1)),
    "qwen2_vl_1x8": ("qwen2-vl-2b", F32, (1, 8), (1, 1, 1, 1)),
    "llama_latent": ("llama3-8b", dict(F32, cache_shard="latent"), (2, 4),
                     (1, 2, 1, 1)),
    "whisper_latent": ("whisper-medium", dict(F32, cache_shard="latent"),
                       (2, 4), (1, 1, 1, 1)),
    "qwen2_vl_1x8_latent": ("qwen2-vl-2b", dict(F32, cache_shard="latent"),
                            (1, 8), (1, 1, 1, 1)),
}
#: the GQA cases whose k / v (and whisper's ck / cv) split head_dim
LATENT = [c for c, (_, over, _, _) in CASES.items()
          if over.get("cache_shard") == "latent" and "deepseek" not in c]


def _inputs(cfg, steps):
    """The prompt batch and each step's tokens from numpy seed 0, with the
    stub inputs (frame embeddings; patch embeddings and M-RoPE
    positions)."""
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, PLEN)).astype(
        np.int32)}
    if cfg.encoder_decoder:
        batch["enc_embeds"] = (rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.n_patches:
        batch["img_embeds"] = (rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.mrope:
        batch["pos3"] = rng.integers(0, PLEN, (3, B, PLEN)).astype(np.int32)
    toks = [rng.integers(0, cfg.vocab, (B, n)).astype(np.int32)
            for n in steps]
    return batch, toks


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


def _layer_index(cfg):
    """(kind key or None, index in its stack) of each layer's cache in the
    reference's stacked cache."""
    if cfg.encoder_decoder:
        return [(None, i) for i in range(cfg.n_layers)]
    sched, _, idx = transformer.layer_schedule(cfg)
    return list(zip(sched, idx))


def _ref_layers(jcache, cfg):
    """The reference's stacked cache as the port's per-layer list (fp32
    numpy)."""
    out = []
    for kind, i in _layer_index(cfg):
        stack = jcache if kind is None else jcache[kind]
        out.append({k: np.asarray(v[i], np.float32)
                    for k, v in stack.items()})
    return out


def _to_ref(layers, like, cfg):
    """The port's per-layer cache (numpy) stacked as the reference's
    cache ``like``, in its dtypes."""
    def stack(tree, items):
        return {k: jnp.asarray(np.stack([layers[i][k] for i in items]),
                               tree[k].dtype) for k in tree}
    where = _layer_index(cfg)
    if cfg.encoder_decoder:
        return stack(like, range(len(layers)))
    return {kind: stack(like[kind], [j for j, (kk, _) in enumerate(where)
                                     if kk == kind]) for kind in like}


def _check_head_dim_split(res, case):
    """A GQA latent case's k / v (ck / cv) leaves are split by head_dim
    (``Shard(3)`` over ``model``), so the steps took the head_dim path,
    not the sequence split that ``cache_specs`` falls back to."""
    if case not in LATENT:
        return
    for i, dims in enumerate(res["model_dim"]):
        for k in ("k", "v", "ck", "cv"):
            if k in dims:
                assert dims[k] == 3, (case, i, k, dims[k])


def _check_cache(got, want, what):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), (what, i)
        for k in w:
            if k == "s":                   # the fp32 SSM state
                np.testing.assert_allclose(g[k], w[k], rtol=0, atol=TOL,
                                           err_msg=f"{what} layer {i} s")
                continue
            np.testing.assert_allclose(g[k], w[k], rtol=BF16_RTOL, atol=TOL,
                                       err_msg=f"{what} layer {i} {k}")
            off = np.mean(np.abs(g[k] - w[k]) > TOL)
            assert off <= BF16_OFF, (what, i, k, off)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Every case's mesh prefill and decode steps on one world of 8 ranks,
    started first; the reference's prefill of each case while it runs."""
    cases, refs = [], {}
    for name, (arch, over, shape, steps) in CASES.items():
        cfg = jconfigs.get_reduced(arch).scaled(**over)
        params = jax.jit(lambda c=cfg: JModel(c).init(0))()
        batch, toks = _inputs(cfg, steps)
        refs[name] = (cfg, params, batch, toks)
        cases.append(dict(arch=arch, overrides=over, mesh_shape=shape,
                          tree=_np(params), batch=batch, steps=toks,
                          cache_len=CACHE))
    world = start_world(mesh_serve_rank, 8,
                        str(tmp_path_factory.mktemp("serve")), cases)
    prefilled = {}
    for name, (cfg, params, batch, _) in refs.items():
        jl, jcache, jfill = JModel(cfg).prefill(
            params, {k: jnp.asarray(v) for k, v in batch.items()},
            cache_len=CACHE)
        prefilled[name] = (np.asarray(jl, np.float32), jcache, int(jfill))
    got = join_world(world, timeout=600)[0]
    return {name: (res, refs[name], prefilled[name])
            for name, res in zip(CASES, got)}


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_prefill_matches_reference(served, case):
    """The prefill's logits within 1e-4 of the reference's and its cache,
    gathered, against the reference's cache."""
    res, (cfg, _, _, _), (jl, jcache, jfill) = served[case]
    _check_head_dim_split(res, case)
    assert res["logits"][0].shape == jl.shape
    np.testing.assert_allclose(res["logits"][0], jl, rtol=0, atol=TOL)
    _check_cache(res["caches"][0], _ref_layers(jcache, cfg), "prefill")
    assert jfill == PLEN


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_decode_matches_reference(served, case):
    """Each decode step on the mesh's cache against the reference's decode
    (jitted, the fill traced) from the same cache bytes: logits within
    1e-4, every leaf of the updated cache."""
    res, (cfg, params, _, toks), (_, jcache, _) = served[case]
    _check_head_dim_split(res, case)
    jm = JModel(cfg)
    decode = jax.jit(lambda p, tok, c, f: jm.decode(
        p, tok, c, f, absorbed_mla=cfg.mla_absorb))
    fill = PLEN
    for t, tok in enumerate(toks):
        before = _to_ref(res["caches"][t], jcache, cfg)
        jl, jc = decode(params, jnp.asarray(tok), before, jnp.int32(fill))
        jl = np.asarray(jl, np.float32)
        assert res["logits"][t + 1].shape == jl.shape
        np.testing.assert_allclose(res["logits"][t + 1], jl, rtol=0,
                                   atol=TOL, err_msg=f"step {t}")
        _check_cache(res["caches"][t + 1], _ref_layers(jc, cfg),
                     f"step {t}")
        fill += tok.shape[1]


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_cache_layout(served, case):
    """Every leaf's placements are those of ``layer_cache_specs`` and its
    block on rank 0 has the shape they give: the batch over the data
    axes, one dimension over ``model`` (the sequence, the kv heads, the
    latent's feature axes, the SSM heads or d_inner)."""
    res, (cfg, _, _, _), _ = served[case]
    _check_head_dim_split(res, case)
    arch, over, shape, _ = CASES[case]
    axes = (("pod", "data", "model") if len(shape) == 3
            else ("data", "model"))
    mesh = types.SimpleNamespace(shape=dict(zip(axes, shape)),
                                 axis_names=axes)
    tcfg = configs.get_reduced(arch).scaled(**over)
    specs = shd.layer_cache_specs(
        mesh, [{k: v for k, v in c.items()} for c in res["caches"][0]], tcfg)
    for i, (lay, loc, full) in enumerate(zip(res["layout"], res["local"],
                                             res["caches"][0])):
        assert all(lay.values()), (i, lay)
        for k, spec in specs[i].items():
            want = list(full[k].shape)
            for d, entry in enumerate(spec):
                for a in shd._entry_axes(entry):
                    want[d] //= mesh.shape[a]
            assert list(loc[k]) == want, (i, k, spec)
    split = {k for s in specs for k, spec in s.items() if "model" in
             [a for e in spec for a in shd._entry_axes(e)]}
    assert split, "no leaf split over model"


# ----------------------------------------------------------------------
# The merge and the blocks, without a world
# ----------------------------------------------------------------------
def _qkv(b, hq, hkv, sq, skv, d, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32))
    return mk(b, hq, sq, d), mk(b, hkv, skv, d), mk(b, hkv, skv, d)


@pytest.mark.parametrize("sq,kv_len,blocks", [
    (1, 40, (0, 16, 32, 48, 64)),      # one query, the last block empty
    (2, 33, (0, 16, 32, 48, 64)),      # two queries across a boundary
    (3, 17, (0, 8, 16, 24, 64)),       # queries before a block's start
    (1, 64, (0, 64)),                  # one block
])
def test_attend_block_and_merge_equal_whole_cache(sq, kv_len, blocks):
    """``attend_block`` on every block of a 64-slot cache (queries at
    positions kv_len - sq + i) merged by ``combine_partials`` equals the
    plain attention over the whole cache, and the blocks' lse merged
    equals ``flash_lse_plain`` of the whole; a block with no valid key
    gives o 0 and lse -inf and no NaN."""
    q, k, v = _qkv(2, 8, 2, sq, 64, 16)
    parts = [attend_block(q, k[:, :, lo:hi], v[:, :, lo:hi], lo, hi,
                          kv_len - sq) for lo, hi in zip(blocks, blocks[1:])]
    o = torch.stack([p[0] for p in parts])
    lse = torch.stack([p[1] for p in parts])
    assert torch.isfinite(o).all()
    empty = [i for i, lo in enumerate(blocks[:-1]) if lo >= kv_len]
    for i in empty:
        assert (o[i] == 0).all() and torch.isneginf(lse[i]).all()
    got = combine_partials(o, lse)
    want = flash_attention_plain(q, k, v, causal=True, kv_len=kv_len)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    merged = torch.logsumexp(lse, 0)
    torch.testing.assert_close(
        merged, flash_lse_plain(q, k, causal=True, kv_len=kv_len),
        rtol=0, atol=1e-5)


def test_attention_return_lse_on_cpu():
    """``ops.attention(..., return_lse=True)`` on CPU tensors: the plain
    attention and ``flash_lse_plain`` at the same ``kv_len``, causal and
    not; a block without keys (kv_len 0) is refused."""
    q, k, v = _qkv(1, 4, 2, 2, 20, 16, seed=1)
    for causal in (True, False):
        o, lse = ops.attention(q, k, v, causal=causal, kv_len=13,
                               return_lse=True)
        torch.testing.assert_close(o, flash_attention_plain(
            q, k, v, causal=causal, kv_len=13), rtol=0, atol=0)
        torch.testing.assert_close(lse, flash_lse_plain(
            q, k, causal=causal, kv_len=13), rtol=0, atol=0)
    with pytest.raises(ValueError, match="kv_len 0"):
        ops.attention(q, k, v, kv_len=0, return_lse=True)


def test_combine_partials_weighs_empty_blocks_zero():
    """Rows whose every block is empty come out 0, not NaN; a row with
    one non-empty block takes its output as it is."""
    o = torch.zeros(3, 1, 1, 2, 4)
    lse = torch.full((3, 1, 1, 2), float("-inf"))
    o[1, ..., 0, :] = torch.arange(4.0)
    lse[1, ..., 0] = 0.5
    got = combine_partials(o, lse)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got[..., 0, :], o[1, ..., 0, :])
    assert (got[..., 1, :] == 0).all()


MESHES = {(16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model"),
          (2, 4): ("data", "model")}


@pytest.mark.parametrize("arch", list(jconfigs._ALIASES))
def test_layer_cache_specs_match_reference(arch):
    """Each layer's cache specs (``layer_cache_specs``) are the
    reference's ``cache_specs`` of the stacked leaf without its layer
    axis, for the full config's decode cache (batch 128 x 32768 slots) on
    the production meshes and (2, 4), in the three ``cache_shard``
    layouts."""
    ref_cfg, cfg = jconfigs.get(arch), configs.get(arch)
    ref_cache = ref_shapes.cache_specs(ref_cfg, 128, 32768)
    cache = shapes.cache_specs(cfg, 128, 32768)
    where = _layer_index(cfg)
    for shape, axes in MESHES.items():
        mesh = types.SimpleNamespace(shape=dict(zip(axes, shape)),
                                     axis_names=axes)
        for mode in ("seq", "heads", "latent"):
            want = ref_shd.cache_specs(mesh, ref_cache,
                                       ref_cfg.scaled(cache_shard=mode))
            got = shd.layer_cache_specs(mesh, cache,
                                        cfg.scaled(cache_shard=mode))
            for (kind, _), layer in zip(where, got):
                stack = want if kind is None else want[kind]
                assert set(layer) == set(stack)
                for k, spec in layer.items():
                    assert tuple(spec) == tuple(stack[k])[1:], (
                        shape, mode, kind, k)
