"""Context-parallel attention (``cfg.ctx_parallel``) in the port's mesh
step, on the CPU with gloo, against the reference's single-device step.

Reduced configs in fp32 on a (2, 4) mesh of 8 gloo ranks, all in one
world started before the reference runs: llama3-8b at 32 tokens with the
attention projections stored replicated (``ctx_replicate_weights``, the
reference's default) and stored sharded (gathered each layer); at 30
tokens, which do not divide over the model axis (the layer falls back to
the head split on the replicated weights); with ``sp_residual=False``
(the replicated residual split for the queries and the output
all-gathered); phi3.5-moe (GQA with the MoE FFN, grad_accum 2); jamba cut
to one period of 8 layers (its GQA layer context-parallel beside the
Mamba-2 layers, grad_accum 2); whisper at its 64 frames (the encoder's
self-attention not causal, the decoder's causal, cross-attention head
split) and qwen2-vl (M-RoPE on drawn positions, each rank rotating its
block of them).

One step from the reference's ``Model.init(0)`` weights
(``models/convert.py``) and the batch drawn from numpy seed 0 must give
the loss and every parameter leaf of the reference's
``make_train_step(mesh=None)`` within 1e-4; the gradients the mesh step
hands its optimizer (``build_mesh_grad_fn``, gathered whole) are held
leaf by leaf against ``jax.grad`` of the reference's loss at a relative
L2 error of 1e-4 and their global norm at 1e-5 relative: a replicated
projection's gradient summed over ``model`` twice, or not at all, shows
here. Each case also reports how many attention layers took the
context-parallel path and which parameters the mesh stores whole.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import Model as JModel
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import init_opt_state as jinit_opt_state
from repro.runtime.train import make_train_step as jmake_train_step
from torch_mesh_worker import join_world, mesh_steps_rank, start_world

OPT = dict(lr=1e-3)
CTX = dict(compute_dtype="float32", param_dtype="float32",
           ctx_parallel=True)
TOL = 1e-4
GRAD_RTOL = 1e-4
NORM_RTOL = 1e-5
ATTN = {"wq", "wk", "wv", "wo", "bq", "bk", "bv"}

#: case -> (arch, overrides, sequence length, context-parallel layers)
CASES = {
    "llama_replicated": ("llama3-8b", CTX, 32, True),
    "llama_sharded": ("llama3-8b", dict(CTX, ctx_replicate_weights=False),
                      32, True),
    "llama_seq30": ("llama3-8b", CTX, 30, False),
    "llama_no_sp": ("llama3-8b", dict(CTX, sp_residual=False), 32, True),
    "phi35_moe": ("phi3.5-moe-42b-a6.6b", dict(CTX, grad_accum=2), 32,
                  True),
    "jamba": ("jamba-v0.1-52b", dict(CTX, n_layers=8, grad_accum=2), 32,
              True),
    "whisper": ("whisper-medium", CTX, 32, True),
    "qwen2_vl": ("qwen2-vl-2b", CTX, 32, True),
}


def _batch(cfg, s, b=8):
    """Tokens and labels from numpy seed 0, then the stub inputs (the
    frame embeddings; the patch embeddings, a loss mask over the patches
    and drawn M-RoPE positions)."""
    rng = np.random.default_rng(0)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.encoder_decoder:
        out["enc_embeds"] = (rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.n_patches:
        out["img_embeds"] = (rng.standard_normal(
            (b, cfg.n_patches, cfg.d_model)) * 0.02).astype(np.float32)
        mask = np.ones((b, s), np.float32)
        mask[:, :cfg.n_patches] = 0.0
        out["loss_mask"] = mask
    if cfg.mrope:
        out["pos3"] = rng.integers(0, 4 * s, (3, b, s)).astype(np.int32)
    return out


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree, np.float32)}


@pytest.fixture(scope="module")
def ctx(tmp_path_factory):
    """Every case's mesh step on one world of 8 ranks, started first; the
    reference's single-device step and ``jax.grad`` (each distinct
    config and batch once, without ``ctx_parallel``, which the reference
    reads only under a mesh) while it runs."""
    inits, cases, keys = {}, [], []
    for arch, over, s, _ in CASES.values():
        ref_over = {k: v for k, v in over.items()
                    if k not in ("ctx_parallel", "ctx_replicate_weights",
                                 "sp_residual")}
        key = (arch, tuple(sorted(ref_over.items())), s)
        if key not in inits:
            cfg = jconfigs.get_reduced(arch).scaled(**ref_over)
            params = jax.jit(lambda c=cfg: JModel(c).init(0))()
            inits[key] = (cfg, params, _batch(cfg, s))
        _, params, batch = inits[key]
        keys.append(key)
        cases.append(dict(arch=arch, overrides=over, mesh_shape=(2, 4),
                          tree=_np(params), batch=batch, opt=OPT))
    world = start_world(mesh_steps_rank, 8,
                        str(tmp_path_factory.mktemp("ctx")), cases)
    refs = {}
    for key, (cfg, params, batch) in inits.items():
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        step = jax.jit(jmake_train_step(cfg, JAdamWConfig(**OPT), mesh=None))
        p, _, loss, _ = step(params, jinit_opt_state(params), jb)
        g = _np(jax.jit(jax.grad(
            lambda q: JModel(cfg).loss(q, jb)[0]))(params))
        norm = np.sqrt(sum(np.sum(v.astype(np.float64) ** 2)
                           for v in _flat(g).values()))
        refs[key] = (float(loss), _np(p), g, float(norm))
    got = join_world(world, timeout=600)[0]
    return {name: (res, refs[key])
            for name, res, key in zip(CASES, got, keys)}


@pytest.mark.parametrize("case", list(CASES))
def test_ctx_mesh_step_matches_single_device(ctx, case):
    """Loss and every parameter leaf after one step within 1e-4 of the
    reference's single-device step."""
    (loss, params, step, _, _, _), (ref_loss, ref_params, _, _) = ctx[case]
    assert step == 1
    assert abs(loss - ref_loss) < TOL, (loss, ref_loss)
    g, w = _flat(params), _flat(ref_params)
    assert set(g) == set(w)
    errs = {k: float(np.abs(g[k] - w[k]).max()) for k in w}
    worst = max(errs, key=errs.get)
    assert errs[worst] < TOL, (worst, errs[worst])


@pytest.mark.parametrize("case", list(CASES))
def test_ctx_mesh_gradients_match_jax_grad(ctx, case):
    """The gradients the mesh step hands its optimizer, gathered whole:
    every leaf within a relative L2 error of 1e-4 of ``jax.grad`` of the
    reference's loss, the global norm within 1e-5 relative."""
    (_, _, _, grads, gnorm, _), (_, _, want, wnorm) = ctx[case]
    g, w = _flat(grads), _flat(want)
    assert set(g) == set(w)
    errs = {k: float(np.linalg.norm(g[k] - w[k]))
            / max(float(np.linalg.norm(w[k])), 1e-30) for k in w}
    worst = max(errs, key=errs.get)
    assert errs[worst] < GRAD_RTOL, (worst, errs[worst])
    assert abs(gnorm - wnorm) <= NORM_RTOL * wnorm, (gnorm, wnorm)


@pytest.mark.parametrize("case", list(CASES))
def test_ctx_path_and_weight_layout(ctx, case):
    """The attention layers took the context-parallel path where the
    sequence divides over the model axis (and only there), and the
    attention projections are stored whole on every model rank exactly
    when ``ctx_replicate_weights`` (named_param_specs'
    ``replicate_attn``); the MLA / MoE / SSM weights keep their split."""
    (_, _, _, _, _, info), _ = ctx[case]
    arch, over, _, on = CASES[case]
    assert (info["ctx_calls"] > 0) == on, info["ctx_calls"]
    attn = {n for n in info["replicated"]
            if n.split(".")[-1] in ATTN and "ffn" not in n}
    if over.get("ctx_replicate_weights", True):
        assert attn and all(n.split(".")[-1] in ATTN
                            for n in attn), sorted(attn)
        assert {n.split(".")[-1] for n in attn} >= {"wq", "wk", "wv", "wo"}
    else:
        assert not attn, sorted(attn)
