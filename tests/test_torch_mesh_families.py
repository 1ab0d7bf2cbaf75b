"""The model axis of the MoE, SSM, hybrid, encoder-decoder and VLM families
in the port, on the CPU with gloo, against the reference's single-device
step.

Reduced configs in fp32 with the sequence-parallel residual, each on a
(2, 4) mesh of 8 gloo ranks: deepseek-v2-lite-16b (MLA heads over
``model``, 8 experts over 4 ranks, a shared expert, grad_accum 4),
phi3.5-moe-42b (GQA, 4 experts over 4 ranks, grad_accum 2), mamba2-1.3b
(8 SSD heads over 4 ranks, the gated norm over all of d_inner),
jamba-v0.1-52b cut to one period of 8 layers (Mamba-2, GQA, MLP and MoE
layers, grad_accum 2), whisper-medium (LayerNorm, GELU MLPs, tied
embeddings, cross-attention) at its 64 frames and at 50 frames (which do
not divide over the model axis while the 32 decoder tokens do: the
encoder's residual is replicated, the decoder's sequence-parallel, as
whisper's 1500 frames over 8 ranks) and qwen2-vl-2b (M-RoPE on drawn
positions, the patch stub, the loss mask); jamba on a (2, 2, 2) mesh
over ("pod", "data", "model"); deepseek with 8 MLA heads and mamba2
on (1, 8), one expert and one SSD head a rank; and qwen2-vl's 4 heads
(2 kv heads) on (1, 8), where ranks 4-7 hold no head: they compute no
q, k or v columns, attend nothing and add a zero partial to ``wo``'s
sum, while taking part in every collective. All cases run in one world
of 8 ranks.

One step of the port's mesh step from the reference's ``Model.init(0)``
weights (``models/convert.py``) and the batch drawn from numpy seed 0
must give the loss and every parameter leaf of the reference's
``make_train_step(mesh=None)`` within 1e-4; the gradients the mesh step
hands its optimizer (``build_mesh_grad_fn``, gathered whole) are held
leaf by leaf against ``jax.grad`` of the reference's loss at a relative
L2 error of 1e-4 and their global norm at 1e-5 relative (the bounds of
``test_torch_mesh_train.py``). The reference runs while the ranks do.
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
F32 = dict(compute_dtype="float32", param_dtype="float32")
SEQ = 32
TOL = 1e-4
GRAD_RTOL = 1e-4
NORM_RTOL = 1e-5

#: case -> (arch, overrides, mesh shape)
CASES = {
    "deepseek_2x4": ("deepseek-v2-lite-16b", F32, (2, 4)),
    "phi35_moe_2x4": ("phi3.5-moe-42b-a6.6b", dict(F32, grad_accum=2),
                      (2, 4)),
    "mamba2_2x4": ("mamba2-1.3b", F32, (2, 4)),
    "jamba_2x4": ("jamba-v0.1-52b", dict(F32, n_layers=8, grad_accum=2),
                  (2, 4)),
    "whisper_2x4": ("whisper-medium", F32, (2, 4)),
    "whisper_enc50_2x4": ("whisper-medium", dict(F32, enc_seq=50), (2, 4)),
    "qwen2_vl_2x4": ("qwen2-vl-2b", F32, (2, 4)),
    "jamba_pod2x2x2": ("jamba-v0.1-52b", dict(F32, n_layers=8,
                                              grad_accum=2), (2, 2, 2)),
    "deepseek_1x8": ("deepseek-v2-lite-16b", dict(F32, n_heads=8), (1, 8)),
    "mamba2_1x8": ("mamba2-1.3b", F32, (1, 8)),
    "qwen2_vl_1x8": ("qwen2-vl-2b", F32, (1, 8)),
}


def _batch(cfg, s=SEQ, b=8):
    """Tokens and labels from numpy seed 0, then the stub inputs: the
    encoder-decoder's frame embeddings, the VLM's patch embeddings with a
    loss mask over the patches and drawn M-RoPE positions."""
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
def families(tmp_path_factory):
    """Every case's mesh step on one world of 8 ranks, started first; the
    reference's single-device step and ``jax.grad`` (each distinct
    config once) while it runs."""
    inits, cases = {}, []
    for arch, over, shape in CASES.values():
        key = (arch, tuple(sorted(over.items())))
        if key not in inits:
            cfg = jconfigs.get_reduced(arch).scaled(**over)
            params = jax.jit(lambda c=cfg: JModel(c).init(0))()
            inits[key] = (cfg, params, _batch(cfg))
        _, params, batch = inits[key]
        cases.append(dict(arch=arch, overrides=over, mesh_shape=shape,
                          tree=_np(params), batch=batch, opt=OPT))
    world = start_world(mesh_steps_rank, 8,
                        str(tmp_path_factory.mktemp("families")), cases)
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
    return {name: (res, refs[(arch, tuple(sorted(over.items())))])
            for (name, (arch, over, _)), res in zip(CASES.items(), got)}


@pytest.mark.parametrize("case", list(CASES))
def test_family_mesh_step_matches_single_device(families, case):
    """Loss and every parameter leaf after one step within 1e-4 of the
    reference's single-device step."""
    (loss, params, step, _, _), (ref_loss, ref_params, _, _) = \
        families[case]
    assert step == 1
    assert abs(loss - ref_loss) < TOL, (loss, ref_loss)
    g, w = _flat(params), _flat(ref_params)
    assert set(g) == set(w)
    errs = {k: float(np.abs(g[k] - w[k]).max()) for k in w}
    worst = max(errs, key=errs.get)
    assert errs[worst] < TOL, (worst, errs[worst])


@pytest.mark.parametrize("case", list(CASES))
def test_family_mesh_gradients_match_jax_grad(families, case):
    """The gradients the mesh step hands its optimizer, gathered whole:
    every leaf within a relative L2 error of 1e-4 of ``jax.grad`` of the
    reference's loss, the global norm (each replicated block counted
    once) within 1e-5 relative. A replicated leaf's gradient summed over
    ``model`` once too often (the MoE's aux loss through the router) or
    a norm over one rank's block of d_inner shows here."""
    (_, _, _, grads, gnorm), (_, _, want, wnorm) = families[case]
    g, w = _flat(grads), _flat(want)
    assert set(g) == set(w)
    errs = {k: float(np.linalg.norm(g[k] - w[k]))
            / max(float(np.linalg.norm(w[k])), 1e-30) for k in w}
    worst = max(errs, key=errs.get)
    assert errs[worst] < GRAD_RTOL, (worst, errs[worst])
    assert abs(gnorm - wnorm) <= NORM_RTOL * wnorm, (gnorm, wnorm)
