"""The mirror of ``tests/test_models.py`` for the port, over all ten
architectures of the registry: each config equals the reference's (full
and reduced), each reduced config trains (a finite, positive loss and
finite gradients) and serves (prefill and one decode step, finite
logits of the padded vocabulary's width) on the CPU in its own dtypes,
and each full config's parameter count, the model built on the meta
device (shapes only), equals the reference's ``jax.eval_shape`` count
(``configs.shapes.count_params``).
"""
import numpy as np
import pytest

import torch

from repro import configs as jconfigs

from repro_torch import configs as tconfigs
from repro_torch.models import Model

ARCHS = sorted(tconfigs.ARCHS)


def _batch(cfg, b=2, s=32, seed=0):
    """tests/test_models.py's batch: tokens and labels, the frame or patch
    embeddings (bf16) and the patches' loss mask."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (b, s))),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)))}
    if cfg.encoder_decoder:
        batch["enc_embeds"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model)) * 0.02).to(torch.bfloat16)
    if cfg.n_patches:
        batch["img_embeds"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.n_patches, cfg.d_model)) * 0.02).to(torch.bfloat16)
        mask = np.ones((b, s), np.float32)
        mask[:, :cfg.n_patches] = 0
        batch["loss_mask"] = torch.from_numpy(mask)
    return batch


def test_registry_matches_reference():
    assert sorted(tconfigs.ARCHS) == sorted(jconfigs.ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    assert tconfigs.get(arch).__dict__ == jconfigs.get(arch).__dict__
    assert tconfigs.get_reduced(arch).__dict__ == jconfigs.get_reduced(
        arch).__dict__


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_smoke_train(arch):
    cfg = tconfigs.get_reduced(arch)
    model = Model(cfg)
    params = model.init(0, device="cpu", trainable=True)
    loss, metrics = model.loss(params, _batch(cfg))
    grads = torch.autograd.grad(loss, list(params.parameters()))
    loss = float(loss.detach())
    assert np.isfinite(loss) and loss > 0, arch
    assert set(metrics) == {"xent", "moe_aux"}
    assert all(bool(torch.isfinite(g).all()) for g in grads), arch


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_smoke_decode(arch):
    cfg = tconfigs.get_reduced(arch)
    model = Model(cfg)
    params = model.init(0, device="cpu")
    b, s = 2, 32
    with torch.inference_mode():
        logits, cache, fill = model.prefill(params, _batch(cfg, b, s),
                                            cache_len=s + 8)
        assert logits.shape == (b, cfg.padded_vocab)
        tok = logits.argmax(-1)[:, None]
        logits2, _ = model.decode(params, tok, cache, fill)
    assert logits2.shape == (b, 1, cfg.padded_vocab)
    assert bool(torch.isfinite(logits2.float()).all()), arch


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_param_count(arch):
    """The full config built on the meta device: the reference's count
    (all archs above 0.5 B parameters, as tests/test_models.py holds)."""
    cfg = tconfigs.get(arch)
    params = Model(cfg).init(0, device="meta")
    assert {p.device.type for p in params.parameters()} == {"meta"}
    n = sum(p.numel() for p in params.parameters())
    assert n == jconfigs.shapes.count_params(jconfigs.get(arch)), arch
    assert n > 0.5e9
