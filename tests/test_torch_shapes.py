"""The port's assigned shapes (``repro_torch.configs.shapes``) against the
reference's ``repro.configs.shapes``: for all ten configs and four
shapes, the same applicability and reasons, every input of the cell with
the shape and dtype of the reference's ``ShapeDtypeStruct`` (the decode
cache restacked into the reference's per-kind layout), and the same
parameter and active-parameter counts."""
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as ref_configs
from repro.configs import shapes as ref_shapes
from repro_torch import configs
from repro_torch.configs import shapes
from repro_torch.models import transformer

ARCHS = list(ref_configs._ALIASES)           # the ten configs by name
SHAPES = list(ref_shapes.SHAPES)
DTYPES = {jnp.dtype(jnp.int32): torch.int32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.float32): torch.float32}


def _same(spec, t):
    assert isinstance(t, torch.Tensor) and t.is_meta
    assert tuple(t.shape) == tuple(spec.shape)
    assert t.dtype == DTYPES[jnp.dtype(spec.dtype)]


def _stacked(cfg, cache):
    """The port's per-layer cache in the reference's layout: the
    encoder-decoder's (L, ...) leaves, or {kind: (count, ...) leaves}."""
    def stack(layers):
        return {k: (len(layers), *layers[0][k].shape, layers[0][k].dtype)
                for k in layers[0]}
    if cfg.encoder_decoder:
        return stack(cache)
    sched = transformer.layer_schedule(cfg)[0]
    return {kind: stack([c for c, s in zip(cache, sched) if s == kind])
            for kind in dict.fromkeys(sched)}


def _ref_stacked(tree):
    return jax.tree.map(lambda s: (*s.shape, DTYPES[jnp.dtype(s.dtype)]),
                        tree)


def test_shape_table_equal():
    assert list(shapes.SHAPES) == SHAPES
    for name, sh in ref_shapes.SHAPES.items():
        got = shapes.SHAPES[name]
        assert (got.name, got.seq_len, got.global_batch, got.kind) == (
            sh.name, sh.seq_len, sh.global_batch, sh.kind)
    assert configs.SHAPES is shapes.SHAPES
    assert configs.input_specs is shapes.input_specs
    assert configs.shape_applicable is shapes.shape_applicable


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_applicable_and_inputs_equal(arch, shape):
    ref_cfg, cfg = ref_configs.get(arch), configs.get(arch)
    assert shapes.shape_applicable(cfg, shape) == \
        ref_shapes.shape_applicable(ref_cfg, shape)
    want = ref_shapes.input_specs(ref_cfg, shape)
    got = shapes.input_specs(cfg, shape)
    assert sorted(got) == sorted(want)
    if "batch" in want:
        assert sorted(got["batch"]) == sorted(want["batch"])
        for k, spec in want["batch"].items():
            _same(spec, got["batch"][k])
        return
    _same(want["tokens"], got["tokens"])
    assert want["fill"].shape == () and isinstance(got["fill"], int)
    assert got["fill"] == ref_shapes.SHAPES[shape].seq_len - 1
    assert all(t.is_meta for c in got["cache"] for t in c.values())
    assert _stacked(cfg, got["cache"]) == _ref_stacked(want["cache"])


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal(arch):
    ref_cfg, cfg = ref_configs.get(arch), configs.get(arch)
    assert shapes.count_params(cfg) == ref_shapes.count_params(ref_cfg)
    assert shapes.active_params(cfg) == ref_shapes.active_params(ref_cfg)
    assert all(p.is_meta for p in shapes.param_specs(cfg).parameters())
