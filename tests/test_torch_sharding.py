"""The port's sharding rules (``repro_torch.distributed.sharding``)
against the reference's ``repro.distributed.sharding``, with no process
group: the reference's functions read only a mesh's ``shape`` and
``axis_names``, so a stand-in serves for the production meshes' 256 and
512 devices. For all ten configs, full size (the reference's
``jax.eval_shape``, the port's meta device) and reduced, on (16, 16),
(2, 16, 16), (2, 4) and (4, 2): ``param_specs`` with and without
``replicate_attn``, ``opt_state_specs``, ``batch_specs``, ``cache_specs``
(seq, heads and latent) and ``logical_out_specs`` must be equal entry for
entry. Then the per-layer specs the port's modules take, and the specs'
DTensor placements and blocks."""
import types

import jax
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro import configs as ref_configs
from repro.configs import shapes as ref_shapes
from repro.distributed import sharding as ref_shd
from repro_torch import configs
from repro_torch.configs import shapes
from repro_torch.distributed import sharding as shd
from repro_torch.models import transformer
from repro_torch.models.convert import to_reference

ARCHS = list(ref_configs._ALIASES)
MESHES = {(16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model"),
          (2, 4): ("data", "model"), (4, 2): ("data", "model")}


def _mesh(shape):
    axes = MESHES[shape]
    return types.SimpleNamespace(shape=dict(zip(axes, shape)),
                                 axis_names=axes)


def _cfgs(arch, size):
    if size == "full":
        return ref_configs.get(arch), configs.get(arch)
    return ref_configs.get_reduced(arch), configs.get_reduced(arch)


def _ref_tree(tree):
    """A reference tree of PartitionSpecs as nested dicts of tuples."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    out = {}
    for path, spec in flat:
        node = out
        keys = [k.key for k in path]
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = tuple(spec)
    return out


def _port_tree(tree):
    if isinstance(tree, dict):
        return {k: _port_tree(v) for k, v in tree.items()}
    assert isinstance(tree, shd.P)
    return tuple(tree)


def _port_params(cfg):
    """The port's parameters on the meta device in the stacked layout."""
    named = dict(shapes.param_specs(cfg).named_parameters())
    return to_reference(named, cfg), named


def _stacked_cache(cfg, cache):
    """The port's per-layer meta cache stacked as the reference's."""
    def stack(layers):
        return {k: torch.empty((len(layers), *layers[0][k].shape),
                               device="meta") for k in layers[0]}
    if cfg.encoder_decoder:
        return stack(cache)
    sched = transformer.layer_schedule(cfg)[0]
    return {kind: stack([c for c, s in zip(cache, sched) if s == kind])
            for kind in dict.fromkeys(sched)}


@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_specs_equal_reference(arch, size):
    ref_cfg, cfg = _cfgs(arch, size)
    ref_params = ref_shapes.param_specs(ref_cfg)
    params, _ = _port_params(cfg)
    for replicate in (False, True):
        assert _port_tree(shd.param_specs(params, replicate)) == _ref_tree(
            ref_shd.param_specs(ref_params, replicate))
    for shape in MESHES:
        mesh = _mesh(shape)
        assert _port_tree(shd.opt_state_specs(mesh, params)) == _ref_tree(
            ref_shd.opt_state_specs(mesh, ref_params)), shape


@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_equal_reference(arch, size):
    """The training batch at 4096 and 4 x 2048 tokens (the odd batch of
    3 replicated), the decode cache of the assigned decode shape (full)
    or of batch 8 x 64 (reduced) in the three cache layouts."""
    ref_cfg, cfg = _cfgs(arch, size)
    b, s = (128, 32768) if size == "full" else (8, 64)
    for shape in MESHES:
        mesh = _mesh(shape)
        for bb, ss in ((256, 4096), (4, 2048), (3, 64)):
            want = ref_shd.batch_specs(mesh, ref_shapes.batch_specs(
                ref_cfg, bb, ss))
            got = shd.batch_specs(mesh, shapes.batch_specs(cfg, bb, ss))
            assert _port_tree(got) == _ref_tree(want), (shape, bb)
        ref_cache = ref_shapes.cache_specs(ref_cfg, b, s)
        cache = _stacked_cache(cfg, shapes.cache_specs(cfg, b, s))
        for mode in ("seq", "heads", "latent"):
            rc, c = (ref_cfg.scaled(cache_shard=mode),
                     cfg.scaled(cache_shard=mode))
            assert _port_tree(shd.cache_specs(mesh, cache, c)) == _ref_tree(
                ref_shd.cache_specs(mesh, ref_cache, rc)), (shape, mode)
        for kind in ("loss", "logits"):
            assert tuple(shd.logical_out_specs(mesh, kind)) == tuple(
                ref_shd.logical_out_specs(mesh, kind))


def test_per_layer_specs_drop_the_layer_axis():
    """A per-layer leaf takes its stack's spec without the layer axis:
    deepseek's (E, d, ff) experts EP over their expert axis (the rule
    would read a 3-D leaf as a dense MLP's), its shared experts and
    llama's MLP and attention Megatron-style, the embeddings
    vocab-parallel, norms replicated."""
    ds = configs.get_reduced("deepseek-v2-lite-16b")
    _, named = _port_params(ds)
    specs = shd.named_param_specs(ds, named)
    moe_layer = next(i for i in range(ds.n_layers) if ds.is_moe_layer(i))
    ffn = f"layers.{moe_layer}.ffn"
    assert named[f"{ffn}.w1"].ndim == 3
    assert specs[f"{ffn}.w1"] == shd.P("model", None, None)
    assert specs[f"{ffn}.w2"] == shd.P("model", None, None)
    assert specs[f"{ffn}.router"] == shd.P(None, None)
    assert specs[f"{ffn}.shared.w1"] == shd.P(None, "model")
    assert specs[f"{ffn}.shared.w2"] == shd.P("model", None)
    llama = configs.get("llama3-8b")
    _, named = _port_params(llama)
    specs = shd.named_param_specs(llama, named)
    assert specs["layers.5.mixer.wq"] == shd.P(None, "model")
    assert specs["layers.5.mixer.wo"] == shd.P("model", None)
    assert specs["layers.5.ffn.w1"] == shd.P(None, "model")
    assert specs["layers.5.ffn.w2"] == shd.P("model", None)
    assert specs["layers.5.norm1.scale"] == shd.P(None)
    assert specs["embed.embed"] == shd.P("model", None)
    assert specs["embed.unembed"] == shd.P(None, "model")
    assert specs["final_norm.scale"] == shd.P(None)
    attn = shd.named_param_specs(llama, named, replicate_attn=True)
    assert attn["layers.5.mixer.wq"] == shd.P(None, None)
    assert attn["layers.5.ffn.w1"] == shd.P(None, "model")


@pytest.mark.parametrize("shape", [(16, 16), (2, 16, 16)])
def test_per_layer_opt_specs_are_zero1_of_the_layer(shape):
    """Each per-layer optimizer leaf shards its first evenly divisible
    free dimension over the data axes (pod-major where there are two);
    what stays unsharded is what does not divide."""
    mesh = _mesh(shape)
    da = ("pod", "data") if len(shape) == 3 else ("data",)
    cfg = configs.get("llama3-8b")
    _, named = _port_params(cfg)
    specs = shd.named_opt_specs(mesh, cfg, named)
    assert specs["layers.0.mixer.wq"] == shd.P(da, "model")
    assert specs["layers.0.mixer.wo"] == shd.P("model", da)
    assert specs["layers.0.norm1.scale"] == shd.P(da)
    assert specs["embed.embed"] == shd.P("model", da)
    assert shd._zero1((7, 3), shd.P(None, None), da, 16) == shd.P(None, None)


def test_placements_and_blocks_follow_the_mesh_order():
    """``P(("pod", "data"), "model")`` on (2, 16, 16): dimension 0 over
    pod and data, pod-major, as JAX and DTensor both lay it out (the
    block of the rank at (p, d, m) is p * 16 + d); an uneven dimension
    splits as torch.chunk; a spec naming its axes out of the mesh's
    order or an axis twice is refused."""
    mesh = _mesh((2, 16, 16))
    pl = shd.placements(shd.P(("pod", "data"), "model"), mesh)
    assert pl == [Shard(0), Shard(0), Shard(1)]
    assert shd.placements(shd.P(None, None), mesh) == [Replicate()] * 3
    for p_, d_, m_ in ((0, 0, 0), (1, 3, 15), (0, 15, 7), (1, 15, 0)):
        sl = shd.local_slices((64, 32), pl, (2, 16, 16), (p_, d_, m_))
        blk = p_ * 16 + d_
        assert sl == (slice(2 * blk, 2 * blk + 2), slice(2 * m_, 2 * m_ + 2))
    sl = [shd.local_slices((10,), [Shard(0)], (4,), (c,))[0]
          for c in range(4)]
    assert [(s.start, s.stop) for s in sl] == [
        (a, b) for a, b in ((0, 3), (3, 6), (6, 9), (9, 10))]
    assert [len(c) for c in torch.arange(10).chunk(4)] == [
        s.stop - s.start for s in sl]
    with pytest.raises(ValueError, match="order"):
        shd.placements(shd.P(("data", "pod")), mesh)
    with pytest.raises(ValueError, match="twice"):
        shd.placements(shd.P("model", "model"), mesh)


def test_mesh_needs_a_process_group_of_its_size():
    """No process group: a mesh refuses to build; nothing falls back to
    one device."""
    from repro_torch.launch import mesh as tmesh
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh_for(8, 2, device_type="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_production_mesh(multi_pod=True, device_type="cpu")
    with pytest.raises(ValueError, match="split"):
        tmesh.make_mesh_for(6, 4, device_type="cpu")
