"""Sharding rules: DP / TP / EP / SP partition specs for every tree, the
counterpart of ``repro.distributed.sharding``, and their DTensor
placements.

The rules are the reference's, name for name, over the reference's
stacked layout (``models/convert.py``: a tree of nested dicts whose
per-layer leaves carry a leading layer axis). A spec is :class:`P`, a
tuple with one entry a dimension: None (replicated), a mesh axis name,
or a tuple of axis names (that dimension sharded over those axes, the
first major), as the reference's ``PartitionSpec``.

  * mesh axes: ("data", "model"), or ("pod", "data", "model"); ``pod``
    composes with ``data`` for the batch and the gradients.
  * TP (model axis): attention heads and the FFN hidden Megatron-style;
    vocab-parallel embed / unembed; MoE experts across model (EP);
    mamba's d_inner across model.
  * ZeRO-1: the optimizer state (fp32 master, m, v) also sharded over the
    data axes on the first dimension that divides evenly.
  * Activations: the batch over (pod, data); decode caches shard their
    sequence axis over model.

The port keeps one module per layer, so each per-layer leaf's spec is its
stacked leaf's spec without the leading layer axis (:func:`layer_specs`;
the rules are never run on per-layer ranks: a per-layer MoE expert leaf
is 3-D and would read as a dense MLP's). A spec becomes a list of DTensor
placements, one a mesh dimension (:func:`placements`): ``Shard(d)``
where the spec names that mesh axis on dimension d, else
``Replicate()``. Uneven dimensions split as ``torch.chunk`` splits them,
DTensor's rule (:func:`local_slices`).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Mapping, Sequence, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard


class P(tuple):
    """A partition spec: ``P(None, "model")``, ``P(("pod", "data"))``. An
    entry of one axis is that axis (``P(("data",)) == P("data")``), as
    the reference's ``PartitionSpec`` keeps it."""

    def __new__(cls, *dims):
        return super().__new__(cls, (
            d[0] if isinstance(d, tuple) and len(d) == 1 else d
            for d in dims))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh`` or of any object with the
    reference mesh's ``axis_names`` and ``shape`` (a mapping)."""
    if isinstance(mesh.shape, Mapping):
        return dict(mesh.shape)
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    return dict(zip(names, mesh.shape))


def _data_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)


def _map(fn: Callable, tree: Any, path: Tuple[str, ...] = ()) -> Any:
    """``fn(path, leaf)`` over a tree of nested mappings."""
    if isinstance(tree, Mapping):
        return {k: _map(fn, tree[k], path + (k,)) for k in tree}
    return fn(path, tree)


def _map2(fn: Callable, a: Any, b: Any) -> Any:
    if isinstance(a, Mapping):
        return {k: _map2(fn, a[k], b[k]) for k in a}
    return fn(a, b)


# name -> spec builder
_RULES = {
    # embeddings (vocab-parallel)
    "embed": lambda nd: _shard_last(nd, 0),         # (vocab, d)
    "unembed": lambda nd: _shard_last(nd, nd - 1),  # (d, vocab)
    # attention
    "wq": lambda nd: _shard_last(nd, nd - 1),
    "wk": lambda nd: _shard_last(nd, nd - 1),
    "wv": lambda nd: _shard_last(nd, nd - 1),
    "bq": lambda nd: _shard_last(nd, nd - 1),
    "bk": lambda nd: _shard_last(nd, nd - 1),
    "bv": lambda nd: _shard_last(nd, nd - 1),
    "wo": lambda nd: _shard_last(nd, nd - 2),       # (hd*h, d) row-parallel
    # MLA
    "wdkv": lambda nd: _replicate(nd),              # shared latent: small
    "wuk": lambda nd: _shard_last(nd, nd - 1),
    "wuv": lambda nd: _shard_last(nd, nd - 1),
    "kv_norm": lambda nd: _replicate(nd),
    # dense mlp
    "w1": lambda nd: _shard_last(nd, nd - 1),
    "w3": lambda nd: _shard_last(nd, nd - 1),
    "w2": lambda nd: _shard_last(nd, nd - 2),       # (ff, d) row-parallel
    # moe
    "router": lambda nd: _replicate(nd),
    # ssm
    "wz": lambda nd: _shard_last(nd, nd - 1),
    "wx": lambda nd: _shard_last(nd, nd - 1),
    "wb": lambda nd: _replicate(nd),
    "wc": lambda nd: _replicate(nd),
    "wdt": lambda nd: _shard_last(nd, nd - 1),
    "dt_bias": lambda nd: _shard_last(nd, nd - 1),
    "conv_x": lambda nd: _shard_last(nd, nd - 1),
    "conv_x_b": lambda nd: _shard_last(nd, nd - 1),
    "conv_b": lambda nd: _replicate(nd),
    "conv_b_b": lambda nd: _replicate(nd),
    "conv_c": lambda nd: _replicate(nd),
    "conv_c_b": lambda nd: _replicate(nd),
    "A_log": lambda nd: _shard_last(nd, nd - 1),
    "D": lambda nd: _shard_last(nd, nd - 1),
    "norm": lambda nd: _shard_last(nd, nd - 1),     # (d_inner,) gated norm
    "img_proj": lambda nd: _replicate(nd),
}

# keys inside moe expert stacks: leading expert dim -> EP over model
_MOE_EXPERT_KEYS = {"w1", "w2", "w3"}


def _shard_last(nd: int, dim: int) -> P:
    spec = [None] * nd
    spec[dim] = "model"
    return P(*spec)


def _replicate(nd: int) -> P:
    return P(*([None] * nd))


def _leaf_spec(path: Tuple[str, ...], leaf) -> P:
    nd = len(leaf.shape)
    name = path[-1]
    # moe experts: (..., E, d, ff), told from dense mlps (which share the
    # w1/w2/w3 names) by the extra expert axis (nd >= 4 once stacked)
    if (name in _MOE_EXPERT_KEYS and "ffn" in path
            and "shared" not in path and nd >= 4):
        spec = [None] * nd
        spec[nd - 3] = "model"                      # EP over the expert axis
        return P(*spec)
    if name in _RULES:
        return _RULES[name](nd)
    # norms / scalars / anything else: replicated
    return _replicate(nd)


_CTX_ATTN_KEYS = {"wq", "wk", "wv", "bq", "bk", "bv", "wo"}


def param_specs(params_shape: Any, replicate_attn: bool = False) -> Any:
    """Tree of :class:`P` matching a params (shape) tree in the stacked
    layout: leaves of any kind with a ``shape``.

    ``replicate_attn``: context-parallel layout, attention projections
    replicated so attention runs head-complete on local sequence
    shards."""
    def leaf(path, x):
        if replicate_attn and path[-1] in _CTX_ATTN_KEYS:
            return _replicate(len(x.shape))
        return _leaf_spec(path, x)
    return _map(leaf, params_shape)


# ----------------------------------------------------------------------
# Batches / caches / optimizer state
# ----------------------------------------------------------------------
def _axes_size(mesh, axes) -> int:
    sizes = axis_sizes(mesh)
    if axes is None:
        return 1
    if isinstance(axes, str):
        return sizes[axes]
    return math.prod(sizes[a] for a in axes)


def batch_specs(mesh, batch_shape: Any) -> Any:
    """Shard the leading batch axis over (pod, data) when divisible;
    pos3 carries the batch at axis 1."""
    da = _data_axes(mesh)
    nd_ = _axes_size(mesh, da)

    def spec(path, leaf):
        bax = 1 if path[-1] == "pos3" else 0
        s = [None] * len(leaf.shape)
        if leaf.shape[bax] % nd_ == 0:
            s[bax] = da
        return P(*s)
    return _map(spec, batch_shape)


def cache_specs(mesh, cache_shape: Any, cfg) -> Any:
    """Decode-cache sharding: attention KV / MLA latent caches shard the
    SEQUENCE axis over ``model`` (``cfg.cache_shard`` "heads" / "latent":
    the kv-head / trailing feature axis where it divides); SSM states
    shard heads / d_inner over ``model``; the batch over the data axes
    when divisible. Leaves are layer-stacked: (L|NP, B, ...)."""
    da = _data_axes(mesh)
    nd_ = _axes_size(mesh, da)
    nm = axis_sizes(mesh)["model"]
    SEQ_AXIS = {"k": 3, "v": 3, "ck": 3, "cv": 3, "c_kv": 2, "k_rope": 3}
    HEAD_AXIS = {"k": 2, "v": 2, "ck": 2, "cv": 2}
    FEAT_AXIS = {"k": 4, "v": 4, "ck": 4, "cv": 4, "c_kv": 3, "k_rope": 4}
    MODEL_AXIS = {"s": 2, "cx": 3}                  # ssm heads / d_inner

    def spec(path, leaf):
        shape = leaf.shape
        nd = len(shape)
        name = path[-1]
        s = [None] * nd
        if nd >= 2 and shape[1] % nd_ == 0:
            s[1] = da
        ax = MODEL_AXIS.get(name)
        if ax is None:
            mode = getattr(cfg, "cache_shard", "seq")
            cand = {"seq": SEQ_AXIS, "heads": HEAD_AXIS,
                    "latent": FEAT_AXIS}[mode].get(name)
            ax = (cand if (cand is not None and cand < nd
                           and shape[cand] % nm == 0)
                  else SEQ_AXIS.get(name))
        if ax is not None and ax < nd and shape[ax] % nm == 0:
            s[ax] = "model"
        return P(*s)
    return _map(spec, cache_shape)


def _zero1(shape, spec: P, da, n_data: int) -> P:
    """The param spec with its first evenly divisible unsharded dimension
    also sharded over the data axes."""
    dims = list(spec) + [None] * (len(shape) - len(spec))
    for i, (d, s) in enumerate(zip(shape, dims)):
        if s is None and d % n_data == 0 and d >= n_data:
            dims[i] = da
            break
    return P(*dims)


def opt_state_specs(mesh, params_shape: Any) -> Any:
    """ZeRO-1: take the param spec and additionally shard the first
    evenly-divisible unsharded dim over the data axes."""
    da = _data_axes(mesh)
    n_data = _axes_size(mesh, da)
    return _map2(lambda leaf, spec: _zero1(leaf.shape, spec, da, n_data),
                 params_shape, param_specs(params_shape))


def logical_out_specs(mesh, kind: str) -> P:
    """Common output specs: scalar losses replicated; decode logits
    sharded (batch over data, vocab over model)."""
    if kind == "loss":
        return P()
    return P(_data_axes(mesh), None, "model")


# ----------------------------------------------------------------------
# The port's per-layer leaves
# ----------------------------------------------------------------------
def _stacked_tree(named: Mapping[str, torch.Tensor], cfg) -> Dict[str, Any]:
    """The reference's stacked tree of ``named``'s shapes (meta)."""
    from repro_torch.models.convert import to_reference
    return to_reference({n: torch.empty(tuple(t.shape), device="meta")
                         for n, t in named.items()}, cfg)


def layer_specs(cfg, names: Sequence[str], stacked: Any) -> Dict[str, P]:
    """Each per-layer name's spec: its stacked leaf's spec in
    ``stacked`` (a tree of :class:`P`), without the leading layer axis
    for a layer's entry."""
    from repro_torch.models.convert import reference_path
    out = {}
    for name in names:
        path, idx = reference_path(name, cfg)
        spec = stacked
        for key in path:
            spec = spec[key]
        out[name] = spec if idx is None else P(*spec[1:])
    return out


def named_param_specs(cfg, named: Mapping[str, torch.Tensor],
                      replicate_attn=None) -> Dict[str, P]:
    """``{name: P}`` for a module's ``named_parameters()`` (full
    shapes), from the stacked rules. ``replicate_attn`` None: the
    config's layout, as the reference's dry run places the parameters
    (``cfg.ctx_parallel and cfg.ctx_replicate_weights``: the attention
    projections replicated)."""
    if replicate_attn is None:
        replicate_attn = cfg.ctx_parallel and cfg.ctx_replicate_weights
    return layer_specs(cfg, list(named), param_specs(
        _stacked_tree(named, cfg), replicate_attn))


def named_opt_specs(mesh, cfg, named: Mapping[str, torch.Tensor]
                    ) -> Dict[str, P]:
    """ZeRO-1 specs of the per-layer optimizer state: each leaf's param
    spec (:func:`named_param_specs`) with its own first evenly divisible
    unsharded dimension sharded over the data axes; the attention
    projections keep their sharded specs under ``ctx_parallel``, as
    ``opt_state_specs`` does in the reference's dry run. (The reference's
    stacked rule may pick the layer axis instead; a rank then holds whole
    layers' state where here it holds a slice of each layer's, the same
    bytes either way.)"""
    da = _data_axes(mesh)
    n_data = _axes_size(mesh, da)
    pspecs = named_param_specs(cfg, named, replicate_attn=False)
    return {n: _zero1(tuple(t.shape), pspecs[n], da, n_data)
            for n, t in named.items()}


class _Shape:
    """A leaf of a shape tree: ``shape`` alone."""

    def __init__(self, shape):
        self.shape = tuple(shape)


def layer_cache_specs(mesh, cache: Sequence[Mapping[str, Any]],
                      cfg) -> list:
    """``cache_specs`` of the port's cache, a list of per-layer dicts
    (``models/transformer.py:init_cache``; leaves with a ``shape``). The
    reference's specs index its layer-stacked leaves (L|NP, B, ...); a
    spec never splits the layer axis, so each per-layer leaf's spec is
    that of its leaf stacked one layer deep, ``(1, *shape)``, without the
    leading entry: the stacked sequence axis 3 of ``k`` is axis 2 of a
    layer's."""
    out = []
    for layer in cache:
        stacked = {k: _Shape((1, *v.shape)) for k, v in layer.items()}
        out.append({k: P(*spec[1:]) for k, spec in
                    cache_specs(mesh, stacked, cfg).items()})
    return out


# ----------------------------------------------------------------------
# Specs as DTensor placements
# ----------------------------------------------------------------------
def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: P, mesh) -> list:
    """One placement a mesh dimension: ``Shard(d)`` where ``spec`` shards
    tensor dimension d over that mesh axis, else ``Replicate()``. A
    dimension over several axes must name them in the mesh's order (the
    first major, as in the reference and in DTensor)."""
    names = list(axis_sizes(mesh))
    where = {}
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if [names.index(a) for a in axes] != sorted(names.index(a)
                                                     for a in axes):
            raise ValueError(f"{spec}: axes {axes} not in the mesh's order "
                             f"{tuple(names)}")
        for a in axes:
            if a in where:
                raise ValueError(f"{spec}: axis {a!r} used twice")
            where[a] = d
    return [Shard(where[a]) if a in where else Replicate() for a in names]


def local_slices(shape, placements_, sizes: Sequence[int],
                 coord: Sequence[int]) -> Tuple[slice, ...]:
    """The slices of a tensor of ``shape`` that the rank at mesh
    coordinate ``coord`` holds: mesh dimensions applied in order, each
    ``Shard(d)`` a ``torch.chunk`` of what is left of dimension d (the
    last chunks may be short or empty)."""
    lo, hi = [0] * len(shape), list(shape)
    for pl, n, c in zip(placements_, sizes, coord):
        if isinstance(pl, Shard):
            d = pl.dim
            size = -(-(hi[d] - lo[d]) // n)
            start = min(lo[d] + c * size, hi[d])
            lo[d], hi[d] = start, min(start + size, hi[d])
    return tuple(slice(a, b) for a, b in zip(lo, hi))


def _coord(mesh) -> list:
    return list(mesh.get_coordinate())


def local_part(t: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec`` on ``mesh`` (a view)."""
    return t[local_slices(t.shape, placements(spec, mesh), mesh.shape,
                          _coord(mesh))]


def _strides(shape) -> Tuple[int, ...]:
    out, acc = [], 1
    for d in reversed(tuple(shape)):
        out.append(acc)
        acc *= d
    return tuple(reversed(out))


def as_dtensor(local: torch.Tensor, mesh, placements_, shape) -> DTensor:
    """A DTensor of global ``shape`` from this rank's ``local`` block
    (no communication)."""
    return DTensor.from_local(local, mesh, placements_, run_check=False,
                              shape=torch.Size(shape),
                              stride=_strides(shape))


def distribute(t: torch.Tensor, mesh, spec: P) -> DTensor:
    """``t`` (the same on every rank) as a DTensor: each rank keeps a
    copy of its block."""
    return as_dtensor(local_part(t, spec, mesh).contiguous().clone(), mesh,
                      placements(spec, mesh), t.shape)


def _owner(module: nn.Module, name: str):
    *path, attr = name.split(".")
    for key in path:
        module = getattr(module, key)
    return module, attr


def shard_params(module: nn.Module, mesh, specs: Mapping[str, P]
                 ) -> nn.Module:
    """Replace each of ``module``'s full parameters (the same on every
    rank) by a DTensor parameter under its spec, in place; each rank keeps
    its block, the full tensor is dropped. Returns ``module``."""
    for name, p in list(module.named_parameters()):
        owner, attr = _owner(module, name)
        dt = distribute(p.detach(), mesh, specs[name])
        setattr(owner, attr, nn.Parameter(dt, requires_grad=p.requires_grad))
    return module


def gather_params(tensors) -> Dict[str, torch.Tensor]:
    """``{name: full tensor}`` of a module's DTensor parameters (or of a
    mapping of DTensors): every rank gathers every leaf (a collective)."""
    if isinstance(tensors, nn.Module):
        tensors = dict(tensors.named_parameters())
    return {n: (t.full_tensor() if isinstance(t, DTensor) else t).detach()
            for n, t in tensors.items()}

