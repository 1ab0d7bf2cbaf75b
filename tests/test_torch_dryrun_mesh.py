"""The dry run on meshes (``repro_torch.launch.dryrun``): one rank's step
traced under PyTorch's fake process group, with no card and no gloo
world.

* The wire model equals the reference's ``parse_collectives`` on each
  line of its own test's HLO sample; a group of one rank moves nothing.
* Rank 0's argument bytes on the fake (16, 16) and (2, 16, 16) meshes
  equal the per-device bytes of the reference's specs (``param_specs``,
  ``opt_state_specs``, ``batch_specs``, ``cache_specs``, blocks
  ceil-divided) for all ten full-size configs at ``train_4k`` and
  ``decode_32k``: params, ZeRO-1 master, m and v, and the batch, or the
  tokens and the cache.
* Reduced configs, one per family, on fake (1, 1), (2, 1), (2, 4) and
  (2, 2, 2) meshes: on (1, 1) the kernel calls and flops of the card's
  step and no wire bytes; on the others the kernel flops a rank counts
  are the card's over the ranks (the pod mesh one kind a family), and
  on (2, 4) ``delta_total`` of each family's first kind equals the
  direct count, collectives included.
* A DTensor matmul counts its local flops and bytes, and the
  collectives its redistribution issues.
* The production records of llama3-8b's decode_32k, and the GQA latent
  cache's refusal as an error record.

The collectives of a real gloo step against the fake trace are in
``test_torch_mesh_train.py``'s world.
"""
import functools
import json
import math

import numpy as np
import pytest
import torch

import jax

from repro import configs as jconfigs
from repro.configs import shapes as jshapes
from repro.distributed import sharding as rsh
from repro.launch.dryrun import (_COLL_RE, _GROUPS_LIST_RE, _GROUPS_RE,
                                 _shape_bytes, parse_collectives)
from repro.models import Model as JModel
from repro_torch import configs
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import dryrun
from repro_torch.perfmodel import gpu_roofline
from test_dryrun_tools import HLO_SAMPLE
from test_torch_dryrun import card_reduced

KINDS = ["all-gather", "reduce-scatter", "all-reduce", "all-to-all",
         "collective-permute"]
B, S = 8, 32


# ----------------------------------------------------------------------
# (a) the wire model
# ----------------------------------------------------------------------
def _sample_lines(kind):
    """(line, output bytes, group) of each sample line of ``kind``, read
    with the reference's own patterns (a line without replica groups: the
    reference's 2)."""
    out = []
    for line in HLO_SAMPLE.splitlines():
        m = _COLL_RE.search(line)
        if not m or m.group(2) != kind:
            continue
        gm, gl = _GROUPS_RE.search(line), _GROUPS_LIST_RE.search(line)
        group = (int(gm.group(2)) if gm else
                 len(gl.group(1).split(",")) if gl else 2)
        out.append((line, _shape_bytes(m.group(1)), group))
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_wire_model_equals_the_references(kind):
    lines = _sample_lines(kind)
    assert lines
    for line, nbytes, group in lines:
        want = parse_collectives(line)["wire_bytes_per_device"][kind]
        assert dryrun.wire_bytes(kind, nbytes, group) == pytest.approx(
            want, rel=1e-12)
        assert dryrun.wire_bytes(kind, nbytes, 1) == 0.0


# ----------------------------------------------------------------------
# (b) argument bytes against the reference's specs
# ----------------------------------------------------------------------
class _StandIn:
    """The reference mesh's ``shape`` (a mapping) and ``axis_names``."""

    def __init__(self, shape):
        self.axis_names = (("data", "model") if len(shape) == 2
                           else ("pod", "data", "model"))
        self.shape = dict(zip(self.axis_names, shape))


def _entry_size(entry, mesh) -> int:
    axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
    return math.prod(mesh.shape[a] for a in axes)


def _block(shape, spec, mesh):
    """Rank 0's block of a leaf: each dimension ceil-divided by the mesh
    axes its spec entry names."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return [-(-d // _entry_size(e, mesh)) for d, e in zip(shape, spec)]


def _specs_bytes(tree, specs, mesh, itemsize=None) -> int:
    leaves = jax.tree_util.tree_leaves(tree)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(leaves) == len(spec_leaves)
    return sum(math.prod(_block(a.shape, s, mesh))
               * (itemsize or np.dtype(a.dtype).itemsize)
               for a, s in zip(leaves, spec_leaves))


@functools.lru_cache(maxsize=None)
def _reference_params(arch: str):
    return jax.eval_shape(lambda: JModel(jconfigs.get(arch)).init(0))


def _reference_bytes(arch: str, shape_name: str, mshape):
    """Rank 0's bytes of the step's arguments by the reference's specs."""
    cfg = jconfigs.get(arch)
    mesh = _StandIn(mshape)
    sh = SHAPES[shape_name]
    params = _reference_params(arch)
    total = _specs_bytes(params, rsh.param_specs(
        params, replicate_attn=cfg.ctx_parallel
        and cfg.ctx_replicate_weights), mesh)
    if sh.kind == "train":
        total += 3 * _specs_bytes(params, rsh.opt_state_specs(mesh, params),
                                  mesh, itemsize=4)
        batch = jshapes.batch_specs(cfg, sh.global_batch, sh.seq_len)
        total += _specs_bytes(batch, rsh.batch_specs(mesh, batch), mesh)
    else:
        spec = jshapes.input_specs(cfg, shape_name)
        toks = {"tokens": spec["tokens"]}
        total += _specs_bytes(toks, rsh.batch_specs(mesh, toks), mesh)
        total += _specs_bytes(spec["cache"], rsh.cache_specs(
            mesh, spec["cache"], cfg), mesh)
    return total


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("shape_name", ["train_4k", "decode_32k"])
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_rank0_argument_bytes_equal_the_references_specs(arch, shape_name,
                                                         mesh):
    """The arguments are built, not traced. On (16, 16) mamba2-1.3b's and
    jamba's 1-D Mamba-2 leaves keep their optimizer state stacked
    (``sharding.opt_layout``), the layer axis over the data ranks, as the
    reference's ZeRO-1 rule splits it."""
    mshape = dryrun.PRODUCTION[mesh]
    want = _reference_bytes(arch, shape_name, mshape)
    cfg = configs.get(arch)
    with dryrun.fake_mesh(mshape) as m:
        _, args = dryrun._build_step(cfg, shape_name, m)
        got = dryrun._unique_bytes([
            list(a.parameters()) if isinstance(a, torch.nn.Module) else a
            for a in args])
    assert got == want, (got, want)


# ----------------------------------------------------------------------
# (c) one reduced config a family on small fake meshes
# ----------------------------------------------------------------------
FAMILIES = {"dense": "llama3-8b", "moe": "deepseek-v2-lite-16b",
            "ssm": "mamba2-1.3b", "hybrid": "jamba-v0.1-52b",
            "encdec": "whisper-medium", "vlm": "qwen2-vl-2b"}
CELLS = {"train": "train_4k", "prefill": "prefill_32k",
         "decode": "decode_32k"}


def _family_cfg(family: str):
    """The dry run's reduced config (card head dims); jamba one period
    of 8 layers. The mesh prefill fills its cache in one piece
    (``transformer.prefill``), so the card's step is held without
    chunked prefill."""
    cfg = card_reduced(FAMILIES[family]).scaled(prefill_microbatch=1)
    return cfg.scaled(n_layers=8) if family == "hybrid" else cfg


def _kinds(family: str):
    """jamba's training trace walks the SSD's plain backward of every
    Mamba-2 layer (seconds a trace): its serving steps stand for the
    family here; mamba2's training covers the SSD's."""
    return ["prefill", "decode"] if family == "hybrid" else list(CELLS)


@pytest.fixture(scope="module")
def card_counts():
    out = {}
    for family in FAMILIES:
        cfg = _family_cfg(family)
        for kind in _kinds(family):
            out[family, kind] = dryrun.count_cell(
                cfg, CELLS[kind], skip_delta=True, size=(B, S))["production"]
    return out


@pytest.mark.parametrize("family", list(FAMILIES))
def test_one_rank_mesh_counts_the_cards_kernels(card_counts, family):
    """(1, 1): the mesh step's kernel calls and flops are the card's, and
    its collectives (the norm's all-reduce on a 1-rank world) move
    nothing."""
    cfg = _family_cfg(family)
    for kind in _kinds(family):
        rec = dryrun.count_cell(cfg, CELLS[kind], skip_delta=True,
                                mesh_shape=(1, 1), size=(B, S))
        p, card = rec["production"], card_counts[family, kind]
        assert p["launches"] == card["launches"], kind
        assert p["kernel_flops"] == card["kernel_flops"], kind
        assert p["collectives"]["total_wire_bytes_per_device"] == 0
        assert p["memory"]["argument_bytes"] == \
            card["memory"]["argument_bytes"], kind


@pytest.mark.parametrize("mesh_shape", [(2, 1), (2, 4), (2, 2, 2)])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_rank_counts_on_more_ranks(card_counts, family, mesh_shape):
    """Every family's reduced blocks divide over the ranks, so rank 0's
    kernel flops times the ranks are the card's at the same global
    batch; training issues reduce-scatters and all-gathers (ZeRO-1, the
    sequence-parallel residual) over every axis of more than one rank,
    and moves nothing over one of one. On (2, 4) the delta method over 1
    and 2 periods gives the direct count, its wire bytes included, for
    the family's first kind (training where it has one); the pod mesh
    traces that kind alone, the others' counts being (2, 4)'s."""
    cfg = _family_cfg(family)
    names = ("data", "model") if len(mesh_shape) == 2 else (
        "pod", "data", "model")
    kinds = _kinds(family)
    for kind in kinds if len(mesh_shape) == 2 else kinds[:1]:
        delta_too = mesh_shape == (2, 4) and kind == kinds[0]
        rec = dryrun.count_cell(cfg, CELLS[kind], skip_delta=not delta_too,
                                mesh_shape=mesh_shape, size=(B, S))
        p = rec["production"]
        assert math.prod(mesh_shape) * p["kernel_flops"] == \
            card_counts[family, kind]["kernel_flops"], kind
        wire = p["collectives"]["total_wire_bytes_per_device"]
        if delta_too:
            delta = rec["delta_total"]
            assert delta["flops"] == p["flops"]
            assert delta["bytes_accessed"] == p["bytes_accessed"]
            assert delta["collective_wire_bytes_per_device"] == wire > 0
        if kind == "train":
            by_axis = p["collectives"]["wire_bytes_by_axis"]
            assert p["collectives"]["counts"]["reduce-scatter"] > 0
            assert p["collectives"]["counts"]["all-gather"] > 0
            for a, n in zip(names, mesh_shape):
                assert (by_axis.get(a, 0) > 0) == (n > 1), (a, by_axis)


# ----------------------------------------------------------------------
# (d) DTensor ops count their local work
# ----------------------------------------------------------------------
def test_dtensor_matmul_counts_its_local_work():
    """(256, 128) over data times (128, 16) over model on a fake (4, 4)
    mesh: the rank's (64, 128) x (128, 4) product, its bytes, and the two
    all-gathers that make the product whole."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.distributed import sharding as shd
    with dryrun.fake_mesh((4, 4)) as mesh:
        a = shd.as_dtensor(torch.empty((64, 128), device="meta"), mesh,
                           [Shard(0), Replicate()], (256, 128))
        b = shd.as_dtensor(torch.empty((128, 4), device="meta"), mesh,
                           [Replicate(), Shard(1)], (128, 16))
        rec = dryrun.trace(lambda x, y: x @ y, a, b, mesh=mesh)
        assert rec["flops"] == rec["aten_flops"] == 2 * 64 * 128 * 4
        assert rec["aten_bytes"] == (64 * 128 + 128 * 4 + 64 * 4) * 4
        assert rec["memory"]["argument_bytes"] == (64 * 128 + 128 * 4) * 4
        assert rec["memory"]["temp_bytes"] == 64 * 4 * 4
        assert rec["collectives"]["counts"] == {}
        rec = dryrun.trace(lambda x, y: (x @ y).full_tensor(), a, b,
                           mesh=mesh)
        assert rec["aten_flops"] == 2 * 64 * 128 * 4
        col = rec["collectives"]
        assert col["counts"] == {"all-gather": 2}
        assert sorted((op[3], op[4]) for op in col["ops"]) == \
            [(4, "data"), (4, "model")]
        want = sum(dryrun.wire_bytes("all-gather", op[2] * 4, op[3])
                   for op in col["ops"])
        assert col["total_wire_bytes_per_device"] == want > 0
        # the whole (256, 16) is the last all-gather's output
        assert max(op[2] for op in col["ops"]) == 256 * 16
        with pytest.raises(RuntimeError, match="fake process group only"):
            with dryrun.fake_mesh((2, 2)):
                pass


def test_attention_without_heads_counts_nothing():
    """A rank without heads: ``ops.attention`` tallies no call on the meta
    route, and on CPU tensors under autograd gives empty gradients that
    keep the rank's graph (and its collectives' backward) whole."""
    from repro_torch.kernels import ops
    q = torch.empty((2, 0, 16, 64), device="meta")
    ops.reset_dry()
    assert ops.attention(q, q, q).shape == (2, 0, 16, 64)
    assert ops.attention(q, q, q, kv_len=3, return_lse=True)[1].shape == \
        (2, 0, 16)
    assert not any(ops.dry()["calls"].values())
    w = torch.ones((4, 0), requires_grad=True)
    x = torch.ones((2, 16, 4))
    qc = (x @ w).reshape(2, 16, 0, 64).transpose(1, 2)
    o = ops.attention(qc, qc, qc)
    (o.transpose(1, 2).reshape(2, 16, 0) @ torch.ones((0, 4))).sum(
    ).backward()
    assert w.grad is not None and w.grad.shape == (4, 0)


# ----------------------------------------------------------------------
# (e), (f) production records
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_production_mesh_record(mesh, tmp_path):
    dryrun.main(["--arch", "llama3-8b", "--shape", "decode_32k", "--mesh",
                 mesh, "--skip-delta", "--out", str(tmp_path)])
    name = dryrun.mesh_name(dryrun.PRODUCTION[mesh])
    rows = gpu_roofline.roofline_table(str(tmp_path), mesh=name)
    assert len(rows) == 1 and not rows[0].get("skipped")
    with open(tmp_path / f"llama3-8b_decode_32k_{mesh}.json") as f:
        rec = json.load(f)
    assert rec["mesh"] == name and rec["rank"] == 0
    assert rec["n_devices"] == {"single": 256, "multi": 512}[mesh]
    assert rec["fits"] is True
    col = rec["production"]["collectives"]
    assert col["wire_bytes_per_device"]["all-gather"] > 0
    assert col["wire_bytes_per_device"]["all-reduce"] > 0
    assert col["wire_bytes_by_axis"]["model"] > 0
    assert {op[3] for op in col["ops"] if op[4] == "model"} == {16}
    r = rows[0]
    assert r["chips"] == rec["n_devices"]
    assert r["t_collective_s"] == pytest.approx(
        col["total_wire_bytes_per_device"] / gpu_roofline.LINK_BW)
    # 32 layers of the rank's (128 / data, 8, 2048, 128) blocks of k and v
    n_data = rec["n_devices"] // 16
    assert rec["production"]["memory"]["argument_bytes"] > \
        32 * 2 * (128 // n_data) * 8 * 2048 * 128 * 2


def test_gqa_latent_cache_traces(tmp_path):
    """``--set cache_shard=latent`` on a GQA arch traces: llama3-8b's
    decode_32k rank on 16x16 launches both kernels of the head_dim split
    once a layer and all-reduces each layer's fp32 partial logits (b 8,
    hq 32, 1 query, 32768 keys) over the 16 model ranks, at least 32 x 2
    x 15 / 16 x 33.5 MB = 2.01 GB of all-reduce wire a device, so the
    roofline's collective term bounds the step (``mesh_rows`` with the
    record's overrides); MLA's latent cache traces too."""
    dryrun.main(["--arch", "llama3-8b", "--shape", "decode_32k",
                 "--mesh", "single", "--skip-delta", "--set",
                 "cache_shard=latent", "--out", str(tmp_path)])
    with open(tmp_path / "llama3-8b_decode_32k_single_cache_shard-latent"
              ".json") as f:
        rec = json.load(f)
    assert rec["mesh"] == "16x16" and "error" not in rec
    assert rec["launches"]["attention_split_logits"] == 32
    assert rec["launches"]["attention_split_softmax_pv"] == 32
    assert "attention" not in rec["launches"]
    col = rec["production"]["collectives"]
    logits = 8 * 32 * 32768
    assert ["all-reduce", "float32", logits, 16, "model", 32] in col["ops"]
    want = 32 * 2 * 15 / 16 * logits * 4
    assert want == pytest.approx(2.01e9, rel=2e-3)
    assert col["wire_bytes_per_device"]["all-reduce"] >= want
    # the wire at NVLink's rate (~4.5 ms) bounds the step, not its bytes
    rows = gpu_roofline.mesh_rows(str(tmp_path), ("16x16",),
                                  {"cache_shard": "latent"})
    assert len(rows) == 1 and rows[0].endswith("(collective) |")
    assert gpu_roofline.mesh_rows(str(tmp_path), ("16x16",)) == []
    rec = dryrun.trace_cell("deepseek-v2-lite-16b", "decode_32k", "single",
                            {"cache_shard": "latent"}, skip_delta=True)
    assert "error" not in rec and rec["launches"]
