"""Elastic checkpoints in the port (``repro_torch.checkpoint.elastic``),
on the CPU.

The reference's three elastic cases (``tests/test_checkpoint.py``):
same shapes, a shape mismatch reported and refused, added state
tolerated only when not strict. Then, on 8 gloo ranks, reduced
``llama3-8b`` in fp32 through the sharded Trainer: one step on (4, 2)
saved, restored onto (2, 4) bit-exact (every leaf of the state each rank
reads as its blocks, gathered, equal to the saved one), the (2, 4)
continuation's loss within the reference's 2.5e-2 of the (4, 2)
continuation's (``tests/test_optimized_layouts.py``) and, tighter, within
1e-4; the sharded Trainer's checkpoint restored by the reference's
single-device ``CheckpointManager``, and the reference Trainer's
checkpoint resumed by the sharded one, both bit-exact; reduced mamba2's
checkpoint, its 1-D leaves' optimizer state stacked over the data
ranks, saved on (4, 2) and restored onto (2, 4) bit-exact."""
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import configs as jconfigs
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.models import Model as JModel
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import init_opt_state as jinit_opt_state
from repro.runtime import TrainConfig as JTrainConfig
from repro.runtime import Trainer as JTrainer
from repro_torch.checkpoint import (reshard_checkpoint, save_pytree,
                                    validate_compat)
from torch_mesh_worker import elastic_rank, run_world


def _tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(4, 8, generator=g),
            "nested": {"b": torch.randn(3, generator=g),
                       "c": torch.tensor(seed, dtype=torch.int32)}}


def test_elastic_reshard_same_shapes(tmp_path):
    t = _tree(7)
    save_pytree(t, str(tmp_path / "ck"))
    back = reshard_checkpoint(str(tmp_path / "ck"), t)
    assert torch.equal(back["a"], t["a"])
    assert torch.equal(back["nested"]["b"], t["nested"]["b"])
    assert int(back["nested"]["c"]) == 7


def test_elastic_detects_mismatch(tmp_path):
    t = _tree(7)
    save_pytree(t, str(tmp_path / "ck"))
    bad = {"a": torch.zeros(5, 8), "nested": t["nested"]}
    missing, mismatched = validate_compat(str(tmp_path / "ck"), bad)
    assert mismatched and not missing
    with pytest.raises(ValueError, match="mismatch"):
        reshard_checkpoint(str(tmp_path / "ck"), bad)


def test_elastic_tolerates_added_state(tmp_path):
    t = _tree(7)
    save_pytree(t, str(tmp_path / "ck"))
    bigger = dict(t)
    bigger["new_state"] = torch.zeros(2)
    with pytest.raises(ValueError, match="missing"):
        reshard_checkpoint(str(tmp_path / "ck"), bigger, strict=True)
    back = reshard_checkpoint(str(tmp_path / "ck"), bigger, strict=False)
    assert torch.equal(back["a"], t["a"])
    assert back["new_state"] is bigger["new_state"]


def _cfg():
    return jconfigs.get_reduced("llama3-8b").scaled(
        compute_dtype="float32", param_dtype="float32")


def _stored(path):
    """A checkpoint directory's leaves by name (numpy)."""
    with open(os.path.join(path, "manifest.json")) as f:
        return {m["name"]: np.load(os.path.join(path, f"leaf_{m['i']}.npy"))
                for m in json.load(f)}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}[{k!r}]"))
        return out
    return {prefix: np.asarray(tree)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The reference Trainer's one-step checkpoint, then the 8-rank
    world of :func:`elastic_rank`."""
    ref = str(tmp_path_factory.mktemp("ref"))
    JTrainer(_cfg(), JAdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10),
             JTrainConfig(steps=1, log_every=0, ckpt_every=1, ckpt_dir=ref,
                          resume="none", global_batch=8, seq_len=32,
                          multistream_plan=False)).run()
    work = str(tmp_path_factory.mktemp("w8"))
    out = run_world(elastic_rank, 8, work, work, ref)[0]
    out["ref_dir"], out["work"] = ref, work
    return out


def test_restore_onto_another_mesh_is_bit_exact(world):
    saved = _stored(os.path.join(world["work"], "a", "step_000000001"))
    got = _flat(world["b_restored"])
    assert world["b_step"] == 1
    assert set(got) == set(saved)
    for k, v in saved.items():
        assert got[k].tobytes() == v.astype(got[k].dtype).tobytes(), k


def test_stacked_optimizer_state_restores_onto_another_mesh(world):
    """Reduced mamba2's one-step (4, 2) checkpoint, whose 1-D Mamba-2
    leaves' optimizer state is stacked over 4 data ranks, restored onto
    (2, 4), stacked over 2: every leaf equal to the stored one."""
    saved = _stored(os.path.join(world["work"], "s", "step_000000001"))
    got = _flat(world["s_restored"])
    assert world["s_step"] == 1
    assert set(got) == set(saved)
    assert any("A_log" in k for k in saved)
    for k, v in saved.items():
        assert got[k].tobytes() == v.astype(got[k].dtype).tobytes(), k


def test_continuation_on_another_mesh(world):
    """(2, 4) resumed from the (4, 2) checkpoint continues as (4, 2)
    resumed from it: the step-2 losses within 2.5e-2 (the reference's
    bound) and within 1e-4."""
    assert world["b_resumed"] == world["c_resumed"] == 1
    (lb,), (lc,) = world["b_losses"], world["c_losses"]
    assert np.isfinite(lb) and abs(lb - lc) < 2.5e-2
    assert abs(lb - lc) < 1e-4


def test_reference_restores_the_sharded_checkpoint(world):
    """The reference's single-device CheckpointManager restores the
    sharded Trainer's (4, 2) checkpoint into its own state tree, every
    leaf equal to the stored one."""
    cfg = _cfg()
    params = jax.jit(lambda: JModel(cfg).init(0))()
    like = {"params": params, "opt": jinit_opt_state(params),
            "data_step": jnp.zeros((), jnp.int32)}
    restored, step = JCheckpointManager(
        os.path.join(world["work"], "a")).restore(like)
    assert step == 1
    saved = _stored(os.path.join(world["work"], "a", "step_000000001"))
    got = {jax.tree_util.keystr(p): np.asarray(a) for p, a in
           jax.tree_util.tree_flatten_with_path(restored)[0]}
    assert set(got) == set(saved)
    for k, v in saved.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert int(restored["data_step"]) == 1


def test_sharded_trainer_resumes_the_reference_checkpoint(world):
    """The sharded Trainer on (2, 4) resumes the reference Trainer's
    step-1 checkpoint: every leaf it restores equal to the stored one,
    and it runs on to step 2."""
    saved = _stored(os.path.join(world["ref_dir"], "step_000000001"))
    got = _flat(world["r_restored"])
    assert world["r_step"] == world["r_resumed"] == 1
    assert set(got) == set(saved)
    for k, v in saved.items():
        assert got[k].tobytes() == v.astype(got[k].dtype).tobytes(), k
    assert len(world["r_losses"]) == 1 and np.isfinite(world["r_losses"][0])
