"""The port's training path (``Model.loss``, ``build_step_fn``,
``Trainer``, ``SyntheticLM``, checkpoints) against the JAX reference's,
on the reduced mamba2-1.3b config.

Weights come from the reference's ``Model(cfg).init(0)`` through
``convert.from_reference``; batches from ``SyntheticLM.batch_at`` (numpy
in both). fp32 (``compute_dtype`` and ``param_dtype``) is the tight
check; the bf16 check has the looser tolerance stated where it is used:
the reference's ``ref`` backend runs its SSD chunked form with bf16
intra-chunk operands where the port (like the reference's Pallas kernel)
computes in fp32.
"""
import functools
import json
import os
import shutil
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import configs as jconfigs
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.checkpoint import load_pytree as jload_pytree
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import Model as JModel
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import init_opt_state as jinit_opt_state
from repro.runtime import TrainConfig as JTrainConfig
from repro.runtime import Trainer as JTrainer
from repro.runtime.train import build_step_fn as jbuild_step_fn

from repro_torch import configs as tconfigs
from repro_torch.checkpoint import CheckpointManager, load_pytree, save_pytree
from repro_torch.data import SyntheticLM
from repro_torch.models import Model
from repro_torch.models.convert import (from_reference, named_from_reference,
                                        to_reference)
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.runtime import TrainConfig, Trainer, build_step_fn
from repro_torch.runtime.serve import check_mesh_serve
from repro_torch.runtime.train import make_train_step

ARCH = "mamba2-1.3b"
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=20)


def _cfgs(dtype="float32", **kw):
    return tuple(m.get_reduced(ARCH).scaled(compute_dtype=dtype,
                                            param_dtype=dtype, **kw)
                 for m in (jconfigs, tconfigs))


@functools.lru_cache(maxsize=None)
def _init32():
    return JModel(_cfgs()[0]).init(0)


def _jparams(dtype="float32"):
    """The reference's ``Model(cfg).init(0)``, drawn once: its bf16
    weights are the fp32 draws cast, as its init casts them."""
    return jax.tree.map(lambda a: a.astype(dtype), _init32())


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _tbatch(batch):
    return {k: torch.from_numpy(np.array(v)).long() for k, v in batch.items()}


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(a, np.float32)
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _ported(tree, cfg):
    """The port's named tensors as the reference's tree, leaf by name."""
    return {jax.tree_util.keystr(p): a.detach().float().numpy()
            for p, a in jax.tree_util.tree_flatten_with_path(
                to_reference(tree, cfg))[0]}


def test_config_matches_reference():
    assert tconfigs.get(ARCH).__dict__ == jconfigs.get(ARCH).__dict__
    jc, tc = _cfgs()
    assert tc.__dict__ == jc.__dict__
    assert (tc.d_inner, tc.ssm_heads) == (jc.d_inner, jc.ssm_heads)


def test_batches_match_reference():
    jc, tc = _cfgs()
    for host in (0, 1):
        jd = JSyntheticLM(jc, 4, 32, seed=9, host_id=host, n_hosts=2)
        td = SyntheticLM(tc, 4, 32, seed=9, host_id=host, n_hosts=2)
        for step in (0, 3):
            jb, tb = jd.batch_at(step), td.batch_at(step)
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(tb[k].numpy(),
                                              np.asarray(jb[k]))


def test_prefetch_iterator_yields_batch_at_in_order():
    _, tc = _cfgs()
    data = SyntheticLM(tc, 2, 16, seed=1)
    it = iter(data)
    for step in range(3):
        assert torch.equal(next(it)["tokens"], data.batch_at(step)["tokens"])
    data.close()
    assert data.state.step == 3


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def loss_pair(request):
    jc, tc = _cfgs(request.param)
    jparams = _jparams(request.param)
    batch = JSyntheticLM(jc, 2, 64, seed=1).batch_at(0)
    (jl, jm), jg = jax.jit(jax.value_and_grad(JModel(jc).loss, has_aux=True))(
        jparams, batch)
    tparams = from_reference(_np(jparams), tc, device="cpu")
    tparams.requires_grad_(True)
    tl, tm = Model(tc).loss(tparams, _tbatch(batch))
    named = dict(tparams.named_parameters())
    tg = torch.autograd.grad(tl, list(named.values()))
    return (request.param, tc, (float(jl), _np(jm), _leaves(jg)),
            (float(tl.detach()), {k: float(v.detach()) for k, v in tm.items()},
             _ported(dict(zip(named, tg)), tc)))


def test_loss_and_grads_match_reference(loss_pair):
    dtype, _, (jl, jm, jg), (tl, tm, tg) = loss_pair
    assert set(tm) == {"xent", "moe_aux"} and tm["moe_aux"] == 0.0
    assert set(tg) == set(jg)
    if dtype == "float32":
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        np.testing.assert_allclose(tm["xent"], float(jm["xent"]), rtol=1e-5)
        for k, want in jg.items():
            np.testing.assert_allclose(tg[k], want, rtol=1e-4,
                                       atol=1e-4 * np.abs(want).max(),
                                       err_msg=k)
        return
    # bf16: loss measured 2.3e-4 relative apart, each leaf's gradient at
    # most 0.13 apart in relative L2 norm (the reference rounds its SSD
    # intra-chunk operands to bf16, the port does not); held at 1e-3 and
    # 0.25
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    for k, want in jg.items():
        rel = np.linalg.norm(tg[k] - want) / np.linalg.norm(want)
        assert rel < 0.25, (k, rel)


def test_dense_loss_matches_reference_on_cpu():
    """The same loss_fn takes the dense ``attn_mlp`` kind (on CPU tensors;
    tests/test_torch_dense_train.py holds its gradients)."""
    jc, tc = (m.get_reduced("llama3-8b").scaled(
        compute_dtype="float32", param_dtype="float32")
        for m in (jconfigs, tconfigs))
    jparams = jax.jit(lambda: JModel(jc).init(0))()
    batch = JSyntheticLM(jc, 2, 16, seed=5).batch_at(0)
    want, _ = jax.jit(JModel(jc).loss)(jparams, batch)
    tparams = from_reference(_np(jparams), tc, device="cpu")
    got, _ = Model(tc).loss(tparams, _tbatch(batch))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_chunked_xent_matches_reference():
    """The sequence-chunked cross-entropy (a loop here, a scan in the
    reference) with and without a mask, against the reference's."""
    from repro.models.common import chunked_xent as jchunked_xent
    from repro_torch.models.common import Embed, chunked_xent
    jc, tc = _cfgs(logits_chunk=8)
    rng = np.random.default_rng(4)
    emb = {"embed": rng.standard_normal((tc.padded_vocab, tc.d_model)),
           "unembed": 0.1 * rng.standard_normal((tc.d_model,
                                                 tc.padded_vocab))}
    emb = {k: v.astype(np.float32) for k, v in emb.items()}
    h = rng.standard_normal((2, 32, tc.d_model)).astype(np.float32)
    labels = rng.integers(0, tc.vocab, (2, 32))
    mask = (rng.random((2, 32)) > 0.3).astype(np.float32)
    temb = Embed(*(torch.from_numpy(emb[k]) for k in ("embed", "unembed")))
    for m in (None, mask):
        want = jchunked_xent(jc, emb, jnp.asarray(h), jnp.asarray(labels),
                             None if m is None else jnp.asarray(m))
        got = chunked_xent(tc, temb, torch.from_numpy(h),
                           torch.from_numpy(labels),
                           None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_remat_none_gives_the_same_loss_and_grads():
    """``remat="none"`` keeps the activations, ``"full"`` recomputes
    them and ``"dots"`` keeps only the products' outputs: the same loss
    and gradients every way."""
    _, tc = _cfgs(n_layers=2)
    batch = SyntheticLM(tc, 2, 32, seed=3).batch_at(0)
    params = Model(tc).init(0, device="cpu", trainable=True)
    out = []
    for remat in ("full", "none", "dots"):
        loss, _ = Model(tc.scaled(remat=remat)).loss(params, batch)
        out.append([loss, *torch.autograd.grad(loss,
                                               list(params.parameters()))])
    for other in out[1:]:
        for a, b in zip(out[0], other):
            assert torch.equal(a, b)


@pytest.mark.parametrize("accum", [1, 2])
def test_step_fn_matches_reference(accum):
    """One build_step_fn step (fp32), with and without microbatch
    accumulation: loss, new params and the optimizer state."""
    jc, tc = _cfgs(grad_accum=accum)
    jparams = _jparams()
    batch = JSyntheticLM(jc, 4, 32, seed=2).batch_at(0)
    jp, js, jl, _ = jax.jit(jbuild_step_fn(jc, JAdamWConfig(**OPT)))(
        jparams, jinit_opt_state(jparams), batch)
    tparams = from_reference(_np(jparams), tc, device="cpu")
    tparams.requires_grad_(True)
    tp, ts, tl, _ = build_step_fn(tc, AdamWConfig(**OPT))(
        tparams, init_opt_state(dict(tparams.named_parameters())),
        _tbatch(batch))
    assert tp is tparams and ts["step"] == int(js["step"]) == 1
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    # the first AdamW step moves each weight by about lr * sign(g): a
    # gradient within rounding of 0 may move the other way
    lr1 = 1e-3 / 2
    want = _leaves(jp)
    for k, got in _ported(dict(tp.named_parameters()), tc).items():
        np.testing.assert_allclose(got, want[k], rtol=1e-5, atol=2 * lr1,
                                   err_msg=k)
    for part in ("m", "v"):
        want = _leaves(js[part])
        for k, got in _ported(ts[part], tc).items():
            np.testing.assert_allclose(got, want[k], rtol=1e-3,
                                       atol=1e-3 * np.abs(want[k]).max(),
                                       err_msg=f"{part}{k}")


# ----------------------------------------------------------------------
# Trainer and checkpoints, both ways
# ----------------------------------------------------------------------
STEPS, RESUME_AT = 4, 2


def _tcfg(cls, d, **kw):
    return cls(steps=STEPS, log_every=0, ckpt_every=RESUME_AT, ckpt_dir=d,
               global_batch=2, seq_len=32, multistream_plan=False, **kw)


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference Trainer for STEPS steps (checkpoints every
    RESUME_AT), and a checkpoint of its initial state at step 0."""
    jc, tc = _cfgs()
    root = tmp_path_factory.mktemp("ref_train")
    run = JTrainer(jc, JAdamWConfig(**OPT), _tcfg(JTrainConfig,
                                                  str(root / "run"))).run()
    jparams = _jparams()
    JCheckpointManager(str(root / "init"), async_save=False).save(
        0, {"params": jparams, "opt": jinit_opt_state(jparams),
            "data_step": jnp.int32(0)})
    return jc, tc, root, run


def _port_trainer(tc, d):
    return Trainer(tc, AdamWConfig(**OPT), _tcfg(TrainConfig, d),
                   device="cpu")


def test_trainer_losses_match_reference(reference_run, tmp_path):
    """The port's Trainer, started from the reference's initial state
    (its step-0 checkpoint), gives the reference Trainer's losses."""
    jc, tc, root, run = reference_run
    d = tmp_path / "ckpt"
    shutil.copytree(root / "init", d)
    r = _port_trainer(tc, str(d)).run()
    assert r["resumed_from"] == 0 and r["bad_steps"] == 0
    np.testing.assert_allclose(r["losses"], run["losses"], rtol=1e-4)


def test_port_resumes_reference_checkpoint(reference_run, tmp_path):
    """The reference's step-RESUME_AT checkpoint resumes in the port and
    continues the reference's loss stream; the port's last checkpoint
    then loads in the reference's ``load_pytree`` and matches the
    reference's own."""
    jc, tc, root, run = reference_run
    d = tmp_path / "ckpt"
    d.mkdir()
    name = f"step_{RESUME_AT:09d}"
    shutil.copytree(root / "run" / name, d / name)
    r = _port_trainer(tc, str(d)).run()
    assert r["resumed_from"] == RESUME_AT
    np.testing.assert_allclose(r["losses"], run["losses"][RESUME_AT:],
                               rtol=1e-4)
    last = f"step_{STEPS:09d}"
    with open(d / last / "manifest.json") as f:
        port_names = [m["name"] for m in json.load(f)]
    with open(root / "run" / last / "manifest.json") as f:
        assert port_names == [m["name"] for m in json.load(f)]
    like = {"params": run["params"], "opt": run["opt"],
            "data_step": jnp.zeros((), jnp.int32)}
    got = _leaves(jload_pytree(str(d / last), like))
    want = _leaves(jload_pytree(str(root / "run" / last), like))
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(w).max(), 1e-30),
                                   err_msg=k)


def test_checkpoint_round_trip_keeps_dtypes(tmp_path):
    _, tc = _cfgs("bfloat16")
    params = Model(tc).init(0, device="cpu")
    tree = {"params": to_reference(dict(params.named_parameters()), tc),
            "data_step": torch.tensor(5, dtype=torch.int32)}
    save_pytree(tree, str(tmp_path / "c"))
    with open(tmp_path / "c" / "manifest.json") as f:
        dtypes = {m["name"]: m["dtype"] for m in json.load(f)}
    assert dtypes["['params']['embed']['embed']"] == "bfloat16"
    assert dtypes["['data_step']"] == "int32"
    back = load_pytree(str(tmp_path / "c"), tree)
    named = named_from_reference(back["params"],
                                 dict(params.named_parameters()), tc)
    for n, p in params.named_parameters():
        assert named[n].dtype == torch.bfloat16
        assert torch.equal(named[n], p.detach())
    assert int(back["data_step"]) == 5


def test_checkpoint_manager_keeps_last_k_and_reports_failures(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "m"), keep=2)
    for step in (1, 2, 3):
        mgr.save(step, {"x": torch.full((3,), float(step))})
    mgr.wait()
    assert mgr.steps() == [2, 3] and not any(
        n.endswith(".tmp") for n in os.listdir(tmp_path / "m"))
    restored, step = mgr.restore({"x": torch.zeros(3)})
    assert step == 3 and torch.equal(restored["x"], torch.full((3,), 3.0))
    (tmp_path / "m" / "step_000000004.tmp").write_text("")  # blocks it
    mgr.save(4, {"x": torch.zeros(3)})
    with pytest.raises(RuntimeError, match="checkpoint save failed"):
        mgr.wait()


# ----------------------------------------------------------------------
# fault tolerance, as tests/test_system.py holds the reference
# ----------------------------------------------------------------------
def _small_trainer(tmp_path, steps, **kw):
    _, tc = _cfgs(n_layers=2)
    return Trainer(tc, AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=60),
                   TrainConfig(steps=steps, log_every=0, ckpt_every=100,
                               ckpt_dir=str(tmp_path / "ckpt"),
                               global_batch=2, seq_len=16,
                               multistream_plan=False, **kw), device="cpu")


def test_nan_fuse_counts_and_aborts(tmp_path):
    t = _small_trainer(tmp_path, 30, max_bad_steps=3)
    orig = t.step_fn

    def poisoned(params, opt, batch):
        p, o, _, m = orig(params, opt, batch)
        return p, o, torch.tensor(float("nan")), m
    t.step_fn = poisoned
    with pytest.raises(FloatingPointError):
        t.run()
    assert t.stats["bad_steps"] == 4


def test_straggler_watchdog_counts(tmp_path, monkeypatch):
    """The Trainer's clock is a stub, so the step times are exact: 10, 11
    and 12 ms in turn, and 500 ms for the tenth step, which the watchdog
    counts, and no other."""
    from repro_torch.runtime import train as rtrain
    clock = {"now": 0.0, "calls": 0}
    monkeypatch.setattr(rtrain, "time", types.SimpleNamespace(
        perf_counter=lambda: clock["now"]))
    t = _small_trainer(tmp_path, 12)
    orig = t.step_fn

    def slow_sometimes(params, opt, batch):
        clock["calls"] += 1
        n = clock["calls"]
        clock["now"] += 0.5 if n == 10 else (0.010, 0.011, 0.012)[n % 3]
        return orig(params, opt, batch)
    t.step_fn = slow_sometimes
    r = t.run()
    assert r["straggler_events"] == 1 and len(r["losses"]) == 12


def test_trainer_refuses_what_is_not_ported(tmp_path):
    _, tc = _cfgs()
    # the mesh is ported (slice G), every family's model axis too,
    # ctx_parallel on a model axis, and serving with a GQA cache split by
    # head_dim (the mesh steps: tests/test_torch_mesh_serve.py)
    mesh = types.SimpleNamespace(device_type="cpu", shape=(1, 2),
                                 mesh_dim_names=("data", "model"))
    make_train_step(tc.scaled(ctx_parallel=True), AdamWConfig(), mesh)
    dense = tconfigs.get_reduced("llama3-8b").scaled(cache_shard="latent")
    assert check_mesh_serve(dense, mesh) is None
    # the multistream update plan is ported: on by default, as in the
    # reference, and both values construct
    assert TrainConfig().multistream_plan is True
    for plan in (True, False):
        Trainer(tc, AdamWConfig(), TrainConfig(ckpt_dir=str(tmp_path),
                                               multistream_plan=plan),
                device="cpu")


def test_launch_train_defaults_to_mamba2_on_cpu(tmp_path, capsys):
    """The launcher's default arch is the family the port trains."""
    from repro_torch.launch import train as launch
    assert launch._parse([]).arch == "mamba2-1.3b"
    assert launch.main(["--reduced", "--device", "cpu", "--steps", "3",
                        "--global-batch", "2", "--seq", "16", "--ckpt",
                        str(tmp_path / "ckpt"), "--set", "n_layers=2"]) == 0
    assert "done: loss" in capsys.readouterr().out
