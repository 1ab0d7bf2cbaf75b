"""Training on a (data, model) mesh in the port, on the CPU with gloo,
against the reference's single-device step.

Reduced ``llama3-8b`` in fp32 with the sequence-parallel residual on the
(2, 4), (4, 2) and (1, 8) meshes of 8 gloo ranks: one step of the port's
mesh step from the reference's ``Model.init(0)`` weights must give the
loss and every parameter leaf of the reference's ``make_train_step(mesh
=None)`` within 1e-4 (the bound of the reference's own mesh test,
``tests/test_distributed.py``, whose mesh run the reference's single-
device run stands in for here), and of the port's ``build_step_fn``. The
same on (2, 4) with a 30-token sequence, which does not divide over the
model axis (the replicated residual), and on a (2, 2, 2) mesh over
("pod", "data", "model"), the batch and the optimizer state over pod
and data together; ``grad_accum`` 2 on (2, 2), and 8 (more microbatches
than a rank's 4 rows: it takes 4 of one row); a
config whose 6 heads of 16 split unevenly over 4 ranks (q heads 2, 2, 1,
1; one rank's q heads reading two kv heads), with qkv biases, tied
embeddings and the chunked cross-entropy on (1, 4); reduced
``mamba2-1.3b`` on (4, 1) (data-parallel with ZeRO-1) against its
single-device step; what a model axis still refuses (too few experts
or SSD heads for it; a GQA decode cache split by head_dim) and that
fewer heads than model ranks build; the collectives that ranks 0 and 7
issue in a (2, 4) step, against the dry run's trace of the same ranks
under the fake process group; and the launcher under
``torchrun`` on a 2 x 2 CPU mesh, reduced llama3-8b and mamba2-1.3b. The
other families' model axis is in ``test_torch_mesh_families.py``.

The gradients the mesh step hands its optimizer (``build_mesh_grad_fn``,
gathered whole) are held leaf by leaf against ``jax.grad`` of the
reference's loss at a relative L2 error of 1e-4, and their global norm
at 1e-5 relative: the first AdamW step moves each element by about lr
whatever the gradient's size, so the parameters alone cannot see a
gradient summed once too often or a missing data share.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import configs as jconfigs
from repro.models import Model as JModel
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import init_opt_state as jinit_opt_state
from repro.runtime.train import make_train_step as jmake_train_step
from repro_torch import configs
from repro_torch.models.convert import from_reference, to_reference
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.runtime import build_step_fn
from torch_mesh_worker import mesh_steps_rank, run_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPT = dict(lr=1e-3)
F32 = dict(compute_dtype="float32", param_dtype="float32")
UNEVEN = dict(F32, n_heads=6, head_dim=16, qkv_bias=True,
              tie_embeddings=True, logits_chunk=8)
TOL = 1e-4
GRAD_RTOL = 1e-4
NORM_RTOL = 1e-5


def _batch(cfg, s, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (8, s)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (8, s)).astype(np.int32)}


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


def _reference(arch, over, s):
    """The reference's init tree and its single-device step: (tree,
    batch, loss, new params, (gradients, global norm))."""
    cfg = jconfigs.get_reduced(arch).scaled(**over)
    params = jax.jit(lambda: JModel(cfg).init(0))()
    batch = _batch(cfg, s)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    step = jax.jit(jmake_train_step(cfg, JAdamWConfig(**OPT), mesh=None))
    p, _, loss, _ = step(params, jinit_opt_state(params), jb)
    return (_np(params), batch, float(loss), _np(p),
            _reference_grads(cfg, params, jb))


def _reference_grads(cfg, params, batch):
    """``jax.grad`` of the reference's loss (the mean over the whole
    batch) and the gradients' global norm, in float64 on the host."""
    g = _np(jax.jit(jax.grad(
        lambda p: JModel(cfg).loss(p, batch)[0]))(params))
    norm = np.sqrt(sum(np.sum(v.astype(np.float64) ** 2)
                       for v in _flat(g).values()))
    return g, float(norm)


def _single(arch, over, tree, batch):
    """The port's own single-device ``build_step_fn`` step."""
    cfg = configs.get_reduced(arch).scaled(**over)
    params = from_reference(tree, cfg, device="cpu").requires_grad_(True)
    p, _, loss, _ = build_step_fn(cfg, AdamWConfig(**OPT))(
        params, init_opt_state(dict(params.named_parameters())),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    full = to_reference({n: t.detach() for n, t in p.named_parameters()},
                        cfg)
    return float(loss), _np({k: v for k, v in _t2np(full).items()})


def _t2np(tree):
    if isinstance(tree, dict):
        return {k: _t2np(v) for k, v in tree.items()}
    return tree.numpy()


def _grads_close(got, gnorm, want):
    """Every leaf's relative L2 error within GRAD_RTOL, the global norm
    within NORM_RTOL."""
    g, (w, wnorm) = _flat(got), (_flat(want[0]), want[1])
    assert set(g) == set(w)
    errs = {k: float(np.linalg.norm(g[k] - w[k]))
            / max(float(np.linalg.norm(w[k])), 1e-30) for k in w}
    worst = max(errs, key=errs.get)
    assert errs[worst] < GRAD_RTOL, (worst, errs[worst])
    assert abs(gnorm - wnorm) <= NORM_RTOL * wnorm, (gnorm, wnorm)


def _close(got, want, tol=TOL):
    g, w = _flat(got), _flat(want)
    assert set(g) == set(w)
    worst = max(float(np.abs(g[k] - w[k]).max()) for k in w)
    assert worst < tol, worst
    return worst


CASES8 = {"2x4": ((2, 4), 32), "4x2": ((4, 2), 32), "1x8": ((1, 8), 32),
          "2x4_seq30": ((2, 4), 30), "pod2x2x2": ((2, 2, 2), 32)}


#: the case whose ranks log their collectives: the dry run's head dims
LOGGED = dict(F32, head_dim=64)


@pytest.fixture(scope="module")
def dense8(tmp_path_factory):
    """Each 8-rank case: the reference's and the port's single-device
    step and the port's mesh step; then the logged case's step on (2, 4),
    whose collectives every rank logs (``"logs"``: each rank's)."""
    refs = {s: _reference("llama3-8b", F32, s) for s in (32, 30)}
    cases, out = [], {}
    for name, (shape, s) in CASES8.items():
        tree, batch = refs[s][:2]
        cases.append(dict(arch="llama3-8b", overrides=F32, mesh_shape=shape,
                          tree=tree, batch=batch, opt=OPT))
    lcfg = jconfigs.get_reduced("llama3-8b").scaled(**LOGGED)
    cases.append(dict(arch="llama3-8b", overrides=LOGGED, mesh_shape=(2, 4),
                      tree=_np(jax.jit(lambda: JModel(lcfg).init(0))()),
                      batch=_batch(lcfg, 32), opt=OPT, log=True))
    ranks = run_world(mesh_steps_rank, 8, str(tmp_path_factory.mktemp("w8")),
                      cases)
    got = ranks[0]
    singles = {s: _single("llama3-8b", F32, refs[s][0], refs[s][1])
               for s in refs}
    for (name, (_, s)), res in zip(CASES8.items(), got):
        out[name] = (res, refs[s], singles[s])
    out["logs"] = [got[-1][-1]] + [r[-1] for r in ranks[1:]]
    return out


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """The 4-rank cases: grad_accum 2 on (2, 2) against the reference,
    the uneven heads on (1, 4) and mamba2 on (4, 1) against the port's
    single-device step, and the refusals."""
    acc = dict(F32, grad_accum=2)
    ref_acc = _reference("llama3-8b", acc, 32)
    acc8 = dict(F32, grad_accum=8)
    ref_acc8 = _reference("llama3-8b", acc8, 32)
    ref_uneven = _reference("llama3-8b", UNEVEN, 32)
    mcfg = jconfigs.get_reduced("mamba2-1.3b").scaled(**F32)
    mparams = jax.jit(lambda: JModel(mcfg).init(0))()
    mtree = _np(mparams)
    mbatch = _batch(mcfg, 32)
    mgrads = _reference_grads(mcfg, mparams, {
        k: jnp.asarray(v) for k, v in mbatch.items()})
    cases = [dict(arch="llama3-8b", overrides=acc, mesh_shape=(2, 2),
                  tree=ref_acc[0], batch=ref_acc[1], opt=OPT),
             dict(arch="llama3-8b", overrides=UNEVEN, mesh_shape=(1, 4),
                  tree=ref_uneven[0], batch=ref_uneven[1], opt=OPT),
             dict(arch="mamba2-1.3b", overrides=F32, mesh_shape=(4, 1),
                  tree=mtree, batch=mbatch, opt=OPT),
             dict(arch="llama3-8b", overrides=acc8, mesh_shape=(2, 2),
                  tree=ref_acc8[0], batch=ref_acc8[1], opt=OPT)]
    *got, refusals = run_world(mesh_steps_rank, 4,
                               str(tmp_path_factory.mktemp("w4")), cases,
                               True)[0]
    return {"accum": (got[0], ref_acc), "accum8": (got[3], ref_acc8),
            "uneven": (got[1], ref_uneven,
                       _single("llama3-8b", UNEVEN, *ref_uneven[:2])),
            "mamba": (got[2], _single("mamba2-1.3b", F32, mtree, mbatch),
                      mgrads),
            "refusals": refusals}


@pytest.mark.parametrize("case", list(CASES8))
def test_dense_mesh_step_matches_single_device(dense8, case):
    """Loss and every leaf within 1e-4 of the reference's single-device
    step and of the port's."""
    (loss, params, step, _, _), (_, _, ref_loss, ref_params, _), \
        (s_loss, s_params) = dense8[case]
    assert step == 1
    assert abs(loss - ref_loss) < TOL and abs(loss - s_loss) < TOL
    _close(params, ref_params)
    _close(params, s_params)


def test_grad_accum_on_a_2x2_mesh(world4):
    """grad_accum 2: each rank accumulates its blocks' fp32 gradients
    over its two microbatches; against the reference's grad_accum 2
    step."""
    (loss, params, *_), (_, _, ref_loss, ref_params, _) = world4["accum"]
    assert abs(loss - ref_loss) < TOL
    _close(params, ref_params)


def test_grad_accum_over_more_microbatches_than_rows(world4):
    """grad_accum 8 on (2, 2): a rank's 4 rows of the batch of 8 make 4
    microbatches of one row; against the reference's grad_accum 8 step,
    8 microbatches of one row."""
    (loss, params, *_), (_, _, ref_loss, ref_params, _) = world4["accum8"]
    assert abs(loss - ref_loss) < TOL
    _close(params, ref_params)


@pytest.mark.parametrize("grad_accum,rows,want", [
    (1, 8, 1), (2, 8, 2), (8, 4, 4), (16, 8, 8), (3, 8, None), (4, 6, None)])
def test_mesh_accum_splits_a_ranks_rows_or_refuses(grad_accum, rows, want):
    """A mesh rank's microbatches: ``grad_accum`` where its rows divide
    into them, one row each where ``grad_accum`` is a multiple of its
    rows, else a ValueError naming both."""
    from repro_torch.runtime.train import mesh_accum
    if want is None:
        with pytest.raises(ValueError, match=f"grad_accum {grad_accum} .* "
                                             f"{rows} rows"):
            mesh_accum(grad_accum, rows)
    else:
        assert mesh_accum(grad_accum, rows) == want


def test_uneven_heads_bias_tied_chunked(world4):
    """6 heads over 4 ranks (stored blocks of 1.5 heads: the rank
    gathers wq / wo and its kv heads), qkv biases, tied embeddings, the
    chunked cross-entropy: against the reference and the port's
    single-device step."""
    (loss, params, *_), (_, _, ref_loss, ref_params, _), \
        (s_loss, s_params) = world4["uneven"]
    assert abs(loss - ref_loss) < TOL and abs(loss - s_loss) < TOL
    _close(params, ref_params)
    _close(params, s_params)


def test_mamba2_data_parallel_zero1(world4):
    """Reduced mamba2-1.3b on (4, 1): data-parallel with the optimizer
    state sharded over data, against its single-device step."""
    (loss, params, *_), (s_loss, s_params), _ = world4["mamba"]
    assert abs(loss - s_loss) < TOL
    _close(params, s_params)


@pytest.mark.parametrize("case", list(CASES8) + ["accum", "accum8",
                                                  "uneven", "mamba"])
def test_mesh_gradients_match_jax_grad(request, case):
    """The gradients the mesh step hands its optimizer, gathered whole,
    against ``jax.grad`` of the reference's loss: every leaf within a
    relative L2 error of 1e-4, the global norm (summed over every block,
    each replicated block once) within 1e-5 relative."""
    if case in CASES8:
        (_, _, _, grads, gnorm), ref, _ = request.getfixturevalue(
            "dense8")[case]
        want = ref[4]
    else:
        got = request.getfixturevalue("world4")[case]
        (_, _, _, grads, gnorm) = got[0]
        want = got[2] if case == "mamba" else got[1][4]
    _grads_close(grads, gnorm, want)


@pytest.mark.parametrize("rank", [0, 7])
def test_fake_trace_issues_the_real_steps_collectives(dense8, rank):
    """The dry run's trace of rank 0 and rank 7 of the (2, 4) step under
    the fake process group issues the collectives the same rank of the
    gloo world issued in its step: the same multiset of (kind, dtype,
    numel, group size, mesh axis)."""
    from collections import Counter
    from repro_torch.launch import dryrun
    cfg = configs.get_reduced("llama3-8b").scaled(**LOGGED)
    with dryrun.fake_mesh((2, 4), rank) as mesh:
        fn, args = dryrun.mesh_train_step(cfg, mesh, 8, 32)
        rec = dryrun.trace(fn, *args, mesh=mesh)
    fake = Counter({tuple(op[:5]): op[5]
                    for op in rec["collectives"]["ops"]})
    real = Counter(tuple(op) for op in dense8["logs"][rank])
    assert fake == real
    assert {op[0] for op in fake} >= {"all-gather", "reduce-scatter",
                                      "all-reduce"}


def test_model_axis_outside_dense_is_refused(world4):
    """Since every family splits over ``model`` and ctx_parallel is
    context-parallel attention (``test_torch_ctx_parallel.py``), the
    train step refuses only a model axis that leaves a rank without
    experts or SSD heads; reduced mamba2, jamba and a dense config with
    ctx_parallel build on (2, 2), and a dense config with fewer heads
    than the model axis builds on (1, 4) (a rank without heads adds a
    zero partial: ``test_torch_mesh_families.py``'s qwen2-vl on (1, 8)).
    The mesh decode step builds for a GQA cache split by head_dim
    (``tests/test_torch_mesh_serve.py`` holds its steps)."""
    ssm, ctx, hybrid, narrow, experts, ssd, latent = world4["refusals"]
    assert ssm is None and hybrid is None and ctx is None
    assert narrow is None
    assert experts is not None and "n_experts 3" in experts
    assert ssd is not None and "ssm_heads 2" in ssd
    assert latent is None


@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-1.3b"])
def test_launcher_trains_on_a_2x2_cpu_mesh(tmp_path, arch):
    """``torchrun --standalone --nproc-per-node 4 -m
    repro_torch.launch.train ... --device cpu --mesh 2x2 --steps 2``:
    finite losses, a checkpoint in the reference's layout from rank 0;
    reduced llama3-8b and mamba2-1.3b (the SSD heads over ``model``)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
         "--arch", arch, "--reduced", "--device", "cpu",
         "--mesh", "2x2", "--steps", "2", "--global-batch", "4", "--seq",
         "32", "--ckpt", str(tmp_path), "--resume", "none"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    done = [ln for ln in out.stdout.splitlines() if ln.startswith("done:")]
    assert len(done) == 1, out.stdout
    first, last = (float(x) for x in done[0].split("done: loss ")[1]
                   .split(",")[0].split(" -> "))
    assert np.isfinite(first) and np.isfinite(last)
    assert os.path.exists(tmp_path / "step_000000002" / "manifest.json")
