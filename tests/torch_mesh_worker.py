"""Worlds of gloo ranks on the CPU for the port's mesh tests.

``run_world(fn, world, workdir, *args)`` (or ``start_world`` and
``join_world``, to work while the ranks run) starts ``world`` spawned
processes, each a rank of a gloo process group rendezvousing through a
``FileStore`` under ``workdir`` (no ports), runs ``fn(*args)`` in every
rank with one CPU thread, and returns each rank's result (pickled through
``workdir``). Every collective has a timeout and the world a join
deadline, so a hung rendezvous fails the test. The functions the ranks
run live here; this module imports torch and the port, never JAX.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import sys
import time
import traceback

import multiprocessing as mp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COLLECTIVE_TIMEOUT_S = 120


def _entry(fn, rank: int, world: int, workdir: str, args) -> None:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    out = os.path.join(workdir, f"rank{rank}.pkl")
    try:
        store = dist.FileStore(os.path.join(workdir, "store"), world)
        dist.init_process_group(
            "gloo", store=store, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        result = fn(*args)
        dist.destroy_process_group()
        with open(out, "wb") as f:
            pickle.dump(("ok", result), f)
    except BaseException:                        # reported by run_world
        with open(out, "wb") as f:
            pickle.dump(("error", traceback.format_exc()), f)
        raise


def start_world(fn, world: int, workdir: str, *args):
    """Start ``world`` ranks running ``fn(*args)``; :func:`join_world`
    collects them (the caller may work meanwhile)."""
    os.makedirs(workdir, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, workdir, args))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, workdir


def join_world(handle, timeout: float = 240):
    """Each rank's result of a :func:`start_world`; raises with a rank's
    traceback if any failed or the world outlived ``timeout`` seconds
    from now."""
    procs, workdir = handle
    world = len(procs)
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    results = []
    for r in range(world):
        path = os.path.join(workdir, f"rank{r}.pkl")
        if not os.path.exists(path):
            results.append(("error", f"rank {r} wrote no result"))
            continue
        with open(path, "rb") as f:
            results.append(pickle.load(f))
    errors = [f"rank {r}: {v}" for r, (k, v) in enumerate(results)
              if k == "error"]
    if hung or errors:
        raise RuntimeError(f"world of {world}: hung ranks {hung} after "
                           f"{timeout} s; " + "\n".join(errors[:2]))
    return [v for _, v in results]


def run_world(fn, world: int, workdir: str, *args, timeout: float = 240):
    """``[fn(*args) on rank r for r in range(world)]``; raises with a
    rank's traceback if any failed or the world outlived ``timeout``."""
    return join_world(start_world(fn, world, workdir, *args), timeout)


# ----------------------------------------------------------------------
# What the ranks run
# ----------------------------------------------------------------------
def collective_inputs():
    """The inputs of the reference's ``tests/test_distributed.py``
    (``default_rng(0)``): the compressed mean's (8, 1000), the rings'
    (64, 32) x (32, 48) and (32, 16); the pipeline's (8, 16) stage
    parameters and (12, 4, 16) microbatches."""
    import numpy as np
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 1000)).astype(np.float32)
    xs = rng.standard_normal((64, 32)).astype(np.float32)
    w = rng.standard_normal((32, 48)).astype(np.float32)
    w2 = rng.standard_normal((32, 16)).astype(np.float32)
    rng = np.random.default_rng(0)
    params = rng.standard_normal((8, 16)).astype(np.float32)
    mxs = rng.standard_normal((12, 4, 16)).astype(np.float32)
    return dict(x=x, xs=xs, w=w, w2=w2, params=params, mxs=mxs)


def collectives_rank():
    """On 8 ranks over ("data",): each collective of the port on the
    rank's block, as the reference's ``shard_map`` runs it; and the
    blocks of a (2, 2, 2) mesh's specs."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.distributed import collectives, overlap, pipeline
    from repro_torch.distributed import sharding as shd

    r = dist.get_rank()
    inp = {k: torch.from_numpy(v) for k, v in collective_inputs().items()}
    mesh = DeviceMesh("cpu", torch.arange(8), mesh_dim_names=("data",))
    g = mesh.get_group("data")
    out = {"compressed": collectives.compressed_psum_mean(inp["x"][r], g),
           "pmean": collectives.psum_mean(inp["x"][r], g),
           "ag": overlap.ring_allgather_matmul(
               inp["xs"][8 * r:8 * r + 8], inp["w"][:, 6 * r:6 * r + 6], g),
           "rs": overlap.ring_matmul_reducescatter(
               inp["xs"][:, 4 * r:4 * r + 4], inp["w2"][4 * r:4 * r + 4], g)}
    run = pipeline.pipelined_apply(
        mesh, lambda p, x: torch.clamp_min(x + p, 0.0), "data",
        shd.P("data", None), shd.P(None, None, None), shd.P(None, None, None))
    out["pipeline"] = run(inp["params"], inp["mxs"])
    m3 = DeviceMesh("cpu", torch.arange(8).reshape(2, 2, 2),
                    mesh_dim_names=("pod", "data", "model"))
    spec = shd.P(("pod", "data"), "model")
    t = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    dt = shd.distribute(t, m3, spec)
    out["block"] = shd.local_part(t, spec, m3)
    out["dtensor_local"] = dt.to_local()
    out["dtensor_full"] = dt.full_tensor()
    return {k: v.numpy() for k, v in out.items()}


def _cfg(arch: str, overrides: dict):
    from repro_torch import configs
    return configs.get_reduced(arch).scaled(**overrides)


def mesh_step(arch: str, overrides: dict, mesh_shape, tree, batch,
              opt: dict, sp: bool = True, log: bool = False):
    """One step of the port's mesh step on a ``mesh_shape`` mesh over all
    ranks from the reference's parameters ``tree`` (numpy, stacked) and
    the global ``batch``: ``(loss, new params, optimizer step, grads,
    global norm)``, the params and the gradients the step's
    (``build_mesh_grad_fn`` on the same parameters and batch) gathered
    whole in the stacked layout as numpy on every rank. With
    ``cfg.ctx_parallel`` also ``{"ctx_calls": the context-parallel
    attention layers the gradient pass ran, "replicated": the names of
    the parameters stored whole on every model rank}``. With ``log``
    also the collectives the step issued on this rank, as the dry run's
    ``ByteCounter`` logs them: ``(kind, dtype, numel, group size,
    axis)`` each."""
    import numpy as np
    import torch
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import attention
    from repro_torch.models.common import set_activation_sharding
    from repro_torch.models.convert import from_reference, to_reference
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.train import (build_mesh_grad_fn,
                                           init_sharded_opt_state,
                                           make_train_step)

    cfg = _cfg(arch, overrides)
    mesh = _mesh_of(mesh_shape)
    if sp:
        set_activation_sharding(mesh, tuple(mesh.mesh_dim_names[:-1]),
                                "model")
    try:
        params = from_reference(tree, cfg, device="cpu").requires_grad_(True)
        shd.shard_params(params, mesh, shd.named_param_specs(
            cfg, dict(params.named_parameters())))
        state = init_sharded_opt_state(mesh, cfg, params)
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        calls = [0]
        ctx = attention._gqa_ctx

        def counted(*a, **k):
            calls[0] += 1
            return ctx(*a, **k)
        attention._gqa_ctx = counted
        try:
            _, _, grads, gnorm = build_mesh_grad_fn(cfg, mesh)(params,
                                                               batch)
        finally:
            attention._gqa_ctx = ctx
        grads = to_reference(shd.unstack_opt(
            {n: g.full_tensor() for n, g in grads.items()},
            shd.opt_layout(mesh, cfg, dict(params.named_parameters()))[1]),
            cfg)
        step = make_train_step(cfg, AdamWConfig(**opt), mesh)
        counter = contextlib.nullcontext()
        if log:
            from repro_torch.launch.dryrun import ByteCounter, mesh_groups
            counter = ByteCounter(mesh_groups(mesh))
        with counter:
            params, state, loss, _ = step(params, state, batch)
    finally:
        set_activation_sharding()
    full = to_reference(shd.gather_params(params), cfg)

    def host(t):
        if isinstance(t, dict):
            return {k: host(v) for k, v in t.items()}
        return t.detach().float().numpy()
    res = (float(loss), host(full), state["step"], host(grads),
           float(gnorm))
    if cfg.ctx_parallel:
        model = mesh.mesh_dim_names.index("model")
        res += ({"ctx_calls": calls[0], "replicated": sorted(
            n for n, p in params.named_parameters()
            if not isinstance(p.placements[model], shd.Shard))},)
    if log:
        res += (counter.collectives,)
    return res


def mesh_steps_rank(cases, refusals: bool = False):
    """``mesh_step`` for each case dict (and, with ``refusals``, then
    :func:`mesh_refusals`); rank 0 returns the results, every other rank
    the collective logs of the cases with ``log`` (None for the rest)."""
    import torch.distributed as dist
    out = [mesh_step(**case) for case in cases]
    if refusals:
        out.append(mesh_refusals())
    if dist.get_rank() == 0:
        return out
    return [res[-1] if case.get("log") else None
            for case, res in zip(cases, out)]


def mesh_refusals():
    """What ``make_train_step`` does with a model axis over 1: reduced
    mamba2 (SSM), a dense config with ctx_parallel and jamba (hybrid)
    build on a (2, 2) mesh (None); on a (1, 4) mesh a dense config with
    fewer heads than the model axis builds (None), a MoE config whose 3
    experts leave a rank without one and a Mamba-2 config with 2 SSD
    heads are refused (ValueError); and the mesh decode step builds for
    a GQA cache split by head_dim (``cache_shard="latent"``: None)."""
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.serve import build_mesh_decode_fn
    from repro_torch.runtime.train import make_train_step
    mesh = make_mesh_for(4, 2, device_type="cpu")
    msgs = []
    for arch, over in (("mamba2-1.3b", {}),
                       ("llama3-8b", {"ctx_parallel": True}),
                       ("jamba-v0.1-52b", {})):
        try:
            make_train_step(_cfg(arch, over), AdamWConfig(), mesh)
            msgs.append(None)
        except NotImplementedError as e:
            msgs.append(str(e))
    wide = make_mesh_for(4, 4, device_type="cpu")
    for arch, over in (("llama3-8b", {"n_heads": 2, "n_kv_heads": 1,
                                      "head_dim": 64}),
                       ("phi3.5-moe-42b-a6.6b", {"n_experts": 3}),
                       ("mamba2-1.3b", {"ssm_headdim": 128})):
        try:
            make_train_step(_cfg(arch, over), AdamWConfig(), wide)
            msgs.append(None)
        except ValueError as e:
            msgs.append(str(e))
    try:
        build_mesh_decode_fn(_cfg("llama3-8b", {"cache_shard": "latent"}),
                             mesh)
        msgs.append(None)
    except NotImplementedError as e:
        msgs.append(str(e))
    return msgs


def _trainer(mesh_shape, ckpt_dir: str, steps: int, resume: str = "auto",
             arch: str = "llama3-8b"):
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models.common import set_activation_sharding
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import TrainConfig, Trainer
    d, m = mesh_shape
    mesh = make_mesh_for(d * m, m, device_type="cpu")
    set_activation_sharding(mesh, ("data",), "model")
    cfg = _cfg(arch, {"compute_dtype": "float32", "param_dtype": "float32"})
    return Trainer(cfg, AdamWConfig(lr=1e-3, warmup_steps=2,
                                    total_steps=10),
                   TrainConfig(steps=steps, log_every=0, ckpt_every=1,
                               ckpt_dir=ckpt_dir, resume=resume,
                               global_batch=8, seq_len=32),
                   mesh=mesh, device="cpu")


def _restored(trainer):
    """The state a resuming ``trainer`` restores, gathered whole in the
    stacked layout (numpy), and the step it names."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.runtime.train import init_sharded_opt_state
    params = trainer.model.init(0, device="cpu", trainable=True)
    shd.shard_params(params, trainer.mesh, shd.named_param_specs(
        trainer.cfg, dict(params.named_parameters())))
    opt = init_sharded_opt_state(trainer.mesh, trainer.cfg, params)
    step = trainer._restore(params, opt)
    trainer.data.close()
    tree = trainer._state_tree(params, opt, trainer.data.state.step)
    return (None if tree is None else _host_tree(tree)), step


def _host_tree(t):
    if isinstance(t, dict):
        return {k: _host_tree(v) for k, v in t.items()}
    return t.detach().numpy()


def elastic_rank(workdir: str, ref_ckpt: str):
    """Save on (4, 2), restore onto (2, 4) and continue, continue on
    (4, 2); resume the reference's single-device checkpoint on (2, 4);
    reduced mamba2, whose 1-D Mamba-2 leaves keep their optimizer state
    stacked on both meshes (``sharding.opt_layout``), saved on (4, 2)
    and restored onto (2, 4). Rank 0 returns what it saw."""
    import shutil
    import torch.distributed as dist
    a, b, c, r = (os.path.join(workdir, x) for x in "abcr")
    first = _trainer((4, 2), a, 1, resume="none").run()
    out = {"a_losses": first["losses"]}
    if dist.get_rank() == 0:
        for dst in (b, c):
            shutil.copytree(a, dst)
        shutil.copytree(ref_ckpt, r)
    dist.barrier()
    out["b_restored"], out["b_step"] = _restored(_trainer((2, 4), b, 2))
    res = _trainer((2, 4), b, 2).run()
    out["b_losses"], out["b_resumed"] = res["losses"], res["resumed_from"]
    res = _trainer((4, 2), c, 2).run()
    out["c_losses"], out["c_resumed"] = res["losses"], res["resumed_from"]
    out["r_restored"], out["r_step"] = _restored(_trainer((2, 4), r, 2))
    res = _trainer((2, 4), r, 2).run()
    out["r_losses"], out["r_resumed"] = res["losses"], res["resumed_from"]
    s = os.path.join(workdir, "s")
    _trainer((4, 2), s, 1, resume="none", arch="mamba2-1.3b").run()
    out["s_restored"], out["s_step"] = _restored(
        _trainer((2, 4), s, 2, arch="mamba2-1.3b"))
    return out if dist.get_rank() == 0 else None


def _mesh_of(mesh_shape):
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.launch.mesh import make_mesh_for
    if len(mesh_shape) == 3:                 # the multi-pod layout
        return DeviceMesh("cpu", torch.arange(8).reshape(mesh_shape),
                          mesh_dim_names=("pod", "data", "model"))
    d, m = mesh_shape
    return make_mesh_for(d * m, m, device_type="cpu")


def mesh_serve(arch: str, overrides: dict, mesh_shape, tree, batch,
               steps, cache_len: int):
    """The port's mesh prefill of the global ``batch`` into a cache of
    ``cache_len`` slots, then one decode step for each (b, s_new) array
    of ``steps`` (teacher-forced tokens), from the reference's
    parameters ``tree``: ``{"logits": [prefill's, each step's],
    "caches": [after prefill, after each step], each layer's leaves
    gathered whole, "layout": for each leaf whether its placements are
    those of ``layer_cache_specs``, "local": each leaf's shape on this
    rank, "model_dim": the dimension each leaf's ``model`` placement
    shards (None: whole)}``, numpy, on every rank."""
    import torch
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.convert import from_reference
    from repro_torch.runtime.serve import (build_mesh_decode_fn,
                                           build_mesh_prefill_fn)

    cfg = _cfg(arch, overrides)
    mesh = _mesh_of(mesh_shape)
    params = from_reference(tree, cfg, device="cpu")
    shd.shard_params(params, mesh, shd.named_param_specs(
        cfg, dict(params.named_parameters())))
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}

    def whole(cache):
        return [{k: t.full_tensor().float().numpy() for k, t in c.items()}
                for c in cache]
    logits, cache, fill = build_mesh_prefill_fn(cfg, mesh)(
        params, batch, cache_len)
    out = {"logits": [logits.full_tensor().float().numpy()],
           "caches": [whole(cache)]}
    decode = build_mesh_decode_fn(cfg, mesh)
    for toks in steps:
        logits, cache = decode(params, torch.from_numpy(toks), cache, fill)
        fill += toks.shape[1]
        out["logits"].append(logits.full_tensor().float().numpy())
        out["caches"].append(whole(cache))
    specs = shd.layer_cache_specs(mesh, cache, cfg)
    out["layout"] = [{k: list(t.placements) == shd.placements(specs[i][k],
                                                              mesh)
                      for k, t in c.items()} for i, c in enumerate(cache)]
    out["local"] = [{k: tuple(t.to_local().shape) for k, t in c.items()}
                    for c in cache]
    model = mesh.mesh_dim_names.index("model")
    out["model_dim"] = [{k: getattr(t.placements[model], "dim", None)
                         for k, t in c.items()} for c in cache]
    return out


def mesh_serve_rank(cases):
    """:func:`mesh_serve` for each case dict; rank 0 returns the
    results."""
    import torch.distributed as dist
    out = [mesh_serve(**case) for case in cases]
    return out if dist.get_rank() == 0 else None
