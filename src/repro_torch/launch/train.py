"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

    python -m repro_torch.launch.train --arch mamba2-1.3b --reduced \\
        --device cpu --steps 20
    python -m repro_torch.launch.train --arch llama3-8b \\
        --set n_layers=4 --global-batch 4 --seq 2048 --steps 5
    python -m repro_torch.launch.train --arch deepseek-v2-lite-16b \\
        --set n_layers=3 --global-batch 4 --seq 2048 --steps 5
    python -m repro_torch.launch.train --arch whisper-medium \\
        --global-batch 8 --seq 448 --steps 5
    python -m repro_torch.launch.train --arch qwen2-vl-2b \\
        --global-batch 4 --seq 1024 --steps 5
    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m repro_torch.launch.train --arch llama3-8b --reduced \\
        --device cpu --mesh 2x2 --steps 2
    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m repro_torch.launch.train --arch mamba2-1.3b --reduced \\
        --device cpu --mesh 2x2 --steps 2

Wires the arch registry, the mesh, the activation-sharding context, the
Trainer and checkpointing, with the reference launcher's flags. It
trains on one device (``--device``, the card by default) or, with
``--mesh DxM`` under ``torchrun`` (D x M ranks), on a (data, model) mesh
(every family; the model axis splits heads, MLPs, experts and SSD heads):
gloo with ``--device cpu``, NCCL on ``cuda:LOCAL_RANK`` otherwise; rank
0 prints. The Trainer
plans its optimizer update as a multistream descriptor program, as the
reference's does. The data pipeline draws the stub inputs of the
encoder-decoder (``--arch whisper-medium``: frame embeddings at the
config's ``enc_seq``, ``--seq`` decoder tokens) and of the VLM (``--arch
qwen2-vl-2b``: ``n_patches`` patch embeddings over the first positions,
masked out of the loss, and M-RoPE positions), so both train from here.
"""
import argparse
import datetime
import os
import sys
import tempfile


def _parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mamba2-1.3b",
                    help="mamba2-1.3b, a dense GQA config (llama3-8b, "
                         "yi-9b, phi3-medium-14b, granite-3-8b), a MoE "
                         "config (deepseek-v2-lite-16b, phi3.5-moe-42b), "
                         "jamba-v0.1-52b, whisper-medium or qwen2-vl-2b, "
                         "each also on any --mesh; training takes ~30 "
                         "bytes a parameter, so cut a full config's depth "
                         "on one card (--set n_layers=4)")
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced smoke config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", default="auto", choices=["auto", "none"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernels) or cpu (their plain "
                         "versions)")
    ap.add_argument("--mesh", default=None,
                    help="DxM, e.g. 2x2: a (data, model) mesh over the "
                         "ranks torchrun starts")
    ap.add_argument("--set", nargs="*", default=[],
                    help="ArchConfig overrides key=value")
    return ap.parse_args(argv)


def init_mesh(spec: str, device: str):
    """The process group torchrun describes (its environment) and the
    ``spec`` ("DxM") mesh over it: gloo for ``device`` cpu, NCCL on
    ``cuda:LOCAL_RANK`` otherwise. Returns ``(mesh, device)``."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh_for

    d, m = map(int, spec.lower().split("x"))
    if device == "cpu":
        backend = "gloo"
    else:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
        torch.cuda.set_device(device)
        backend = "nccl"
    dist.init_process_group(backend, timeout=datetime.timedelta(minutes=10))
    if dist.get_world_size() != d * m:
        raise SystemExit(f"--mesh {spec} needs {d * m} ranks; torchrun "
                         f"started {dist.get_world_size()}")
    return make_mesh_for(d * m, m, "cpu" if device == "cpu" else "cuda"), \
        device


def parse_overrides(pairs) -> dict:
    """``["n_layers=4", "remat=none"]`` -> ``{"n_layers": 4, "remat":
    "none"}``: ints, floats, true / false, else strings."""
    overrides = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        try:
            v = int(v)
        except ValueError:
            try:
                v = float(v)
            except ValueError:
                v = {"true": True, "false": False}.get(v.lower(), v)
        overrides[k] = v
    return overrides


def main(argv=None):
    args = _parse(argv)
    from repro_torch import configs
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import TrainConfig, Trainer

    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get(args.arch))
    overrides = parse_overrides(args.set)
    if overrides:
        cfg = cfg.scaled(**overrides)

    mesh, device = None, args.device
    if args.mesh:
        import torch.distributed as dist
        from repro_torch.models.common import set_activation_sharding
        mesh, device = init_mesh(args.mesh, args.device)
        set_activation_sharding(mesh, ("data",), "model")
    trainer = Trainer(
        cfg,
        AdamWConfig(lr=args.lr, warmup_steps=max(10, args.steps // 10),
                    total_steps=args.steps),
        TrainConfig(steps=args.steps, log_every=10,
                    ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt,
                    resume=args.resume, global_batch=args.global_batch,
                    seq_len=args.seq),
        mesh=mesh, device=device)
    r = trainer.run()
    if mesh is None or dist.get_rank() == 0:
        print(f"done: loss {r['losses'][0]:.3f} -> {r['losses'][-1]:.3f}, "
              f"stragglers={r['straggler_events']}, bad={r['bad_steps']}, "
              f"resumed_from={r['resumed_from']}", flush=True)
    if mesh is not None:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
