"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

Serves random-init weights (``Model.init(0)``) of the reduced config, or
of the full config with ``--full``, on the card (``--device cpu`` runs
the plain PyTorch versions of the kernels instead). Every family serves
through the same ``Server``: the SSM and hybrid caches hold each Mamba-2
layer's fp32 state beside its conv tails, and prefill takes the state
from the SSD kernel. ``--set`` overrides config fields; a model larger
than one 80 GB card serves cut in depth:

    python -m repro_torch.launch.serve --arch mamba2-1.3b --full
    python -m repro_torch.launch.serve --arch phi3.5-moe-42b --full \\
        --set n_layers=28          # 41.9 B parameters, 83.7 GB in bf16
    python -m repro_torch.launch.serve --arch jamba-v0.1-52b --full \\
        --set n_layers=23          # 32 layers: 51.5 B, 102.9 GB in bf16

The encoder-decoder (whisper-medium) and the VLM (qwen2-vl-2b) need
frontend inputs (frame or patch embeddings) that prompts do not carry:
as the reference's launcher does, this one refuses them. They serve
through ``Server.generate(prompts, extra={"enc_embeds": ...})`` or
``extra={"img_embeds": ..., "pos3": ...}``.
"""
import argparse
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--full", action="store_true",
                    help="serve the full config instead of the reduced one")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--set", nargs="*", default=[],
                    help="ArchConfig overrides key=value")
    args = ap.parse_args(argv)

    from repro_torch import configs
    from repro_torch.models import Model
    from repro_torch.runtime import Server, ServeConfig

    from repro_torch.launch.train import parse_overrides

    cfg = configs.get(args.arch) if args.full else configs.get_reduced(
        args.arch)
    overrides = parse_overrides(args.set)
    if overrides:
        cfg = cfg.scaled(**overrides)
    if cfg.encoder_decoder or cfg.n_patches:
        print(f"{args.arch} needs frontend inputs — serve it through "
              f"Server.generate(prompts, extra={{...}})")
        return 1
    params = Model(cfg).init(0, device=args.device)
    srv = Server(cfg, params, ServeConfig(
        max_seq=args.prompt_len + args.new_tokens + 8,
        max_new_tokens=args.new_tokens, eos_token=-1,
        temperature=args.temperature))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, args.prompt_len)
               for _ in range(args.batch)]
    out = srv.generate(prompts)
    print(f"prefill {out['prefill_s']*1e3:.0f} ms | "
          f"decode {out['decode_tok_per_s']:.1f} tok/s")
    for i, c in enumerate(out["completions"]):
        print(f"req{i}: {c}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
