#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the NTX reproduction on one NVIDIA GPU.

    python3 chip_smoke.py    # every phase: serve llama3-8b,
                             # deepseek-v2-lite-16b, phi3.5-moe-42b,
                             # mamba2-1.3b and jamba-v0.1-52b, serve
                             # and train whisper-medium and qwen2-vl-2b,
                             # train mamba2-1.3b, a 4-layer llama3-8b
                             # and the two MoE models cut in depth, run
                             # the paper's kernel suite, hold the dry
                             # run's counts against the card's
    python3 chip_smoke.py --phases 1,13   # one phase alone
    python3 chip_smoke.py --phases 1,5,11,19   # the dry run against
                             # phases 5 and 11 alone
    python3 chip_smoke.py --phases 1,21   # context and cache
                             # parallelism alone
    python3 chip_smoke.py --phases 1,20   # the mesh steps alone (add 3
                             # and --only gemm:tp8,attention:tp8,
                             # attention_bwd:tp8,act_bwd:tp8,ssd:tp8 for
                             # the tensor-parallel shard shapes' kernels)
    python3 chip_smoke.py --phases 1,3 --only attention:prefill_4096 \
        --src ../parent/src  # one case's check and time, another tree's
                             # kernels on the same card

Phases, one result line each:
  1. build   — compile the CUDA kernels (src/repro_torch/kernels/csrc)
               with nvcc and load them; print the card's name and limit.
  2. check   — every kernel against its plain PyTorch version on the
               card, at the serving and training paths' shapes (and the
               fused AdamW on odd-length operands off a 16-byte
               boundary); the dense training path's: the flash backward
               (b 4, hq 32, hkv 8, s 2048, bf16; hkv 4; a small fp32
               shape; two calls bit-equal; phase 1 fails if its
               kernels spill or serialise wgmma), the forward's lse,
               the activation backward at
               8192 x 14336 (bit-equal) and the MLP backward's GEMMs at
               m 8192; an AXPY -> RELU -> SUM ntx.Program bit-equal
               under the serial and fused policies, and a prefix-store
               program on a CUDA image against the cycle-faithful
               engine.
  3. time    — each kernel's time (CUDA events) and its host issue time,
               its bound, its plain version's time and one PyTorch
               library call's time (SDPA in its fastest form, with the
               backend it ran); each serving MLP GEMM at its split-k
               plan and at two blocks per SM; flash attention at a 4096-
               token prefill (its 128-row plan beside 64-row blocks) and
               a decode step over 4000 keys, the split-kv merge alone,
               the fp32 FFMA GEMM at 4096^3 against torch.matmul (TF32
               off); the SSD call's three kernels under torch.profiler;
               the PyTorch SSD backward on its own, with its bound;
               the flash backward against SDPA's backward (its forward
               and backward less its forward), with its plan (group
               splits, ring stages, grids).
  4. width   — llama3-8b at full width, depth cut to 2 layers, on the card
               and on the CPU with the same weights and tokens: prefill
               logits, 4 decode steps' logits (the CPU decoding each from
               the card's cache) and every cache leaf after each.
  5. serve   — Server.generate on the full 32-layer llama3-8b (bf16,
               random weights from Model.init(0)): 4 requests, prompt 32,
               16 new tokens, greedy and at temperature 0.8, and one
               request with a 2048-token prompt and 8 new tokens (its
               decode steps split the keys), with the kernel launch
               counts of that run; the long prompt's prefill under
               torch.profiler (an observation, no limit); then one
               decode step under torch.profiler, its device time by
               kernel family.
  6. train width — mamba2-1.3b at full width, depth cut to 2 layers, one
               build_step_fn step on the card and on the CPU from the
               same weights and batch: loss, grad norm and new params.
  7. train   — Trainer on the full 48-layer mamba2-1.3b (bf16, Model.init(0)
               weights): 5 steps at global batch 8, seq 1024, with a
               checkpoint; step time, tokens/s, peak memory and launch
               counts; then apply_updates(use_fused=True) against
               use_fused=False on the final state.
  8. suite   — the paper's §III-B kernel suite through the ops entry
               points: conv2d 3x3/5x5/7x7 on an 8192 x 8192 plane, the
               stencil pass on each axis of 512**3, Laplace 1-D/2-D/3-D
               (2**26, 8192**2, 512**3), the compensated GEMM at 4096**3,
               AXPY 2**22 and a THRESH->RELU->THRESH chain through ops and
               as ntx.Programs, and the PCS RMSE study on the card against
               the CPU; Gflop/s, bound shares and launch counts, then each
               result against its plain version as in phase 2; the fused
               Laplace timed beside the per-axis route it replaced.
  9. policies — the Executor's five policies on the card, every one
               bit-equal to serial: the serving samplers at phase 5's
               shapes (greedy, staged prefill, temperature 0.8; tokens
               equal to torch.argmax), 8 lanes of AXPY -> RELU -> SUM over
               2**20 each, 4 fp32 GEMM(512, 512, 512) + RELU lanes, one
               2**20 chain larger than the TCDM (auto picks tiled), a
               fitting program raced under autotune="measure" (the second
               race hits the cache) and shard_map on one device (raises);
               each policy's wall time and launches per run, the lane
               launches checked against their plain versions and timed
               beside L one-lane launches, and the sampler's decode-step
               time under fused against multistream.
 10. dense width — llama3-8b at full width, depth cut to 1 layer, one
               build_step_fn step (batch 1 x 256) on the card and on the
               CPU from the same weights and batch, fp32 and bf16.
 11. dense train — build_step_fn on llama3-8b at full width cut to 4 of
               32 layers (bf16, remat="full"), 5 steps at batch 4 x
               2048: step time, tokens/s, peak memory, the model-FLOP
               share, the launch counts, one step under torch.profiler
               by kernel family.
 12. deepseek — deepseek-v2-lite-16b (MLA and MoE): the width check of
               phase 4 at 2 of 27 layers, then Server.generate on the
               full 27-layer model (bf16, Model.init(0), ~32.4 GB) at
               phase 5's sizes and one 2048-token prompt, launch counts
               (MLA's flash route at q/k 192, v 128, its split merge, the
               samplers), peak memory, the long prefill and one decode
               step under torch.profiler beside the decode step's
               expert-weight bytes bound. Phases 2/3 hold the (192, 128)
               forward at its shapes and, for phase 13, its forward with
               lse and its backward at one 2048-token row.
 13. deepseek train — a 1-layer full-width build_step_fn step card vs
               CPU at 1 x 256 (fp32: the same MoE routing on both; bf16:
               the CPU replays the card's experts; every remat recompute
               routes as its forward), then 3 of 27 layers (bf16,
               remat="full") for 5 steps at 4 x 2048 in the config's
               grad_accum 4: step time, tokens/s, peak memory (at least 5
               GB free), the (192, 128) forward-with-lse and backward
               launches, one step profiled by kernel family (the MoE's
               scatters and gathers apart).
 14. phi3.5-moe — phi3.5-moe-42b: the 2-layer serving width check, then
               Server.generate at 28 of 32 layers (~73 GB bf16) at phase
               5's sizes with a profiled decode step, a 1-layer
               full-width training step card vs CPU, and 5 steps at 1 of
               32 layers, 8 x 2048 in grad_accum 8 (as phase 13).
 15. mamba2 — mamba2-1.3b serving: 2 layers at full width card vs CPU
               (prefill logits, the cache's state and conv tails, 4
               decode steps from the card's cache; fp32 and bf16), decode
               continuing a 16- and a 128-token prefill on the card, then
               Server.generate on all 48 layers at phase 5's sizes and one
               2048-token prompt: launch counts (the SSD kernel's state
               route once a layer and prefill, never ops.ssd),
               peak memory, the long prefill (ssd_scan.cu's three
               kernels a layer) and a decode step under torch.profiler.
               Phases 2/3 hold the state route (y bit-equal to ops.ssd's)
               at its prefill shapes, timed beside ops.ssd.
 16. jamba  — jamba-v0.1-52b (hybrid: Mamba-2 and GQA on a period of 8,
               MLP and MoE): phase 15's 2-layer check (ssm_mlp, ssm_moe;
               the CPU replays the card's routing), then Server.generate
               at full width cut to 23 of 32 layers (the deepest cut
               that leaves 5 GB of the card free) at phase 5's sizes,
               with launch counts, a profiled prefill and decode step.
 17. whisper — whisper-medium (the encoder-decoder: 24 + 24 layers,
               16 heads of 64, LayerNorm, GELU MLPs, 1500 encoder frames
               from the frontend stub): the width check at 2 + 2 layers
               (prefill logits, 4 decode steps and the cache's k, v, ck,
               cv), then Server.generate(prompts, extra={"enc_embeds"})
               on the full model at phase 5's sizes, its launches held
               exactly (per prefill 72 flash launches and 96 GEMMs, per
               decode step 48 flash launches and the cross-attention's
               split merges), a profiled decode step; a 1 + 1-layer
               training step card vs CPU, then 5 steps at full size, 8 x
               448 decoder tokens against 8 x 1500 frames (the flash
               forward with lse, its backward at sq != skv and the GELU
               activation backward, counted exactly), one step profiled.
 18. qwen2-vl — qwen2-vl-2b (28 layers, 12 / 2 heads of 128, M-RoPE,
               256 patch embeddings from the stub): phase 17's pattern at
               4 prompts of 256 patches and 32 text tokens with pos3 on a
               patch grid, training at 4 x 1024 with the patches masked
               out of the loss.
               Phases 2/3 hold and time both families' path shapes: the
               flash forward at d 64 non-causal (1500 x 1500, 32 and one
               query against 1500 keys, with its merge) and causal, qwen's
               group of 6, each with lse for training; the backward at
               sq 448 / skv 1500 non-causal, at 1500 x 1500 and qwen's 4
               x 1024; the GELU GEMM and w2 + residual at m 6000; the
               GELU activation backward at 3584 and 12000 x 4096; the
               samplers' ARGMAX and AXPY -> ARGMAX at both vocabularies.
 19. dryrun — the card's ceilings (a bf16 torch.matmul at 8192^3, an
               fp32 one at 4096^3 with TF32 off, a 2 GiB copy) beside the
               data sheet's; then every workload phases 5, 7 and 11-18
               measured, dry-run on the meta device
               (repro_torch.launch.dryrun) in worker processes at the
               phase's depth cut, batch, sequence and step count: its
               kernel calls must equal the launches the phase counted on
               the card and its hand predictor, family by family; each
               prefill, decode step and training step's roofline at both
               ceilings beside the measured time, and the dry run's peak
               beside the card's (observations).
 20. mesh   — the (data, model) mesh on the card, on a 1-rank NCCL process
               group (one rank: no collective here crosses cards):
               Trainer(mesh=make_mesh_for(1)) on phase 11's
               llama3-8b (4 of 32 layers, 4 x 2048, bf16) for 3 steps,
               its checkpoint gathered to the reference's layout and
               written by rank 0, then build_step_fn's plain step from the
               same seed in turn: loss and every parameter leaf within
               phase 10's bf16 limits, the step times side by side, peak
               memory, the launches of phase 11's step held exactly; the
               int8 collectives on CUDA tensors bit-equal to the CPU port,
               the ring products bit-equal to their one-rank product.
               Then the mesh step of two more families beside their plain
               step, each 3 steps from the same seed, held alike and
               their launches equal: mamba2-1.3b at full size, 8 x 1024
               (the SSD kernel through the mesh step), and
               deepseek-v2-lite-16b cut to 2 of 27 layers, 4 x 2048 in
               grad_accum 4 (MLA and the expert stacks as DTensors).
               Phases 2/3 hold and time the kernels at the shard shapes a
               rank of an 8-way model axis gives them (the ``tp8`` cases:
               the MLP's products at w1 / w3 4096 x 1792 and w2 1792 x
               4096 for m 8192, the activation backward at 8192 x 1792,
               flash attention with lse and its backward at 4 q heads /
               1 kv head, b 4, s 2048; the SSD scan at mamba2's 8 heads
               and jamba's 16 heads of d_state 16, b 8, l 1024; MLA's
               (192, 128) forward with lse and backward at 2 heads, b 1,
               s 2048; whisper's flash at 2 heads of 64, the encoder's
               8 x 1500 frames and the cross-attention 448 x 1500, with
               lse and backward; the GEMMs of whisper's GELU MLP at m
               12000, k 1024, n 512 and back and of qwen2-vl's SwiGLU at
               m 4096, k 1536, n 1120 and back).
               While the card trains, worker processes dry-run the mesh
               step (repro_torch.launch.dryrun under PyTorch's fake
               process group): phase 20's llama3-8b step as rank 0 of a
               fake (1, 1) mesh, whose kernel calls times the steps must
               equal the launches the mesh step counted, family by
               family, its peak beside max_memory_allocated; and, as
               observations, rank 0's records of llama3-8b train_4k on
               16x16 and deepseek-v2-lite-16b decode_32k on 2x16x16:
               peak, fit, wire bytes by kind and the roofline's terms.
 21. ctx    — context and cache parallelism on the card: flash attention
               with lse and its backward at llama3-8b's context-parallel
               rank shapes (b 1, 32 q / 8 kv heads, a 8192-token sequence
               over 8 ranks: queries 1024, keys 1024 / 4096 / 8192, the
               causal diagonal bottom-right) against their plain versions,
               timed beside SDPA with a lower-right causal mask; the
               split merge's lse on its own; a 32768-slot decode cut into
               8 blocks, each block's (o, lse) through the split kernel
               and the merge's lse, merged as a sequence-sharded cache's
               ranks merge them, against the whole-cache call; then
               build_mesh_prefill_fn / build_mesh_decode_fn on a 1-rank
               NCCL mesh (llama3-8b cut to 4 layers at full width, the
               cache as cache_specs places it: split by the sequence)
               against Model.prefill / decode, with equal launches; the
               two kernels of a decode over a GQA cache split by head_dim
               (csrc/ntx_attn_split.cu) at llama3-8b decode_32k's 16- and
               4-way rank blocks and whisper's cross-attention block
               against their plain versions, timed beside one
               torch.matmul; a 32768-slot cache cut into 16 head_dim
               blocks, the blocks' partial logits summed and each block's
               softmax-PV side by side, against the whole-cache call; and
               the mesh steps again with cache_shard="latent" (k and v
               Shard(3)), which must launch both kernels every layer of
               every decode step and no flash call, against the plain
               steps at phase 4's bf16 limits (two attention routes).
The line before the last is the kernel table as JSON, the last line
{"ok": true, "device": {...}}. Any failure exits non-zero before either.
The script needs a CUDA device and the repository's src/ beside it; it
imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import datetime
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
#: dense peaks; fp32 off the tensor cores. ``fp32_unfused`` is the rate of
#: separate FMUL and FADD instructions (132 SMs x 128 lanes x ~1.98 GHz),
#: the bound of kernels whose products are rounded before their adds
#: (conv, the stencil pass, the Laplace): bit-equality forbids FMA there
PEAK_OPS = {"bf16": 989e12, "fp32": 67e12, "fp32_unfused": 33.5e12}
PROMPT_LEN, NEW_TOKENS, BATCH = 32, 16, 4
MAX_SEQ = PROMPT_LEN + NEW_TOKENS + 8        # launch/serve.py's sizing
#: phase 5's long-prompt request: one prompt of 2048 tokens, 8 new ones
LONG_PROMPT, LONG_NEW = 2048, 8
LONG_SEQ = LONG_PROMPT + LONG_NEW + 8
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 1024, 5
#: phase 6's limit on the worst leaf's relative L2 gradient error, card vs
#: CPU: 10x the 9.9e-6 measured on an H100 in fp32, 4x the 1.27e-2 in bf16
#: (a gradient pointing the wrong way is off by 1 or more)
GRAD_RTOL = {"float32": 1e-4, "bfloat16": 5e-2}
DEVICE = "cuda"
ALL_PHASES = set(range(1, 22))
#: phase 12's model (MLA and MoE); phase 13 trains it at full width cut
#: to DEEPSEEK_TRAIN_LAYERS of 27 layers (~30 bytes a parameter with the
#: plain AdamW: 16.2 B parameters need ~490 GB), batch DENSE_BATCH x
#: DENSE_SEQ in the config's grad_accum 4 microbatches
DEEPSEEK = "deepseek-v2-lite-16b"
DEEPSEEK_TRAIN_LAYERS = 3
#: phase 14's model (GQA and MoE): served at full width cut to
#: PHI35_SERVE_LAYERS of 32 layers (41.9 B parameters are 83.7 GB in
#: bf16), trained at PHI35_TRAIN_LAYERS, batch PHI35_BATCH x DENSE_SEQ in
#: the config's grad_accum 8 microbatches, for PHI35_STEPS steps
PHI35 = "phi3.5-moe-42b-a6.6b"
PHI35_VOCAB = 32064
PHI35_SERVE_LAYERS, PHI35_TRAIN_LAYERS = 28, 1
PHI35_BATCH, PHI35_STEPS = 8, 5
#: phase 15's model, served at full size; phase 16's (the hybrid), served
#: at full width cut to JAMBA_SERVE_LAYERS of 32 layers
MAMBA2 = "mamba2-1.3b"
JAMBA = "jamba-v0.1-52b"
JAMBA_SERVE_LAYERS = 23
#: phase 17's model (the encoder-decoder) at full size: the config's 1500
#: encoder frames a request, its padded vocabulary; trained at WHISPER_TRAIN_BATCH x
#: WHISPER_TRAIN_SEQ decoder tokens (each against its 1500 frames)
WHISPER = "whisper-medium"
ENC_SEQ, WHISPER_VOCAB = 1500, 51968
WHISPER_TRAIN_BATCH, WHISPER_TRAIN_SEQ = 8, 448
#: phase 18's model (the VLM) at full size: prompts of QWEN_PATCHES
#: patch positions and PROMPT_LEN text tokens, its padded vocabulary;
#: trained at QWEN_TRAIN_BATCH
#: x QWEN_TRAIN_SEQ with the patches masked out of the loss
QWEN = "qwen2-vl-2b"
QWEN_PATCHES, QWEN_VOCAB = 256, 152064
QWEN_PLEN = QWEN_PATCHES + PROMPT_LEN
QWEN_MAX_SEQ = QWEN_PLEN + NEW_TOKENS + 8
QWEN_TRAIN_BATCH, QWEN_TRAIN_SEQ = 4, 1024
#: the serving width checks (phases 4, 12, 14-18) compare WIDTH_STEPS
#: decode steps after the prefill
WIDTH_STEPS = 4
#: the width checks' limit on the SSM state's relative L2 error, card vs
#: CPU (a wrong state is off by ~1): fp32 33x the 3.0e-6 measured on an
#: H100 at jamba's widths (mamba2's 1.4e-6), bf16 3x the 6.3e-3 / 5.8e-3
#: measured at both
SSM_STATE_L2 = {"float32": 1e-4, "bfloat16": 2e-2}
#: every depth cut leaves at least this much of the card's memory free
HEADROOM_BYTES = 5e9
#: phases 10-11: llama3-8b cut to DENSE_LAYERS of 32 layers, batch
#: DENSE_BATCH x DENSE_SEQ for DENSE_STEPS steps; the width check's
#: 1 layer at batch 1 x DENSE_WIDTH_SEQ (256, not 512: at 512 its CPU
#: side took 39 s in fp32 and 61 s in bf16 on the H100's host, 2 layers;
#: at 64 the CPU sides of phases 10 and 13 took 6-17 s less than at 256,
#: since the plain AdamW over their ~1.3 B parameters dominates them)
DENSE_LAYERS, DENSE_BATCH, DENSE_SEQ, DENSE_STEPS = 4, 4, 2048, 5
DENSE_WIDTH_SEQ = 256
#: phase 20: the mesh step's steps; the model axis whose rank's blocks
#: phases 2/3 hold the kernels at (llama3-8b's 32 / 8 heads, 14336 d_ff;
#: mamba2's 64 / 8 SSD heads, deepseek's 16 / 8 MLA heads, whisper's and
#: qwen2-vl's MLPs); its other families' 1-rank steps: mamba2-1.3b at
#: full size, TRAIN_BATCH x TRAIN_SEQ, and deepseek cut to
#: MESH_DEEPSEEK_LAYERS of 27 layers, DENSE_BATCH x DENSE_SEQ in its
#: grad_accum 4
MESH_STEPS, TP_RANKS = 3, 8
MESH_DEEPSEEK_LAYERS = 2
#: phase 21: the sequence of a context-parallel rank's shapes (over
#: TP_RANKS ranks), the sharded decode cache and its blocks, the mesh
#: serving check's prompt and decode steps (tokens a step: the 2-token
#: step's queries see the cache with two kv_lens)
CTX_SEQ, CTX_CACHE, CTX_BLOCKS = 8192, 32768, 8
CTX_PROMPT, CTX_STEPS = 2048, (1, 2, 1, 1)
#: the sharded decode's filled slots (6.5 of its 8 blocks: the last one
#: empty) and each block's key scale (a block's lse grows with its
#: square, so the blocks' lse differ by units)
CTX_FILL = CTX_CACHE - CTX_CACHE // CTX_BLOCKS * 3 // 2
CTX_KEY_SCALES = (0.5, 1.0, 1.5, 2.0, 2.5, 3.0, 3.5, 4.0)
#: phase 21's decode over a cache split by head_dim: the rank blocks of
#: llama3-8b decode_32k (b 8 = 128 over 16 data ranks, 32 / 8 heads, 32768
#: keys) on 16 and 4 model ranks, whisper-medium's cross-attention block
#: on 16 (16 / 16 heads, 1500 frames, db 4); the one-card stand-in's
#: blocks of head_dim 128 and its filled slots
SPLIT_BATCH, SPLIT_RANKS, SPLIT_FILL = 8, (16, 4), 32768 - 200
#: phase 8's shapes: the conv plane, the Laplace grids, the GEMM side
CONV_HW, CONV_TAPS = 8192, (3, 5, 7)
LAP_SHAPES = ((1 << 26,), (8192, 8192), (512, 512, 512))
KAHAN_N = 4096
AXPY_N = 1 << 22
#: phase 9's shapes: the sampler batch and vocabulary (phase 5's), the
#: data-parallel lanes and their length, the GEMM lanes and their side
VOCAB = 128256
LANES, LANE_N = 8, 1 << 20
GEMM_LANES, GEMM_N = 4, 512
#: the 3-command streaming chain of benchmarks/run.py's fusion section
CHAIN3 = [("thresh", 0.2), ("relu", 0.0), ("thresh", 0.5)]
#: ``--only``: phase 2/3 case-name prefixes to keep (empty: all)
ONLY: tuple = ()


def wanted(name: str) -> bool:
    return not ONLY or name.startswith(ONLY)


class Failed(Exception):
    pass


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def need(ok: bool, what: str) -> None:
    if not ok:
        raise Failed(what)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise Failed(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------------
# timing
# ----------------------------------------------------------------------
def time_ms_host(fn, torch, warmup: int = 3, iters: int = 20) -> tuple:
    """(device ms, host ms) per call: CUDA events around ``iters`` calls,
    and the host's clock over the same calls before it synchronises (the
    time to issue one call; where it exceeds the device time, the host
    sets the event time)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host_ms


def time_ms(fn, torch, warmup: int = 3, iters: int = 20) -> float:
    return time_ms_host(fn, torch, warmup, iters)[0]


def bound_ms(nbytes: float, nops: float, kind: str) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------------
# phase 2 / 3: kernels against their plain versions, and their times
# ----------------------------------------------------------------------
def kernel_cases(torch):
    """One dict per check: the ``ops`` wrapper the serving path calls and
    the kernel's plain version, as closures over inputs made on the card
    with the path's dtypes and layouts, the library call (or None), how
    to compare them, the bytes and operations the bound counts, and
    whether the shape is one the serving path gives the kernel
    (``path``)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels import ntx_elementwise as ew
    from repro_torch.kernels import ntx_gemm, ntx_reduce
    from repro_torch.kernels import flash_attention as fa

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(0)
    rn = lambda *s, dt=torch.float32, std=1.0: (
        torch.randn(*s, generator=g, device=dev) * std).to(dt)
    bf = torch.bfloat16
    cases = []
    gemm_src = "src/repro_torch/kernels/csrc/ntx_gemm.cu"
    gemm_rep = "src/repro/kernels/ntx_gemm.py:137"
    flash_src = "src/repro_torch/kernels/csrc/flash_attention.cu"
    flash_rep = "src/repro/kernels/flash_attention.py:77"
    stream_src = "src/repro_torch/kernels/csrc/ntx_stream.cu"

    def gemm_case(name, m, k, n, dt, out_dt, ep_spec, tol, path=True,
                  offset=0, phase="serve"):
        """``ep_spec`` entries: (kind,), (kind, imm) or (kind, dtype) for
        the array kinds, whose operand is made in that dtype (the path's
        residual is the bf16 hidden state, its gate the fp32 GEMM).
        ``offset``: a and b are contiguous views that start that many
        elements into their storage."""
        a = rn(m * k + offset, dt=dt)[offset:].view(m, k)
        b = rn(k * n + offset, dt=dt, std=k ** -0.5)[offset:].view(k, n)
        ep = []
        for kind, *rest in ep_spec:
            if kind in ntx_gemm.EPILOGUE_ARRAY_KINDS:
                op = rn(n) if kind == "bias" else rn(m, n)
                if kind == "mask":
                    op = (op > 0).float()
                ep.append((kind, op.to(rest[0]) if rest else op))
            elif rest:
                ep.append((kind, float(rest[0])))
            else:
                ep.append((kind,))
        norm = ops._norm_epilogue(ep)
        def library():
            return ntx_gemm.apply_epilogue(
                torch.matmul(a, b).float(),
                tuple((k_, i_) for k_, i_, _ in norm),
                [o.float() for _, _, o in norm if o is not None]).to(out_dt)
        nbytes = (a.numel() * a.element_size() + b.numel() * b.element_size()
                  + sum(o.numel() * o.element_size() for _, _, o in norm
                        if o is not None)
                  + m * n * torch.empty((), dtype=out_dt).element_size())
        case = dict(
            name=name, wrapper="gemm", source=gemm_src, replaces=gemm_rep,
            kernel=lambda: ops.gemm(a, b, out_dtype=out_dt, epilogue=ep),
            plain=lambda: ntx_gemm.gemm_plain(a, b, out_dt, norm),
            library=library, mode="close", tol=tol, bytes=nbytes,
            ops=2.0 * m * n * k, kind="bf16" if dt == bf else "fp32",
            path=path, phase=phase)
        if path and dt == bf:
            # the split choice against two blocks per SM, timed in phase 3
            plan = ntx_gemm.split_k_plan(m, n, k)
            alt = max(1, min(2 * ntx_gemm.SMS // (plan.m_tiles
                                                  * plan.n_tiles),
                             plan.k_tiles // ntx_gemm.MIN_SPLIT_K_TILES,
                             ntx_gemm.MAX_SPLITS))
            if alt != plan.splits:
                case["splits"] = (plan.splits, alt, lambda s: ntx_gemm.gemm_cuda(
                    a, b, out_dt, norm, splits=s))
        cases.append(case)

    bf_tol = (1e-2, 1e-2)   # one bf16 ulp (2**-8 rel) + fp32 order noise
    f_tol = (1e-4, 1e-4)    # fp32 summation order over k <= 14336
    f32 = torch.float32
    gemm_case("gemm:prefill_w3_gate", 128, 4096, 14336, bf, f32, [], f_tol)
    gemm_case("gemm:prefill_w1_silu_mul", 128, 4096, 14336, bf, bf,
              [("silu",), ("mul", f32)], bf_tol)
    gemm_case("gemm:prefill_w2_residual", 128, 14336, 4096, bf, bf,
              [("residual", bf)], bf_tol)
    gemm_case("gemm:decode_w3_gate", 4, 4096, 14336, bf, f32, [], f_tol)
    gemm_case("gemm:decode_w1_silu_mul", 4, 4096, 14336, bf, bf,
              [("silu",), ("mul", f32)], bf_tol)
    gemm_case("gemm:decode_w2_residual", 4, 14336, 4096, bf, bf,
              [("residual", bf)], bf_tol)
    gemm_case("gemm:fp32_bias_mask_thresh_gelu", 100, 300, 200, f32, f32,
              [("bias",), ("mask",), ("thresh", 0.1), ("gelu",),
               ("scale", 0.5), ("sub",), ("relu",)], f_tol, path=False)
    # the bf16 route off the path: ragged n on 16-byte copies, k and n not
    # multiples of 8 and operands at an odd element offset (masked loads)
    gemm_case("gemm:bf16_m128_k14336_n1000_gelu", 128, 14336, 1000, bf, bf,
              [("gelu",)], bf_tol, path=False)
    gemm_case("gemm:bf16_m70_k1007_n1003_residual", 70, 1007, 1003, bf, f32,
              [("residual", bf)], f_tol, path=False)
    gemm_case("gemm:bf16_offset1_m4_k1007_n1003_silu_mul", 4, 1007, 1003, bf,
              bf, [("silu",), ("mul", f32)], bf_tol, path=False, offset=1)
    # the fp32 FFMA route's register-tiled 128-row tile, uncompensated;
    # its library call is torch.matmul in fp32 with TF32 off
    gemm_case("gemm:fp32_4096^3", 4096, 4096, 4096, f32, f32, [], f_tol,
              path=False)

    def flash_case(name, b, hq, hkv, sq, skv, kv_len, dt, tol, path=True,
                   d=128, dv=128, phase="serve", causal=True, cached=None):
        """``cached``: k and v in the cache's contiguous (b, hkv, skv, d)
        layout (default: where kv_len is given, i.e. decode); else the
        projections' (b, s, h, d) viewed as (b, h, s, d)."""
        if not wanted(name):
            return
        cached = kv_len is not None if cached is None else cached
        if d == dv:
            # prefill q/k/v are (b, s, h, d) projections viewed as (b, h,
            # s, d) as models/attention.py makes them; decode reads the
            # cache (and the encoder-decoder's cross-attention its cached
            # encoder keys and values, whole)
            q = rn(b, sq, hq, d, dt=dt).transpose(1, 2)
            kv = (lambda: rn(b, hkv, skv, d, dt=dt)) if cached else (
                lambda: rn(b, skv, hkv, d, dt=dt).transpose(1, 2))
            k, v = kv(), kv()
        else:
            # MLA: q and k are concatenations of the nope and rope parts
            # (contiguous), v the latent's up-projection viewed as (b, h,
            # s, dv), the whole cache expanded at decode
            q = rn(b, hq, sq, d, dt=dt)
            k = rn(b, hkv, skv, d, dt=dt)
            v = rn(b, skv, hkv, dv, dt=dt).transpose(1, 2)
        kw = dict(causal=causal, kv_len=kv_len)
        n_kv = skv if kv_len is None else kv_len
        # the library gets its fastest form of the same function: SDPA's
        # own causal flag where the mask is plain causal (sq = skv =
        # kv_len), the first kv_len keys and no mask for one query or
        # without the causal mask, else the dense mask
        if sq == skv == n_kv and causal:
            lib_kw = dict(is_causal=True)
            lk, lv = k, v
        elif sq == 1 or not causal:
            lib_kw, lk, lv = {}, k[:, :, :n_kv], v[:, :, :n_kv]
        else:
            qpos = torch.arange(sq, device=dev)[:, None] + (n_kv - sq)
            kpos = torch.arange(skv, device=dev)[None, :]
            lib_kw = dict(attn_mask=(kpos < n_kv) & (kpos <= qpos))
            lk, lv = k, v
        def library():
            return F.scaled_dot_product_attention(q, lk, lv, enable_gqa=True,
                                                  **lib_kw)
        esz = q.element_size()
        nbytes = (q.numel() + b * hkv * n_kv * (d + dv)
                  + b * hq * sq * dv) * esz
        # operations over the unmasked (query, key) pairs only: query i
        # takes min(n_kv, n_kv - sq + i + 1) keys (all n_kv without the
        # causal mask); S over d, P V over dv
        pairs = (sum(max(0, min(n_kv, n_kv - sq + i + 1)) for i in range(sq))
                 if causal else sq * n_kv)
        case = dict(
            name=name, wrapper="attention", source=flash_src,
            replaces=flash_rep,
            kernel=lambda: ops.attention(q, k, v, **kw),
            plain=lambda: fa.flash_attention_plain(q, k, v, **kw),
            library=library, backend=library, mode="close", tol=tol,
            bytes=nbytes, ops=2.0 * b * hq * (d + dv) * pairs,
            kind="bf16" if dt == bf else "fp32", path=path, phase=phase)
        if d != dv:
            cases.append(case)
            return
        plan = fa.flash_plan(b, hq, hkv, sq, skv, n_kv, d, dt, causal)
        if plan.wr == 8:
            # the plan's 128-row blocks against 64-row ones (each K/V
            # tile read from L2 for half the rows), timed in phase 3
            rows64 = dataclasses.replace(
                plan, qn=64, rows=64, wr=4, stages=fa.tc_stages(4),
                q_tiles=-(-sq // 64), smem=fa.tc_smem(d, 4))
            if d != 128:        # the 64-row alternative is timed at d 128
                cases.append(case)
                return
            case["plans"] = (
                (("128-row blocks (the plan)", plan),
                 ("64-row blocks", rows64)),
                lambda p: fa.flash_attention_cuda(q, k, v, plan=p, **kw))
        cases.append(case)

    flash_case("attention:prefill", 4, 32, 8, 32, 32, None, bf, bf_tol)
    flash_case("attention:decode", 4, 32, 8, 1, MAX_SEQ, 40, bf, bf_tol)
    # phase 14 serves phi3.5-moe at the same head counts and sizes (32 / 8
    # heads of 128): its launches counted apart
    flash_case("attention:phi35_prefill", 4, 32, 8, 32, 32, None, bf,
               bf_tol, phase="phi35")
    flash_case("attention:phi35_decode", 4, 32, 8, 1, MAX_SEQ, 40, bf,
               bf_tol, phase="phi35")
    flash_case("attention:decode_fp32", 4, 32, 8, 1, MAX_SEQ, 40, f32,
               f_tol, path=False)
    # a real prompt length, and a decode step over a long cache: the
    # kernel, not the host, sets these times
    flash_case("attention:prefill_4096", 1, 32, 8, 4096, 4096, None, bf,
               bf_tol, path=False)
    flash_case("attention:decode_4096", 4, 32, 8, 1, 4096, 4000, bf, bf_tol,
               path=False)
    # MLA's (q/k 192, v 128) route at phase 12's deepseek-v2-lite-16b
    # shapes (16 heads, one kv head each): a prefill chunk (the config's
    # prefill_microbatch 2 cuts the 4 prompts into chunks of 2), the
    # 2048-token prompt, a decode step over the 56-slot cache and the long
    # prompt's decode (split, with its merge); an fp32 case off the path
    mla = dict(d=192, dv=128, phase="deepseek")
    flash_case(f"attention:mla_prefill_b{BATCH // 2}_h16_s{PROMPT_LEN}",
               BATCH // 2, 16, 16, PROMPT_LEN, PROMPT_LEN, None, bf, bf_tol,
               **mla)
    flash_case(f"attention:mla_prefill_b1_s{LONG_PROMPT}", 1, 16, 16,
               LONG_PROMPT, LONG_PROMPT, None, bf, bf_tol, **mla)
    flash_case(f"attention:mla_decode_b{BATCH}_kv40_of_{MAX_SEQ}", BATCH, 16,
               16, 1, MAX_SEQ, 40, bf, bf_tol, **mla)
    flash_case(f"attention:mla_decode_b1_kv{LONG_PROMPT + 1}_of_{LONG_SEQ}",
               1, 16, 16, 1, LONG_SEQ, LONG_PROMPT + 1, bf, bf_tol, **mla)
    flash_case("attention:mla_prefill_b1_s300_fp32", 1, 16, 16, 300, 300,
               None, f32, f_tol, path=False, **mla)
    # phase 17's whisper-medium (16 heads of 64, one kv head each): the
    # encoder's 1500 frames non-causal, the decoder's causal prompt, its
    # cross-attention non-causal on the encoder's keys (the projections'
    # views at prefill, the cached bf16 keys whole at decode: split, with
    # its merge), the causal decode step; an fp32 ragged shape off the path
    wh = dict(d=64, dv=64, phase="whisper")
    flash_case(f"attention:whisper_enc_b{BATCH}_h16_s{ENC_SEQ}_d64", BATCH,
               16, 16, ENC_SEQ, ENC_SEQ, None, bf, bf_tol, causal=False, **wh)
    flash_case(f"attention:whisper_self_b{BATCH}_s{PROMPT_LEN}_d64", BATCH,
               16, 16, PROMPT_LEN, PROMPT_LEN, None, bf, bf_tol, **wh)
    flash_case(f"attention:whisper_cross_b{BATCH}_sq{PROMPT_LEN}_skv{ENC_SEQ}"
               f"_d64", BATCH, 16, 16, PROMPT_LEN, ENC_SEQ, None, bf, bf_tol,
               causal=False, **wh)
    flash_case(f"attention:whisper_self_decode_b{BATCH}_kv40_of_{MAX_SEQ}"
               f"_d64", BATCH, 16, 16, 1, MAX_SEQ, 40, bf, bf_tol, **wh)
    flash_case(f"attention:whisper_cross_decode_b{BATCH}_skv{ENC_SEQ}_d64",
               BATCH, 16, 16, 1, ENC_SEQ, None, bf, bf_tol, causal=False,
               cached=True, **wh)
    flash_case("attention:whisper_cross_b1_sq100_skv300_d64_fp32", 1, 16, 16,
               100, 300, None, f32, f_tol, causal=False, path=False, d=64,
               dv=64)
    # phase 18's qwen2-vl-2b (12 / 2 heads of 128: a GQA group of 6): the
    # 288-token prompt (256 patches, 32 text) and a decode step
    flash_case(f"attention:qwen_prefill_b{BATCH}_hq12_hkv2_s{QWEN_PLEN}",
               BATCH, 12, 2, QWEN_PLEN, QWEN_PLEN, None, bf, bf_tol,
               phase="qwen")
    flash_case(f"attention:qwen_decode_b{BATCH}_kv{QWEN_PLEN + 1}_of_"
               f"{QWEN_MAX_SEQ}", BATCH, 12, 2, 1, QWEN_MAX_SEQ,
               QWEN_PLEN + 1, bf, bf_tol, phase="qwen")

    # the split-kv merge alone, at the decode step of phase 5's long
    # prompt (b 1, kv_len 2049 of 2064: the plan splits the keys), on the
    # partials its split kernel leaves
    if wanted("attention_merge"):
        cases.append(merge_case(torch, rn, fa, flash_src, flash_rep, bf_tol))
        # and at whisper's decode cross-attention (d 64, non-causal, all
        # 1500 cached encoder keys)
        cases.append(merge_case(torch, rn, fa, flash_src, flash_rep, bf_tol,
                                b=BATCH, hq=16, hkv=16, skv=ENC_SEQ,
                                kv_len=ENC_SEQ, d=64, causal=False,
                                name="whisper_cross_decode", phase="whisper"))

    vocab = 128256
    red_rep = "src/repro/kernels/ntx_reduce.py:153"
    cr_rep = "src/repro/kernels/ntx_reduce.py:117"

    def with_ties(x):
        top, bot = x.max() + 1.0, x.min() - 1.0
        at = lambda i: i * x.shape[1] // vocab       # llama's row: i
        for r in range(x.shape[0]):          # planted ties across threads
            x[r, at(1000) + r] = x[r, at(90000) - r] = top
            x[r, at(2000) + r] = x[r, at(120000) - r] = bot
        return x

    def reduce_case(op, x, path, phase="serve"):
        lib = {"sum": torch.sum, "min": torch.amin, "max": torch.amax,
               "argmin": torch.argmin, "argmax": torch.argmax}[op]
        cases.append(dict(
            name=f"reduce:{op}_{x.shape[0]}x{x.shape[1]}", wrapper="reduce",
            source=stream_src, replaces=red_rep,
            kernel=lambda: ops.reduce(op, x),
            plain=lambda: ntx_reduce.reduce_plain(op, x),
            library=lambda: lib(x, -1), mode="sum" if op == "sum" else
            "equal", tol=(1e-5, 0.0), scale=x.abs().sum(-1),
            bytes=x.numel() * 4 + x.shape[0] * 4, ops=x.numel(),
            kind="fp32", path=path, phase=phase))

    x4 = with_ties(rn(4, vocab))
    for op in ntx_reduce.REDUCE_OPS:
        reduce_case(op, x4, path=False)
    # greedy decode reduces each request's logits row on its own (phase
    # 14: phi3.5-moe's 32064-wide rows)
    reduce_case("argmax", with_ties(rn(1, vocab)), path=True)
    reduce_case("argmax", with_ties(rn(1, PHI35_VOCAB)), path=True,
                phase="phi35")
    # phases 17-18: whisper's and qwen2-vl's padded vocabularies
    reduce_case("argmax", with_ties(rn(1, WHISPER_VOCAB)), path=True,
                phase="whisper")
    reduce_case("argmax", with_ties(rn(1, QWEN_VOCAB)), path=True,
                phase="qwen")

    row = rn(1, vocab, std=3.0)
    gum = -torch.log(-torch.log(torch.rand(1, vocab, generator=g,
                                           device=dev)))
    row[0, 77] = row[0, 99999] = row.max() + 5.0     # tie for COPY->ARGMAX
    chains = [
        ("chain_reduce:copy_argmax_1x128256", [("copy", 0.0)], row, (),
         True, "serve"),
        ("chain_reduce:axpy_argmax_1x128256", [("axpy", 1 / 0.8)], row,
         (gum,), True, "serve"),
        ("chain_reduce:axpy_thresh_argmax_1x128256",
         [("axpy", 1 / 0.8), ("thresh", 1024.0 + 2.0)], row,
         (gum + 1024.0,), False, "serve"),
        (f"chain_reduce:phi35_axpy_argmax_1x{PHI35_VOCAB}",
         [("axpy", 1 / 0.8)], row[:, :PHI35_VOCAB].contiguous(),
         (gum[:, :PHI35_VOCAB].contiguous(),), True, "phi35"),
    ]
    for tag, v in (("whisper", WHISPER_VOCAB), ("qwen", QWEN_VOCAB)):
        vrow = rn(1, v, std=3.0)
        vgum = -torch.log(-torch.log(torch.rand(1, v, generator=g,
                                                device=dev)))
        chains.append((f"chain_reduce:{tag}_axpy_argmax_1x{v}",
                       [("axpy", 1 / 0.8)], vrow, (vgum,), True, tag))
    for name, stages, xx, ys, path, phase in chains:
        # COPY->ARGMAX is one torch.argmax; the AXPY chains have no one call
        lib = (lambda xx=xx: torch.argmax(xx, -1)) \
            if stages == [("copy", 0.0)] else None
        cases.append(dict(
            name=name, wrapper="chain_reduce", source=stream_src,
            replaces=cr_rep,
            kernel=lambda s=stages, xx=xx, ys=ys: ops.chain_reduce(
                s, "argmax", xx, ys),
            plain=lambda s=stages, xx=xx, ys=ys: _chain_reduce_plain(
                ops, ntx_reduce, s, xx, ys),
            library=lib, mode="equal", tol=(0.0, 0.0),
            bytes=xx.numel() * 4 * (2 + len(ys)) + 4,
            ops=xx.numel() * (len(stages) + 1), kind="fp32", path=path,
            phase=phase))

    ew_rep = "src/repro/kernels/ntx_elementwise.py:61"
    chain_rep = "src/repro/kernels/ntx_elementwise.py:109"
    n = 100003                                        # ragged on purpose
    ex, ey = rn(1, n), rn(1, n)
    ey[0, ::7] = 0.0                                  # MASK zeros
    imm = 0.3
    libs = {"axpy": lambda: torch.add(ey, ex, alpha=imm),
            "add": lambda: torch.add(ex, ey),
            "sub": lambda: torch.sub(ex, ey),
            "mul": lambda: torch.mul(ex, ey),
            "mask": lambda: torch.where(ey != 0, ex, 0.0),
            "relu": lambda: torch.relu(ex),
            "thresh": lambda: F.threshold(ex, imm, 0.0),   # strict >
            "copy": lambda: ex.clone(),
            "set": lambda: torch.full_like(ex, imm)}
    for op in ew._OPCODE:
        y = ey if op in ew._OPS2 else None
        cases.append(dict(
            name=f"elementwise:{op}_1x{n}", wrapper="elementwise",
            source=stream_src, replaces=ew_rep,
            kernel=lambda op=op, y=y: ops.elementwise(op, ex, y, imm=imm),
            plain=lambda op=op, y=y: ew.elementwise_plain(op, ex, y, imm),
            library=libs[op], mode="equal", tol=(0.0, 0.0),
            bytes=n * 4 * (2 + (y is not None) - (op == "set")), ops=n,
            kind="fp32", path=False))
    all_stages = [(op, 0.3 + 0.1 * i) for i, op in enumerate(ew._OPCODE)
                  if op != "set"] + [("set", 2.0), ("axpy", -1.5)]
    n_ys = sum(1 for op, _ in all_stages if op in ew._OPS2)
    chain_ys = tuple(rn(1, n) for _ in range(n_ys))
    cases.append(dict(
        name=f"elementwise_chain:{len(all_stages)}_stages_1x{n}",
        wrapper="elementwise_chain", source=stream_src, replaces=chain_rep,
        kernel=lambda: ops.elementwise_chain(all_stages, ex, chain_ys),
        plain=lambda: ew.elementwise_chain_plain(all_stages, ex, chain_ys),
        library=None, mode="equal", tol=(0.0, 0.0),
        bytes=n * 4 * (2 + n_ys), ops=n * len(all_stages), kind="fp32",
        path=False))
    # a view at an odd element offset takes the scalar instantiation
    flat = rn(2 * n + 1)
    ux, uy = flat[1:n + 1].view(1, n), flat[n + 1:].view(1, n)
    cases.append(dict(
        name=f"elementwise:axpy_1x{n}_offset_1", wrapper="elementwise",
        source=stream_src, replaces=ew_rep,
        kernel=lambda: ops.elementwise("axpy", ux, uy, imm=imm),
        plain=lambda: ew.elementwise_plain("axpy", ux, uy, imm),
        library=lambda: torch.add(uy, ux, alpha=imm), mode="equal",
        tol=(0.0, 0.0), bytes=n * 12, ops=2 * n, kind="fp32", path=False))
    cases += train_cases(torch, rn)
    cases += ssm_serve_cases(torch, rn)
    cases += suite_cases(torch, rn)
    # the dense training path's MLP products at m = 4 x 2048 tokens: the
    # forward's three (a1 and the gate, and dh = dout w2^T in the
    # backward, share the first shape), and the backward's dx and weight
    # gradients (fp32 out; transposed operands are contiguous copies)
    m_tr = DENSE_BATCH * DENSE_SEQ
    for name, m, k, n, out_dt, ep in (
            (f"gemm:train_gate_a1_dh_m{m_tr}_k4096_n14336", m_tr, 4096,
             14336, f32, []),
            (f"gemm:train_w1_silu_mul_m{m_tr}", m_tr, 4096, 14336, bf,
             [("silu",), ("mul", f32)]),
            (f"gemm:train_w2_residual_m{m_tr}_k14336_n4096", m_tr, 14336,
             4096, bf, [("residual", bf)]),
            (f"gemm:train_dx_residual_m{m_tr}_k14336_n4096", m_tr, 14336,
             4096, bf, [("residual", f32)]),
            ("gemm:train_dw1_dw3_m4096_k8192_n14336", 4096, m_tr, 14336,
             f32, []),
            ("gemm:train_dw2_m14336_k8192_n4096", 14336, m_tr, 4096, f32,
             [])):
        if wanted(name):
            gemm_case(name, m, k, n, bf, out_dt, ep, f_tol if out_dt == f32
                      else bf_tol, phase="dense")
    # phase 20: the same products at the blocks of a rank of an 8-way
    # model axis (d_ff 14336 / 8 = 1792 columns of w1 / w3, rows of w2;
    # the residual is added after the sum over ranks, so w2 stores none)
    ff8 = 14336 // TP_RANKS
    for name, m, k, n, out_dt, ep in (
            (f"gemm:tp8_gate_a1_dh_m{m_tr}_k4096_n{ff8}", m_tr, 4096, ff8,
             f32, []),
            (f"gemm:tp8_w1_silu_mul_m{m_tr}_n{ff8}", m_tr, 4096, ff8, bf,
             [("silu",), ("mul", f32)]),
            (f"gemm:tp8_w2_m{m_tr}_k{ff8}_n4096", m_tr, ff8, 4096, bf, []),
            (f"gemm:tp8_dx_residual_m{m_tr}_k{ff8}_n4096", m_tr, ff8, 4096,
             bf, [("residual", f32)]),
            (f"gemm:tp8_dw1_dw3_m4096_k{m_tr}_n{ff8}", 4096, m_tr, ff8, f32,
             []),
            (f"gemm:tp8_dw2_m{ff8}_k{m_tr}_n4096", ff8, m_tr, 4096, f32, [])):
        if wanted(name):
            gemm_case(name, m, k, n, bf, out_dt, ep, f_tol if out_dt == f32
                      else bf_tol, phase="mesh")
    # phase 17's GELU MLPs (d 1024, d_ff 4096): the encoder's 4 x 1500
    # frames, a decode step's 4 rows; phase 18's SwiGLU (1536 -> 8960) at
    # the 4 x 288-token prefill
    m_enc, m_q = BATCH * ENC_SEQ, BATCH * QWEN_PLEN
    for name, m, k, n, out_dt, ep, phase in (
            (f"gemm:whisper_w1_gelu_m{m_enc}_k1024_n4096", m_enc, 1024, 4096,
             bf, [("gelu",)], "whisper"),
            (f"gemm:whisper_w2_residual_m{m_enc}_k4096_n1024", m_enc, 4096,
             1024, bf, [("residual", bf)], "whisper"),
            (f"gemm:whisper_decode_w1_gelu_m{BATCH}", BATCH, 1024, 4096, bf,
             [("gelu",)], "whisper"),
            (f"gemm:whisper_decode_w2_residual_m{BATCH}", BATCH, 4096, 1024,
             bf, [("residual", bf)], "whisper"),
            (f"gemm:qwen_w3_gate_m{m_q}_k1536_n8960", m_q, 1536, 8960, f32,
             [], "qwen"),
            (f"gemm:qwen_w1_silu_mul_m{m_q}", m_q, 1536, 8960, bf,
             [("silu",), ("mul", f32)], "qwen"),
            (f"gemm:qwen_w2_residual_m{m_q}_k8960_n1536", m_q, 8960, 1536,
             bf, [("residual", bf)], "qwen")):
        if wanted(name):
            gemm_case(name, m, k, n, bf, out_dt, ep, f_tol if out_dt == f32
                      else bf_tol, phase=phase)
    # the GELU MLP of a rank of whisper's 8-way model axis (the encoder's
    # 8 x 1500 frames, d_ff 4096 / 8 = 512) and qwen2-vl's SwiGLU (4 x 1024
    # tokens, d_ff 8960 / 8 = 1120), each w2 without the residual (added
    # after the sum over ranks); counted under their training phases
    m_wt = WHISPER_TRAIN_BATCH * ENC_SEQ
    m_qt = QWEN_TRAIN_BATCH * QWEN_TRAIN_SEQ
    ff_w, ff_q = 4096 // TP_RANKS, 8960 // TP_RANKS
    for name, m, k, n, out_dt, ep, phase in (
            (f"gemm:tp8_whisper_w1_gelu_m{m_wt}_k1024_n{ff_w}", m_wt, 1024,
             ff_w, bf, [("gelu",)], "whisper_train"),
            (f"gemm:tp8_whisper_w2_m{m_wt}_k{ff_w}_n1024", m_wt, ff_w, 1024,
             bf, [], "whisper_train"),
            (f"gemm:tp8_qwen_w3_gate_m{m_qt}_k1536_n{ff_q}", m_qt, 1536,
             ff_q, f32, [], "qwen_train"),
            (f"gemm:tp8_qwen_w1_silu_mul_m{m_qt}_k1536_n{ff_q}", m_qt, 1536,
             ff_q, bf, [("silu",), ("mul", f32)], "qwen_train"),
            (f"gemm:tp8_qwen_w2_m{m_qt}_k{ff_q}_n1536", m_qt, ff_q, 1536, bf,
             [], "qwen_train")):
        if wanted(name):
            gemm_case(name, m, k, n, bf, out_dt, ep, f_tol if out_dt == f32
                      else bf_tol, phase=phase)
    cases += dense_cases(torch, rn, bf_tol)
    return cases


def merge_case(torch, rn, fa, flash_src, flash_rep, tol, b=1, hq=32,
               hkv=8, skv=LONG_SEQ, kv_len=LONG_PROMPT + 1, d=128,
               causal=True, name="decode", phase="serve") -> dict:
    """The split-kv merge of ``csrc/flash_attention.cu`` on its own, on
    the partials the split kernel leaves at a decode step (default: that
    of phase 5's long prompt)."""
    bf = torch.bfloat16
    mq = rn(b, hq, 1, d, dt=bf)
    mk, mv = (rn(b, hkv, skv, d, dt=bf) for _ in range(2))
    plan = fa.flash_plan(b, hq, hkv, 1, skv, kv_len, d, bf, causal)
    ws, mo = fa.flash_attention_cuda(mq, mk, mv, causal=causal,
                                     kv_len=kv_len, plan=plan, partials=True)
    case = dict(
        name=f"attention_merge:{name}_kv{kv_len}_{plan.splits}_splits",
        wrapper="attention_merge", source=flash_src, replaces=flash_rep,
        kernel=lambda: fa.flash_merge_cuda(ws, mo, plan.splits),
        plain=lambda: fa.flash_merge_plain(ws, plan.splits, b, hq, 1, d,
                                           bf),
        library=None, mode="close", tol=tol,
        bytes=ws.numel() * 4 + mo.numel() * 2,
        ops=3.0 * ws.numel(), kind="fp32", path=True, phase=phase)
    del mk, mv
    return case


def dense_cases(torch, rn, bf_tol):
    """The dense training path's new kernels (``phase="dense"``): the
    flash backward at phase 11's shape (b 4, hq 32, hkv 8, s 2048, d 128,
    bf16, causal) against ``ref.mha_blocked``'s VJP by the worst
    relative L2 of dQ / dK / dV (GRAD_RTOL), its last key tile on its
    own; off the path, yi's group of 8 (hkv 4) and a ragged fp32 shape;
    the forward with lse against its plain version (o keeping the bits of
    the call without lse); the activation backward bit-equal at phase
    11's 8192 x 14336. The backward's library call is SDPA's backward:
    its forward and backward, less its forward."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ntx_elementwise as ew
    bf, f32 = torch.bfloat16, torch.float32
    flash_src = "src/repro_torch/kernels/csrc/flash_attention.cu"
    bwd_src = "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
    bwd_rep = "src/repro/kernels/ref.py:250 _mha_blocked_bwd"
    cases = []

    def qkv(b, hq, hkv, s, dt, d=128, dv=128, skv=None):
        # (b, s, h, d) projections viewed as (b, h, s, d), as the model
        # makes them (MLA's q and k: contiguous concatenations); dO as
        # autograd hands it (a view of (b, s, h dv)); k and v of skv rows
        # (default s: the encoder-decoder's cross-attention has more)
        skv = s if skv is None else skv
        if d == dv:
            q = rn(b, s, hq, d, dt=dt, std=0.5).transpose(1, 2)
            k = rn(b, skv, hkv, d, dt=dt, std=0.5).transpose(1, 2)
        else:
            q = rn(b, hq, s, d, dt=dt, std=0.5)
            k = rn(b, hkv, skv, d, dt=dt, std=0.5)
        v = rn(b, skv, hkv, dv, dt=dt).transpose(1, 2)
        do = rn(b, s, hq, dv, dt=dt).transpose(1, 2)
        return q, k, v, do

    def bwd_case(name, b, hq, hkv, s, dt, path, d=128, dv=128,
                 phase="dense", skv=None, causal=True):
        if not wanted(name):
            return
        skv = s if skv is None else skv
        q, k, v, do = qkv(b, hq, hkv, s, dt, d, dv, skv)
        plan = fa.flash_plan(b, hq, hkv, s, skv, skv, d, dt, causal,
                             lse=True, **({} if d == dv else {"dv": dv}))
        o, lse = fa.flash_attention_cuda(q, k, v, causal=causal, plan=plan,
                                         lse=True)
        lib_in = [t.detach().clone().requires_grad_() for t in (q, k, v)]

        def lib_fwd():
            return F.scaled_dot_product_attention(*lib_in, is_causal=causal,
                                                  enable_gqa=True)

        def last_tile(got, want):
            rel = [float((g[:, :, -64:].float() - w[:, :, -64:].float())
                         .norm() / w[:, :, -64:].float().norm())
                   for g, w in zip(got[1:], want[1:])]
            again = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                                causal=causal)
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            ok = max(rel) <= GRAD_RTOL[str(dt)[6:]] and all(
                float(g[:, :, -64:].float().abs().sum()) > 0
                for g in got[1:]) and same
            return ok, (f"last key tile (keys {skv - 64}-{skv - 1}): dK, dV "
                        f"rel L2 {rel[0]:.3e}, {rel[1]:.3e}, nonzero | a "
                        f"second call bit-equal {same}")
        bp = fa.flash_bwd_plan(b, hq, hkv, s, skv, d, dt, causal,
                               *(() if d == dv else (dv,)))
        # (an older tree's plan, under --src, has no group split or ring)
        note = (f" | plan gs {getattr(bp, 'gs', 1)}, stages "
                f"{getattr(bp, 'stages', 2)}, dK/dV grid {bp.dkdv_grid}, dQ "
                f"grid {bp.dq_grid}")
        esz = q.element_size()
        pairs = b * hq * (s * (s + 1) / 2 if causal else s * skv)
        # q, dq at d and o, dO at dv a query; k, dk at d and v, dv at dv a
        # key; five products a pair: S, dK, dQ over d, dP, dV over dv
        cases.append(dict(
            name=name, wrapper="attention_bwd", source=bwd_src,
            replaces=bwd_rep,
            kernel=lambda: fa.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                                        causal=causal),
            plain=lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                       causal=causal),
            library=lambda: torch.autograd.grad(lib_fwd(), lib_in, do),
            library_minus=lib_fwd, backend=lib_fwd, check_vs=last_tile,
            note=note,
            mode="rel_l2", tol=(GRAD_RTOL[str(dt)[6:]], 0.0),
            bytes=(b * (hq * s + hkv * skv) * 2 * (d + dv)) * esz
            + lse.numel() * 4,
            ops=2.0 * (3 * d + 2 * dv) * pairs,
            kind="bf16" if dt == bf else "fp32", path=path, phase=phase))

    bwd_case(f"attention_bwd:train_b{DENSE_BATCH}_hq32_hkv8_s{DENSE_SEQ}"
             f"_bf16", DENSE_BATCH, 32, 8, DENSE_SEQ, bf, True)
    # a rank of an 8-way model axis: 32 / 8 q heads, the one kv head they
    # read (phase 20)
    bwd_case(f"attention_bwd:tp8_b{DENSE_BATCH}_hq4_hkv1_s{DENSE_SEQ}_bf16",
             DENSE_BATCH, 32 // TP_RANKS, 1, DENSE_SEQ, bf, True,
             phase="mesh")
    bwd_case(f"attention_bwd:yi_b2_hq32_hkv4_s{DENSE_SEQ}_bf16", 2, 32, 4,
             DENSE_SEQ, bf, False)
    bwd_case("attention_bwd:b1_hq8_hkv2_s1000_fp32", 1, 8, 2, 1000, f32,
             False)
    # MLA's (q/k 192, v 128) backward at phase 13's microbatch (deepseek's
    # 16 heads, one 2048-token row: the 4 x 2048 batch in grad_accum 4),
    # and a small fp32 case; phi3.5-moe's GQA backward at phase 14's
    # microbatch (8 x 2048 in grad_accum 8)
    bwd_case(f"attention_bwd:mla_b1_h16_s{DENSE_SEQ}_bf16", 1, 16, 16,
             DENSE_SEQ, bf, True, d=192, dv=128, phase="deepseek_train")
    bwd_case("attention_bwd:mla_b1_h4_s300_fp32", 1, 4, 4, 300, f32, False,
             d=192, dv=128)
    bwd_case(f"attention_bwd:phi35_b1_hq32_hkv8_s{DENSE_SEQ}_bf16", 1, 32,
             8, DENSE_SEQ, bf, True, phase="phi35_train")

    def lse_case(name, b, hq, hkv, s, phase, d=128, dv=128, skv=None,
                 causal=True):
        if not wanted(name):
            return
        skv = s if skv is None else skv
        q, k, v, _ = qkv(b, hq, hkv, s, bf, d, dv, skv)
        plan = fa.flash_plan(b, hq, hkv, s, skv, skv, d, bf, causal,
                             lse=True, dv=dv)
        o_serve = fa.flash_attention_cuda(q, k, v, causal=causal, plan=plan)

        def lse_check(got, want):
            err = float((got[1] - want[1]).abs().max())
            ok = torch.equal(got[0], o_serve) and err <= 1e-4 * (
                1.0 + float(want[1].abs().max()))
            return ok, (f"o bit-equal to the call without lse "
                        f"{torch.equal(got[0], o_serve)} | lse max_abs_err "
                        f"{err:.3e} (<= 1e-4 (1 + max|lse|))")
        pairs = b * hq * (s * (s + 1) / 2 if causal else s * skv)
        scale = d ** -0.5            # MLA's (dn + dr) ** -0.5 at 192
        sdpa = lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True, scale=scale)
        cases.append(dict(
            name=name, wrapper="attention", source=flash_src,
            replaces="src/repro/kernels/flash_attention.py:77",
            kernel=lambda: fa.flash_attention_cuda(q, k, v, causal=causal,
                                                   plan=plan, lse=True),
            plain=lambda: (fa.flash_attention_plain(q, k, v, causal=causal),
                           fa.flash_lse_plain(q, k, causal=causal)),
            library=sdpa, backend=sdpa,
            check_vs=lse_check, mode="close", tol=bf_tol,
            bytes=(q.numel() + k.numel() + v.numel() + b * hq * s * dv) * 2
            + b * hq * s * 4,
            ops=2.0 * (d + dv) * pairs, kind="bf16", path=True,
            phase=phase))

    lse_case(f"attention:train_lse_b{DENSE_BATCH}_s{DENSE_SEQ}_bf16",
             DENSE_BATCH, 32, 8, DENSE_SEQ, "dense")
    lse_case(f"attention:tp8_lse_b{DENSE_BATCH}_hq4_hkv1_s{DENSE_SEQ}_bf16",
             DENSE_BATCH, 32 // TP_RANKS, 1, DENSE_SEQ, "mesh")
    lse_case(f"attention:mla_train_lse_b1_h16_s{DENSE_SEQ}_bf16", 1, 16, 16,
             DENSE_SEQ, "deepseek_train", d=192, dv=128)
    # a rank of deepseek's 8-way model axis: 16 / 8 MLA heads (phase 20's
    # deepseek mesh step runs the unsplit shape on one card)
    lse_case(f"attention:tp8_mla_lse_b1_h2_s{DENSE_SEQ}_bf16", 1,
             16 // TP_RANKS, 16 // TP_RANKS, DENSE_SEQ, "mesh_deepseek",
             d=192, dv=128)
    lse_case(f"attention:phi35_train_lse_b1_hq32_hkv8_s{DENSE_SEQ}_bf16", 1,
             32, 8, DENSE_SEQ, "phi35_train")
    # phase 17's training forward with lse: the encoder's 1500 frames and
    # the decoder's cross-attention non-causal, its self-attention causal;
    # phase 18's at 4 x 1024 (a GQA group of 6)
    wb, ws_ = WHISPER_TRAIN_BATCH, WHISPER_TRAIN_SEQ
    wt = dict(d=64, dv=64)
    lse_case(f"attention:whisper_train_lse_enc_b{wb}_s{ENC_SEQ}", wb, 16, 16,
             ENC_SEQ, "whisper_train", causal=False, **wt)
    lse_case(f"attention:whisper_train_lse_cross_b{wb}_sq{ws_}_skv{ENC_SEQ}",
             wb, 16, 16, ws_, "whisper_train", skv=ENC_SEQ, causal=False,
             **wt)
    lse_case(f"attention:whisper_train_lse_self_b{wb}_s{ws_}", wb, 16, 16,
             ws_, "whisper_train", **wt)
    lse_case(f"attention:qwen_train_lse_b{QWEN_TRAIN_BATCH}_hq12_hkv2_s"
             f"{QWEN_TRAIN_SEQ}", QWEN_TRAIN_BATCH, 12, 2, QWEN_TRAIN_SEQ,
             "qwen_train")
    # a rank of whisper's 8-way model axis: 16 / 8 heads of 64
    h8 = 16 // TP_RANKS
    lse_case(f"attention:tp8_whisper_lse_enc_b{wb}_h{h8}_s{ENC_SEQ}", wb, h8,
             h8, ENC_SEQ, "whisper_train", causal=False, **wt)
    lse_case(f"attention:tp8_whisper_lse_cross_b{wb}_h{h8}_sq{ws_}_skv"
             f"{ENC_SEQ}", wb, h8, h8, ws_, "whisper_train", skv=ENC_SEQ,
             causal=False, **wt)
    # and their backward: sq != skv non-causal (both tiles ragged: 1500 =
    # 23 x 64 + 28), the encoder's square non-causal, the decoder's causal,
    # qwen's group of 6; a small fp32 sq != skv case off the path
    bwd_case(f"attention_bwd:whisper_cross_b{wb}_h16_sq{ws_}_skv{ENC_SEQ}"
             f"_bf16", wb, 16, 16, ws_, bf, True, skv=ENC_SEQ, causal=False,
             phase="whisper_train", **wt)
    bwd_case(f"attention_bwd:whisper_enc_b{wb}_h16_s{ENC_SEQ}_bf16", wb, 16,
             16, ENC_SEQ, bf, True, causal=False, phase="whisper_train", **wt)
    bwd_case(f"attention_bwd:whisper_self_b{wb}_h16_s{ws_}_bf16", wb, 16, 16,
             ws_, bf, True, phase="whisper_train", **wt)
    bwd_case(f"attention_bwd:qwen_b{QWEN_TRAIN_BATCH}_hq12_hkv2_s"
             f"{QWEN_TRAIN_SEQ}_bf16", QWEN_TRAIN_BATCH, 12, 2,
             QWEN_TRAIN_SEQ, bf, True, phase="qwen_train")
    bwd_case("attention_bwd:b1_h4_sq100_skv300_d64_fp32", 1, 4, 4, 100, f32,
             False, skv=300, causal=False, **wt)
    # the backward at the 8-way ranks' shapes: deepseek's 2 MLA heads,
    # whisper's 2 heads of 64 (cross-attention and the encoder)
    bwd_case(f"attention_bwd:tp8_mla_b1_h2_s{DENSE_SEQ}_bf16", 1,
             16 // TP_RANKS, 16 // TP_RANKS, DENSE_SEQ, bf, True, d=192,
             dv=128, phase="mesh_deepseek")
    bwd_case(f"attention_bwd:tp8_whisper_cross_b{wb}_h{h8}_sq{ws_}_skv"
             f"{ENC_SEQ}_bf16", wb, h8, h8, ws_, bf, True, skv=ENC_SEQ,
             causal=False, phase="whisper_train", **wt)
    bwd_case(f"attention_bwd:tp8_whisper_enc_b{wb}_h{h8}_s{ENC_SEQ}_bf16",
             wb, h8, h8, ENC_SEQ, bf, True, causal=False,
             phase="whisper_train", **wt)

    act_src = "src/repro_torch/kernels/csrc/ntx_act_bwd.cu"
    act_rep = ("none: XLA autodiff of the MLP's epilogue "
               "(src/repro/kernels/ntx_gemm.py:50 apply_epilogue)")
    for name, act, (m, n), dt, path in (
            (f"act_bwd:swiglu_{DENSE_BATCH * DENSE_SEQ}x14336_bf16",
             "swiglu", (DENSE_BATCH * DENSE_SEQ, 14336), bf, True),
            (f"act_bwd:tp8_swiglu_{DENSE_BATCH * DENSE_SEQ}x"
             f"{14336 // TP_RANKS}_bf16", "swiglu",
             (DENSE_BATCH * DENSE_SEQ, 14336 // TP_RANKS), bf, True),
            ("act_bwd:gelu_4096x4095_fp32", "gelu", (4096, 4095), f32,
             False),
            # phase 17's GELU MLPs: the decoder's 8 x 448 tokens and the
            # encoder's 8 x 1500 frames, d_ff 4096
            (f"act_bwd:whisper_gelu_{WHISPER_TRAIN_BATCH * WHISPER_TRAIN_SEQ}"
             f"x4096_bf16", "gelu", (WHISPER_TRAIN_BATCH * WHISPER_TRAIN_SEQ,
                                     4096), bf, True),
            (f"act_bwd:whisper_gelu_{WHISPER_TRAIN_BATCH * ENC_SEQ}x4096_bf16",
             "gelu", (WHISPER_TRAIN_BATCH * ENC_SEQ, 4096), bf, True),
            # phase 18's SwiGLU at 4 x 1024 tokens, d_ff 8960
            (f"act_bwd:qwen_swiglu_{QWEN_TRAIN_BATCH * QWEN_TRAIN_SEQ}x8960"
             f"_bf16", "swiglu", (QWEN_TRAIN_BATCH * QWEN_TRAIN_SEQ, 8960),
             bf, True)):
        if not wanted(name):
            continue
        dh, a1, gate = rn(m, n), rn(m, n, std=3.0), rn(m, n)
        g = gate if act == "swiglu" else None
        n_in, n_out = (3, 3) if act == "swiglu" else (2, 2)
        cases.append(dict(
            name=name, wrapper="act_bwd", source=act_src, replaces=act_rep,
            kernel=lambda a=(act, dh, a1, g, dt): ops.act_bwd(*a),
            plain=lambda a=(act, dh, a1, g, dt): ew.act_bwd_plain(*a),
            library=None, mode="equal", tol=(0.0, 0.0),
            bytes=m * n * (4 * n_in + n_out * (2 if dt == bf else 4)),
            ops=20.0 * m * n, kind="fp32", path=path,
            phase=("whisper_train" if "whisper" in name else "qwen_train"
                   if "qwen" in name else "mesh" if "tp8" in name
                   else "dense")))
    return cases


def ssd_inputs(torch, rn, b, l, dt_x, h=64, dh=64, n=128):
    """SSD operands at mamba2-1.3b's head shapes with the model's
    distributions: dt = softplus(N(0, 1)), A = -exp(U(log 1/4, log 4))
    (the strong decay at which the reference's jnp chunked form turns
    NaN), B and C 0.3 N(0, 1)."""
    dev = torch.device(DEVICE)
    x = rn(b, l, h, dh, dt=dt_x)
    dt = torch.nn.functional.softplus(rn(b, l, h))
    u = torch.rand(h, device=dev)
    A = -torch.exp(math.log(0.25) + u * math.log(16.0))
    return x, dt, A, rn(b, l, n, dt=dt_x, std=0.3), rn(b, l, n, dt=dt_x,
                                                       std=0.3)


def ssd_ops(l, h, dh, n, b, chunk) -> float:
    """Operations the scan needs: per chunk of L steps, C.B^T and W.X over
    the s <= t pairs, L (L + 1) (n + dh), plus C.S and the state update,
    4 L n dh."""
    per_seq = sum(L * (L + 1) * (n + dh) + 4 * L * n * dh
                  for L in (min(chunk, l - c0) for c0 in range(0, l, chunk)))
    return float(per_seq * b * h)


def train_cases(torch, rn):
    """The training path's kernels: the SSD scan at mamba2-1.3b's full
    width (batch 8, seq 1024, as phase 7 trains) and the fused AdamW step
    at a layer matrix's and the embedding's shape."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ntx_elementwise as ew
    from repro_torch.kernels.ssd_scan import ssd_scan_plain
    cases = []
    bf = torch.bfloat16
    ssd_src = "src/repro_torch/kernels/csrc/ssd_scan.cu"
    ssd_rep = "src/repro/kernels/ssd_scan.py:68"
    chunk = 128
    # bf16 y: the kernel (every product exact on the tensor cores, its
    # fp32 operands split into three bf16 parts) and the plain version
    # agree in fp32 to ~1e-6 and then round to bf16, so they may differ
    # by one bf16 ulp (2**-8 rel). The tp8 cases: a rank of an 8-way
    # model axis, mamba2's 64 / 8 SSD heads (phase 20's mamba2 mesh step
    # runs the unsplit shape on one card) and jamba's 128 / 8 at d_state
    # 16 (counted under phase 7's mamba2 step, jamba training none)
    for name, b, l, dt_x, tol, path, h, n, phase in (
            ("ssd:train_b8_l1024_bf16", TRAIN_BATCH, TRAIN_SEQ, bf,
             (1e-2, 1e-2), True, 64, 128, "train"),
            ("ssd:train_b8_l1024_fp32", TRAIN_BATCH, TRAIN_SEQ,
             torch.float32, (1e-3, 1e-3), False, 64, 128, "train"),
            ("ssd:ragged_b2_l1000_fp32", 2, 1000, torch.float32,
             (1e-3, 1e-3), False, 64, 128, "train"),
            (f"ssd:tp8_mamba2_b8_l1024_h{64 // TP_RANKS}_bf16", TRAIN_BATCH,
             TRAIN_SEQ, bf, (1e-2, 1e-2), True, 64 // TP_RANKS, 128,
             "mesh_mamba2"),
            (f"ssd:tp8_jamba_b8_l1024_h{128 // TP_RANKS}_n16_bf16",
             TRAIN_BATCH, TRAIN_SEQ, bf, (1e-2, 1e-2), True,
             128 // TP_RANKS, 16, "train")):
        if not wanted(name):
            continue
        x, dt, A, B, C = ssd_inputs(torch, rn, b, l, dt_x, h=h, n=n)
        esz = x.element_size()
        cases.append(dict(
            name=name, wrapper="ssd", source=ssd_src, replaces=ssd_rep,
            kernel=lambda a=(x, dt, A, B, C): ops.ssd(*a, chunk=chunk),
            plain=lambda a=(x, dt, A, B, C): ssd_scan_plain(*a, chunk),
            library=None, mode="close", tol=tol,
            bytes=2 * x.numel() * esz + dt.numel() * 4 + A.numel() * 4
            + 2 * B.numel() * esz,
            ops=ssd_ops(l, h, 64, n, b, chunk),
            kind="bf16" if dt_x == bf else "fp32", path=path,
            phase=phase))

    adamw_src = "src/repro_torch/kernels/csrc/ntx_adamw.cu"
    adamw_rep = "src/repro/kernels/ntx_elementwise.py:163"
    step, lr = 3, 3e-4 * 3 / 10
    for name, shape in (("adamw:layer_2048x4096_fp32", (2048, 4096)),
                        ("adamw:embed_50432x2048_fp32", (50432, 2048))):
        p, g = rn(*shape, std=0.02), rn(*shape, std=1e-3)
        m, v = rn(*shape, std=1e-4), rn(*shape, std=1e-7).abs()
        lib_args = ([p.clone()], [g.clone()], [m.clone()], [v.clone()], [],
                    [torch.tensor(float(step), device=DEVICE)])

        def library(a=lib_args):
            torch._fused_adamw_(*a, lr=lr, beta1=0.9, beta2=0.999,
                                weight_decay=0.01, eps=1e-8, amsgrad=False,
                                maximize=False)
        cases.append(dict(
            name=name, wrapper="adamw", source=adamw_src, replaces=adamw_rep,
            kernel=lambda a=(p, g, m, v): ops.adamw_update(*a, step, lr=lr),
            plain=lambda a=(p, g, m, v): ew.adamw_plain(*a, step, lr=lr),
            library=library, mode="close", tol=(1e-5, 1e-6),
            bytes=28.0 * p.numel(), ops=16.0 * p.numel(), kind="fp32",
            path=True, phase="train"))
    # off the path: an odd length whose operands start 1 element past a
    # 16-byte boundary together (a scalar head and tail around the
    # vectors), and apart (element by element throughout)
    n = 4 * 1000003 + 3
    for name, offs in (("adamw:offset1_odd_fp32", (1, 1, 1, 1)),
                       ("adamw:offsets0123_odd_fp32", (0, 1, 2, 3))):
        ins = []
        for off, std in zip(offs, (0.02, 1e-3, 1e-4, 1e-7)):
            buf = torch.empty(n + 4, device=DEVICE)
            view = buf[off:off + n]
            view.copy_(rn(n, std=std))
            ins.append(view)
        ins[3].abs_()
        cases.append(dict(
            name=name, wrapper="adamw", source=adamw_src, replaces=adamw_rep,
            kernel=lambda a=tuple(ins): ops.adamw_update(*a, step, lr=lr),
            plain=lambda a=tuple(ins): ew.adamw_plain(*a, step, lr=lr),
            library=None, mode="close", tol=(1e-5, 1e-6), bytes=28.0 * n,
            ops=16.0 * n, kind="fp32", path=False, phase="train"))
    return cases


def ssm_serve_cases(torch, rn):
    """The SSD kernel's final-state route (``ops.ssd_with_state``), as
    the serving prefills of phases 15-16 call it: mamba2-1.3b's widths
    (h 64, dh 64, n 128) at 4 x 32 (one ragged chunk) and at one
    2048-token prompt (16 chunks carried), jamba-v0.1-52b's (h 128, dh
    64, n 16) at 4 x 32, bf16, chunk 128. y against the plain version at
    1e-2 (rounded once to bf16: one ulp); the fp32 state apart, at an
    fp32 limit (its inputs exact and every sum fp32, only the order of the
    sums differs): relative L2 SSM_STATE_L2["float32"] and elementwise
    rtol = atol = 1e-3, as the card tests hold it; y bit-equal to
    ``ops.ssd``'s on the same inputs; timed beside ``ops.ssd``."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan import ssd_scan_with_state_plain
    cases = []
    bf, chunk = torch.bfloat16, 128
    for name, b, l, h, n, phase in (
            ("ssd_state:mamba2_prefill_b4_l32_bf16", BATCH, PROMPT_LEN, 64,
             128, "mamba2_serve"),
            ("ssd_state:mamba2_long_b1_l2048_bf16", 1, LONG_PROMPT, 64, 128,
             "mamba2_serve"),
            ("ssd_state:jamba_prefill_b4_l32_bf16", BATCH, PROMPT_LEN, 128,
             16, "jamba")):
        a = ssd_inputs(torch, rn, b, l, bf, h=h, n=n)
        x = a[0]

        def same_y(got, a=a):
            same = bool(torch.equal(got[0], ops.ssd(*a, chunk=chunk)))
            return same, f"y bit-equal to ops.ssd's: {same}"

        def state_close(got, want):
            d = (got[1] - want[1]).abs()
            rel = float(d.norm() / want[1].norm().clamp_min(1e-30))
            lim = SSM_STATE_L2["float32"]
            ok = (bool(torch.isfinite(got[1]).all()) and rel <= lim
                  and bool((d <= 1e-3 + 1e-3 * want[1].abs()).all()))
            return ok, (f"fp32 state {tuple(got[1].shape)}: rel L2 "
                        f"{rel:.3e} (<= {lim:g}), max_abs_err "
                        f"{float(d.max()):.3e} (rtol 1e-3 atol 1e-3)")
        cases.append(dict(
            name=name, wrapper="ssd_state",
            source="src/repro_torch/kernels/csrc/ssd_scan.cu",
            replaces="src/repro/kernels/ssd_scan.py:68",
            kernel=lambda a=a: ops.ssd_with_state(*a, chunk=chunk),
            plain=lambda a=a: ssd_scan_with_state_plain(*a, chunk=chunk),
            library=None, mode="close", tol=(1e-2, 1e-2), check=same_y,
            apart=(1,), check_vs=state_close, beside=[("ops.ssd (no state)",
                     lambda a=a: ops.ssd(*a, chunk=chunk))],
            bytes=2 * x.numel() * 2 + a[1].numel() * 4 + h * 4
            + 2 * a[3].numel() * 2 + b * h * n * 64 * 4,
            ops=ssd_ops(l, h, 64, n, b, chunk), kind="bf16", path=True,
            phase=phase))
    return cases


def laplace_per_axis(x, ops):
    """The per-axis route of ``ops.laplace`` before the fused kernel: a
    ``stencil_axis`` pass per axis over a contiguous copy of the slice
    interior on the other axes, the terms added with torch adds."""
    nd, out = x.dim(), None
    for d in range(nd):
        sl = [slice(1, -1)] * nd
        sl[d] = slice(None)
        term = ops.stencil_axis(x[tuple(sl)].contiguous(), (1.0, -2.0, 1.0),
                                d)
        out = term if out is None else out + term
    return out


def star_weight(torch, nd, device):
    """The (2 nd + 1)-point Laplace star as a conv weight (1, 1, 3, ...)."""
    w = torch.zeros((3,) * nd, device=device)
    centre = (1,) * nd
    w[centre] = -2.0 * nd
    for d in range(nd):
        for side in (0, 2):
            at = list(centre)
            at[d] = side
            w[tuple(at)] = 1.0
    return w[None, None]


def suite_cases(torch, rn):
    """The paper's kernel suite (phase 8's shapes, ``phase="suite"``):
    conv2d on an 8192 x 8192 fp32 plane (256 MiB, past the 50 MB L2),
    the [1, -2, 1] stencil pass along each axis of a 512**3 volume, the
    Laplace 1-D/2-D/3-D, the compensated GEMM at 4096**3, AXPY 2**22 and
    the THRESH -> RELU -> THRESH chain as the ntx.Program path hands them
    to the streaming kernel. Checked but not path shapes
    (``path=False``): the paper's Figure-5 sizes
    (``perfmodel/ntx.py:98-107``), which sit in L2, and the compensated
    GEMM at the reference test's x100 inputs and on exact slabs."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels import ntx_elementwise as ew
    from repro_torch.kernels import ntx_gemm
    from repro_torch.kernels import ntx_conv
    from repro_torch.kernels.ntx_stencil import laplace_plain, stencil1d_plain
    cases = []
    conv_src = "src/repro_torch/kernels/csrc/ntx_conv.cu"
    conv_rep = "src/repro/kernels/ntx_conv.py:33"
    st_src = "src/repro_torch/kernels/csrc/ntx_stencil.cu"
    st_rep = "src/repro/kernels/ntx_stencil.py:31"
    common = dict(kind="fp32", phase="suite")
    unfused = dict(common, kind="fp32_unfused")

    def conv_case(img, k, path):
        ker = rn(k, k, std=1.0 / k)
        h, w = img.shape
        oh, ow = h - k + 1, w - k + 1
        case = dict(
            name=f"conv2d:{k}x{k}_{h}x{w}", wrapper="conv2d",
            source=conv_src, replaces=conv_rep,
            kernel=lambda: ops.conv2d(img, ker),
            plain=lambda: ntx_conv.conv2d_plain(img, ker),
            library=lambda: F.conv2d(img[None, None], ker[None, None]),
            mode="equal", tol=(0.0, 0.0), bytes=4.0 * (h * w + oh * ow),
            ops=2.0 * k * k * oh * ow, path=path, **unfused)
        if path:
            # the plan's one block per tile against a persistent grid of
            # two blocks per SM (each walks its tiles with the next tile's
            # copy in flight), timed in phase 3
            plan = ntx_conv.tile_plan(oh, ow, k, k)
            sms = torch.cuda.get_device_properties(
                DEVICE).multi_processor_count
            case["plans"] = (
                (("one block per tile", plan),
                 ("persistent, two blocks per SM",
                  plan._replace(blocks=min(plan.tiles, 2 * sms)))),
                lambda p: ntx_conv.conv2d_cuda(img, ker, plan=p))
        cases.append(case)

    plane = rn(CONV_HW, CONV_HW)
    for k in CONV_TAPS:
        conv_case(plane, k, True)
    small = rn(256, 256)
    for k in CONV_TAPS:
        conv_case(small, k, False)

    taps = (1.0, -2.0, 1.0)
    vol = rn(*LAP_SHAPES[2])
    for axis in range(3):
        shape = [1, 1, 1]
        shape[axis] = 3
        wgt = torch.tensor(taps, device=DEVICE).reshape(1, 1, *shape)
        n_out = vol.numel() // vol.shape[axis] * (vol.shape[axis] - 2)
        cases.append(dict(
            name=f"stencil:k3_axis{axis}_{'x'.join(map(str, vol.shape))}",
            wrapper="stencil",
            source=st_src, replaces=st_rep,
            kernel=lambda a=axis: ops.stencil_axis(vol, taps, a),
            plain=lambda a=axis: stencil1d_plain(vol, taps, a),
            library=lambda wgt=wgt: F.conv3d(vol[None, None], wgt),
            mode="equal", tol=(0.0, 0.0),
            bytes=4.0 * (vol.numel() + n_out), ops=6.0 * n_out, path=True,
            **unfused))

    def laplace_case(x, path):
        nd = x.dim()
        interior = math.prod(s - 2 for s in x.shape)
        conv = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}[nd]
        wgt = star_weight(torch, nd, DEVICE)
        cases.append(dict(
            name=f"laplace:{nd}d_{'x'.join(map(str, x.shape))}",
            wrapper="laplace", source=st_src, replaces=st_rep,
            kernel=lambda: ops.laplace(x),
            plain=lambda: laplace_plain(x),
            library=lambda: conv(x[None, None], wgt)[0, 0],
            mode="equal", tol=(0.0, 0.0),
            bytes=4.0 * (x.numel() + interior),
            ops=2.0 * (2 * nd + 1) * interior, path=path, **unfused))

    laplace_case(rn(*LAP_SHAPES[0]), True)
    laplace_case(plane, True)
    laplace_case(vol, True)
    for shape in ((1 << 22,), (2048, 2048), (160, 160, 160)):
        laplace_case(rn(*shape), False)

    gemm_src = "src/repro_torch/kernels/csrc/ntx_gemm.cu"
    kahan_rep = "src/repro/kernels/ntx_gemm.py:112"

    def kahan_case(name, a, b, check, path, **how):
        m, k = a.shape
        n = b.shape[1]
        cases.append(dict(
            name=name, wrapper="gemm_kahan", source=gemm_src,
            replaces=kahan_rep,
            kernel=lambda: ops.gemm(a, b, compensated=True),
            plain=lambda: ntx_gemm.gemm_kahan_plain(a, b),
            library=None, aside=lambda: torch.matmul(a, b),
            check=check, bytes=4.0 * (m * k + k * n + m * n),
            ops=2.0 * m * n * k, path=path, **how, **common))

    def errors(a, b, got):
        """Max |error| of the compensated result and of the uncompensated
        kernel against an fp64 product, and the fp64 product."""
        ref64 = a.double() @ b.double()
        err_c = float((got.double() - ref64).abs().max())
        err_p = float((ops.gemm(a, b).double() - ref64).abs().max())
        return err_c, err_p, ref64

    def halves_the_error(a, b):
        """The reference's property asks no more than x 1.01 the
        uncompensated error, which skipping compensation would meet; at
        most half of it is asked here (0.08 at 4096**3 and 0.13 at the
        x100 inputs were measured on an H100)."""
        def check(got):
            err_c, err_p, _ = errors(a, b, got)
            return err_c <= 0.5 * err_p, (
                f"max |err| vs fp64: compensated {err_c:.4e}, uncompensated "
                f"ntx_gemm {err_p:.4e} (limit x 0.5)")
        return check

    def rounded_once(a, b):
        """Exact slabs: the fp64 product rounded once, bit for bit, and
        the uncompensated kernel off by more."""
        def check(got):
            err_c, err_p, ref64 = errors(a, b, got)
            return bool(torch.equal(got, ref64.float())) and (
                err_p > err_c + 1.0), (
                f"equals the fp64 product rounded once: "
                f"{bool(torch.equal(got, ref64.float()))} | max |err| vs "
                f"fp64: compensated {err_c:.4e}, uncompensated ntx_gemm "
                f"{err_p:.4e}")
        return check

    # against the plain version: within 1e-5 of the product's standard
    # deviation, std_a std_b sqrt(k) (a difference of 0 was measured)
    for name, (m, k, n), std_a, std_b, path in (
            (f"gemm_kahan:{KAHAN_N}^3_fp32", (KAHAN_N,) * 3, 1.0,
             KAHAN_N ** -0.5, True),
            ("gemm_kahan:128x2048x128_x100", (128, 2048, 128), 100.0, 100.0,
             False)):
        a, b = rn(m, k, std=std_a), rn(k, n, std=std_b)
        kahan_case(name, a, b, halves_the_error(a, b), path, mode="close",
                   tol=(0.0, 1e-5 * std_a * std_b * math.sqrt(k)))
    # integers in [-8, 8], the first slab's times 2**16: every slab product
    # is exact in fp32 in any order, the slab sums near 2**24 lose low
    # bits, and only the compensation keeps them (so a kernel that skipped
    # or dropped it fails); both routes are then exact
    ints = lambda *s: (rn(*s) * 3.0).round().clamp(-8.0, 8.0)
    a, b = ints(1024, 4096), ints(4096, 1024)
    a[:, :ntx_gemm.KAHAN_SLAB] *= 2.0 ** 16
    kahan_case("gemm_kahan:1024x4096x1024_exact_slabs", a, b,
               rounded_once(a, b), False, mode="equal", tol=(0.0, 0.0))

    # as phase 8's ntx.Programs hand them to the streaming kernel: AXPY,
    # and the THRESH -> RELU -> THRESH chain (which is one F.threshold)
    ex, ey = rn(1, AXPY_N), rn(1, AXPY_N)
    stream_src = "src/repro_torch/kernels/csrc/ntx_stream.cu"
    for name, wrapper, rep, run, plain, lib, nbytes, nops in (
            (f"elementwise:axpy_1x{AXPY_N}", "elementwise",
             "src/repro/kernels/ntx_elementwise.py:61",
             lambda: ops.elementwise("axpy", ex, ey, imm=2.5),
             lambda: ew.elementwise_plain("axpy", ex, ey, 2.5),
             lambda: torch.add(ey, ex, alpha=2.5), 12, 2),
            (f"elementwise_chain:thresh_relu_thresh_1x{AXPY_N}",
             "elementwise_chain", "src/repro/kernels/ntx_elementwise.py:109",
             lambda: ops.elementwise_chain(CHAIN3, ex),
             lambda: ew.elementwise_chain_plain(CHAIN3, ex),
             lambda: F.threshold(ex, 0.5, 0.0), 8, 3)):
        cases.append(dict(
            name=name, wrapper=wrapper, source=stream_src, replaces=rep,
            kernel=run, plain=plain, library=lib, mode="equal",
            tol=(0.0, 0.0), bytes=float(nbytes * AXPY_N),
            ops=float(nops * AXPY_N), path=True, **common))
    return cases


def time_ssd_backward(torch) -> dict:
    """The SSD backward (PyTorch autograd of the plain version, which
    ``ops.ssd``'s backward recomputes; no kernel of this package yet) at
    the training shape, timed alone."""
    from repro_torch.kernels.ssd_scan import ssd_scan_plain
    g = torch.Generator(device=DEVICE).manual_seed(1)
    rn = lambda *s, dt=torch.float32, std=1.0: (
        torch.randn(*s, generator=g, device=DEVICE) * std).to(dt)
    ins = [t.requires_grad_() for t in ssd_inputs(
        torch, rn, TRAIN_BATCH, TRAIN_SEQ, torch.bfloat16)]
    gy = rn(*ins[0].shape, dt=torch.bfloat16)

    def bwd():
        y = ssd_scan_plain(*ins, chunk=128)
        return torch.autograd.grad(y, ins, gy)
    ms = time_ms(bwd, torch, warmup=1, iters=5)
    # the bound: read the inputs and gy once, write each input's gradient
    # once; about twice the forward's operations, at the inputs' bf16 rate
    nbytes = gy.numel() * gy.element_size() + 2 * sum(
        t.numel() * t.element_size() for t in ins)
    b_ms, b_by = bound_ms(nbytes, 2 * ssd_ops(TRAIN_SEQ, 64, 64, 128,
                                              TRAIN_BATCH, 128), "bf16")
    say("time", f"ssd_bwd:train_b8_l1024_bf16 (PyTorch autograd, not a "
                f"kernel): {ms:.4f} ms per layer | bound {b_ms:.4f} ms "
                f"({b_by}: {nbytes / 1e6:.1f} MB) | card {card_line()}")
    return {"name": "ssd_bwd", "ms": ms}


def profile_ssd_passes(torch) -> None:
    """Device time of each of the three kernels of one ``ops.ssd`` call
    at the training shape, bf16 and fp32 (torch.profiler over 5 calls)."""
    import re
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    g = torch.Generator(device=DEVICE).manual_seed(2)
    rn = lambda *s, dt=torch.float32, std=1.0: (
        torch.randn(*s, generator=g, device=DEVICE) * std).to(dt)
    for dt_x in (torch.bfloat16, torch.float32):
        ins = ssd_inputs(torch, rn, TRAIN_BATCH, TRAIN_SEQ, dt_x)
        ops.ssd(*ins, chunk=128)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                ops.ssd(*ins, chunk=128)
            torch.cuda.synchronize()
        per = {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                m = re.search(r"ssd_\w+", e.key)
                name = m.group(0) if m else e.key[:40]
                per[name] = per.get(name, 0.0) + e.self_device_time_total / 5e3
        msg = " | ".join(f"{k} {v:.4f} ms" for k, v in per.items()) or (
            "profiler saw no device time: not measured")
        say("time", f"ssd passes, b8 l1024 {str(dt_x)[6:]} (device ms per "
                    f"call): {msg}")
        del ins


def sdpa_backend(fn) -> str:
    """Which of SDPA's backends one call of ``fn`` ran, by the aten op
    the profiler records (CPU side only)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    names = {e.key for e in prof.key_averages()}
    for backend in ("flash", "efficient", "cudnn"):
        if f"aten::_scaled_dot_product_{backend}_attention" in names:
            return backend
    if "aten::_scaled_dot_product_attention_math" in names:
        return "math"
    return "not recorded"


def _chain_reduce_plain(ops, ntx_reduce, stages, x, ys):
    """The plain chain-reduce with the wrapper's int32 arg result."""
    out, red = ntx_reduce.chain_reduce_plain(stages, "argmax", x, ys)
    return out, ops._arg_int("argmax", red)


def digest(torch, t) -> str:
    """A short hash of a tensor's bytes."""
    import hashlib
    return hashlib.sha1(t.detach().contiguous().view(torch.uint8).cpu()
                        .numpy().tobytes()).hexdigest()[:16]


def compare(torch, case, got, want) -> tuple:
    """(ok, max_abs_err, max_rel_err) under the case's mode."""
    gots = got if isinstance(got, tuple) else (got,)
    wants = want if isinstance(want, tuple) else (want,)
    ok, max_abs, max_rel, worst_l2 = True, 0.0, 0.0, 0.0
    for part, (gg, ww) in enumerate(zip(gots, wants)):
        if part in case.get("apart", ()):
            continue                      # held by the case's check_vs
        if gg is None or ww is None:
            ok &= gg is None and ww is None
            continue
        gg = gg.float()
        ww = ww.float()
        if gg.shape != ww.shape:
            return False, float("inf"), float("inf")
        diff = (gg - ww).abs()
        max_abs = max(max_abs, float(diff.max()) if diff.numel() else 0.0)
        rel = diff / ww.abs().clamp_min(1e-30)
        max_rel = max(max_rel, float(rel.max()) if rel.numel() else 0.0)
        if case["mode"] == "equal" or (case["mode"] == "lanesum"
                                       and part == 0):
            ok &= bool(torch.equal(gg, ww))
        elif case["mode"] == "lanesum":   # a row's sum, to its sum of |v|
            scale = wants[0].abs().double().sum(-1)
            ok &= bool((diff.double() <= case["tol"][0] * scale).all())
        elif case["mode"] == "sum":       # relative to the sum of |x|
            ok &= bool((diff <= case["tol"][0] * case["scale"]).all())
        elif case["mode"] == "rel_l2":    # a gradient, by its L2 error
            rel = float(diff.norm() / ww.norm().clamp_min(1e-30))
            worst_l2 = max(worst_l2, rel)
            ok &= bool(torch.isfinite(gg).all()) and rel <= case["tol"][0]
        else:
            rtol, atol = case["tol"]
            ok &= bool(torch.isfinite(gg).all()) and bool(
                (diff <= atol + rtol * ww.abs()).all())
    return ok, max_abs, worst_l2 if case["mode"] == "rel_l2" else max_rel


def check_policies(torch) -> None:
    """A chain ending in a SUM as one ntx.Program, under the serial policy
    (two elementwise launches, then the reduce kernel) and the fused one
    (one chain-reduce launch): the same bits, call after call, and within
    the phase-2 SUM tolerance of an fp64 sum."""
    import ntx_torch as ntx
    from repro_torch.kernels import ops
    n = (1 << 20) + 3                  # 257 chunks, a ragged last one
    g = torch.Generator(device=DEVICE).manual_seed(9)
    xs = torch.randn(n, generator=g, device=DEVICE)
    ys = torch.randn(n, generator=g, device=DEVICE)
    with ntx.Program() as prog:
        x = prog.buffer((n,), name="x")
        y = prog.buffer((n,), name="y")
        t = prog.axpy(0.5, x, y)
        prog.relu(t, out=t)
        total = prog.reduce("sum", t, name="total")
    runs = []
    for policy in ("serial", "fused", "serial", "fused"):
        ops.reset_launches()
        res = ntx.Executor(policy, device=DEVICE).run(
            prog, inputs={x: xs, y: ys})
        runs.append((policy, res.read_tensor(total).clone(),
                     res.read_tensor(t).clone(), ops.launches()))
    want = runs[0][2].double().sum()
    bits = {int(r[1].view(torch.int32)[0]) for r in runs}
    err = float((runs[0][1].double() - want).abs()[0])
    scale = float(runs[0][2].abs().double().sum())
    counts = {p: (c["elementwise"], c["reduce"], c["chain_reduce"])
              for p, _, _, c in runs}
    ok = (len(bits) == 1 and all(torch.equal(r[2], runs[0][2]) for r in runs)
          and counts == {"serial": (2, 1, 0), "fused": (0, 0, 1)}
          and err <= 1e-5 * scale)
    say("check", f"ntx.Program axpy->relu->sum over {n}: serial and fused "
                 f"sums {sorted(bits)} (int32 bits, 4 runs) | |sum - fp64| "
                 f"{err:.3e} (<= 1e-5 * sum|t| = {1e-5 * scale:.3e}) | "
                 f"launches (elementwise, reduce, chain_reduce) {counts} "
                 f"{'ok' if ok else 'FAIL'}")
    need(ok, "serial and fused SUM programs disagree on the card")


def check_prefix_store(torch) -> None:
    """A prefix-store program on a CUDA image: a dot product over 64 rows
    of 64, stored after each row as it runs (MAC, store_level 1 <
    init_level 2), and a running ARGMAX
    with planted ties (store_level 0 < init_level 1), which no kernel
    matches, under the serial and fused policies (the torch engine on the
    card), against the cycle-faithful ``engine.execute`` on the same
    image: the ARGMAX bit-equal, the sums within 1e-5 of each stored
    value's sum of |terms|."""
    import numpy as np
    import ntx_torch as ntx
    from repro_torch.core import engine
    from repro_torch.core.descriptor import Agu, Descriptor, Opcode
    rows, cols, n = 64, 64, 4096
    g = torch.Generator(device=DEVICE).manual_seed(13)
    xs = torch.randn(rows * cols, generator=g, device=DEVICE)
    ys = torch.randn(rows * cols, generator=g, device=DEVICE)
    zs = torch.randn(n, generator=g, device=DEVICE)
    zs[[100, 900, 3000]] = zs.max() + 1.0          # ties: the first wins
    prog = ntx.Program()
    x, y = prog.buffer((rows * cols,), name="x"), prog.buffer(
        (rows * cols,), name="y")
    z = prog.buffer((n,), name="z")
    dots, best = prog.buffer((rows,), name="dots"), prog.buffer(
        (n,), name="best")
    prog.emit(Descriptor(bounds=(cols, rows), opcode=Opcode.MAC,
                         init_level=2, store_level=1,
                         agu0=Agu(x.offset, (1, cols)),
                         agu1=Agu(y.offset, (1, cols)),
                         agu2=Agu(dots.offset, (0, 1))))
    prog.emit(Descriptor(bounds=(n,), opcode=Opcode.ARGMAX, init_level=1,
                         store_level=0, agu0=Agu(z.offset, (1,)),
                         agu2=Agu(best.offset, (1,))))
    inputs = {x: xs, y: ys, z: zs}
    mem = prog.pack(inputs, device="cpu").numpy()
    for desc in prog.descriptors:
        mem = engine.execute(desc, mem)
    want = prog.unpack(torch.from_numpy(mem))
    scale = np.abs(xs.cpu().numpy().astype(np.float64)
                   * ys.cpu().numpy()).reshape(rows, cols).sum(1).cumsum()
    out = []
    for policy in ("serial", "fused"):
        res = ntx.Executor(policy, device=DEVICE).run(prog, inputs=inputs)
        d_err = np.abs(res["dots"].astype(np.float64) - want["dots"])
        same = np.array_equal(res["best"].view(np.int32),
                              want["best"].view(np.int32))
        ok = same and bool((d_err <= 1e-5 * scale).all())
        out.append(ok)
        say("check", f"prefix-store program on a CUDA image ({policy}): "
                     f"running ARGMAX over {n} bit-equal to engine.execute "
                     f"{same} | running dots max_abs_err {d_err.max():.3e} "
                     f"{'ok' if ok else 'FAIL'}")
    need(all(out), "prefix-store program disagrees with engine.execute")


def phase_check_and_time(torch, do_time: bool) -> list:
    cases = [case for case in kernel_cases(torch) if wanted(case["name"])]
    rows = check_and_time(torch, cases, do_time, "check", "time")
    check_policies(torch)
    check_prefix_store(torch)
    return rows


def check_and_time(torch, cases, do_time: bool, check: str,
                   timing: str) -> list:
    """Each case's kernel against its plain version (failing on any
    disagreement), then, with ``do_time``, its time, bound, plain and
    library times; the cases' closures are dropped before returning."""
    rows, failed = [], []
    for case in cases:
        got = case["kernel"]()
        torch.cuda.synchronize()
        want = case["plain"]()
        ok, max_abs, max_rel = compare(torch, case, got, want)
        tol = ("bit-equal" if case["mode"] == "equal" else
               f"|d| <= {case['tol'][0]:g} * sum|x|"
               if case["mode"] in ("sum", "lanesum")
               else f"worst rel L2 <= {case['tol'][0]:g}"
               if case["mode"] == "rel_l2"
               else f"rtol {case['tol'][0]:g} atol {case['tol'][1]:g}")
        rel_name = ("worst_rel_l2" if case["mode"] == "rel_l2"
                    else "max_rel_err")
        say(check, f"{case['name']}: max_abs_err {max_abs:.3e} "
                   f"{rel_name} {max_rel:.3e} ({tol}) "
                   f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(case["name"])
        if case.get("check"):
            ok, msg = case["check"](got)
            say(check, f"{case['name']}: {msg} {'ok' if ok else 'FAIL'}")
            if not ok:
                failed.append(case["name"])
        if case.get("check_vs"):
            ok, msg = case["check_vs"](got, want)
            say(check, f"{case['name']}: {msg} {'ok' if ok else 'FAIL'}")
            if not ok:
                failed.append(case["name"])
        if case["wrapper"] == "attention" and torch.is_tensor(got):
            # the serving forward's bits, to hold against another tree's
            # (--src) on the same inputs
            say(check, f"{case['name']}: output digest "
                       f"{digest(torch, got)}")
        del got, want
        case["max_abs_err"] = max_abs
        rows.append(case)
    need(not failed, f"kernels disagree with their plain versions: {failed}")
    if do_time:
        for case in rows:
            case["ms"], host_ms = time_ms_host(case["kernel"], torch)
            case["plain_ms"] = time_ms(case["plain"], torch)
            case["library_ms"] = (time_ms(case["library"], torch)
                                  if case["library"] else None)
            if case.get("library_minus"):     # a backward: less its forward
                case["library_ms"] -= time_ms(case["library_minus"], torch)
            b_ms, b_by = bound_ms(case["bytes"], case["ops"], case["kind"])
            case["bound_ms"], case["bound_by"] = b_ms, b_by
            lib = (f"{case['library_ms']:.4f}" if case["library_ms"]
                   is not None else "null")
            aside = (f" | torch.matmul fp32 (not the same function) "
                     f"{time_ms(case['aside'], torch):.4f} ms"
                     if case.get("aside") else "")
            if case.get("backend"):
                aside += f" | SDPA backend {sdpa_backend(case['backend'])}"
            aside += case.get("note", "")
            for label, fn in case.get("beside", ()):
                aside += f" | {label} {time_ms(fn, torch):.4f} ms"
            if case.get("singles"):
                n_single, singles = case["singles"]
                aside += (f" | {n_single} one-lane launches "
                          f"{time_ms(singles, torch):.4f} ms")
            say(timing, f"{case['name']}: kernel {case['ms']:.4f} ms | "
                        f"host issue {host_ms:.4f} ms | bound {b_ms:.4f} ms"
                        f" ({b_by}) | plain {case['plain_ms']:.4f} ms | "
                        f"library {lib} ms{aside}")
            if case.get("splits"):
                plan, alt, run = case["splits"]
                say(timing, f"{case['name']}: split-k plan {plan} -> "
                            f"{time_ms(lambda: run(plan), torch):.4f} ms | "
                            f"two blocks per SM, {alt} -> "
                            f"{time_ms(lambda: run(alt), torch):.4f} ms "
                            f"(gemm_cuda alone)")
            if case.get("plans"):
                plans, run = case["plans"]
                outs = [run(p) for _, p in plans]
                same = all(torch.equal(o, outs[0]) for o in outs)
                del outs
                msg = " | ".join(
                    f"{label}, {p.blocks} blocks -> "
                    f"{time_ms(lambda p=p: run(p), torch):.4f} ms"
                    for label, p in plans)
                say(timing, f"{case['name']}: {msg} (the kernel alone) | "
                            f"bit-equal {same}")
                if case["mode"] == "equal":
                    need(same, f"{case['name']}: the plans disagree")
    for case in rows:            # free the inputs the closures hold
        for key in ("kernel", "plain", "library", "scale", "check",
                    "aside", "splits", "plans", "backend", "singles",
                    "check_vs", "library_minus", "beside"):
            case.pop(key, None)
    torch.cuda.empty_cache()
    return rows


# ----------------------------------------------------------------------
# phase 4 / 5: the serving path
# ----------------------------------------------------------------------
def prompts_for(cfg, np, plen: int = PROMPT_LEN):
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab, plen) for _ in range(BATCH)]


#: a near-tie of the MoE router that bf16 rounding can flip: the two
#: experts' CPU probabilities within 5 % of each other (bf16 logits carry
#: 2**-8 relative rounding, and card and CPU inputs to the router differ
#: by bf16 roundings of the layers before it)
ROUTER_TIE = 0.05


class RouteLog:
    """Records every MoE routing (``moe.route``) of ``params``' layers on
    the host, keyed by (layer, that layer's call count): a forward routes
    each layer once, a remat recompute once more, a chunked prefill once a
    chunk. With ``replay`` (another run's log) each call takes that run's
    experts for the same key, weighted by its own probabilities (the
    gate's gradient flows through them as through the top-k values), so
    two devices' runs route alike and the rest of their arithmetic can be
    compared."""

    def __init__(self, torch, params, replay=None):
        self.torch, self.replay = torch, replay
        # (the encoder-decoder has no MoE layer, and no "layers")
        self.layer = {id(l.ffn): i for i, l in enumerate(
            getattr(params, "layers", ()))}
        self.calls = {}

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.route = moe, moe.route
        torch = self.torch

        def recording(cfg, p, x):
            probs, gate, expert = self.route(cfg, p, x)
            key = (self.layer[id(p)], sum(1 for k in self.calls
                                          if k[0] == self.layer[id(p)]))
            self.calls[key] = (probs.detach().float().cpu(), expert.cpu())
            if self.replay is not None:
                expert = self.replay.calls[key][1].to(expert.device)
                gate = torch.take_along_dim(probs, expert, -1)
                gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True),
                                              1e-9)
            return probs, gate, expert
        moe.route = recording
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route

    def pairs(self) -> list:
        """(probs, experts) of every call, in key order."""
        return [self.calls[k] for k in sorted(self.calls)]

    def recomputes_agree(self) -> bool:
        """Under remat="full" a layer's calls alternate forward and
        recompute: each recompute (odd count) picks the experts of the
        forward before it."""
        torch = self.torch
        return all(torch.equal(e, self.calls[(i, n - 1)][1])
                   for (i, n), (_, e) in self.calls.items() if n % 2)


def routing_gaps(card, cpu) -> list:
    """Each (call, row, token) whose expert set the CPU's own router picks
    differently from the card's (two :class:`RouteLog` s of the same
    calls), as the gap ln(p_a / p_b) between the CPU's probabilities of
    the experts only it picked and those only the card picked (0 at an
    exact tie)."""
    gaps = []
    for (_, eg), (pc, ec) in zip(card.pairs(), cpu.pairs()):
        eg, ec = eg.sort(-1).values, ec.sort(-1).values
        for r, t in (eg != ec).any(-1).nonzero().tolist():
            gs, cs = set(eg[r, t].tolist()), set(ec[r, t].tolist())
            p = pc[r, t]
            gaps.append(math.log(max(float(p[j]) for j in cs - gs)
                                 / min(float(p[j]) for j in gs - cs)))
    return gaps


def check_routing(tag: str, dtype: str, card, cpu,
                  sides=("card", "CPU")) -> None:
    """fp32: the CPU's own router picks the card's experts everywhere;
    bf16: they may differ only at near-ties (``ROUTER_TIE``). ``sides``
    names the two runs (the one replayed, the one replaying)."""
    gaps = routing_gaps(card, cpu)
    n_tok = sum(e.shape[0] * e.shape[1] for _, e in card.pairs())
    a, b = sides
    say(tag, f"{dtype} MoE routing: {len(gaps)} of {n_tok} token routings "
             f"differ {a} vs {b}, largest {b} probability gap ln p_a/p_b "
             f"{max(gaps, default=0.0):.3e} (near-tie <= {ROUTER_TIE:g} in "
             f"bf16, none in fp32)")
    need(not gaps if dtype == "float32" else
         max(gaps, default=0.0) <= ROUTER_TIE,
         f"{dtype} MoE routing differs {a} vs {b} past a near-tie")


def serve_obs(runs: dict, peak: int) -> dict:
    """What phase 19 sets beside the dry run of a serving phase: the
    BATCH-prompt runs' mean prefill time and mean decode-step time (each
    step with its sampling), and the phase's peak memory."""
    batch = [out for name, out in runs.items() if name != "long"]
    return {"prefill_ms": 1e3 * sum(o["prefill_s"] for o in batch)
            / len(batch),
            "step_ms": 1e3 * sum(o["decode_s"] for o in batch)
            / (len(batch) * NEW_TOKENS),
            "peak": peak}


def phase_serve(torch, np) -> dict:
    import importlib
    from repro_torch import configs
    from repro_torch.kernels import ops
    # the module, not the function repro_torch.core re-exports
    dispatch = importlib.import_module("repro_torch.core.dispatch")
    from repro_torch.models import Model
    from repro_torch.runtime import ServeConfig, Server

    cfg = configs.get("llama3-8b")
    t0 = time.perf_counter()
    params = Model(cfg).init(0, device=DEVICE)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    say("serve", f"llama3-8b {cfg.n_layers} layers, {n_params / 1e9:.3f} B "
                 f"params bf16 ({torch.cuda.memory_allocated() / 1e9:.2f} GB)"
                 f", init {time.perf_counter() - t0:.1f} s")
    prompts = prompts_for(cfg, np)
    with torch.inference_mode():
        logits, _, _ = Model(cfg).prefill(
            params, {"tokens": torch.as_tensor(np.stack(prompts),
                                               device=DEVICE)},
            cache_len=MAX_SEQ)
    need(tuple(logits.shape) == (BATCH, cfg.padded_vocab)
         and bool(torch.isfinite(logits).all()),
         f"prefill logits {tuple(logits.shape)} not finite/shaped")
    card = card_line()
    runs = {}
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    dispatch.reset_engine_fallbacks()
    for name, temp in (("greedy", 0.0), ("temperature", 0.8)):
        srv = Server(cfg, params, ServeConfig(
            max_seq=MAX_SEQ, max_new_tokens=NEW_TOKENS, eos_token=-1,
            temperature=temp))
        out = srv.generate(prompts)
        runs[name] = out
    # one long prompt: its decode steps split the keys (the merge runs)
    long_prompt = np.random.default_rng(1).integers(0, cfg.vocab,
                                                    LONG_PROMPT)
    long_srv = Server(cfg, params, ServeConfig(
        max_seq=LONG_SEQ, max_new_tokens=LONG_NEW, eos_token=-1))
    long_out = long_srv.generate([long_prompt])
    counts = ops.launches()
    fallbacks = dispatch.engine_fallbacks
    peak = torch.cuda.max_memory_allocated()
    for name, out in runs.items():
        comp = out["completions"]
        need(len(comp) == BATCH and all(
            len(c) == NEW_TOKENS and all(0 <= t < cfg.padded_vocab
                                         for t in c) for c in comp),
             f"{name}: completions malformed")
        say("serve", f"{name}: prefill {out['prefill_s'] * 1e3:.2f} ms | "
                     f"decode {out['decode_tok_per_s']:.2f} tok/s | "
                     f"req0 {comp[0]} | card {card}")
    per_kernel = {"ntx_gemm": counts["gemm"],
                  "flash_attention": counts["attention"],
                  "flash_merge": counts["attention_merge"],
                  "ntx_stream": sum(counts[w] for w in (
                      "elementwise", "elementwise_chain", "chain_reduce",
                      "reduce"))}
    say("serve", f"peak memory {peak / 1e9:.2f} GB | kernel launches "
                 f"{per_kernel} (by wrapper {counts}) | engine_fallbacks "
                 f"{fallbacks} | card {card}")
    for wrapper in ("gemm", "attention", "attention_merge", "reduce",
                    "chain_reduce"):
        need(counts[wrapper] > 0, f"{wrapper} kernel never launched")
    need(fallbacks == 0, f"{fallbacks} descriptors fell back to the engine")
    comp = long_out["completions"]
    need(len(comp) == 1 and len(comp[0]) == LONG_NEW and all(
        0 <= t < cfg.padded_vocab for t in comp[0]),
         "long-prompt completion malformed")
    profile_long_prefill(torch, cfg, params, long_srv, long_prompt,
                         long_out)
    profile_decode_step(torch, np, cfg, params, prompts)
    return {"serve": (counts, serve_obs(runs, peak))}


def profile_long_prefill(torch, cfg, params, srv, prompt, out,
                         tag: str = "serve") -> None:
    """An observation, no limit: the long-prompt request's prefill and
    decode times (the run counted above), then its prefill once more
    under torch.profiler, device ms by kernel family (its launches here
    are not counted); returns the groups, or None when the profiler saw
    no device time."""
    from torch.profiler import ProfilerActivity, profile
    card = card_line()
    say(tag, f"long prompt {LONG_PROMPT} + {LONG_NEW} new tokens (batch 1, "
             f"max_seq {LONG_SEQ}): prefill {out['prefill_s'] * 1e3:.2f} ms "
             f"| decode {out['decode_tok_per_s']:.2f} tok/s | card {card}")
    tokens = torch.as_tensor(prompt[None], device=DEVICE)
    with torch.inference_mode():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            srv.model.prefill(params, {"tokens": tokens}, cache_len=LONG_SEQ)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    split = kernel_split(prof.key_averages(), KERNEL_GROUPS)
    if split is None:
        say(tag, "profiler saw no device time: long prefill not measured")
        return None
    busy, by_group, _ = split
    groups = {k: (round(v[0], 3), v[1]) for k, v in by_group.items()}
    say(tag, f"profiled long prefill: wall {wall_ms:.2f} ms (profiler on) | "
             f"device busy {busy:.2f} ms | kernels by group (ms, launches) "
             f"{groups} | card {card}")
    return by_group


def profile_decode_step(torch, np, cfg, params, prompts,
                        tag: str = "serve", extra=None,
                        max_seq: int = MAX_SEQ) -> None:
    """One greedy decode step of the batch (Model.decode, then the
    per-request ARGMAX programs) under torch.profiler, after a prefill
    (with the ``extra`` inputs, on the card) and one unprofiled step:
    device time by kernel family, and the host's share of the step's wall
    time. Its launches are not counted in the kernels line."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime import ServeConfig, Server
    srv = Server(cfg, params, ServeConfig(max_seq=max_seq, eos_token=-1))
    rng = np.random.default_rng(0)

    def step(cur, cache, fill):
        tok = torch.as_tensor(cur[:, None], dtype=torch.long, device=DEVICE)
        logits, cache = srv.model.decode(params, tok, cache, fill)
        return srv._sample(logits[:, -1], rng), cache, fill + 1

    with torch.inference_mode():
        logits, cache, fill = srv.model.prefill(
            params, {"tokens": torch.as_tensor(np.stack(prompts),
                                               device=DEVICE),
                     **(extra or {})}, cache_len=max_seq)
        cur = srv._sample(logits, rng, prefill=True)
        cur, cache, fill = step(cur, cache, fill)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(cur, cache, fill)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    split = kernel_split(prof.key_averages(), KERNEL_GROUPS)
    if split is None:
        say(tag, "profiler saw no device time: decode split not measured")
        return
    busy, by_group, top = split
    say(tag, f"profiled decode step (batch {len(prompts)}): wall "
             f"{wall_ms:.2f} ms (profiler on) | device busy {busy:.2f} ms "
             f"({busy / wall_ms:.3f} of wall) | host gap "
             f"{wall_ms - busy:.2f} ms | kernels by group (ms, launches) "
             f"{ {k: (round(v[0], 3), v[1]) for k, v in by_group.items()} }"
             f" | card {card_line()}")
    for e in top:
        say(tag, f"  {e.self_device_time_total / 1e3:9.3f} ms "
                 f"x{e.count:5d}  {e.key[:110]}")


# ----------------------------------------------------------------------
# phase 12: serving deepseek-v2-lite-16b (MLA and MoE)
# ----------------------------------------------------------------------
def phase_deepseek(torch, np) -> dict:
    """deepseek-v2-lite-16b: first the 2-layer width check card vs CPU
    (as phase 4), then Server.generate on the full 27-layer model (bf16,
    random weights from Model.init(0), ~32.4 GB) at phase 5's sizes:
    4 requests of 32 tokens, 16 new, greedy and at temperature 0.8 (the
    config's prefill_microbatch 2 prefills them in chunks of 2), and one
    2048-token prompt, with the launch counts of that run; then the long
    prefill and one decode step under torch.profiler. A decode step reads
    every expert's weights (the reference's static capacity gives each of
    the 64 experts top_k slots at s 1), the bytes bound it is printed
    beside."""
    import importlib
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import Model, moe
    from repro_torch.runtime import ServeConfig, Server
    dispatch = importlib.import_module("repro_torch.core.dispatch")

    gc_collect(torch)                      # phase 5's llama and the rest
    phase_width(torch, np, DEEPSEEK, "deepseek width")
    gc_collect(torch)
    cfg = configs.get(DEEPSEEK)
    t0 = time.perf_counter()
    params = Model(cfg).init(0, device=DEVICE)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    say("deepseek", f"{DEEPSEEK} {cfg.n_layers} layers, "
                    f"{n_params / 1e9:.3f} B params bf16 "
                    f"({torch.cuda.memory_allocated() / 1e9:.2f} GB), init "
                    f"{time.perf_counter() - t0:.1f} s")
    prompts = prompts_for(cfg, np)
    card = card_line()
    runs = {}
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    dispatch.reset_engine_fallbacks()
    for name, temp in (("greedy", 0.0), ("temperature", 0.8)):
        runs[name] = Server(cfg, params, ServeConfig(
            max_seq=MAX_SEQ, max_new_tokens=NEW_TOKENS, eos_token=-1,
            temperature=temp)).generate(prompts)
    long_prompt = np.random.default_rng(1).integers(0, cfg.vocab,
                                                    LONG_PROMPT)
    long_srv = Server(cfg, params, ServeConfig(
        max_seq=LONG_SEQ, max_new_tokens=LONG_NEW, eos_token=-1))
    long_out = long_srv.generate([long_prompt])
    counts = ops.launches()
    fallbacks = dispatch.engine_fallbacks
    peak = torch.cuda.max_memory_allocated()
    for name, out in list(runs.items()) + [("long", long_out)]:
        comp = out["completions"]
        n_req, n_new = (1, LONG_NEW) if name == "long" else (BATCH,
                                                             NEW_TOKENS)
        need(len(comp) == n_req and all(
            len(c) == n_new and all(0 <= t < cfg.padded_vocab for t in c)
            for c in comp), f"deepseek {name}: completions malformed")
        if name != "long":
            say("deepseek", f"{name}: prefill {out['prefill_s'] * 1e3:.2f} "
                            f"ms | decode {out['decode_tok_per_s']:.2f} "
                            f"tok/s | req0 {comp[0]} | card {card}")
    say("deepseek", f"peak memory {peak / 1e9:.2f} GB | kernel launches "
                    f"{counts} | engine_fallbacks {fallbacks} | card {card}")
    for wrapper in ("attention", "attention_merge", "reduce",
                    "chain_reduce"):
        need(counts[wrapper] > 0, f"deepseek: {wrapper} kernel never "
                                  f"launched")
    need(fallbacks == 0, f"{fallbacks} descriptors fell back to the engine")
    expert_bytes = (cfg.n_layers * cfg.n_experts * 3 * cfg.d_model
                    * cfg.d_ff_expert * 2)
    say("deepseek", f"a decode step reads every expert's weights "
                    f"({moe._capacity(cfg, 1)} slots an expert at s 1): "
                    f"{expert_bytes / 1e9:.2f} GB, bound "
                    f"{expert_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms (bytes)")
    profile_long_prefill(torch, cfg, params, long_srv, long_prompt,
                         long_out, "deepseek")
    profile_decode_step(torch, np, cfg, params, prompts, "deepseek")
    del params
    gc_collect(torch)
    return {"deepseek": (counts, serve_obs(runs, peak))}


# ----------------------------------------------------------------------
# phases 15 / 16: serving mamba2-1.3b and jamba-v0.1-52b (SSM and hybrid)
# ----------------------------------------------------------------------
def serve_and_decode(torch, model, params, tokens, steps, replay=None,
                     starts=None, extra=None, max_seq=MAX_SEQ):
    """Prefill ``tokens`` (with the ``extra`` inputs, CPU tensors moved to
    the tokens' device) into a cache of ``max_seq`` slots, then decode
    ``steps`` (each (b, 1) tokens, the same on both devices), under a
    :class:`RouteLog`: (the prefill logits
    and each step's last-position logits, host copies of the cache after
    the prefill and after each step, the log). With ``starts`` (another
    run's copies) each step first takes that run's cache, so both devices
    decode every step from the same bytes: the bf16 conv tails and keys
    round values that agree to ~1e-6, and may land one bf16 ulp apart at
    every step."""
    dev = tokens.device
    host = lambda cache: [{k: v.detach().to("cpu", torch.float32,
                                            copy=True)
                           for k, v in c.items()} for c in cache]
    batch = {"tokens": tokens, **{k: v.to(dev) for k, v in
                                  (extra or {}).items()}}
    with RouteLog(torch, params, replay) as log, torch.inference_mode():
        logits, cache, fill = model.prefill(params, batch, cache_len=max_seq)
        out, caches = [logits.float().cpu()], [host(cache)]
        for i, tok in enumerate(steps):
            for c, c0 in zip(cache, starts[i] if starts else ()):
                for k, v in c.items():
                    v.copy_(c0[k])
            logits, cache = model.decode(params, tok.to(dev), cache, fill)
            fill += 1
            out.append(logits[:, -1].float().cpu())
            caches.append(host(cache))
    return out, caches, log


def phase_width(torch, np, arch: str = "llama3-8b", tag: str = "width",
                cut=None, plen: int = PROMPT_LEN, extra=None) -> None:
    """``arch`` at full width, depth cut to 2 layers (or the ``cut``
    overrides), on the card and on the CPU with the same weights, tokens
    (``plen`` a prompt) and ``extra`` inputs (``extra(cfg, np, plen)``:
    CPU tensors): prefill logits, every cache leaf (attention keys and values,
    the encoder-decoder's cross-attention ones, or MLA's latents; the SSM
    state and conv tails) after the prefill and after each of WIDTH_STEPS
    decode
    steps, and each step's logits, in fp32 and in bf16 compute; the CPU
    decodes each step from the card's cache. With MoE layers the CPU
    replays the card's expert choices (fp32: its own router must agree;
    bf16: near-ties only, ``ROUTER_TIE``). fp32 at 1e-3 (the bf16 cache
    leaves, one bf16 rounding of fp32 values, at 1e-2); bf16 at 2e-2 /
    6e-2, about twice the worst card-vs-CPU logit error measured on an
    H100 (3.1e-2 absolute on logits of order 1; see PERF.md). The SSM
    state by its relative L2 error (SSM_STATE_L2): each element sums
    decayed terms of either sign, so where bf16 inputs round one ulp
    apart on the two devices its error scales with the sum of its terms'
    sizes, not with its own size."""
    from repro_torch import configs
    from repro_torch.models import Model
    from repro_torch.models.transformer import layer_schedule

    full = configs.get(arch)
    cut = cut or {"n_layers": 2}
    base = full.scaled(**cut)
    t0 = time.perf_counter()
    params = Model(base).init(0, device=DEVICE)
    params_cpu = copy.deepcopy(params).to("cpu")
    tokens = torch.as_tensor(np.stack(prompts_for(base, np, plen)),
                             dtype=torch.long)
    inputs = extra(base, np, plen) if extra else {}
    max_seq = plen + WIDTH_STEPS + 8
    steps = torch.as_tensor(np.random.default_rng(5).integers(
        0, base.vocab, (WIDTH_STEPS, BATCH, 1)), dtype=torch.long)
    kinds = ("encoder-decoder" if base.encoder_decoder
             else layer_schedule(base)[0])
    for dtype, rtol, atol in (("float32", 1e-3, 1e-3),
                              ("bfloat16", 2e-2, 6e-2)):
        cfg = base.scaled(compute_dtype=dtype)
        lg, cg, rg = serve_and_decode(torch, Model(cfg), params,
                                      tokens.to(DEVICE), steps, extra=inputs,
                                      max_seq=max_seq)
        lc, cc, rc = serve_and_decode(torch, Model(cfg), params_cpu,
                                      tokens, steps, replay=rg, starts=cg,
                                      extra=inputs, max_seq=max_seq)
        if cfg.moe:
            check_routing(tag, dtype, rg, rc)
        worst = {}

        def close(key, got, want, rt, at, l2=None):
            d = (got - want).abs()
            ok = bool(torch.isfinite(got).all())
            if l2 is None:
                ok &= bool((d <= at + rt * want.abs()).all())
                rel = 0.0
            else:
                rel = float(d.norm() / want.norm().clamp_min(1e-30))
                ok &= rel <= l2
            err = float(d.max()) if d.numel() else 0.0
            prev = worst.get(key, (0.0, 0.0, 0.0, True))
            worst[key] = (max(prev[0], err), max(prev[1], rel),
                          max(prev[2], float(want.abs().max())),
                          prev[3] and ok)
        for i, (g, c) in enumerate(zip(lg, lc)):
            close("prefill logits" if i == 0 else "decode logits", g, c,
                  rtol, atol)
        for snap_g, snap_c in zip(cg, cc):
            for layer_g, layer_c in zip(snap_g, snap_c):
                for k in layer_g:
                    tail = dtype == "float32" and k != "s"
                    close(f"cache {k}", layer_g[k], layer_c[k],
                          1e-2 if tail else rtol, 1e-2 if tail else atol,
                          SSM_STATE_L2[dtype] if k == "s" else None)
        msg = " | ".join(
            f"{k} {e:.3e}" + (f" (rel L2 {r:.3e} <= "
                              f"{SSM_STATE_L2[dtype]:g}, max|s| {m:.3e})"
                              if k == "cache s" else "")
            + f" {'ok' if ok else 'FAIL'}"
            for k, (e, r, m, ok) in worst.items())
        say(tag, f"{dtype} card vs CPU max_abs_err (prefill, "
                 f"{WIDTH_STEPS} decode steps, caches): {msg}")
        need(all(ok for *_, ok in worst.values()),
             f"{tag}: {dtype} card and CPU disagree")
    depth = ", ".join(f"{k} {v} of {getattr(full, k)}"
                      for k, v in cut.items())
    say(tag, f"{arch} full width, {depth} ({kinds}), prompts {BATCH} x "
             f"{plen}, {time.perf_counter() - t0:.1f} s ok")
    del params, params_cpu
    gc_collect(torch)


def continuation_check(torch, np, arch: str, tag: str) -> None:
    """On the card, decode continues the prefill (the mirror of the
    reference's test_ssm_decode_matches_prefill_continuation): 2 layers
    at full width in fp32 compute, token s + 1 decoded from an s-token
    prefill (the conv tails cached in bf16) against an (s + 1)-token
    prefill, at the reference's 2e-2, for s 16 (inside the first chunk)
    and 128 (one whole chunk carried into the state)."""
    from repro_torch import configs
    from repro_torch.models import Model
    cfg = configs.get(arch).scaled(n_layers=2, compute_dtype="float32")
    model = Model(cfg)
    params = model.init(0, device=DEVICE)
    rng = np.random.default_rng(4)
    for s in (16, 128):
        t = torch.as_tensor(rng.integers(0, cfg.vocab, (1, s + 1)),
                            device=DEVICE)
        with torch.inference_mode():
            full, _, _ = model.prefill(params, {"tokens": t},
                                       cache_len=s + 8)
            _, cache, fill = model.prefill(params, {"tokens": t[:, :s]},
                                           cache_len=s + 8)
            step, _ = model.decode(params, t[:, s:], cache, fill)
        d = (full - step[:, 0]).abs()
        ok = bool((d <= 2e-2 + 2e-2 * full.abs()).all())
        say(tag, f"decode after a {s}-token prefill vs a {s + 1}-token "
                 f"prefill (fp32, 2 layers): max_abs_err "
                 f"{float(d.max()):.3e} (rtol 2e-2 atol 2e-2) "
                 f"{'ok' if ok else 'FAIL'}")
        need(ok, f"{tag}: decode does not continue the prefill at {s}")
    del params
    gc_collect(torch)


def serve_runs(torch, np, cfg, params, tag: str, long: bool) -> tuple:
    """Server.generate at phase 5's sizes, greedy and at temperature 0.8,
    and (``long``) one LONG_PROMPT-token prompt with LONG_NEW new tokens,
    with the launch counts (every Mamba-2 layer's prefill launches the
    state route: a layer that took a plain version would leave the count
    short) and the peak memory of that run; then the prefill under
    torch.profiler (the long prompt's, or the batch's), which must launch
    ssd_scan.cu's three kernels once per Mamba-2 layer, and one decode
    step by kernel family. Returns (the launch counts, the times and peak
    that phase 19 reads)."""
    import importlib
    from repro_torch.kernels import ops
    from repro_torch.runtime import ServeConfig, Server
    dispatch = importlib.import_module("repro_torch.core.dispatch")
    prompts = prompts_for(cfg, np)
    card = card_line()
    runs = {}
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    dispatch.reset_engine_fallbacks()
    for name, temp in (("greedy", 0.0), ("temperature", 0.8)):
        runs[name] = Server(cfg, params, ServeConfig(
            max_seq=MAX_SEQ, max_new_tokens=NEW_TOKENS, eos_token=-1,
            temperature=temp)).generate(prompts)
    if long:
        long_prompt = np.random.default_rng(1).integers(0, cfg.vocab,
                                                        LONG_PROMPT)
        long_srv = Server(cfg, params, ServeConfig(
            max_seq=LONG_SEQ, max_new_tokens=LONG_NEW, eos_token=-1))
        runs["long"] = long_srv.generate([long_prompt])
    counts = ops.launches()
    fallbacks = dispatch.engine_fallbacks
    peak = torch.cuda.max_memory_allocated()
    n_ssm = sum(not cfg.is_attn_layer(i) for i in range(cfg.n_layers))
    n_prefills = len(runs)
    for name, out in runs.items():
        comp = out["completions"]
        n_req, n_new = (1, LONG_NEW) if name == "long" else (BATCH,
                                                             NEW_TOKENS)
        need(len(comp) == n_req and all(
            len(c) == n_new and all(0 <= t < cfg.padded_vocab for t in c)
            for c in comp), f"{tag} {name}: completions malformed")
        say(tag, f"{name}: prefill {out['prefill_s'] * 1e3:.2f} ms | decode "
                 f"{out['decode_tok_per_s']:.2f} tok/s | req0 {comp[0]} | "
                 f"card {card}")
    say(tag, f"peak memory {peak / 1e9:.2f} GB | kernel launches {counts} "
             f"| engine_fallbacks {fallbacks} | card {card}")
    need(counts["ssd_state"] == n_ssm * n_prefills,
         f"{tag}: {counts['ssd_state']} state-route launches for "
         f"{n_prefills} prefills of {n_ssm} Mamba-2 layers")
    need(counts["ssd"] == 0 and counts["ssd_bwd"] == 0,
         f"{tag}: serving ran ops.ssd")
    for wrapper in ("reduce", "chain_reduce") + (
            ("gemm", "attention") if cfg.family == "hybrid" else ()):
        need(counts[wrapper] > 0, f"{tag}: {wrapper} kernel never launched")
    need(fallbacks == 0, f"{fallbacks} descriptors fell back to the engine")
    if long:
        by_group = profile_long_prefill(torch, cfg, params, long_srv,
                                        long_prompt, runs["long"], tag)
    else:
        by_group = profile_prefill(torch, np, cfg, params, prompts, tag)
    if by_group is not None:
        need(by_group["ssd_scan.cu"][1] == 3 * n_ssm,
             f"{tag}: the profiled prefill launched "
             f"{by_group['ssd_scan.cu'][1]} ssd_scan.cu kernels, not 3 a "
             f"Mamba-2 layer ({n_ssm})")
    profile_decode_step(torch, np, cfg, params, prompts, tag)
    return counts, serve_obs(runs, peak)


def profile_prefill(torch, np, cfg, params, prompts, tag: str):
    """The batch's prefill once more under torch.profiler: device ms by
    kernel family (its launches are not counted); the groups, or None
    when the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import Model
    tokens = torch.as_tensor(np.stack(prompts), device=DEVICE)
    with torch.inference_mode():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            Model(cfg).prefill(params, {"tokens": tokens}, cache_len=MAX_SEQ)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    split = kernel_split(prof.key_averages(), KERNEL_GROUPS)
    if split is None:
        say(tag, "profiler saw no device time: prefill not measured")
        return None
    busy, by_group, _ = split
    say(tag, f"profiled prefill ({len(prompts)} x {PROMPT_LEN}): wall "
             f"{wall_ms:.2f} ms (profiler on) | device busy {busy:.2f} ms | "
             f"kernels by group (ms, launches) "
             f"{ {k: (round(v[0], 3), v[1]) for k, v in by_group.items()} }"
             f" | card {card_line()}")
    return by_group


def phase_mamba2(torch, np) -> dict:
    """mamba2-1.3b serving: the 2-layer full-width check card vs CPU
    (prefill, caches, decode steps), decode continuing the prefill on the
    card, then Server.generate on all 48 layers (bf16, Model.init(0)) at
    phase 5's sizes and one 2048-token prompt, with launch counts and the
    profiled long prefill and decode step."""
    from repro_torch import configs
    from repro_torch.models import Model
    gc_collect(torch)
    phase_width(torch, np, MAMBA2, "mamba2 width")
    continuation_check(torch, np, MAMBA2, "mamba2 width")
    cfg = configs.get(MAMBA2)
    t0 = time.perf_counter()
    params = Model(cfg).init(0, device=DEVICE)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    say("mamba2", f"{MAMBA2} {cfg.n_layers} layers, {n_params / 1e9:.3f} B "
                  f"params bf16 ({torch.cuda.memory_allocated() / 1e9:.2f} "
                  f"GB), init {time.perf_counter() - t0:.1f} s")
    counts, obs = serve_runs(torch, np, cfg, params, "mamba2", long=True)
    del params
    gc_collect(torch)
    return {"mamba2_serve": (counts, obs)}


def phase_jamba(torch, np) -> dict:
    """jamba-v0.1-52b serving: the 2-layer full-width check (ssm_mlp,
    ssm_moe) card vs CPU with the CPU replaying the card's routing, then
    Server.generate at full width cut to JAMBA_SERVE_LAYERS of 32 (bf16,
    Model.init(0)) at phase 5's sizes, the cut's peaks (the init's and
    the serving run's) leaving at least HEADROOM_BYTES of the card free,
    with launch counts and the profiled prefill and decode step."""
    from repro_torch import configs
    from repro_torch.models import Model
    gc_collect(torch)
    phase_width(torch, np, JAMBA, "jamba width")
    full = configs.get(JAMBA)
    cfg = full.scaled(n_layers=JAMBA_SERVE_LAYERS)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = Model(cfg).init(0, device=DEVICE)
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in params.parameters())
    say("jamba", f"{JAMBA} cut: {cfg.n_layers} of {full.n_layers} layers at "
                 f"full width, {n_params / 1e9:.3f} B params bf16 "
                 f"({torch.cuda.memory_allocated() / 1e9:.2f} GB), init "
                 f"{time.perf_counter() - t0:.1f} s")
    # the init's transient counts: each expert tensor is drawn in fp32
    # (3.76 GB) before its bf16 copy is made
    card_memory_ok(torch, init_peak, "jamba", f"initialising {cfg.n_layers} "
                                              f"of {full.n_layers} layers")
    counts, obs = serve_runs(torch, np, cfg, params, "jamba", long=False)
    card_memory_ok(torch, obs["peak"], "jamba", f"serving {cfg.n_layers} of "
                                                f"{full.n_layers} layers")
    del params
    gc_collect(torch)
    return {"jamba": (counts, obs)}


# ----------------------------------------------------------------------
# phases 17 / 18: the encoder-decoder (whisper-medium) and the VLM
# (qwen2-vl-2b), served and trained at full size
# ----------------------------------------------------------------------
def whisper_extra(cfg, np, s: int, b: int = BATCH, seed: int = 11) -> dict:
    """The frontend stub's frame embeddings (b, enc_seq, d_model) for
    prompts of s tokens (any), drawn
    as the data pipeline draws them (0.02 N(0, 1) in numpy, rounded to
    bf16), as CPU tensors."""
    import torch
    a = np.random.default_rng(seed).standard_normal(
        (b, cfg.enc_seq, cfg.d_model)) * 0.02
    return {"enc_embeds": torch.from_numpy(a).to(torch.bfloat16)}


def qwen_extra(cfg, np, s: int, b: int = BATCH, seed: int = 12) -> dict:
    """For prompts of s tokens: the patch stub's embeddings (b, n_patches,
    d_model) bf16 and M-RoPE's positions pos3 (3, b, s): the patches on a 1 x 16 x 16 (t,
    h, w) grid, the text after them from the grid's largest position on,
    as CPU tensors."""
    import torch
    a = np.random.default_rng(seed).standard_normal(
        (b, cfg.n_patches, cfg.d_model)) * 0.02
    n = cfg.n_patches
    side = int(round(n ** 0.5))
    grid = [np.zeros(n, np.int64), np.arange(n) // side, np.arange(n) % side]
    text = np.arange(s - n) + side
    pos = np.stack([np.concatenate([g, text]) for g in grid])
    return {"img_embeds": torch.from_numpy(a).to(torch.bfloat16),
            "pos3": torch.from_numpy(np.broadcast_to(
                pos[:, None], (3, b, s)).copy())}


def serve_launches(torch, cfg, plen: int, max_seq: int,
                   n_runs: int) -> tuple:
    """The exact launches of ``n_runs`` Server.generate calls of BATCH
    prompts of ``plen`` tokens and NEW_TOKENS decode steps each: a flash
    launch per attention layer and call (the encoder's, the decoder's
    self- and cross-attention), a merge for each plan that splits the
    keys, the MLP's GEMMs (GELU 2, SwiGLU 3), nothing of training; and
    the flash launches of one prefill."""
    from repro_torch.kernels import flash_attention as fa
    b, hq, hkv, d = BATCH, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    L, enc = cfg.n_layers, cfg.enc_seq
    calls = [(plen, plen, plen, True)] * L               # prefill self
    n_mlp = L
    if cfg.encoder_decoder:
        calls += [(enc, enc, enc, False)] * cfg.n_enc_layers
        calls += [(plen, enc, enc, False)] * L
        n_mlp += cfg.n_enc_layers
    prefill_calls = len(calls)
    for j in range(NEW_TOKENS):                          # decode steps
        calls += [(1, max_seq, plen + j + 1, True)] * L
        if cfg.encoder_decoder:
            calls += [(1, enc, enc, False)] * L
    merges = sum(fa.flash_plan(b, hq, hkv, sq, skv, kv, d, torch.bfloat16,
                               causal).splits > 1
                 for sq, skv, kv, causal in calls)
    per_mlp = 2 if cfg.act == "gelu" else 3
    return {"attention": n_runs * len(calls),
            "attention_merge": n_runs * merges,
            "gemm": n_runs * per_mlp * (n_mlp + NEW_TOKENS * L),
            "attention_bwd": 0, "act_bwd": 0, "gemm_kahan": 0}, prefill_calls


def serve_family(torch, np, cfg, params, tag: str, plen: int, max_seq: int,
                 extra: dict) -> tuple:
    """Server.generate(prompts, extra=...) on ``cfg`` at BATCH prompts of
    ``plen`` tokens, NEW_TOKENS new ones, greedy and at temperature 0.8,
    the ``extra`` inputs on the card: prefill ms, decode tok/s, peak
    memory, the launches held exactly to :func:`serve_launches`, the
    samplers' launches, no engine fallback; then one decode step
    profiled. Returns (the launch counts, the times and peak that phase
    19 reads)."""
    import importlib
    from repro_torch.kernels import ops
    from repro_torch.runtime import ServeConfig, Server
    dispatch = importlib.import_module("repro_torch.core.dispatch")
    prompts = prompts_for(cfg, np, plen)
    extra = {k: v.to(DEVICE) for k, v in extra.items()}
    card = card_line()
    runs = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    dispatch.reset_engine_fallbacks()
    for name, temp in (("greedy", 0.0), ("temperature", 0.8)):
        runs[name] = Server(cfg, params, ServeConfig(
            max_seq=max_seq, max_new_tokens=NEW_TOKENS, eos_token=-1,
            temperature=temp)).generate(prompts, extra=extra)
    counts = ops.launches()
    fallbacks = dispatch.engine_fallbacks
    peak = torch.cuda.max_memory_allocated()
    for name, out in runs.items():
        comp = out["completions"]
        need(len(comp) == BATCH and all(
            len(c) == NEW_TOKENS and all(0 <= t < cfg.padded_vocab
                                         for t in c) for c in comp),
             f"{tag} {name}: completions malformed")
        say(tag, f"{name}: prefill {out['prefill_s'] * 1e3:.2f} ms | decode "
                 f"{out['decode_tok_per_s']:.2f} tok/s | req0 {comp[0]} | "
                 f"card {card}")
    want, per_prefill = serve_launches(torch, cfg, plen, max_seq, len(runs))
    say(tag, f"peak memory {peak / 1e9:.2f} GB | kernel launches {counts} "
             f"| expected {want} ({per_prefill} attention launches a "
             f"prefill) | engine_fallbacks {fallbacks} | card {card}")
    need(all(counts[k] == v for k, v in want.items()),
         f"{tag}: launches {counts}, expected {want}")
    for wrapper in ("reduce", "chain_reduce"):
        need(counts[wrapper] > 0, f"{tag}: {wrapper} kernel never launched")
    need(fallbacks == 0, f"{fallbacks} descriptors fell back to the engine")
    profile_decode_step(torch, np, cfg, params, prompts, tag, extra=extra,
                        max_seq=max_seq)
    return counts, serve_obs(runs, peak)


def family_train(torch, cfg, batch: int, seq: int, tag: str) -> dict:
    """build_step_fn on ``cfg`` (bf16, remat="full") for DENSE_STEPS steps
    at ``batch`` x ``seq`` from SyntheticLM (with the stub inputs it
    draws): step time, tokens/s, peak memory (held to HEADROOM_BYTES), the
    launches checked exactly per step (the flash forward with lse and its
    remat recompute a layer, one backward; the activation backward an
    MLP; GELU 2 + 2 + 5 GEMMs an MLP, SwiGLU 3 + 3 + 8); one more step
    profiled by kernel family."""
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.runtime import build_step_fn

    card = card_line()
    opt_cfg = AdamWConfig(warmup_steps=10, total_steps=DENSE_STEPS)
    gc_collect(torch)                  # what earlier phases left cached
    t0 = time.perf_counter()
    params = Model(cfg).init(0, device=DEVICE, trainable=True)
    opt = init_opt_state(dict(params.named_parameters()))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    step_fn = build_step_fn(cfg, opt_cfg)
    data = SyntheticLM(cfg, batch, seq, seed=0)
    batches = [{k: v.to(DEVICE) for k, v in data.batch_at(i).items()}
               for i in range(DENSE_STEPS + 1)]
    depth = (f"{cfg.n_enc_layers} + {cfg.n_layers}" if cfg.encoder_decoder
             else cfg.n_layers)
    say(tag, f"{cfg.name} {depth} layers, {n_params / 1e9:.3f} B "
             f"params, batch {batch} x {seq} "
             f"({', '.join(sorted(batches[0]))}), {DENSE_STEPS} steps; "
             f"init {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    ops.reset_launches()
    for step in range(DENSE_STEPS):
        t0 = time.perf_counter()
        params, opt, loss, _ = step_fn(params, opt, batches[step])
        losses.append(float(loss))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = ops.launches()
    peak = torch.cuda.max_memory_allocated()
    need(all(math.isfinite(x) for x in losses),
         f"{tag}: losses not all finite: {losses}")
    step_s = sum(times[1:]) / len(times[1:])
    tokens = batch * seq
    if cfg.encoder_decoder:
        # 6 N D over each stack's tokens: the encoder's parameters see the
        # frames, the decoder's (and the unembedding) the tokens
        n_enc = sum(p.numel() for p in params.enc_layers.parameters())
        n_dec = sum(p.numel() for p in params.dec_layers.parameters()) \
            + cfg.d_model * cfg.padded_vocab
        flops = 6.0 * (n_enc * batch * cfg.enc_seq + n_dec * tokens)
        what = (f"{batch * cfg.enc_seq / step_s:.0f} frames/s and "
                f"{tokens / step_s:.0f} tokens/s")
    else:
        flops = 6.0 * n_params * tokens
        what = f"{tokens / step_s:.0f} tokens/s"
    say(tag, f"losses {[round(x, 4) for x in losses]} | step times "
             f"{[round(t * 1e3, 1) for t in times]} ms | step after step 1 "
             f"{step_s * 1e3:.1f} ms | {what} | model FLOPs {flops / 1e12:.2f}"
             f" T a step = {flops / step_s / PEAK_OPS['bf16']:.4f} of the "
             f"989 TFLOP/s bf16 peak (observation) | card {card}")
    card_memory_ok(torch, peak, tag, f"training at batch {batch} x {seq}")
    S = DENSE_STEPS
    want = train_launches(cfg, S)
    say(tag, f"kernel launches in {S} steps {counts} | expected {want}")
    need(all(counts[k] == v for k, v in want.items()),
         f"{tag}: launches {counts}, expected {want}")
    params, opt = profile_dense_step(torch, cfg, step_fn, params, opt,
                                     batches[DENSE_STEPS], step_s, tag)
    del params, opt, batches
    gc_collect(torch)
    return counts, {"step_ms": step_s * 1e3, "peak": peak}


def train_launches(cfg, steps: int) -> dict:
    """The exact launches of ``steps`` dense, encoder-decoder or VLM
    training steps: the flash forward with lse and its remat recompute an
    attention, one backward; the activation backward an MLP; GELU 2 + 2 +
    5 GEMMs an MLP, SwiGLU 3 + 3 + 8."""
    n_attn = (cfg.n_enc_layers + 2 * cfg.n_layers if cfg.encoder_decoder
              else cfg.n_layers)
    n_mlp = cfg.n_layers + (cfg.n_enc_layers if cfg.encoder_decoder else 0)
    per_gemm = 9 if cfg.act == "gelu" else 14
    return {"attention": 2 * n_attn * steps, "attention_bwd": n_attn * steps,
            "act_bwd": n_mlp * steps, "gemm": per_gemm * n_mlp * steps,
            "attention_merge": 0}


def moe_train_launches(cfg, steps: int) -> dict:
    """The exact launches of ``steps`` MoE training steps: the flash
    forward with lse and its recompute a layer and microbatch, one
    backward; no GEMM kernel (the experts run on cuBLAS)."""
    L = cfg.n_layers * cfg.grad_accum * steps
    return {"attention": 2 * L, "attention_bwd": L, "attention_merge": 0,
            "gemm": 0}


def phase_whisper(torch, np) -> tuple:
    """whisper-medium: the width check (2 encoder + 2 decoder layers at
    full width, card vs CPU: prefill logits, 4 decode steps and every
    cache leaf, k, v, ck and cv), then Server.generate on the full model
    (24 + 24 layers) with 1500-frame inputs, its launches held exactly; a
    1 + 1-layer training step card vs CPU, then DENSE_STEPS steps at
    full size, 8 x 448 decoder tokens against 8 x 1500 frames. Returns the
    serving and the training launch counts."""
    from repro_torch import configs
    from repro_torch.models import Model
    gc_collect(torch)
    phase_width(torch, np, WHISPER, "whisper width",
                cut={"n_layers": 2, "n_enc_layers": 2}, extra=whisper_extra)
    cfg = configs.get(WHISPER)
    t0 = time.perf_counter()
    params = Model(cfg).init(0, device=DEVICE)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    say("whisper", f"{WHISPER} {cfg.n_enc_layers} + {cfg.n_layers} layers, "
                   f"{n_params / 1e9:.3f} B params bf16 "
                   f"({torch.cuda.memory_allocated() / 1e9:.2f} GB), init "
                   f"{time.perf_counter() - t0:.1f} s")
    # a decode step reads the decoder's weights but the cross-attention's
    # wk and wv, the unembedding, and the cached keys and values
    d, L = cfg.d_model, cfg.n_layers
    step_bytes = 2 * (L * (6 * d * d + 2 * d * cfg.d_ff)
                      + d * cfg.padded_vocab
                      + L * BATCH * 2 * d * (cfg.enc_seq + MAX_SEQ))
    say("whisper", f"a decode step reads {step_bytes / 1e9:.3f} GB of "
                   f"weights and caches (bf16): bound "
                   f"{step_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms (bytes)")
    serve = serve_family(torch, np, cfg, params, "whisper",
                                   PROMPT_LEN, MAX_SEQ,
                                   whisper_extra(cfg, np, PROMPT_LEN))
    del params
    gc_collect(torch)
    t0 = time.perf_counter()
    width_step_check(torch, cfg.scaled(n_layers=1, n_enc_layers=1),
                     DENSE_WIDTH_SEQ, "whisper train width")
    say("whisper train width", f"{WHISPER} full width, 1 + 1 of 24 + 24 "
                               f"layers, batch 1 x {DENSE_WIDTH_SEQ} tokens "
                               f"against {cfg.enc_seq} frames, "
                               f"{time.perf_counter() - t0:.1f} s ok")
    gc_collect(torch)
    train = family_train(torch, cfg, WHISPER_TRAIN_BATCH, WHISPER_TRAIN_SEQ,
                         "whisper train")
    return {"whisper": serve, "whisper_train": train}


def phase_qwen(torch, np) -> tuple:
    """qwen2-vl-2b: the width check (2 of 28 layers at full width, card vs
    CPU, prompts of 256 patches and 32 text tokens with pos3 on a patch
    grid), then Server.generate on the full model with img_embeds and
    pos3, its launches held exactly; a 1-layer training step card vs CPU,
    then DENSE_STEPS steps at full size, QWEN_TRAIN_BATCH x
    QWEN_TRAIN_SEQ with the patches masked out of the loss. Returns the
    serving and the training launch counts."""
    from repro_torch import configs
    from repro_torch.models import Model
    gc_collect(torch)
    phase_width(torch, np, QWEN, "qwen width", plen=QWEN_PLEN,
                extra=qwen_extra)
    cfg = configs.get(QWEN)
    t0 = time.perf_counter()
    params = Model(cfg).init(0, device=DEVICE)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    say("qwen", f"{QWEN} {cfg.n_layers} layers, {n_params / 1e9:.3f} B "
                f"params bf16 ({torch.cuda.memory_allocated() / 1e9:.2f} GB),"
                f" init {time.perf_counter() - t0:.1f} s")
    serve = serve_family(torch, np, cfg, params, "qwen", QWEN_PLEN,
                                   QWEN_MAX_SEQ,
                                   qwen_extra(cfg, np, QWEN_PLEN))
    del params
    gc_collect(torch)
    t0 = time.perf_counter()
    width_step_check(torch, cfg.scaled(n_layers=1), QWEN_PATCHES + 64,
                     "qwen train width")
    say("qwen train width", f"{QWEN} full width, 1 of 28 layers, batch 1 x "
                            f"{QWEN_PATCHES + 64} ({QWEN_PATCHES} patches "
                            f"masked), {time.perf_counter() - t0:.1f} s ok")
    gc_collect(torch)
    train = family_train(torch, cfg, QWEN_TRAIN_BATCH, QWEN_TRAIN_SEQ,
                         "qwen train")
    return {"qwen": serve, "qwen_train": train}


# ----------------------------------------------------------------------
# phase 6 / 7: the training path
# ----------------------------------------------------------------------
def phase_train_width(torch, np) -> None:
    """One build_step_fn step of full-width mamba2-1.3b (2 of 48 layers,
    to fit the CPU side) on the card and on the CPU, same weights and
    batch."""
    from repro_torch import configs
    t0 = time.perf_counter()
    width_step_check(torch, configs.get("mamba2-1.3b").scaled(n_layers=2),
                     256, "train width")                   # 2 chunks
    say("train width", f"mamba2-1.3b full width, 2 of 48 layers (depth cut "
                       f"to fit the CPU side), batch 1 x 256, "
                       f"{time.perf_counter() - t0:.1f} s ok")


def step_with_grads(step_fn, params, opt_state, batch, update=True):
    """One step of ``step_fn`` (``build_step_fn``'s or the mesh step's)
    that also returns the gradients it handed to the optimizer
    (``apply_updates``, wrapped for the call) and their global norm (the
    mesh step's own, else ``global_norm``): ``(params, new_state, loss,
    grads, gnorm)``. With ``update=False`` the step ends there: the
    parameters stay as they were and ``opt_state`` is not read."""
    from repro_torch.optim import global_norm
    from repro_torch.runtime import train
    seen, real = {}, train.apply_updates

    def capture(cfg, named, grads, state, **kw):
        seen["grads"] = grads
        seen["gnorm"] = kw.get("gnorm")
        if seen["gnorm"] is None:
            seen["gnorm"] = global_norm(grads)
        if not update:
            return dict(named), state       # copy_ onto itself: a no-op
        return real(cfg, named, grads, state, **kw)
    train.apply_updates = capture
    try:
        params, state, loss, _ = step_fn(params, opt_state, batch)
    finally:
        train.apply_updates = real
    return params, state, loss, seen["grads"], seen["gnorm"]


def width_step_check(torch, base, seq: int, tag: str) -> None:
    """One build_step_fn step of ``base`` at batch 1 x ``seq`` on the card
    and on the CPU from the same weights and batch, in fp32 and bf16:
    loss, grad norm, every leaf's gradient and the params after the
    step, each held to its limit (below); the gradients are the ones the
    step hands to its optimizer. With MoE layers both sides run under a
    :class:`RouteLog` and the CPU replays the card's experts (forward and
    remat recompute alike): in fp32 the CPU's own router must pick them
    everywhere, in bf16 it may differ at near-ties only; on the card
    every recompute must route as its forward did. The CPU's step stops
    at its gradients: the same plain AdamW (plain PyTorch on either
    device, no kernel of the port) steps them on the card, from the same
    weights and clipped by the CPU's own global norm, leaf by leaf (each
    leaf's update reads only its own state); on the CPU that update took
    most of a side's time."""
    from repro_torch.data import SyntheticLM
    from repro_torch.models import Model
    from repro_torch.optim import (AdamWConfig, apply_updates,
                                   init_opt_state, lr_schedule)
    from repro_torch.runtime import build_step_fn

    opt_cfg = AdamWConfig(warmup_steps=1, total_steps=10)
    lr1 = float(lr_schedule(opt_cfg, 1))
    batch = SyntheticLM(base, 1, seq, seed=0).batch_at(0)
    # loss, grad norm and per-leaf gradients: about 10x the card-vs-CPU
    # differences measured on an H100 on mamba2-1.3b (loss fp32 1e-7
    # relative, summation order; bf16 7.5e-6, and 1.9e-4 on the norm,
    # the compute dtype's rounding through 2 layers); see PERF.md. The
    # gradients are held leaf by leaf, by the worst leaf's relative L2
    # error, since the first AdamW step moves every element by about
    # +-lr whatever its gradient. So the params after the step are only
    # held to 2 lr plus rounding (bf16: one ulp, <= 2**-7 of the value),
    # and to be finite.
    for dtype, loss_rtol, norm_rtol, grad_rtol, p_rtol in (
            ("float32", 1e-5, 1e-5, GRAD_RTOL["float32"], 1e-5),
            ("bfloat16", 1e-4, 2e-3, GRAD_RTOL["bfloat16"], 2.0 ** -7)):
        cfg = base.scaled(compute_dtype=dtype, param_dtype=dtype)
        # the weights are drawn on the card (the CPU's generator took ~35
        # s for 1.6 B parameters on the H100's host) and copied
        p_gpu = Model(cfg).init(0, device=DEVICE, trainable=True)
        p_cpu = copy.deepcopy(p_gpu).to("cpu")
        out, side_s, logs = [], {}, {}
        for dev, params in ((DEVICE, p_gpu), ("cpu", p_cpu)):
            t_side = time.perf_counter()
            b = {k: v.to(dev) for k, v in batch.items()}
            named = dict(params.named_parameters())
            card = params is p_gpu
            with RouteLog(torch, params, logs.get(DEVICE)) as logs[dev]:
                _, state, loss, grads, gnorm = step_with_grads(
                    build_step_fn(cfg, opt_cfg), params,
                    init_opt_state(named) if card else None, b,
                    update=card)
            grads = {n: g.detach().float() for n, g in grads.items()}
            del state
            out.append((float(loss), float(gnorm), grads,
                        {n: p.detach() for n, p in named.items()}))
            side_s[dev] = time.perf_counter() - t_side
        if cfg.moe:
            check_routing(tag, dtype, logs[DEVICE], logs["cpu"])
            n_calls = len(logs[DEVICE].calls)
            same = logs[DEVICE].recomputes_agree()
            say(tag, f"{dtype} card: {n_calls} routings over "
                     f"{cfg.n_layers} layers (the forward and its remat "
                     f"recompute), every recompute as its forward {same}")
            need(same and n_calls == 2 * cfg.n_layers,
                 f"{dtype}: a recompute routed other than its forward")
        # compared on the card, each CPU leaf moved there (the host's
        # passes over the gradients and params took ~10 s a dtype); pc
        # holds the weights before the step
        (lg, ng, gg, pg), (lc, nc, gc, pc) = out
        norm_c = torch.tensor(nc, dtype=torch.float32, device=DEVICE)
        g_err, g_leaf, worst, ok = 0.0, None, 0.0, True
        for n, p0 in pc.items():
            g = gc.pop(n).to(DEVICE)
            err = float((gg[n] - g).norm()) / max(float(g.norm()), 1e-30)
            if not math.isfinite(err) or err > g_err:
                g_err, g_leaf = err, n
            one = {n: p0.to(DEVICE)}
            want = apply_updates(opt_cfg, one, {n: g}, init_opt_state(one),
                                 gnorm=norm_c)[0][n]
            got = pg[n].float()
            diff = (got - want.float()).abs()
            worst = max(worst, float(diff.max()))
            ok &= bool(torch.isfinite(got).all()) and bool(
                (diff <= 2 * lr1 + p_rtol * want.float().abs()).all())
        ok_loss = math.isfinite(lg) and abs(lg - lc) <= loss_rtol * abs(lc)
        ok_norm = math.isfinite(ng) and abs(ng - nc) <= norm_rtol * abs(nc)
        ok_grad = math.isfinite(g_err) and g_err <= grad_rtol
        verdict = "ok" if ok and ok_loss and ok_norm and ok_grad else "FAIL"
        say(tag, f"{dtype}: loss card {lg:.6f} cpu {lc:.6f} "
                 f"(rtol {loss_rtol:g}) | grad norm card {ng:.6f} "
                 f"cpu {nc:.6f} (rtol {norm_rtol:g}) | grads worst "
                 f"leaf rel L2 {g_err:.3e} at {g_leaf} (limit "
                 f"{grad_rtol:g}) | params after one step "
                 f"max_abs_err {worst:.3e} (2 lr {2 * lr1:.1e} + "
                 f"{p_rtol:g} |p|) | card side {side_s[DEVICE]:.1f} s, "
                 f"CPU side {side_s['cpu']:.1f} s {verdict}")
        need(ok_loss and ok_norm and ok_grad and ok,
             f"{dtype} full-width training step disagrees card vs CPU")
        del p_cpu, p_gpu, out, gg, pg, gc, pc
        gc_collect(torch)


def gc_collect(torch) -> None:
    gc.collect()
    torch.cuda.empty_cache()


def phase_dense_width(torch, np) -> None:
    """One build_step_fn step of full-width llama3-8b (1 of 32 layers,
    batch 1 x DENSE_WIDTH_SEQ, to fit the CPU side within the script's
    time) on the card (the flash backward, the MLP backward on ntx_gemm
    and the activation backward) and on the CPU (their plain versions),
    same weights and batch."""
    from repro_torch import configs
    t0 = time.perf_counter()
    width_step_check(torch, configs.get("llama3-8b").scaled(n_layers=1),
                     DENSE_WIDTH_SEQ, "dense width")
    say("dense width", f"llama3-8b full width, 1 of 32 layers (depth cut to "
                       f"fit the CPU side), batch 1 x {DENSE_WIDTH_SEQ}, "
                       f"{time.perf_counter() - t0:.1f} s ok")


#: substrings of cuBLAS/cuDNN kernel names (after the port's own kernels
#: are matched: ``ntx_gemm.cu``'s names contain "gemm" too)
CUBLAS_KEYS = ("gemm", "nvjet", "xmma", "cutlass", "cublas", "sm90_",
               "gemv")


#: the serving path's kernels by source file, for kernel_split
KERNEL_GROUPS = {
    "ntx_gemm.cu": ("gemm_bf16_tc", "tc_reduce", "::gemm_kernel<",
                    "gemm_ffma"),
    "flash_attention.cu": ("flash_tc", "flash_f32", "flash_merge"),
    "ntx_stream.cu": ("stream_flat", "stream_chunk_kernel",
                      "stream_merge_kernel"),
    "ssd_scan.cu": ("ssd_state_", "ssd_carry", "ssd_out_"),
    "cuBLAS": CUBLAS_KEYS}


def kernel_split(evs, groups, skip=()):
    """Device time of a profile's kernels: ``(busy ms, {group: (ms,
    launches)}, the 8 longest kernels)``, each kernel in the first group
    one of whose substrings its name contains, else in "other PyTorch
    kernels"; None when the profiler saw no device time."""
    from torch.autograd import DeviceType
    kernels = [e for e in evs if e.device_type == DeviceType.CUDA
               and e.key not in skip]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if not busy:
        return None
    by_group = {g: [0.0, 0] for g in (*groups, "other PyTorch kernels")}
    for e in kernels:
        name = e.key.lower()
        g = next((g for g, keys in groups.items()
                  if any(k in name for k in keys)), "other PyTorch kernels")
        by_group[g][0] += e.self_device_time_total / 1e3
        by_group[g][1] += e.count
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return busy, by_group, top


def profile_step(torch, cfg, step_fn, params, opt):
    """One more training step under torch.profiler: where its device
    time goes, by kernel and by the step's profiler ranges."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data import SyntheticLM
    batch = {k: v.to(DEVICE) for k, v in SyntheticLM(
        cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0).batch_at(TRAIN_STEPS).items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, _, _ = step_fn(params, opt, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ranges = ("train_step.grads", "train_step.optimizer", "ssd_bwd")
    evs = prof.key_averages()
    span = {e.key: e.device_time_total / 1e3 for e in evs
            if e.key in ranges and e.device_type == DeviceType.CPU}
    split = kernel_split(evs, {"ssd_scan.cu": ("ssd_state_", "ssd_carry",
                                               "ssd_out_"),
                               "cuBLAS/cuDNN matmul": CUBLAS_KEYS},
                         skip=ranges)
    if split is None:
        say("train", "profiler saw no device time: breakdown not measured")
        return params, opt
    busy, by_group, top = split
    say("train", f"profiled step: wall {wall_ms:.1f} ms (profiler on) | "
                 f"device busy {busy:.1f} ms ({busy / wall_ms:.3f} of "
                 f"wall) | ranges (device ms) "
                 f"{ {k: round(v, 1) for k, v in span.items()} } | "
                 f"kernels by group (ms) "
                 f"{ {k: round(v[0], 1) for k, v in by_group.items()} } | "
                 f"card {card_line()}")
    for e in top:
        say("train", f"  {e.self_device_time_total / 1e3:9.2f} ms "
                     f"x{e.count:5d}  {e.key[:110]}")
    return params, opt


def phase_train(torch, np) -> dict:
    """The Trainer on the full 48-layer mamba2-1.3b, then the fused
    optimizer update against the plain one on the final state."""
    from repro_torch import configs
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig, apply_updates, global_norm
    from repro_torch.runtime import TrainConfig, Trainer

    cfg = configs.get("mamba2-1.3b")
    opt_cfg = AdamWConfig(warmup_steps=max(10, TRAIN_STEPS // 10),
                          total_steps=TRAIN_STEPS)
    card = card_line()
    free = shutil.disk_usage(tempfile.gettempdir()).free
    say("train", f"checkpoints go to {tempfile.gettempdir()} "
                 f"({free / 1e9:.0f} GB free)")
    with tempfile.TemporaryDirectory() as ckpt_dir:
        trainer = Trainer(cfg, opt_cfg, TrainConfig(
            steps=TRAIN_STEPS, log_every=0, ckpt_every=50, ckpt_dir=ckpt_dir,
            global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, resume="none"),
            device=DEVICE)
        times = []
        step_fn = trainer.step_fn

        def timed(params, opt_state, batch):
            t0 = time.perf_counter()
            out = step_fn(params, opt_state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            return out
        trainer.step_fn = timed
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        r = trainer.run()
        train_counts = ops.launches()
        peak = torch.cuda.max_memory_allocated()
        saved = sorted(os.listdir(ckpt_dir))
        with open(os.path.join(ckpt_dir, saved[-1], "manifest.json")) as f:
            manifest = json.load(f)
    params, opt = r.pop("params"), r.pop("opt")
    n_params = sum(p.numel() for p in params.parameters())
    losses = r["losses"]
    need(len(losses) == TRAIN_STEPS and all(math.isfinite(x)
                                            for x in losses),
         f"training losses not all finite: {losses}")
    steady = times[1:]
    step_s = sum(steady) / len(steady)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    share = 6.0 * n_params * tokens / step_s / PEAK_OPS["bf16"]
    say("train", f"mamba2-1.3b {cfg.n_layers} layers, {n_params / 1e9:.3f} B "
                 f"params bf16, batch {TRAIN_BATCH} x seq {TRAIN_SEQ}: losses "
                 f"{[round(x, 4) for x in losses]} | card {card}")
    say("train", f"step times {[round(t * 1e3, 1) for t in times]} ms | step "
                 f"after step 1 {step_s * 1e3:.1f} ms | {tokens / step_s:.0f} "
                 f"tokens/s | 6 N tokens / step time = {share:.4f} of the "
                 f"989 TFLOP/s bf16 peak (observation) | peak memory "
                 f"{peak / 1e9:.2f} GB | card {card}")
    say("train", f"kernel launches in {TRAIN_STEPS} steps {train_counts} "
                 f"({train_counts['ssd'] / TRAIN_STEPS:g} ssd per step) | "
                 f"checkpoint {saved[-1]} with {len(manifest)} leaves")
    plan = r["multistream"]
    say("train", f"multistream update plan (priced, not launched): "
                 f"{plan['n_substreams']} sub-streams on {plan['n_clusters']} "
                 f"cluster(s), model speedup {plan['model_speedup']:.3f}, "
                 f"pipeline {plan['pipeline']['n_stages']} stages")
    need(train_counts["ssd"] == 2 * cfg.n_layers * TRAIN_STEPS,
         f"ssd launched {train_counts['ssd']} times, expected "
         f"{2 * cfg.n_layers} per step (forward and recompute)")
    need(r["bad_steps"] == 0, "NaN fuse tripped")
    need(saved == [f"step_{TRAIN_STEPS:09d}"], f"checkpoints {saved}")
    params, opt = profile_step(torch, cfg, step_fn, params, opt)

    # the fused update on the final state, against the plain one
    batch = {k: v.to(DEVICE) for k, v in SyntheticLM(
        cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0).batch_at(
            TRAIN_STEPS + 1).items()}
    named = dict(params.named_parameters())
    loss, _ = Model(cfg).loss(params, batch)
    grads = {n: g.float() for n, g in zip(
        named, torch.autograd.grad(loss, list(named.values())))}
    del loss
    # leaf by leaf on the card: each leaf's update reads only its own
    # state and the global norm's clip, so this is the whole update, with
    # no full new state held or copied to the host
    gnorm = global_norm(grads)
    zero = torch.zeros((), device=DEVICE)
    worst = {k: zero for k in ("params", "master", "m", "v")}
    bad, n_fused = torch.zeros((), dtype=torch.bool, device=DEVICE), 0
    for n, p in named.items():
        one = {k: {n: opt[k][n]} for k in ("master", "m", "v")}
        one["step"] = opt["step"]
        runs = []
        for use_fused in (True, False):
            ops.reset_launches()
            new_p, new_s = apply_updates(opt_cfg, {n: p}, {n: grads[n]}, one,
                                         use_fused=use_fused, gnorm=gnorm)
            n_fused += ops.launches()["adamw"]
            runs.append({"params": new_p[n], "master": new_s["master"][n],
                         "m": new_s["m"][n], "v": new_s["v"][n]})
        fused, plain = runs
        for part, want in plain.items():
            # the fused kernel multiplies by the reciprocal bias
            # corrections where the plain path divides (the reference's
            # 1e-5 / 1e-6); bf16 params may then round one ulp (<= 2**-7
            # of the value) apart
            rtol, atol = ((2.0 ** -7, 0.0) if part == "params"
                          else (1e-5, 1e-6))
            diff = (fused[part].float() - want.float()).abs()
            worst[part] = torch.maximum(worst[part], diff.max())
            bad |= ~(diff <= atol + rtol * want.float().abs()).all()
        del runs, fused, plain, new_p, new_s
    worst = {k: float(v) for k, v in worst.items()}
    ok = not bool(bad)
    n_2d = sum(1 for p in named.values() if p.ndim == 2)
    say("train", f"apply_updates fused vs plain on the final state: max_abs_"
                 f"err {worst} | adamw launches {n_fused} (2-D tensors "
                 f"{n_2d}) {'ok' if ok else 'FAIL'}")
    need(ok, "fused AdamW update disagrees with the plain update")
    need(n_fused == n_2d, f"adamw launched {n_fused} times for {n_2d} "
                          f"2-D tensors")
    del params, opt, grads, named
    torch.cuda.empty_cache()
    # the kernels line reports the Trainer's own run for the scan and the
    # fused update's run for AdamW, never the profiled step or the
    # forward and backward that fed the fused update
    return {"train": (dict(train_counts, adamw=n_fused),
                      {"step_ms": step_s * 1e3, "peak": peak})}


#: the dense training step's kernels by source file, for kernel_split
DENSE_GROUPS = {
    "flash_attention_bwd.cu": ("flash_bwd_dkdv", "flash_bwd_dq",
                               "flash_bwd_delta", "flash_bwd_merge"),
    "flash_attention.cu": ("flash_tc", "flash_f32", "flash_merge"),
    "ntx_gemm.cu": KERNEL_GROUPS["ntx_gemm.cu"],
    "ntx_act_bwd.cu": ("act_bwd",),
    "cuBLAS": CUBLAS_KEYS}


def profile_dense_step(torch, cfg, step_fn, params, opt, batch, wall_s,
                       tag: str = "dense train"):
    """One more dense training step under torch.profiler: device time by
    kernel family. The ctypes launches are not attributed to the
    profiler's ranges, so ntx_gemm.cu is split into forward and backward
    by a second profile of one forward (``Model.loss`` under no_grad):
    the step runs the forward twice (remat), the rest is the MLP
    backward."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import Model
    torch.cuda.synchronize()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) as fp:
        Model(cfg).loss(params, batch)
        torch.cuda.synchronize()
    fwd = kernel_split(fp.key_averages(), DENSE_GROUPS)
    gc_collect(torch)           # the step after it at the timed steps' peak
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, _, _ = step_fn(params, opt, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ranges = ("train_step.grads", "train_step.optimizer", "fused_mlp_bwd")
    evs = prof.key_averages()
    span = {e.key: e.device_time_total / 1e3 for e in evs
            if e.key in ranges and e.device_type == DeviceType.CPU}
    split = kernel_split(evs, DENSE_GROUPS, skip=ranges)
    if split is None:
        say(tag, "profiler saw no device time: breakdown not "
                           "measured")
        return params, opt
    busy, by_group, top = split
    gemm_ms, gemm_n = by_group["ntx_gemm.cu"]
    if fwd is None:
        bwd = "forward / backward split not measured"
    else:
        f_ms, f_n = (2 * x for x in fwd[1]["ntx_gemm.cu"])
        bwd = (f"forward and its recompute {f_ms:.1f} ms x{f_n}, MLP "
               f"backward {gemm_ms - f_ms:.1f} ms x{gemm_n - f_n}")
    say(tag, f"profiled step: wall {wall_ms:.1f} ms (profiler on; "
                       f"{wall_s * 1e3:.1f} ms off) | device busy {busy:.1f} "
                       f"ms ({busy / wall_ms:.3f} of wall) | ranges (device "
                       f"ms of their PyTorch ops; the kernels' ctypes "
                       f"launches are not attributed) "
                       f"{ {k: round(v, 1) for k, v in span.items()} } | "
                       f"card {card_line()}")
    say(tag, "kernels by family (device ms, launches): " + " | "
        .join(f"{k} {v[0]:.1f} x{v[1]}" for k, v in by_group.items())
        + f" | ntx_gemm.cu: {bwd}")
    for e in top:
        say(tag, f"  {e.self_device_time_total / 1e3:9.2f} ms "
                           f"x{e.count:5d}  {e.key[:110]}")
    return params, opt


def phase_dense_train(torch, np) -> dict:
    """build_step_fn on llama3-8b at full width (d_model 4096, 32 / 8
    heads of 128, d_ff 14336, vocab 128256, bf16, remat="full") cut to
    DENSE_LAYERS of 32 layers: DENSE_STEPS steps at batch DENSE_BATCH x
    DENSE_SEQ (the step the Trainer runs; phase 7 covers its
    checkpoints), through :func:`family_train`."""
    from repro_torch import configs
    full = configs.get("llama3-8b")
    say("dense train", f"cut: layers {DENSE_LAYERS} of {full.n_layers} (~16 "
                       f"bytes a parameter: the {full.n_layers}-layer model "
                       f"needs ~128 GB)")
    return {"dense": family_train(torch, full.scaled(n_layers=DENSE_LAYERS),
                                  DENSE_BATCH, DENSE_SEQ, "dense train")}


# ----------------------------------------------------------------------
# phase 20: the mesh on the card
# ----------------------------------------------------------------------
def check_collectives_on_card(torch, group) -> None:
    """The int8 collectives on CUDA tensors against the CPU port on the
    same bytes (bit-equal), and the one-rank compressed mean, mean and
    ring products against their one-rank arithmetic on the card
    (bit-equal)."""
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed import overlap
    g = torch.Generator(device=DEVICE).manual_seed(20)
    x = torch.randn((1 << 22) + 7, generator=g, device=DEVICE) * 3.0
    res = torch.randn(x.shape, generator=g, device=DEVICE) * 1e-3
    xc, rc = x.cpu(), res.cpu()
    same = lambda a, b: a.cpu().numpy().tobytes() == b.numpy().tobytes()
    q, sc = col.quantize_int8(x)
    qc, scc = col.quantize_int8(xc)
    out, new = col.error_feedback(x, res, lambda t: t * 0.5)
    outc, newc = col.error_feedback(xc, rc, lambda t: t * 0.5)
    checks = {"quantize_int8": same(q, qc) and same(sc, scc),
              "dequantize_int8": same(col.dequantize_int8(q, sc),
                                      col.dequantize_int8(qc, scc)),
              "error_feedback": same(out, outc) and same(new, newc)}
    q2, s2 = col.quantize_int8(col.dequantize_int8(q, sc))
    checks["compressed_psum_mean (1 rank)"] = torch.equal(
        col.compressed_psum_mean(x, group), col.dequantize_int8(q2, s2))
    checks["psum_mean (1 rank)"] = torch.equal(col.psum_mean(x, group), x)
    a = torch.randn(512, 256, generator=g, device=DEVICE)
    w = torch.randn(256, 384, generator=g, device=DEVICE)
    want = torch.matmul(a, w)
    checks["ring_allgather_matmul (1 rank)"] = torch.equal(
        overlap.ring_allgather_matmul(a, w, group), want)
    checks["ring_matmul_reducescatter (1 rank)"] = torch.equal(
        overlap.ring_matmul_reducescatter(a, w, group), want)
    say("mesh", "collectives on CUDA tensors: " + " | ".join(
        f"{k} {'bit-equal' if v else 'DIFFERS'}" for k, v in checks.items()))
    need(all(checks.values()), f"collectives on the card: {checks}")


def phase_mesh(torch, np, obs: dict, src: Path) -> dict:
    """Trainer(mesh=make_mesh_for(1)) on a 1-rank NCCL process group
    (rendezvous through a FileStore under $TMPDIR): llama3-8b at full
    width cut to DENSE_LAYERS of 32 layers, batch DENSE_BATCH x DENSE_SEQ,
    bf16, MESH_STEPS steps and a checkpoint; then build_step_fn's plain
    steps from the same seed and batches, in turn (both states at once
    do not fit the card). Held to phase 10's bf16 limits: the losses;
    the global norm and every leaf of the gradients that the first step
    of each hands its optimizer (the mesh step's kept on the host); and
    every parameter leaf after the steps. The launches of each are held
    to phase 11's per step."""
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import Model
    from repro_torch.models.common import set_activation_sharding
    from repro_torch.optim import AdamWConfig, init_opt_state, lr_schedule
    from repro_torch.runtime import TrainConfig, Trainer, build_step_fn

    card = card_line()
    dry_runs = mesh_dry_runs(src)
    cfg = configs.get("llama3-8b").scaled(n_layers=DENSE_LAYERS)
    opt_cfg = AdamWConfig(warmup_steps=10, total_steps=MESH_STEPS)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_mesh_for(1)
        say("mesh", f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} on "
                    f"a {dist.get_world_size()}-rank NCCL group, "
                    f"{torch.cuda.device_count()} card(s) visible: no "
                    f"collective here crosses cards | card {card}")
        check_collectives_on_card(torch, mesh.get_group("data"))
        set_activation_sharding(mesh, ("data",), "model")
        trainer = Trainer(cfg, opt_cfg, TrainConfig(
            steps=MESH_STEPS, log_every=0, ckpt_every=MESH_STEPS,
            ckpt_dir=os.path.join(tmp, "ckpt"), resume="none",
            global_batch=DENSE_BATCH, seq_len=DENSE_SEQ), mesh=mesh,
            device=DEVICE)
        times, real, first = [], trainer.step_fn, {}

        def timed(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if times:
                out = real(*args)
            else:                       # step 1 hands over its gradients
                *out, grads, gnorm = step_with_grads(real, *args)
                out = (*out, {})
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if len(times) == 1:
                first["grads"] = {n: g.detach().cpu()
                                  for n, g in grads.items()}
                first["gnorm"] = float(gnorm)
                del grads
                torch.cuda.reset_peak_memory_stats()
            return out
        trainer.step_fn = timed
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        r = trainer.run()
        run_s = time.perf_counter() - t0
        counts = ops.launches()
        peak = torch.cuda.max_memory_allocated()
        m_losses = r["losses"]
        m_params = {n: p.to_local().detach().cpu()
                    for n, p in r["params"].named_parameters()}
        kinds = {type(p).__name__ for p in r["params"].parameters()}
        del r, trainer, real
        gc_collect(torch)
        saved = sorted(os.listdir(os.path.join(tmp, "ckpt")))
        with open(os.path.join(tmp, "ckpt", saved[-1], "manifest.json")) as f:
            man = {m["name"]: m for m in json.load(f)}
        wq = man["['params']['layers']['attn_mlp']['mixer']['wq']"]
        say("mesh", f"Trainer(mesh): {MESH_STEPS} steps, losses "
                    f"{[round(x, 4) for x in m_losses]}, step times "
                    f"{[round(t * 1e3, 1) for t in times]} ms, run with "
                    f"init and checkpoint {run_s:.1f} s | parameters "
                    f"{sorted(kinds)} | checkpoint {saved[-1]}: "
                    f"{len(man)} leaves in the reference's stacked layout "
                    f"(wq {wq['shape']} {wq['dtype']}), written by rank 0")
        need(saved == [f"step_{MESH_STEPS:09d}"] and wq["shape"] == [
            DENSE_LAYERS, 4096, 4096], f"mesh checkpoint {saved} {wq}")
        card_memory_ok(torch, peak, "mesh", "the mesh step at batch "
                       f"{DENSE_BATCH} x {DENSE_SEQ}")

        params = Model(cfg).init(0, device=DEVICE, trainable=True)
        opt = init_opt_state(dict(params.named_parameters()))
        step_fn = build_step_fn(cfg, opt_cfg)
        data = SyntheticLM(cfg, DENSE_BATCH, DENSE_SEQ, seed=0)
        p_losses, p_times = [], []
        ops.reset_launches()
        for i in range(MESH_STEPS):
            batch = {k: v.to(DEVICE) for k, v in data.batch_at(i).items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if i:
                params, opt, loss, _ = step_fn(params, opt, batch)
            else:
                params, opt, loss, grads, gnorm = step_with_grads(
                    step_fn, params, opt, batch)
            p_losses.append(float(loss))
            torch.cuda.synchronize()
            p_times.append(time.perf_counter() - t0)
            if not i:
                # each leaf's relative L2 error, compared on the card
                g_err, g_leaf = 0.0, None
                for n, want in grads.items():
                    want = want.float()
                    got = first["grads"].pop(n).to(DEVICE).float()
                    err = float((got - want).norm()) / max(
                        float(want.norm()), 1e-30)
                    if not math.isfinite(err) or err > g_err:
                        g_err, g_leaf = err, n
                p_norm = float(gnorm)
                del grads, got, want
        p_counts = ops.launches()
        # phase 10's bf16 limits: the loss at rtol 1e-4; a parameter within
        # 2 lr a step (the first AdamW steps move each weight by about lr
        # whatever its gradient) plus one bf16 ulp (2**-7 of the value)
        lr_sum = sum(float(lr_schedule(opt_cfg, i + 1))
                     for i in range(MESH_STEPS))
        worst, n_diff, n_all, ok_p = 0.0, 0, 0, True
        for n, p in params.named_parameters():     # on the card
            want = p.detach().float()
            got = m_params[n].to(DEVICE).float()
            diff = (got - want).abs()
            worst = max(worst, float(diff.max()))
            n_diff += int((diff > 0).sum())
            n_all += diff.numel()
            ok_p &= bool(torch.isfinite(got).all()) and bool(
                (diff <= 2 * lr_sum + 2.0 ** -7 * want.abs()).all())
        del params, opt, m_params
        gc_collect(torch)
        ok_l = all(math.isfinite(a) and abs(a - b) <= 1e-4 * abs(b)
                   for a, b in zip(m_losses, p_losses))
        m_norm = first["gnorm"]
        ok_n = math.isfinite(m_norm) and abs(m_norm - p_norm) <= 2e-3 * p_norm
        ok_g = math.isfinite(g_err) and g_err <= GRAD_RTOL["bfloat16"]
        m_ms = sum(times[1:]) / len(times[1:]) * 1e3
        p_ms = sum(p_times[1:]) / len(p_times[1:]) * 1e3
        p11 = obs.get("dense", {}).get("step_ms")
        say("mesh", f"plain build_step_fn from the same seed: losses "
                    f"{[round(x, 4) for x in p_losses]} (mesh vs plain "
                    f"rtol 1e-4: {'ok' if ok_l else 'FAIL'}) | step 1 "
                    f"grad norm mesh {m_norm:.6f} plain {p_norm:.6f} "
                    f"(rtol 2e-3: {'ok' if ok_n else 'FAIL'}) | grads "
                    f"worst leaf rel L2 {g_err:.3e} at {g_leaf} (limit "
                    f"{GRAD_RTOL['bfloat16']:g}: "
                    f"{'ok' if ok_g else 'FAIL'}) | params "
                    f"after {MESH_STEPS} steps max_abs_err {worst:.3e}, "
                    f"{n_diff} of {n_all} elements differ (limit 2 x "
                    f"{lr_sum:.2e} + 2**-7 |p|: {'ok' if ok_p else 'FAIL'})")
        say("mesh", f"step after step 1: mesh {m_ms:.1f} ms, plain "
                    f"{p_ms:.1f} ms, phase 11's plain "
                    f"{'not run' if p11 is None else f'{p11:.1f} ms'} | "
                    f"mesh peak memory after step 1 {peak / 1e9:.2f} GB | "
                    f"card {card}")
        want = train_launches(cfg, MESH_STEPS)
        say("mesh", f"launches in {MESH_STEPS} steps: mesh {counts} | plain "
                    f"{p_counts} | expected {want}")
        need(ok_l and ok_n and ok_g and ok_p,
             "the mesh step disagrees with the plain step")
        need(all(counts[k] == v == p_counts[k] for k, v in want.items()),
             f"mesh launches {counts}, plain {p_counts}, expected {want}")
        check_mesh_dry_runs(dry_runs, counts, peak, card)
        out = {"mesh": (counts, {"step_ms": m_ms, "plain_ms": p_ms,
                                 "peak": peak})}
        gc_collect(torch)
        out["mesh_mamba2"] = mesh_family_step(
            torch, mesh, configs.get(MAMBA2), TRAIN_BATCH, TRAIN_SEQ,
            "mesh mamba2")
        out["mesh_deepseek"] = mesh_family_step(
            torch, mesh, configs.get(DEEPSEEK).scaled(
                n_layers=MESH_DEEPSEEK_LAYERS), DENSE_BATCH, DENSE_SEQ,
            "mesh deepseek")
    finally:
        set_activation_sharding()
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def ctx_cases(torch, rn) -> list:
    """Phase 21's kernel cases: the flash forward with lse and its
    backward at a context-parallel rank's shapes (b 1, hq 32, hkv 8, d
    128, bf16; queries CTX_SEQ / TP_RANKS, keys up to the end of the
    rank's block: the first, the middle and the last rank), the library
    call SDPA with a lower-right causal mask (K and V repeated to the 32
    heads outside the timed call); and the split merge with lse at a
    block of phase 21's sharded decode (b BATCH, hq 32, hkv 8, 1 query,
    CTX_CACHE / CTX_BLOCKS keys)."""
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right
    from repro_torch.kernels import flash_attention as fa
    bf = torch.bfloat16
    flash_src = "src/repro_torch/kernels/csrc/flash_attention.cu"
    flash_rep = "src/repro/kernels/flash_attention.py:77"
    bwd_src = "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
    bwd_rep = "src/repro/kernels/ref.py:250 _mha_blocked_bwd"
    b, hq, hkv, d = 1, 32, 8, 128
    sq = CTX_SEQ // TP_RANKS
    cases = []

    def lse_check(got, want, o_plain_route, what):
        """o bit-equal to ``what`` (the same work without lse), lse within
        1e-4 (1 + max|lse|) of the plain version's, as phase 2's
        ``lse_case``."""
        same = torch.equal(got[0], o_plain_route)
        err = float((got[1] - want[1]).abs().max())
        ok = same and err <= 1e-4 * (1.0 + float(want[1].abs().max()))
        return ok, (f"o bit-equal to {what} {same} | lse max_abs_err "
                    f"{err:.3e} (<= 1e-4 (1 + max|lse|))")
    for skv in (sq, CTX_SEQ // 2, CTX_SEQ):
        q = rn(b, sq, hq, d, dt=bf, std=0.5).transpose(1, 2)
        k = rn(b, skv, hkv, d, dt=bf, std=0.5).transpose(1, 2)
        v = rn(b, skv, hkv, d, dt=bf).transpose(1, 2)
        do = rn(b, sq, hq, d, dt=bf).transpose(1, 2)
        plan = fa.flash_plan(b, hq, hkv, sq, skv, skv, d, bf, True,
                             lse=True)
        o, lse = fa.flash_attention_cuda(q, k, v, causal=True, plan=plan,
                                         lse=True)
        o_serve = fa.flash_attention_cuda(q, k, v, causal=True, plan=plan)
        g = hq // hkv
        kr, vr = (t.repeat_interleave(g, 1) for t in (k, v))
        mask = causal_lower_right(sq, skv)
        sdpa = lambda q=q, kr=kr, vr=vr, mask=mask: (
            F.scaled_dot_product_attention(q, kr, vr, attn_mask=mask))
        lib_in = [t.detach().clone().requires_grad_() for t in (q, kr, vr)]
        lib_fwd = lambda lib_in=lib_in, mask=mask: (
            F.scaled_dot_product_attention(*lib_in, attn_mask=mask))
        pairs = b * hq * fa.attention_pairs(sq, skv, True)
        tag = f"b{b}_hq{hq}_hkv{hkv}_sq{sq}_skv{skv}_bf16"
        cases.append(dict(
            name=f"attention:ctx8_lse_{tag}", wrapper="attention",
            source=flash_src, replaces=flash_rep,
            kernel=lambda q=q, k=k, v=v, plan=plan: fa.flash_attention_cuda(
                q, k, v, causal=True, plan=plan, lse=True),
            plain=lambda q=q, k=k, v=v: (
                fa.flash_attention_plain(q, k, v, causal=True),
                fa.flash_lse_plain(q, k, causal=True)),
            library=sdpa, backend=sdpa, mode="close", tol=(1e-2, 1e-2),
            check_vs=lambda got, want, o_serve=o_serve: lse_check(
                got, want, o_serve, "the call without lse"),
            bytes=(q.numel() + k.numel() + v.numel() + o.numel()) * 2
            + lse.numel() * 4,
            ops=4.0 * d * pairs, kind="bf16", path=True, phase="ctx"))
        cases.append(dict(
            name=f"attention_bwd:ctx8_{tag}", wrapper="attention_bwd",
            source=bwd_src, replaces=bwd_rep,
            kernel=lambda q=q, k=k, v=v, o=o, lse=lse, do=do: (
                fa.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                            causal=True)),
            plain=lambda q=q, k=k, v=v, o=o, lse=lse, do=do: (
                fa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                             causal=True)),
            library=lambda lib_fwd=lib_fwd, lib_in=lib_in, do=do: (
                torch.autograd.grad(lib_fwd(), lib_in, do)),
            library_minus=lib_fwd, backend=lib_fwd,
            mode="rel_l2", tol=(GRAD_RTOL["bfloat16"], 0.0),
            bytes=(b * (hq * sq + hkv * skv) * 4 * d) * 2 + lse.numel() * 4,
            ops=2.0 * 5 * d * pairs, kind="bf16", path=True, phase="mesh"))
    blk = CTX_CACHE // CTX_BLOCKS
    mq = rn(BATCH, hq, 1, d, dt=bf)
    mk, mv = (rn(BATCH, hkv, blk, d, dt=bf) for _ in range(2))
    plan = fa.flash_plan(BATCH, hq, hkv, 1, blk, blk, d, bf, True)
    need(plan.splits > 1, f"a {blk}-key block's decode plan does not split")
    ws, mo = fa.flash_attention_cuda(mq, mk, mv, causal=True, plan=plan,
                                     partials=True)
    lse_buf = torch.empty((BATCH, hq, 1), dtype=torch.float32,
                          device=mq.device)
    mo_serve = fa.flash_merge_cuda(ws, torch.empty_like(mo), plan.splits)
    cases.append(dict(
        name=f"attention_merge:ctx_lse_b{BATCH}_kv{blk}_{plan.splits}_"
             f"splits", wrapper="attention_merge", source=flash_src,
        replaces=flash_rep,
        kernel=lambda: fa.flash_merge_cuda(ws, mo, plan.splits, lse_buf),
        plain=lambda: fa.flash_merge_plain(ws, plan.splits, BATCH, hq, 1,
                                           d, bf, lse=True),
        library=None, mode="close", tol=(1e-2, 1e-2),
        check_vs=lambda got, want: lse_check(got, want, mo_serve,
                                             "the merge without lse"),
        bytes=ws.numel() * 4 + mo.numel() * 2 + lse_buf.numel() * 4,
        ops=3.0 * ws.numel(), kind="fp32", path=True, phase="ctx"))
    return cases


def split_cases(torch, rn) -> list:
    """Phase 21's cases of ``csrc/ntx_attn_split.cu``: the logits kernel
    and the softmax-PV kernel at llama3-8b decode_32k's rank blocks on 16
    and 4 model ranks (b SPLIT_BATCH, hq 32, hkv 8, 1 query, 32768 keys,
    db 8 / 32, causal at the last position) and whisper-medium's
    cross-attention block on 16 (hq 16, hkv 16, 1500 frames, db 4, not
    causal), bf16, each against its plain version; the library call of
    the logits is one ``torch.matmul`` of (b, hkv, g s, db) @ (b, hkv,
    db, kv_len) (no PyTorch call computes the softmax-PV of given
    logits)."""
    from repro_torch.kernels import flash_attention as fa
    bf = torch.bfloat16
    src = "src/repro_torch/kernels/csrc/ntx_attn_split.cu"
    rep = ("none: the reference partitions its decode step's einsums "
           "with XLA (src/repro/launch/dryrun.py:110 serve_step)")
    shapes = [(f"llama3_8b_tp{nm}", 32, 8, 32768, 128, nm, True)
              for nm in SPLIT_RANKS]
    shapes.append(("whisper_cross_tp16", 16, 16, 1500, 64, 16, False))
    b, cases = SPLIT_BATCH, []
    for tag, hq, hkv, kv, hd, nm, causal in shapes:
        g, db = hq // hkv, hd // nm
        q = rn(b, hq, 1, db, dt=bf)
        k, v = (rn(b, hkv, kv, db, dt=bf) for _ in range(2))
        logits = fa.attention_split_logits_plain(q, k, kv)
        scale = hd ** -0.5              # the whole head's, not the block's
        q_pos = kv - 1 if causal else 0
        ops_n = 2.0 * b * hq * kv * db
        name = f"b{b}_hq{hq}_hkv{hkv}_kv{kv}_db{db}_bf16"
        cases.append(dict(
            name=f"attention_split_logits:{tag}_{name}",
            wrapper="attention_split_logits", source=src, replaces=rep,
            kernel=lambda q=q, k=k, kv=kv: fa.attention_split_logits_cuda(
                q, k, kv),
            plain=lambda q=q, k=k, kv=kv: fa.attention_split_logits_plain(
                q, k, kv),
            library=lambda q=q, k=k, hkv=hkv, g=g, db=db: torch.matmul(
                q.view(b, hkv, g, db), k.transpose(-1, -2)),
            mode="close", tol=(1e-5, 1e-4),
            bytes=(q.numel() + k.numel()) * 2 + logits.numel() * 4,
            ops=ops_n, kind="fp32", path=True, phase="latent"))
        # the softmax-PV's logits sharpened to a std of 4 after the scale
        # (random blocks of db columns give 0.25-0.5: a near-uniform P whose
        # o is about the mean of v, which a kernel that drops the softmax
        # also returns), held at one bf16 step of max|o|
        sharp = logits * (4.0 / (scale * db ** 0.5))
        pv_atol = 2.0 ** -7 * float(fa.attention_split_softmax_pv_plain(
            sharp, v, q_pos, scale, causal).float().abs().max())
        cases.append(dict(
            name=f"attention_split_softmax_pv:{tag}_{name}",
            wrapper="attention_split_softmax_pv", source=src, replaces=rep,
            kernel=lambda lg=sharp, v=v, p=q_pos, sc=scale, c=causal: (
                fa.attention_split_softmax_pv_cuda(lg, v, p, sc, c)),
            plain=lambda lg=sharp, v=v, p=q_pos, sc=scale, c=causal: (
                fa.attention_split_softmax_pv_plain(lg, v, p, sc, c)),
            library=None, mode="close", tol=(0.0, pv_atol),
            bytes=logits.numel() * 4 + v.numel() * 2 + q.numel() * 2,
            ops=ops_n, kind="fp32", path=True, phase="latent",
            note=f" | split plan {fa.split_pv_plan(b, hq, hkv, 1, kv, db)}"))
    return cases


def head_dim_split_check(torch) -> dict:
    """The decode over a cache split by head_dim as SPLIT_RANKS[0] ranks
    compute it, on one card: a 32768-slot cache (b SPLIT_BATCH, 32 / 8
    heads, head_dim 128, bf16) filled to SPLIT_FILL slots, cut into
    blocks of 128 / SPLIT_RANKS[0] head_dim columns; each block's partial
    logits (``ops.attention_split_logits``) summed in PyTorch (the sum
    the all-reduce takes), each block's softmax-PV
    (``ops.attention_split_softmax_pv``) at the whole head's scale, the
    blocks side by side, against ``ops.attention`` over the whole cache
    at two bf16 epsilons of max|o| (each block's o rounded to bf16 once,
    the flash kernel's P in bf16); timed beside the whole-cache call."""
    from repro_torch.kernels import ops
    bf = torch.bfloat16
    nm, hd = SPLIT_RANKS[0], 128
    g = torch.Generator(device=DEVICE).manual_seed(22)
    rn = lambda *sh: torch.randn(*sh, generator=g, device=DEVICE).to(bf)
    q = rn(SPLIT_BATCH, 32, 1, hd)
    k, v = (rn(SPLIT_BATCH, 8, 32768, hd) for _ in range(2))
    db = hd // nm
    cols = [(r * db, (r + 1) * db) for r in range(nm)]

    def split():
        logits = sum(ops.attention_split_logits(q[..., lo:hi], k[..., lo:hi],
                                                SPLIT_FILL)
                     for lo, hi in cols)
        return torch.cat([ops.attention_split_softmax_pv(
            logits, v[..., lo:hi], SPLIT_FILL - 1, hd ** -0.5, True)
            for lo, hi in cols], -1)
    whole = lambda: ops.attention(q, k, v, causal=True, kv_len=SPLIT_FILL)
    ops.reset_launches()
    got = split()
    n = ops.launches()
    want = whole()
    err = float((got.float() - want.float()).abs().max())
    tol = 2.0 ** -6 * float(want.float().abs().max())
    counts = {k_: n[k_] for k_ in ("attention_split_logits",
                                   "attention_split_softmax_pv")}
    need(bool(torch.isfinite(got).all()) and err <= tol
         and counts == dict.fromkeys(counts, nm),
         f"head_dim split: o max_abs_err {err:.3e} (tol {tol:.3e}), "
         f"launches {counts} (want {nm} each)")
    split_ms = time_ms(split, torch)
    whole_ms = time_ms(whole, torch)
    bound = 2 * SPLIT_BATCH * 8 * SPLIT_FILL * hd * 2 / HBM_BYTES_PER_S * 1e3
    say("ctx", f"decode over {SPLIT_FILL} of 32768 slots split by head_dim "
               f"into {nm} blocks of {db} (b {SPLIT_BATCH}, hq 32, hkv 8, "
               f"bf16): o vs ops.attention over the whole cache max_abs_err "
               f"{err:.3e} (<= 2^-6 max|o| {tol:.3e}) ok | launches {counts}"
               f" | {nm} x 2 kernel calls and the sum {split_ms:.4f} ms, "
               f"whole-cache call {whole_ms:.4f} ms, bound (the valid K and V"
               f" read once) {bound:.4f} ms | card {card_line()}")
    return {"split_ms": split_ms, "whole_ms": whole_ms, "bound_ms": bound,
            "max_abs_err": err}


def sharded_decode_check(torch) -> dict:
    """A CTX_CACHE-slot decode step (b BATCH, 32 / 8 heads, d 128, bf16)
    cut into CTX_BLOCKS blocks as a sequence-sharded cache's ranks hold
    it. The cache is filled to CTX_FILL slots (the last block empty, the
    one before it half full) and block z's keys are scaled by CTX_KEY_
    SCALES[z], so that the blocks' lse differ by units. Each block's (o,
    lse) comes from the mesh's own ``attend_block``
    (``ops.attention(return_lse=True)`` on a split plan: the merge writes
    lse; the empty block launches nothing) and is merged by
    ``combine_partials`` (the body of ``merge_partials``). The merged o
    is held against the plain attention over the whole cache at two bf16
    epsilons of max|o| (each block's o and the merged o are rounded to
    bf16, the plain o once), the logsumexp of the blocks' lse against
    ``flash_lse_plain`` at 1e-4 (1 + max|lse|); timed beside the
    whole-cache call."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models.attention import attend_block
    from repro_torch.models.common import combine_partials
    bf = torch.bfloat16
    g = torch.Generator(device=DEVICE).manual_seed(21)
    rn = lambda *sh: torch.randn(*sh, generator=g, device=DEVICE)
    blk = CTX_CACHE // CTX_BLOCKS
    q = rn(BATCH, 32, 1, 128).to(bf)
    k = (rn(BATCH, 8, CTX_CACHE, 128) * torch.tensor(
        CTX_KEY_SCALES, device=DEVICE).repeat_interleave(blk)[:, None]
         ).to(bf)
    v = rn(BATCH, 8, CTX_CACHE, 128).to(bf)
    q_pos = CTX_FILL - 1
    ranges = [(z * blk, (z + 1) * blk) for z in range(CTX_BLOCKS)]
    # the calls attend_block makes: a block past the query none, the one
    # holding it causal up to it, the ones before it whole
    calls = [(hi - lo, False) if hi <= q_pos else (q_pos + 1 - lo, True)
             for lo, hi in ranges if lo <= q_pos]
    merges = sum(fa.flash_plan(BATCH, 32, 8, 1, blk, n, 128, bf,
                               causal).splits > 1 for n, causal in calls)

    def blocks():
        parts = [attend_block(q, k[:, :, lo:hi], v[:, :, lo:hi], lo, hi,
                              q_pos) for lo, hi in ranges]
        lse = torch.stack([p[1] for p in parts])
        return combine_partials(torch.stack([p[0] for p in parts]), lse), lse
    whole = lambda: ops.attention(q, k, v, causal=True, kv_len=CTX_FILL)
    ops.reset_launches()
    got, lse = blocks()
    n = ops.launches()
    want = fa.flash_attention_plain(q, k, v, causal=True, kv_len=CTX_FILL)
    want_lse = fa.flash_lse_plain(q, k, causal=True, kv_len=CTX_FILL)
    err = float((got.float() - want.float()).abs().max())
    tol = 2.0 ** -6 * float(want.float().abs().max())
    lse_err = float((torch.logsumexp(lse, 0) - want_lse).abs().max())
    lse_tol = 1e-4 * (1 + float(want_lse.abs().max()))
    spread = [round(float(t.max()), 3) for t in lse]
    ok = (bool(torch.isfinite(got).all()) and err <= tol
          and lse_err <= lse_tol and bool(torch.isneginf(lse[-1]).all()))
    counts = {k_: n[k_] for k_ in ("attention", "attention_merge")}
    need(ok and counts == {"attention": len(calls),
                           "attention_merge": merges} and merges > 0,
         f"sharded decode: o max_abs_err {err:.3e} (tol {tol:.3e}), lse "
         f"max_abs_err {lse_err:.3e} (tol {lse_tol:.3e}), launches {counts}"
         f" (want {len(calls)} / {merges})")
    blocks_ms = time_ms(blocks, torch)
    whole_ms = time_ms(whole, torch)
    kv_bytes = 2 * BATCH * 8 * CTX_FILL * 128 * 2
    bound = kv_bytes / HBM_BYTES_PER_S * 1e3
    say("ctx", f"decode over {CTX_FILL} of {CTX_CACHE} slots in "
               f"{CTX_BLOCKS} blocks (b {BATCH}, hq 32, hkv 8, d 128, bf16; "
               f"keys scaled {list(CTX_KEY_SCALES)} a block): blocks' max "
               f"lse {spread} | merged o vs plain max_abs_err {err:.3e} "
               f"(<= 2^-6 max|o| {tol:.3e}) | logsumexp of the blocks' lse "
               f"vs flash_lse_plain {lse_err:.3e} (<= {lse_tol:.3e}) ok | "
               f"launches {counts} | {CTX_BLOCKS} block calls + merge "
               f"{blocks_ms:.4f} ms, whole-cache call {whole_ms:.4f} ms, "
               f"bound (the valid K and V read once) {bound:.4f} ms | card "
               f"{card_line()}")
    return {"blocks_ms": blocks_ms, "whole_ms": whole_ms, "bound_ms": bound,
            "max_abs_err": err, "lse_err": lse_err}


def phase_ctx(torch, np) -> tuple:
    """Phase 21: the kernels at the context-parallel rank's shapes and the
    split merge's lse (:func:`ctx_cases`, checked and timed), the
    sharded decode (:func:`sharded_decode_check`), then the mesh prefill
    and decode steps on a 1-rank NCCL mesh: llama3-8b cut to
    DENSE_LAYERS of 32 layers at full width, bf16, BATCH prompts of
    CTX_PROMPT tokens into a cache of CTX_PROMPT + 8 slots, CTX_STEPS
    decode steps, against ``Model.prefill`` / ``decode`` from the same
    weights (the plain steps first, twice: the second is timed): logits
    (the mesh's gathered) within
    bf16 limits, every cache leaf, and the launches of each equal; then
    the same mesh steps with the cache split by head_dim
    (``cache_shard="latent"``; :func:`split_cases` and
    :func:`head_dim_split_check` hold its kernels first), against the
    plain steps at :func:`phase_width`'s bf16 limits, both kernels
    launched once a layer a decode step.
    Returns (the kernel rows, {"ctx" / "latent": (the mesh steps'
    launches, observations)})."""
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import Model
    from repro_torch.runtime.serve import (build_mesh_decode_fn,
                                           build_mesh_prefill_fn)

    card = card_line()
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(0)
    rn = lambda *s, dt=torch.float32, std=1.0: (
        torch.randn(*s, generator=g, device=dev) * std).to(dt)
    rows = check_and_time(torch, ctx_cases(torch, rn), True, "ctx", "ctx")
    rows += check_and_time(torch, split_cases(torch, rn), True, "ctx", "ctx")
    decode = sharded_decode_check(torch)
    head_dim = head_dim_split_check(torch)
    gc_collect(torch)

    cfg = configs.get("llama3-8b").scaled(n_layers=DENSE_LAYERS)
    cache_len = CTX_PROMPT + 8
    rng = np.random.default_rng(21)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (BATCH, CTX_PROMPT)),
                             device=dev)
    steps = [torch.as_tensor(rng.integers(0, cfg.vocab, (BATCH, n)),
                             device=dev) for n in CTX_STEPS]
    model = Model(cfg)
    params = model.init(0, device=DEVICE)

    def run(prefill, decode_fn, gather):
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache, fill = prefill()
        torch.cuda.synchronize()
        pre_s = time.perf_counter() - t0
        run.prefill_counts = ops.launches()
        out = [gather(logits).float()]
        t0 = time.perf_counter()
        for tok in steps:
            logits, cache = decode_fn(tok, cache, fill)
            fill += tok.shape[1]
            out.append(gather(logits).float())
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
        run.placements = [[getattr(t, "placements", None)
                           for t in c.values()] for c in cache]
        leaves = [{k: gather(t) for k, t in c.items()} for c in cache]
        return out, leaves, ops.launches(), pre_s, dec_s

    with deterministic(torch, True), torch.no_grad():
        for _ in range(2):              # the first warms the card up
            p_out, p_cache, p_counts, p_pre, p_dec = run(
                lambda: model.prefill(params, {"tokens": tokens},
                                      cache_len=cache_len),
                lambda tok, c, f: model.decode(params, tok, c, f),
                lambda t: t)
    p_cache = [{k: t.cpu() for k, t in c.items()} for c in p_cache]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ctx_")
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_mesh_for(1)
        shd.shard_params(params, mesh, shd.named_param_specs(
            cfg, dict(params.named_parameters())))
        pre = build_mesh_prefill_fn(cfg, mesh)
        dec = build_mesh_decode_fn(cfg, mesh)
        with deterministic(torch, True):
            m_out, m_cache, m_counts, m_pre, m_dec = run(
                lambda: pre(params, {"tokens": tokens}, cache_len),
                lambda tok, c, f: dec(params, tok, c, f),
                lambda t: t.full_tensor())
        specs = shd.layer_cache_specs(mesh, m_cache, cfg)
        layout = sorted({str(tuple(sp)) for sp in specs[0].values()})
        # the same steps on a cache split by head_dim: this slice's path
        lat = cfg.scaled(cache_shard="latent")
        pre_l = build_mesh_prefill_fn(lat, mesh)
        dec_l = build_mesh_decode_fn(lat, mesh)
        with deterministic(torch, True):
            l_out, l_cache, l_counts, l_pre, l_dec = run(
                lambda: pre_l(params, {"tokens": tokens}, cache_len),
                lambda tok, c, f: dec_l(params, tok, c, f),
                lambda t: t.full_tensor())
        l_pre_counts = run.prefill_counts
        model_dim = mesh.mesh_dim_names.index("model")
        l_dims = sorted({getattr(pl[model_dim], "dim", None)
                         for c in run.placements for pl in c})
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    worst_l, worst_c = 0.0, 0.0
    for a, b_ in zip(m_out, p_out):
        worst_l = max(worst_l, float((a - b_).abs().max()))
    ok_l = all(torch.allclose(a, b_, rtol=1e-2, atol=1e-2)
               for a, b_ in zip(m_out, p_out))
    for mc, pc in zip(m_cache, p_cache):
        for k, t in mc.items():
            worst_c = max(worst_c, float((t.cpu().float()
                                          - pc[k].float()).abs().max()))
    ok_c = worst_c <= 2 ** -7 * max(
        float(t.float().abs().max()) for c in p_cache for t in c.values())
    say("ctx", f"mesh prefill + {len(CTX_STEPS)} decode steps "
               f"({list(CTX_STEPS)} tokens) of llama3-8b "
               f"{DENSE_LAYERS} of 32 layers, batch {BATCH} x prompt "
               f"{CTX_PROMPT}, cache {cache_len} slots, leaf specs "
               f"{layout}: logits max_abs_err {worst_l:.3e} (rtol/atol "
               f"1e-2: {'ok' if ok_l else 'FAIL'}) | cache leaves "
               f"max_abs_err {worst_c:.3e} ({'ok' if ok_c else 'FAIL'}) | "
               f"prefill {m_pre * 1e3:.1f} ms mesh / {p_pre * 1e3:.1f} ms "
               f"plain, decode steps {m_dec * 1e3:.1f} / {p_dec * 1e3:.1f} "
               f"ms | card {card}")
    say("ctx", f"launches mesh {m_counts} | plain {p_counts}")
    need(ok_l and ok_c, "the mesh prefill / decode disagree with the plain "
                        "steps")
    need(m_counts == p_counts and m_counts["attention"] > 0
         and m_counts["attention_merge"] > 0,
         f"mesh launches {m_counts}, plain {p_counts}")
    # the head_dim split: the prefill's flash calls, then both kernels of
    # csrc/ntx_attn_split.cu once a layer a decode step, and no flash call
    want = dict(p_counts, attention=l_pre_counts["attention"],
                attention_merge=l_pre_counts["attention_merge"],
                attention_split_logits=DENSE_LAYERS * len(CTX_STEPS),
                attention_split_softmax_pv=DENSE_LAYERS * len(CTX_STEPS))
    # two attention routes of one bf16 model (the split's fp32 softmax
    # against the flash kernel's bf16 P): phase_width's bf16 limits
    worst_ll = max(float((a - b_).abs().max())
                   for a, b_ in zip(l_out, p_out))
    ok_ll = all(torch.allclose(a, b_, rtol=2e-2, atol=6e-2)
                for a, b_ in zip(l_out, p_out))
    worst_lc = max(float((t.cpu().float() - pc[k].float()).abs().max())
                   for lc, pc in zip(l_cache, p_cache) for k, t in lc.items())
    ok_lc = all(torch.allclose(t.cpu().float(), pc[k].float(), rtol=2e-2,
                               atol=6e-2)
                for lc, pc in zip(l_cache, p_cache) for k, t in lc.items())
    say("ctx", f"mesh prefill + {len(CTX_STEPS)} decode steps, cache split "
               f"by head_dim (the leaves' dims over model {l_dims}): logits "
               f"max_abs_err {worst_ll:.3e} vs the plain steps (rtol 2e-2 "
               f"atol 6e-2: {'ok' if ok_ll else 'FAIL'}) | cache leaves "
               f"max_abs_err {worst_lc:.3e} ({'ok' if ok_lc else 'FAIL'}) | "
               f"prefill {l_pre * 1e3:.1f} ms, decode steps "
               f"{l_dec * 1e3:.1f} ms | launches {l_counts} | card {card}")
    need(ok_ll and ok_lc and l_dims == [3],
         "the head_dim split's mesh steps disagree with the plain steps, "
         f"or its leaves are not split by head_dim ({l_dims})")
    need(l_counts == want and l_pre_counts["attention"] == DENSE_LAYERS,
         f"head_dim split launches {l_counts} (prefill "
         f"{l_pre_counts}), want {want}")
    del params
    gc_collect(torch)
    return rows, {"ctx": (m_counts, {"decode": decode,
                                     "prefill_ms": m_pre * 1e3,
                                     "decode_ms": m_dec * 1e3}),
                  "latent": (l_counts, {"head_dim": head_dim,
                                        "prefill_ms": l_pre * 1e3,
                                        "decode_ms": l_dec * 1e3})}


@contextlib.contextmanager
def deterministic(torch, on: bool):
    """PyTorch's deterministic kernels where it has them (``warn_only``:
    the rest run as they are, unwarned), memory from ``torch.empty`` left
    unfilled; nothing where ``on`` is false."""
    if not on:
        yield
        return
    import warnings
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*determinis")
            yield
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill


def mesh_family_step(torch, mesh, cfg, batch: int, seq: int,
                     tag: str) -> tuple:
    """``make_train_step(cfg, opt, mesh)`` on the 1-rank mesh (DTensor
    parameters, ZeRO-1 state; the model's tensor-parallel layers with a
    model axis of 1) for MESH_STEPS steps from Model.init(0), then the
    plain ``make_train_step(cfg, opt)`` from the same seed and batches,
    in turn (both states at once may not fit the card). Held to phase
    10's bf16 limits: the losses; step 1's global norm and every leaf of
    the gradients each hands its optimizer (the mesh step's kept on the
    host); every parameter leaf after the steps. The launches of the two
    must be equal (and not none). The MoE's combine (``index_add_``) and
    its gradient's scatters add in atomic order on the card, so two bf16
    runs drift apart (step 3's losses once 1.1e-4 apart, a routing parted
    at a near-tie): with MoE layers both steps take PyTorch's
    deterministic kernels (:func:`deterministic`; their times are those
    kernels'), and both run under a :class:`RouteLog`, the plain step
    replaying the mesh step's experts, its own router held to pick the
    same but at near-ties, as in the width checks. Returns (the mesh
    step's launches, observations)."""
    from repro_torch.data import SyntheticLM
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import ops
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig, init_opt_state, lr_schedule
    from repro_torch.runtime.train import (init_sharded_opt_state,
                                           make_train_step)

    card = card_line()
    opt_cfg = AdamWConfig(warmup_steps=10, total_steps=MESH_STEPS)
    data = SyntheticLM(cfg, batch, seq, seed=0)
    batches = [data.batch_at(i) for i in range(MESH_STEPS)]
    runs, logs = {}, {}
    for kind in ("mesh", "plain"):
        t_init = time.perf_counter()
        params = Model(cfg).init(0, device=DEVICE, trainable=True)
        named = dict(params.named_parameters())
        if kind == "mesh":
            shd.shard_params(params, mesh, shd.named_param_specs(cfg, named))
            opt = init_sharded_opt_state(mesh, cfg, params)
            step_fn = make_train_step(cfg, opt_cfg, mesh)
        else:
            opt = init_opt_state(named)
            step_fn = make_train_step(cfg, opt_cfg)
        del named
        init_s = time.perf_counter() - t_init
        losses, times = [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        routes = (RouteLog(torch, params, logs.get("mesh")) if cfg.moe
                  else contextlib.nullcontext())
        with routes as logs[kind], deterministic(torch, cfg.moe):
            for i, b in enumerate(batches):
                if kind == "plain":     # the mesh step takes its block
                    b = {k: v.to(DEVICE) for k, v in b.items()}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if i:
                    params, opt, loss, _ = step_fn(params, opt, b)
                else:
                    params, opt, loss, grads, gnorm = step_with_grads(
                        step_fn, params, opt, b)
                losses.append(float(loss))
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                if not i:
                    first = ({n: g.detach().cpu() for n, g in grads.items()},
                             float(gnorm))
                    del grads
        runs[kind] = dict(
            losses=losses, times=times, counts=ops.launches(),
            peak=torch.cuda.max_memory_allocated(), init_s=init_s,
            grads=first[0], gnorm=first[1],
            params={n: (p.to_local() if hasattr(p, "to_local") else p)
                    .detach().cpu() for n, p in params.named_parameters()})
        del params, opt, step_fn, first
        gc_collect(torch)
    m, p = runs["mesh"], runs["plain"]
    if cfg.moe:
        check_routing(tag, cfg.compute_dtype, logs["mesh"], logs["plain"],
                      ("mesh", "plain"))
    g_err, g_leaf = 0.0, None
    for n, want in p["grads"].items():
        want, got = want.to(DEVICE).float(), m["grads"][n].to(DEVICE).float()
        err = float((got - want).norm()) / max(float(want.norm()), 1e-30)
        if not math.isfinite(err) or err > g_err:
            g_err, g_leaf = err, n
    del got, want
    lr_sum = sum(float(lr_schedule(opt_cfg, i + 1))
                 for i in range(MESH_STEPS))
    worst, n_diff, n_all, ok_p = 0.0, 0, 0, True
    for n, want in p["params"].items():                # on the card
        want = want.to(DEVICE).float()
        got = m["params"][n].to(DEVICE).float()
        diff = (got - want).abs()
        worst = max(worst, float(diff.max()))
        n_diff += int((diff > 0).sum())
        n_all += diff.numel()
        ok_p &= bool(torch.isfinite(got).all()) and bool(
            (diff <= 2 * lr_sum + 2.0 ** -7 * want.abs()).all())
    ok_l = all(math.isfinite(a) and abs(a - b) <= 1e-4 * abs(b)
               for a, b in zip(m["losses"], p["losses"]))
    ok_n = (math.isfinite(m["gnorm"])
            and abs(m["gnorm"] - p["gnorm"]) <= 2e-3 * p["gnorm"])
    ok_g = math.isfinite(g_err) and g_err <= GRAD_RTOL["bfloat16"]
    ms = {k: sum(r["times"][1:]) / len(r["times"][1:]) * 1e3
          for k, r in runs.items()}
    shape = (f"{cfg.name} {cfg.n_layers} layers, batch {batch} x {seq}, "
             f"grad_accum {cfg.grad_accum}")
    say(tag, f"{shape}: losses mesh {[round(x, 4) for x in m['losses']]} "
             f"plain {[round(x, 4) for x in p['losses']]} (rtol 1e-4: "
             f"{'ok' if ok_l else 'FAIL'}) | step 1 grad norm mesh "
             f"{m['gnorm']:.6f} plain {p['gnorm']:.6f} (rtol 2e-3: "
             f"{'ok' if ok_n else 'FAIL'}) | grads worst leaf rel L2 "
             f"{g_err:.3e} at {g_leaf} (limit {GRAD_RTOL['bfloat16']:g}: "
             f"{'ok' if ok_g else 'FAIL'}) | params after {MESH_STEPS} "
             f"steps max_abs_err {worst:.3e}, {n_diff} of {n_all} elements "
             f"differ (limit 2 x {lr_sum:.2e} + 2**-7 |p|: "
             f"{'ok' if ok_p else 'FAIL'})")
    say(tag, f"step times mesh {[round(t * 1e3, 1) for t in m['times']]} "
             f"ms, plain {[round(t * 1e3, 1) for t in p['times']]} ms | "
             f"after step 1 mesh {ms['mesh']:.1f} ms, plain "
             f"{ms['plain']:.1f} ms | peak memory mesh "
             f"{m['peak'] / 1e9:.2f} GB, plain {p['peak'] / 1e9:.2f} GB | "
             f"init mesh {m['init_s']:.1f} s, plain {p['init_s']:.1f} s | "
             f"card {card}")
    used = {k: v for k, v in m["counts"].items() if v}
    say(tag, f"launches in {MESH_STEPS} steps: mesh {used} | plain "
             f"{ {k: v for k, v in p['counts'].items() if v} }")
    need(ok_l and ok_n and ok_g and ok_p,
         f"{tag}: the mesh step disagrees with the plain step")
    need(used and m["counts"] == p["counts"],
         f"{tag}: mesh launches {m['counts']}, plain {p['counts']}")
    card_memory_ok(torch, max(m["peak"], p["peak"]), tag, shape)
    return m["counts"], {"step_ms": ms["mesh"], "plain_ms": ms["plain"],
                         "peak": m["peak"]}


# ----------------------------------------------------------------------
# phases 13 / 14: the MoE family's training (deepseek, phi3.5-moe) and
# phi3.5-moe's serving
# ----------------------------------------------------------------------
#: a MoE training step's kernels by family, for kernel_split: the flash
#: kernels, the MoE's scatters (the capacity buffers' index_put, the
#: combine's index_add_ and the backward's scatter-adds) and gathers
#: (take_along_dim, advanced indexing), its routing sorts, cuBLAS
MOE_GROUPS = {
    "flash_attention_bwd.cu": DENSE_GROUPS["flash_attention_bwd.cu"],
    "flash_attention.cu": DENSE_GROUPS["flash_attention.cu"],
    "MoE scatter": ("index_put", "indexing_backward", "index_add",
                    "indexfunc", "internal_kernel<true", "scatter_add"),
    "MoE gather": ("internal_kernel<false", "index_kernel_impl", "gather",
                   "index_select"),
    "MoE routing sorts": ("sort", "searchsorted", "radix"),
    "cuBLAS": CUBLAS_KEYS}


def card_memory_ok(torch, peak: int, tag: str, what: str) -> None:
    """A depth cut stands only if its measured peak leaves at least
    HEADROOM_BYTES of the card's memory free."""
    total = torch.cuda.get_device_properties(0).total_memory
    say(tag, f"{what}: peak memory {peak / 1e9:.2f} GB of the card's "
             f"{total / 1e9:.2f} GB ({(total - peak) / 1e9:.2f} GB free; "
             f"the cut needs >= {HEADROOM_BYTES / 1e9:g})")
    need(peak <= total - HEADROOM_BYTES,
         f"{tag}: {what} leaves less than {HEADROOM_BYTES / 1e9:g} GB free")


def active_params(cfg, n_params: int) -> int:
    """Parameters a token runs through: all but the routed experts it is
    not sent to (the reference's ``configs.shapes.active_params``)."""
    return n_params - cfg.n_layers * (cfg.n_experts - cfg.top_k) * 3 \
        * cfg.d_model * cfg.d_ff_expert


def profile_moe_step(torch, step_fn, params, opt, batch, wall_s, tag):
    """One more MoE training step under torch.profiler: device time by
    kernel family (MOE_GROUPS), the 8 longest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, _, _ = step_fn(params, opt, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ranges = ("train_step.grads", "train_step.optimizer")
    evs = prof.key_averages()
    span = {e.key: e.device_time_total / 1e3 for e in evs
            if e.key in ranges and e.device_type == DeviceType.CPU}
    split = kernel_split(evs, MOE_GROUPS, skip=ranges)
    if split is None:
        say(tag, "profiler saw no device time: breakdown not measured")
        return params, opt
    busy, by_group, top = split
    say(tag, f"profiled step: wall {wall_ms:.1f} ms (profiler on; "
             f"{wall_s * 1e3:.1f} ms off) | device busy {busy:.1f} ms "
             f"({busy / wall_ms:.3f} of wall) | ranges (device ms of their "
             f"PyTorch ops) {({k: round(v, 1) for k, v in span.items()})} | "
             f"card {card_line()}")
    say(tag, "kernels by family (device ms, launches): " + " | ".join(
        f"{k} {v[0]:.1f} x{v[1]}" for k, v in by_group.items()))
    for e in top:
        say(tag, f"  {e.self_device_time_total / 1e3:9.2f} ms "
                 f"x{e.count:5d}  {e.key[:110]}")
    return params, opt


def moe_train(torch, arch: str, n_layers: int, batch: int, steps: int,
              tag: str) -> dict:
    """build_step_fn on ``arch`` at full width cut to ``n_layers`` (bf16,
    remat="full", the config's own grad_accum): ``steps`` steps at batch
    ``batch`` x DENSE_SEQ. Step time, tokens/s, peak memory (held to
    HEADROOM_BYTES), the flash kernels' launches per step; one more step
    profiled."""
    from repro_torch import configs
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.runtime import build_step_fn

    full = configs.get(arch)
    cfg = full.scaled(n_layers=n_layers)
    accum = cfg.grad_accum
    card = card_line()
    opt_cfg = AdamWConfig(warmup_steps=10, total_steps=steps)
    t0 = time.perf_counter()
    params = Model(cfg).init(0, device=DEVICE, trainable=True)
    opt = init_opt_state(dict(params.named_parameters()))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    n_active = active_params(cfg, n_params)
    say(tag, f"cut: layers {n_layers} of {full.n_layers} at full width, "
             f"{n_params / 1e9:.3f} B params ({n_active / 1e9:.3f} B active "
             f"a token); batch {batch} x {DENSE_SEQ} in grad_accum {accum} "
             f"microbatches, {steps} steps; init "
             f"{time.perf_counter() - t0:.1f} s")
    step_fn = build_step_fn(cfg, opt_cfg)
    data = SyntheticLM(cfg, batch, DENSE_SEQ, seed=0)
    batches = [{k: v.to(DEVICE) for k, v in data.batch_at(i).items()}
               for i in range(steps + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    ops.reset_launches()
    for step in range(steps):
        t0 = time.perf_counter()
        params, opt, loss, _ = step_fn(params, opt, batches[step])
        losses.append(float(loss))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = ops.launches()
    peak = torch.cuda.max_memory_allocated()
    need(all(math.isfinite(x) for x in losses),
         f"{tag}: losses not all finite: {losses}")
    step_s = sum(times[1:]) / len(times[1:])
    tokens = batch * DENSE_SEQ
    share = 6.0 * n_active * tokens / step_s / PEAK_OPS["bf16"]
    say(tag, f"{arch} {n_layers} layers, batch {batch} x seq {DENSE_SEQ}: "
             f"losses {[round(x, 4) for x in losses]} | card {card}")
    say(tag, f"step times {[round(t * 1e3, 1) for t in times]} ms | step "
             f"after step 1 {step_s * 1e3:.1f} ms | {tokens / step_s:.0f} "
             f"tokens/s | 6 N_active tokens / step time = {share:.4f} of the "
             f"989 TFLOP/s bf16 peak (observation) | card {card}")
    card_memory_ok(torch, peak, tag, f"{n_layers} of {full.n_layers} layers "
                                     f"training")
    per = {k: counts[k] / steps for k in ("attention", "attention_bwd")}
    dk, dv = ((cfg.nope_head_dim + cfg.rope_head_dim, cfg.v_head_dim)
              if cfg.mla else (cfg.hd, cfg.hd))
    say(tag, f"kernel launches in {steps} steps {counts} | per step {per} "
             f"(head dims q/k {dk}, v {dv})")
    want = moe_train_launches(cfg, steps)
    need(all(counts[k] == v for k, v in want.items()),
         f"{tag} launches {counts}, expected {want} (the forward with lse "
         f"and its recompute a layer and microbatch; one backward)")
    params, opt = profile_moe_step(torch, step_fn, params, opt,
                                   batches[steps], step_s, tag)
    del params, opt, batches
    gc_collect(torch)
    return counts, {"step_ms": step_s * 1e3, "peak": peak}


def phase_deepseek_train(torch, np) -> dict:
    """deepseek-v2-lite-16b's training: a 1-layer full-width step card vs
    CPU at 1 x DENSE_WIDTH_SEQ (one microbatch; 2 layers took 102 s of
    CPU side, most of it the plain AdamW over 1.6 B parameters), then the
    Trainer's step at DEEPSEEK_TRAIN_LAYERS of 27 layers, 4 x 2048 in
    grad_accum 4. MLA's attention runs the flash forward with lse and
    the backward kernel at (q/k 192, v 128); the MoE's backward is
    PyTorch autograd."""
    from repro_torch import configs
    gc_collect(torch)
    t0 = time.perf_counter()
    width_step_check(torch, configs.get(DEEPSEEK).scaled(n_layers=1,
                                                         grad_accum=1),
                     DENSE_WIDTH_SEQ, "deepseek train width")
    say("deepseek train width", f"{DEEPSEEK} full width, 1 of 27 layers "
                                f"(depth cut to fit the CPU side), batch 1 "
                                f"x {DENSE_WIDTH_SEQ}, "
                                f"{time.perf_counter() - t0:.1f} s ok")
    gc_collect(torch)
    return {"deepseek_train": moe_train(
        torch, DEEPSEEK, DEEPSEEK_TRAIN_LAYERS, DENSE_BATCH, DENSE_STEPS,
        "deepseek train")}


def phase_phi35(torch, np) -> tuple:
    """phi3.5-moe-42b: the 2-layer serving width check card vs CPU (the
    CPU replays the card's routing), Server.generate at full width cut to
    PHI35_SERVE_LAYERS of 32 (bf16, Model.init(0) built layer by layer on
    the card) at phase 5's sizes, greedy and at temperature 0.8, with one
    decode step profiled; then a 1-layer full-width training step card vs
    CPU at 1 x DENSE_WIDTH_SEQ and PHI35_STEPS steps at
    PHI35_TRAIN_LAYERS, PHI35_BATCH x 2048 in grad_accum 8. Returns the
    serving and the training launch counts."""
    import importlib
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import Model
    from repro_torch.runtime import ServeConfig, Server
    dispatch = importlib.import_module("repro_torch.core.dispatch")

    gc_collect(torch)
    phase_width(torch, np, PHI35, "phi35 width")
    gc_collect(torch)
    full = configs.get(PHI35)
    cfg = full.scaled(n_layers=PHI35_SERVE_LAYERS)
    t0 = time.perf_counter()
    params = Model(cfg).init(0, device=DEVICE)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    say("phi35", f"{PHI35} cut: {cfg.n_layers} of {full.n_layers} layers at "
                 f"full width ({full.n_layers} need ~83.7 GB in bf16), "
                 f"{n_params / 1e9:.3f} B params bf16 "
                 f"({torch.cuda.memory_allocated() / 1e9:.2f} GB), init "
                 f"{time.perf_counter() - t0:.1f} s")
    prompts = prompts_for(cfg, np)
    card = card_line()
    runs = {}
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    dispatch.reset_engine_fallbacks()
    for name, temp in (("greedy", 0.0), ("temperature", 0.8)):
        runs[name] = Server(cfg, params, ServeConfig(
            max_seq=MAX_SEQ, max_new_tokens=NEW_TOKENS, eos_token=-1,
            temperature=temp)).generate(prompts)
    serve_counts = ops.launches()
    fallbacks = dispatch.engine_fallbacks
    peak = torch.cuda.max_memory_allocated()
    for name, out in runs.items():
        comp = out["completions"]
        need(len(comp) == BATCH and all(
            len(c) == NEW_TOKENS and all(0 <= t < cfg.padded_vocab
                                         for t in c) for c in comp),
             f"phi35 {name}: completions malformed")
        say("phi35", f"{name}: prefill {out['prefill_s'] * 1e3:.2f} ms | "
                     f"decode {out['decode_tok_per_s']:.2f} tok/s | req0 "
                     f"{comp[0]} | card {card}")
    say("phi35", f"kernel launches {serve_counts} | engine_fallbacks "
                 f"{fallbacks} | card {card}")
    card_memory_ok(torch, peak, "phi35", f"serving {cfg.n_layers} of "
                                         f"{full.n_layers} layers")
    for wrapper in ("attention", "reduce", "chain_reduce"):
        need(serve_counts[wrapper] > 0, f"phi35: {wrapper} kernel never "
                                        f"launched")
    need(fallbacks == 0, f"{fallbacks} descriptors fell back to the engine")
    profile_decode_step(torch, np, cfg, params, prompts, "phi35")
    del params
    gc_collect(torch)

    t0 = time.perf_counter()
    width_step_check(torch, full.scaled(n_layers=1, grad_accum=1),
                     DENSE_WIDTH_SEQ, "phi35 train width")
    say("phi35 train width", f"{PHI35} full width, 1 of 32 layers (depth "
                             f"cut to fit the CPU side), batch 1 x "
                             f"{DENSE_WIDTH_SEQ}, "
                             f"{time.perf_counter() - t0:.1f} s ok")
    gc_collect(torch)
    return {"phi35": (serve_counts, serve_obs(runs, peak)),
            "phi35_train": moe_train(torch, PHI35, PHI35_TRAIN_LAYERS,
                                     PHI35_BATCH, PHI35_STEPS,
                                     "phi35 train")}


# ----------------------------------------------------------------------
# phase 8: the paper's kernel suite
# ----------------------------------------------------------------------
def phase_suite(torch, np) -> dict:
    """The paper's §III-B kernel suite through the entry points a user
    calls: the path cases of ``suite_cases`` (``ops.conv2d``,
    ``ops.stencil_axis``, ``ops.laplace``, ``ops.gemm(compensated=True)``,
    ``ops.elementwise``/``ops.elementwise_chain``), AXPY and the 3-command
    chain as ``ntx.Program``s run by ``ntx.Executor``, and the
    ``precision`` RMSE study. After one untimed pass, each call is timed
    once with CUDA events between a launch-count reset and a read; then
    each result is held against its plain version by the case's own
    mode, tolerance and check, as in phase 2."""
    import ntx_torch as ntx
    from repro_torch.core import precision
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ntx_elementwise as ew

    g = torch.Generator(device=DEVICE).manual_seed(8)
    rn = lambda *s, std=1.0: torch.randn(*s, generator=g,
                                         device=DEVICE) * std
    card = card_line()
    cases = [case for case in suite_cases(torch, rn) if case["path"]]
    xs, ys = rn(AXPY_N), rn(AXPY_N)
    with ntx.Program() as prog:
        xb = prog.buffer((AXPY_N,), name="x")
        yb = prog.buffer((AXPY_N,), name="y")
        axpy_out = prog.axpy(2.5, xb, yb)
    with ntx.Program() as chain:          # benchmarks/run.py:_chain_program
        cx = chain.buffer((AXPY_N,), name="x")
        t = chain.thresh(cx, CHAIN3[0][1])
        chain.relu(t, out=t)
        chain.thresh(t, CHAIN3[2][1], out=t)

    # (name, call, wrapper, bytes, operations, kind of operations)
    items = [(case["name"], case["kernel"], case["wrapper"], case["bytes"],
              case["ops"], case["kind"]) for case in cases]
    for policy in ("serial", "fused"):
        items.append((f"axpy {AXPY_N} ntx.Program {policy}",
                      lambda p=policy: ntx.Executor(p, device=DEVICE).run(
                          prog, inputs={xb: xs, yb: ys}).read_tensor(
                              axpy_out),
                      "elementwise", 12.0 * AXPY_N, 2.0 * AXPY_N, "fp32"))
    items.append((f"thresh-relu-thresh {AXPY_N} ntx.Program fused",
                  lambda: ntx.Executor("fused", device=DEVICE).run(
                      chain, inputs={cx: xs}).read_tensor(t),
                  "elementwise_chain", 8.0 * AXPY_N, 3.0 * AXPY_N, "fp32"))
    # one untimed pass, its outputs held together as the timed pass holds
    # them, so the timed calls reuse cached blocks instead of new ones
    warm = [call() for _, call, _, _, _, _ in items]
    del warm
    torch.cuda.synchronize()
    alloc_keys = ("num_alloc_retries", "num_device_alloc", "num_device_free")
    alloc0 = torch.cuda.memory_stats()
    gc0 = sum(g["collections"] for g in gc.get_stats())
    ops.reset_launches()
    outs, times, unlaunched = [], [], []
    for name, call, wrapper, _, _, _ in items:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        before = ops.launches()[wrapper]
        t0 = time.perf_counter()
        start.record()
        outs.append(call())
        end.record()
        times.append((start, end, (time.perf_counter() - t0) * 1e3))
        if ops.launches()[wrapper] == before:
            unlaunched.append(name)
    torch.cuda.synchronize()
    counts = ops.launches()
    alloc1 = torch.cuda.memory_stats()
    host = {k: alloc1.get(k, 0) - alloc0.get(k, 0) for k in alloc_keys}
    host["gc_collections"] = sum(g["collections"]
                                 for g in gc.get_stats()) - gc0
    for (name, _, _, nbytes, nops, kind), (start, end, host_ms) in zip(
            items, times):
        ms = start.elapsed_time(end)
        flops, bps = nops / ms * 1e3, nbytes / ms * 1e3
        b_ms, b_by = bound_ms(nbytes, nops, kind)
        say("suite", f"{name}: {ms:.4f} ms | {flops / 1e9:.1f} Gflop/s "
                     f"({flops / PEAK_OPS[kind]:.4f} of the {kind} rate) | "
                     f"{bps / 1e9:.1f} GB/s ({bps / HBM_BYTES_PER_S:.4f} of "
                     f"HBM) | bound {b_ms:.4f} ms ({b_by}), {b_ms / ms:.4f}"
                     f" of it | host {host_ms:.4f} ms to enqueue it | card "
                     f"{card}")
    say("suite", f"kernel launches {counts} | during the timed calls: "
                 f"caching-allocator and Python gc events {host}")
    need(not unlaunched, f"suite calls that launched no kernel: {unlaunched}")
    bad = []
    for shape in LAP_SHAPES[1:]:
        # the fused Laplace beside the per-axis route it replaced (three
        # stencil_axis passes over contiguous copies of the interior
        # slices, and torch adds), in turns: fused, per-axis, per-axis,
        # fused; the two results bit-equal
        x, nd = rn(*shape), len(shape)
        fused = lambda: ops.laplace(x)
        per_axis = lambda: laplace_per_axis(x, ops)
        same = bool(torch.equal(fused(), per_axis()))
        got = [time_ms(fn, torch, warmup=1, iters=5)
               for fn in (fused, per_axis, per_axis, fused)]
        say("suite", f"laplace {nd}-D {'x'.join(map(str, shape))}: fused "
                     f"{got[0]:.4f} / {got[3]:.4f} ms | per-axis route "
                     f"(copies, {nd} passes, adds) {got[1]:.4f} / "
                     f"{got[2]:.4f} ms (CUDA events, mean of 5) | "
                     f"bit-equal {same} | card {card}")
        if not same:
            bad.append(f"laplace {nd}-D fused vs per-axis")
        del x

    # every result against its plain version on the card
    for case, got in zip(cases, outs):
        ok, max_abs, _ = compare(torch, case, got, case["plain"]())
        msg = f"max_abs_err {max_abs:.3e} vs its plain version"
        if case.get("check"):
            ok2, more = case["check"](got)
            ok, msg = ok and ok2, f"{msg} | {more}"
        say("suite", f"{case['name']}: {msg} {'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(case["name"])
    rest = outs[len(cases):]
    want = ref.elementwise("axpy", xs, ys, 2.5)
    for policy, got in zip(("serial", "fused"), rest):
        if not torch.equal(got, want):
            bad.append(f"axpy program {policy}")
    if not torch.equal(rest[2], ew.elementwise_chain_plain(CHAIN3, xs)):
        bad.append("chain program fused")
    del outs, rest, want, cases, items

    t0 = time.perf_counter()
    study = precision.conv_layer_rmse_study(n_outputs=128, device=DEVICE)
    card_s = time.perf_counter() - t0
    cpu = precision.conv_layer_rmse_study(n_outputs=128, device="cpu")
    say("suite", f"PCS RMSE study, 128 outputs of 576 (Kahan on the card, "
                 f"{card_s:.2f} s): {study} | equals the CPU run: "
                 f"{study == cpu}")
    if study != cpu or not (study["rmse_pcs"] < study["rmse_fp32_chained"]
                            and study["rmse_kahan"]
                            < study["rmse_fp32_chained"]):
        bad.append("rmse study")
    need(not bad, f"suite results disagree: {bad}")
    torch.cuda.empty_cache()
    return counts


# ----------------------------------------------------------------------
# phase 9: the Executor's policies
# ----------------------------------------------------------------------
#: (label, policy, ExecutionPolicy overrides): every policy and transport
#: phase 9 runs each program under
POLICY_RUNS = (
    ("serial", "serial", {}),
    ("fused", "fused", {}),
    ("multistream/vmap", "multistream", {"transport": "vmap"}),
    ("multistream/interleave", "multistream", {"transport": "interleave"}),
    ("multistream/serial", "multistream", {"transport": "serial"}),
    ("pipeline/vmap", "pipeline", {"transport": "vmap"}),
    ("pipeline/interleave", "pipeline", {"transport": "interleave"}),
    ("pipeline/overlap", "pipeline", {"transport": "overlap"}),
    ("tiled/dma_overlap", "tiled", {"dma_overlap": True}),
    ("tiled/no_dma", "tiled", {"dma_overlap": False}),
    ("auto/model", "auto", {"autotune": "model"}),
    ("auto/measure", "auto", {"autotune": "measure"}),
)


def lane_programs(torch, np, ntx):
    """Phase 9's programs: (name, Program, inputs, the launches expected
    per run under the vmap transports, slots or None). The samplers'
    programs are the ones ``runtime.serve`` builds, bound to logits and
    numpy Gumbel noise. Under multistream a request's dependent commands
    are one sub-stream (COPY -> ARGMAX fuses into one chain-reduce);
    under pipeline they are stages, one lane launch each."""
    from repro_torch.runtime import serve
    rng = np.random.default_rng(9)
    logits = torch.as_tensor(
        (rng.standard_normal((BATCH, VOCAB)) * 3.0).astype(np.float32),
        device=DEVICE)
    top = logits.max() + 1.0                    # a tie in every row
    logits[:, VOCAB // 30] = logits[:, VOCAB * 7 // 10] = top
    gumbel = rng.gumbel(size=(BATCH, VOCAB)).astype(np.float32)
    dev = torch.device(DEVICE)
    progs = []
    for name, staged, lane in (
            ("greedy", False, {"multistream/vmap": dict(reduce=1),
                               "pipeline/vmap": dict(reduce=1)}),
            ("prefill", True, {"multistream/vmap": dict(chain_reduce=1),
                               "pipeline/vmap": dict(elementwise=1,
                                                    reduce=1)})):
        cache = serve._PREFILL_PROGRAMS if staged else serve._ARGMAX_PROGRAMS
        fn = (serve.greedy_argmax_pipelined if staged
              else serve.greedy_argmax_multistream)
        fn(logits, device=dev)               # builds and caches the program
        prog, _, rows, slots = cache[(BATCH, VOCAB, dev)]
        progs.append((f"sampler:{name}_{BATCH}x{VOCAB}", prog,
                      dict(zip(rows, logits)), lane, slots))
    serve.temperature_sample_multistream(logits, 0.8, gumbel, device=dev)
    prog, _, rows, noises, slots = serve._TEMPERATURE_PROGRAMS[
        (BATCH, VOCAB, 0.8, None, dev)]
    inputs = dict(zip(rows, logits))
    inputs.update(zip(noises, torch.as_tensor(gumbel, device=dev)))
    progs.append((f"sampler:temperature0.8_{BATCH}x{VOCAB}", prog, inputs,
                   {"multistream/vmap": dict(chain_reduce=1),
                    "pipeline/vmap": dict(elementwise=1, reduce=1)}, slots))

    g = torch.Generator(device=DEVICE).manual_seed(19)
    with ntx.Program() as dp:
        dp_in = {}
        for i in range(LANES):
            x = dp.buffer((LANE_N,), name=f"x{i}")
            y = dp.buffer((LANE_N,), name=f"y{i}")
            t = dp.axpy(0.5, x, y)
            dp.relu(t, out=t)
            dp.reduce("sum", t, name=f"s{i}")
            dp_in[x] = torch.randn(LANE_N, generator=g, device=DEVICE)
            dp_in[y] = torch.randn(LANE_N, generator=g, device=DEVICE)
    progs.append((f"data_parallel:axpy_relu_sum_{LANES}x2^20", dp, dp_in,
                  {"multistream/vmap": dict(chain_reduce=1),
                   "pipeline/vmap": dict(elementwise_chain=1, reduce=1)},
                  None))
    with ntx.Program() as gp:
        gp_in = {}
        for i in range(GEMM_LANES):
            a = gp.buffer((GEMM_N, GEMM_N), name=f"a{i}")
            b = gp.buffer((GEMM_N, GEMM_N), name=f"b{i}")
            c = gp.gemm(a, b)
            gp.relu(c, out=c)
            gp_in[a] = torch.randn(GEMM_N, GEMM_N, generator=g,
                                   device=DEVICE)
            gp_in[b] = torch.randn(GEMM_N, GEMM_N, generator=g,
                                   device=DEVICE) * GEMM_N ** -0.5
    progs.append((f"gemm_lanes:relu_{GEMM_LANES}x{GEMM_N}^3", gp, gp_in,
                  {"multistream/vmap": dict(gemm=1),
                   "pipeline/vmap": dict(gemm=1)}, None))
    with ntx.Program() as big:
        x = big.buffer((LANE_N,), name="x")
        y = big.buffer((LANE_N,), name="y")
        t = big.axpy(0.5, x, y)
        big.relu(t, out=t)
        big.reduce("sum", t, name="s")
    progs.append(("oversize:axpy_relu_sum_2^20", big,
                  {x: dp_in[dp.resolve("x0")], y: dp_in[dp.resolve("y0")]},
                  None, None))
    return progs, logits, gumbel


def run_policies(torch, ntx, ops, name, prog, inputs, lane) -> dict:
    """One program under every policy run: bit-equal to serial or fail;
    its wall time per run (host clock around runs that end in a
    synchronize, median of 3 after a warm run) and launches per run."""
    base = None
    out = {}
    for label, policy, kw in POLICY_RUNS:
        ex = ntx.Executor(policy, device=DEVICE, **kw)
        ex.run(prog, inputs=inputs)                    # plan, build, race
        torch.cuda.synchronize()
        before = ops.launches()
        res = ex.run(prog, inputs=inputs)
        torch.cuda.synchronize()
        launches = {k: v - before[k] for k, v in ops.launches().items()
                    if v != before[k]}
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            ex.run(prog, inputs=inputs)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        mem = res.mem
        if base is None:
            base = mem.clone()
        same = bool(torch.equal(mem, base))
        sched = ex.stats["scheduler"] or {}
        mode = sched.get("stage_modes") or sched.get("mode_used")
        out[label] = dict(policy=ex.stats["policy"], wall_ms=sorted(
            walls)[1] * 1e3, launches=launches, same=same)
        say("policies", f"{name} {label}: ran {ex.stats['policy']}"
                        f"{f' ({mode})' if mode else ''} | wall "
                        f"{out[label]['wall_ms']:.3f} ms per run | launches "
                        f"per run {launches} | bit-equal to serial "
                        f"{'yes' if same else 'NO'}")
        need(same, f"{name}: {label} differs from serial on the card")
        if lane and label in lane:
            need(launches == lane[label],
                 f"{name}: {label} launched {launches}, expected "
                 f"{lane[label]}: one launch per group for all lanes")
    return out


def policy_cases(torch, np, logits, gumbel) -> list:
    """The lane launches of phase 9's main path as kernel cases: each
    wrapper on the lane stack the vmap transport hands it (a strided view
    of the memory image), against its plain version, with L one-lane
    launches of the same kernel beside it."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ntx_elementwise as ew
    from repro_torch.kernels import ntx_gemm, ntx_reduce
    stream_src = "src/repro_torch/kernels/csrc/ntx_stream.cu"
    g = torch.Generator(device=DEVICE).manual_seed(29)
    # greedy: a lane is a logits row and its slot, VOCAB + 8 apart;
    # temperature: logits, noise, perturbed row and slot, 3 VOCAB + 8
    W, W3 = VOCAB + 8, 3 * VOCAB + 8
    x = torch.zeros(BATCH * W, device=DEVICE).as_strided(
        (BATCH, VOCAB), (W, 1), 0).copy_(logits)
    timg = torch.zeros(BATCH * W3, device=DEVICE)
    tx = timg.as_strided((BATCH, VOCAB), (W3, 1), 0).copy_(logits)
    noise = timg.as_strided((BATCH, VOCAB), (W3, 1), VOCAB).copy_(
        torch.as_tensor(gumbel, device=DEVICE))
    imm = 1 / 0.8
    cases = [
        dict(name=f"reduce:argmax_lanes_{BATCH}x{VOCAB}", wrapper="reduce",
             source=stream_src, replaces="src/repro/kernels/ntx_reduce.py:153",
             kernel=lambda: ops.reduce("argmax", x),
             plain=lambda: ntx_reduce.reduce_plain("argmax", x),
             library=lambda: torch.argmax(x, -1), mode="equal",
             tol=(0.0, 0.0), bytes=x.numel() * 4 + BATCH * 4,
             ops=x.numel(), kind="fp32", path=True, phase="policies",
             singles=(BATCH, lambda: [ops.reduce("argmax", x[i:i + 1])
                                      for i in range(BATCH)])),
        dict(name=f"elementwise:copy_lanes_{BATCH}x{VOCAB}",
             wrapper="elementwise", source=stream_src,
             replaces="src/repro/kernels/ntx_elementwise.py:61",
             kernel=lambda: ops.elementwise("copy", x),
             plain=lambda: ew.elementwise_plain("copy", x),
             library=lambda: x.clone(), mode="equal", tol=(0.0, 0.0),
             bytes=2 * x.numel() * 4, ops=x.numel(), kind="fp32", path=True,
             phase="policies",
             singles=(BATCH, lambda: [ops.elementwise("copy", x[i:i + 1])
                                      for i in range(BATCH)])),
        dict(name=f"chain_reduce:axpy_argmax_lanes_{BATCH}x{VOCAB}",
             wrapper="chain_reduce", source=stream_src,
             replaces="src/repro/kernels/ntx_reduce.py:117",
             kernel=lambda: ops.chain_reduce([("axpy", imm)], "argmax", tx,
                                             (noise,)),
             plain=lambda: _chain_reduce_plain(ops, ntx_reduce,
                                               [("axpy", imm)], tx, (noise,)),
             library=None, mode="equal", tol=(0.0, 0.0),
             bytes=tx.numel() * 12 + BATCH * 4, ops=2 * tx.numel(),
             kind="fp32", path=True, phase="policies",
             singles=(BATCH, lambda: [ops.chain_reduce(
                 [("axpy", imm)], "argmax", tx[i:i + 1], (noise[i:i + 1],))
                 for i in range(BATCH)])),
    ]
    # the data-parallel lanes: x, y and t of one lane sit 3 * 2**20 + 8
    # apart (with the SUM slot), the stack a strided view
    D = 3 * LANE_N + 8
    dimg = torch.randn(LANES * D, generator=g, device=DEVICE)
    dx = dimg.as_strided((LANES, LANE_N), (D, 1), 0)
    dy = dimg.as_strided((LANES, LANE_N), (D, 1), LANE_N)
    stages = [("axpy", 0.5), ("relu", 0.0)]

    cases.append(dict(
        name=f"chain_reduce:axpy_relu_sum_lanes_{LANES}x2^20",
        wrapper="chain_reduce", source=stream_src,
        replaces="src/repro/kernels/ntx_reduce.py:117",
        kernel=lambda: ops.chain_reduce(stages, "sum", dx, (dy,)),
        plain=lambda: ntx_reduce.chain_reduce_plain(stages, "sum", dx,
                                                    (dy,)),
        library=None, mode="lanesum", tol=(1e-5, 0.0),
        bytes=dx.numel() * 12 + LANES * 4, ops=3 * dx.numel(), kind="fp32",
        path=True, phase="policies",
        singles=(LANES, lambda: [ops.chain_reduce(stages, "sum",
                                                  dx[i:i + 1],
                                                  (dy[i:i + 1],))
                                 for i in range(LANES)])))
    # the GEMM lanes: a, b and c of one lane 3 * 512**2 apart
    n = GEMM_N
    G = 3 * n * n
    gimg = torch.randn(GEMM_LANES * G, generator=g, device=DEVICE)
    gimg.view(GEMM_LANES, G)[:, n * n:2 * n * n] *= n ** -0.5
    ga = gimg.as_strided((GEMM_LANES, n, n), (G, n, 1), 0)
    gb = gimg.as_strided((GEMM_LANES, n, n), (G, n, 1), n * n)
    ep = [("relu",)]
    cases.append(dict(
        name=f"gemm:fp32_relu_lanes_{GEMM_LANES}x{n}^3", wrapper="gemm",
        source="src/repro_torch/kernels/csrc/ntx_gemm.cu",
        replaces="src/repro/kernels/ntx_gemm.py:137",
        kernel=lambda: ops.gemm(ga, gb, epilogue=ep),
        plain=lambda: ntx_gemm.gemm_plain(ga, gb, torch.float32,
                                          ops._norm_epilogue(ep)),
        library=lambda: torch.relu(torch.bmm(ga, gb)), mode="close",
        tol=(1e-4, 1e-4), bytes=3 * GEMM_LANES * n * n * 4,
        ops=2.0 * GEMM_LANES * n ** 3, kind="fp32", path=True,
        phase="policies",
        singles=(GEMM_LANES, lambda: [ops.gemm(ga[i], gb[i], epilogue=ep)
                                      for i in range(GEMM_LANES)]),
        check=lambda got: lanes_equal_singles(torch, got, [
            ops.gemm(ga[i], gb[i], epilogue=ep) for i in range(GEMM_LANES)])))
    return cases


def lanes_equal_singles(torch, got, singles) -> tuple:
    same = all(torch.equal(got[i], s) for i, s in enumerate(singles))
    return same, f"each lane bit-equal to its one-lane launch: {same}"


def phase_policies(torch, np) -> tuple:
    """Every policy and transport on the card over phase 9's programs,
    bit-equal to serial; the launch counts of that run; the samplers'
    tokens against torch.argmax; the tiled verdict, the measured race and
    its cache, shard_map's refusal; then the lane launches checked and
    timed, and the sampler's step under fused against multistream."""
    import ntx_torch as ntx
    from repro_torch.core import clear_measured_policy_cache
    from repro_torch.kernels import ops
    from repro_torch.runtime import serve

    card = card_line()
    progs, logits, gumbel = lane_programs(torch, np, ntx)
    clear_measured_policy_cache()
    ops.reset_launches()
    results = {name: run_policies(torch, ntx, ops, name, prog, inputs, lane)
               for name, prog, inputs, lane, _ in progs}
    counts = ops.launches()
    say("policies", f"launches over every policy run of phase 9 {counts} | "
                    f"card {card}")

    # the samplers' tokens: torch.argmax of the same logits, and of the
    # AXPY's two roundings for the temperature chain
    imm = torch.tensor(1 / 0.8, dtype=torch.float32, device=DEVICE)
    want_t = torch.argmax(logits * imm + torch.as_tensor(
        gumbel, device=DEVICE), -1).cpu().numpy()
    want_g = torch.argmax(logits, -1).cpu().numpy()
    for name, prog, inputs, _, slots in progs[:3]:
        res = ntx.Executor(device=DEVICE).run(prog, inputs=inputs)
        got = np.asarray([res[s][0] for s in slots]).astype(np.int64)
        want = want_t if "temperature" in name else want_g
        ok = bool((got == want).all())
        say("policies", f"{name}: tokens {got.tolist()} torch.argmax "
                        f"{want.tolist()} {'equal' if ok else 'DIFFER'}")
        need(ok, f"{name}: tokens differ from torch.argmax")
    for fn, want in ((serve.greedy_argmax_multistream, want_g),
                     (serve.greedy_argmax_pipelined, want_g)):
        need(bool((fn(logits, device=DEVICE) == want).all()),
             f"{fn.__name__} tokens differ from torch.argmax")
    need(bool((serve.temperature_sample_multistream(
        logits, 0.8, gumbel, device=DEVICE) == want_t).all()),
        "temperature sampler tokens differ")

    # the program larger than the TCDM: auto tiles it
    _, big, big_in, _, _ = progs[-1]
    plan = ntx.Executor(device=DEVICE).plan(big)
    tiled = ntx.Executor(device=DEVICE)
    before = ops.launches()
    tiled.run(big, inputs=big_in)
    st = tiled.stats["scheduler"]
    per_run = {k: v - before[k] for k, v in ops.launches().items()
               if v != before[k]}
    say("policies", f"oversize 2^20 chain: Executor().plan picks "
                    f"{plan['policy']} (working set "
                    f"{plan['gains']['tiling']['working_set_bytes']:.0f} B > "
                    f"TCDM {plan['gains']['tiling']['capacity_bytes']:.0f} B) "
                    f"| {st['n_tiles']} tiles, {st['n_spill_items']} resident "
                    f"| launches per run {per_run}")
    need(plan["policy"] == "tiled", f"auto picked {plan['policy']} for a "
                                    f"program larger than the TCDM")

    # a fitting program raced twice: the second race is the memo's
    with ntx.Program() as fit:
        fin = {}
        for i in range(4):
            fx = fit.buffer((1024,), name=f"x{i}")
            fy = fit.buffer((1024,), name=f"y{i}")
            ft = fit.axpy(0.5, fx, fy)
            fit.relu(ft, out=ft)
            fit.reduce("sum", ft)
            fin[fx] = torch.randn(1024, device=DEVICE)
            fin[fy] = torch.randn(1024, device=DEVICE)
    races = []
    for _ in range(2):        # two executors, the raw layer: no plan cache
        ex = ntx.Executor(autotune="measure", device=DEVICE)
        got = ex.run_descriptors(fit.descriptors, fit.pack(fin, DEVICE))
        races.append((ex.stats["policy"], ex.stats["gains"]))
    base = ntx.Executor("serial", device=DEVICE).run(fit, inputs=fin).mem
    say("policies", f"fitting program raced: pick {races[0][0]} from "
                    f"{ {k: round(v * 1e3, 3) for k, v in races[0][1]['measured'].items()} } "
                    f"ms | second race cached "
                    f"{races[1][1]['measured_cached']} pick {races[1][0]}")
    need(races[1][1]["measured_cached"] is True and races[0][0] ==
         races[1][0], "the second measured race did not hit the cache")
    need(bool(torch.equal(got, base)), "the raced pick differs from serial")

    # shard_map on one device
    try:
        ntx.Executor("multistream", device=DEVICE,
                     transport="shard_map").run(fit, inputs=fin)
        raised = None
    except ValueError as e:
        raised = str(e)
    say("policies", f"shard_map on {torch.cuda.device_count()} device(s): "
                    f"ValueError {raised!r}")
    if torch.cuda.device_count() < 2:
        need(raised is not None and "shard_map" in raised,
             "shard_map on one device did not raise ValueError")

    # the sampler's decode step: fused (the parent's policy) against
    # multistream (the reference's), in turns
    prog, _, rows, slots = serve._ARGMAX_PROGRAMS[(BATCH, VOCAB,
                                                   torch.device(DEVICE))]
    step = {}
    for policy in ("fused", "multistream", "multistream", "fused"):
        ex = ntx.Executor(policy, device=DEVICE)
        ex.run(prog, inputs=dict(zip(rows, logits)))
        t0 = time.perf_counter()
        for _ in range(20):
            res = ex.run(prog, inputs=dict(zip(rows, logits)))
            [res[s][0] for s in slots]             # tokens to the host
        step.setdefault(policy, []).append(
            (time.perf_counter() - t0) / 20 * 1e3)
    say("policies", f"greedy sampler per decode step (b {BATCH}, vocab "
                    f"{VOCAB}, tokens on the host): "
                    + " | ".join(f"{p} {', '.join(f'{t:.3f}' for t in ts)} ms"
                                 for p, ts in step.items())
                    + f" | card {card}")

    rows = check_and_time(torch, policy_cases(torch, np, logits, gumbel),
                          True, "policies", "policies")
    torch.cuda.empty_cache()
    return counts, rows, results


# ----------------------------------------------------------------------
# phase 19: the dry run on the meta device against the card
# ----------------------------------------------------------------------
#: the kernel families with a meta route (``ops``): the dry run's calls of
#: each must equal the card's launches in every measured workload
DRY_FAMILIES = ("gemm", "attention", "attention_merge", "attention_bwd",
                "act_bwd", "ssd", "ssd_state", "ssd_bwd", "adamw")
#: H100 SXM5 80GB data sheet, the dry run's default ceilings
SHEET = {"bf16": PEAK_OPS["bf16"], "hbm": HBM_BYTES_PER_S}


def dry_specs() -> dict:
    """The workloads phases 5, 7 and 11-18 measure, by their counts' key:
    the config and its depth cut, and either the serving runs (Server.
    generate calls of BATCH prompts, and the long prompt) or the training
    steps, as each phase runs them."""
    def serve(arch, cut=None, long=False, plen=PROMPT_LEN, max_seq=MAX_SEQ,
              extra=None):
        reqs = [(BATCH, plen, max_seq, NEW_TOKENS, 2)]
        if long:
            reqs.append((1, LONG_PROMPT, LONG_SEQ, LONG_NEW, 1))
        return {"arch": arch, "cut": cut or {}, "kind": "serve",
                "requests": reqs, "extra": extra}

    def train(arch, cut, batch, seq, steps, fused_update=False):
        return {"arch": arch, "cut": cut, "kind": "train", "batch": batch,
                "seq": seq, "steps": steps, "fused_update": fused_update}

    return {
        "serve": serve("llama3-8b", long=True),
        "train": train(MAMBA2, {}, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS,
                       fused_update=True),
        "dense": train("llama3-8b", {"n_layers": DENSE_LAYERS}, DENSE_BATCH,
                       DENSE_SEQ, DENSE_STEPS),
        "deepseek": serve(DEEPSEEK, long=True),
        "deepseek_train": train(DEEPSEEK, {"n_layers": DEEPSEEK_TRAIN_LAYERS},
                                DENSE_BATCH, DENSE_SEQ, DENSE_STEPS),
        "phi35": serve(PHI35, {"n_layers": PHI35_SERVE_LAYERS}),
        "phi35_train": train(PHI35, {"n_layers": PHI35_TRAIN_LAYERS},
                             PHI35_BATCH, DENSE_SEQ, PHI35_STEPS),
        "mamba2_serve": serve(MAMBA2, long=True),
        "jamba": serve(JAMBA, {"n_layers": JAMBA_SERVE_LAYERS}),
        "whisper": serve(WHISPER, extra="whisper"),
        "whisper_train": train(WHISPER, {}, WHISPER_TRAIN_BATCH,
                               WHISPER_TRAIN_SEQ, DENSE_STEPS),
        "qwen": serve(QWEN, plen=QWEN_PLEN, max_seq=QWEN_MAX_SEQ,
                      extra="qwen"),
        "qwen_train": train(QWEN, {}, QWEN_TRAIN_BATCH, QWEN_TRAIN_SEQ,
                            DENSE_STEPS),
    }


def dry_workload(src: str, spec: dict) -> dict:
    """One workload of :func:`dry_specs` on the meta device, in a worker
    process (no CUDA): its kernel calls over the whole workload (every
    prefill and decode step, every training step, the fused update), the
    full count (flops, bytes, peak) of one prefill and of the first decode
    step, or of one training step, and the config's active and frame
    weights."""
    import collections
    sys.path.insert(0, src)
    import torch
    torch.set_num_threads(1)
    from repro_torch import configs
    from repro_torch.configs.shapes import active_params
    from repro_torch.launch import dryrun
    from repro_torch.models import Model

    t0 = time.perf_counter()
    cfg = configs.get(spec["arch"]).scaled(**spec["cut"])
    calls = collections.Counter()
    traces = {}

    def add(got: dict, times: int = 1) -> None:
        for k, v in got.items():
            calls[k] += v * times

    if spec["kind"] == "train":
        fn, args = dryrun.train_step(cfg, spec["batch"], spec["seq"])
        traces["step"] = dryrun.trace(fn, *args)
        add(traces["step"]["launches"], spec["steps"])
        if spec["fused_update"]:
            from repro_torch.optim import AdamWConfig, apply_updates
            params, opt = args[0], args[1]
            named = dict(params.named_parameters())
            grads = {n: torch.empty(p.shape, device="meta")
                     for n, p in named.items()}
            add(dryrun.count_calls(lambda: apply_updates(
                AdamWConfig(), named, grads, opt, use_fused=True)))
    else:
        model = Model(cfg)
        for i, (b, plen, max_seq, new, runs) in enumerate(spec["requests"]):
            meta = lambda shape, dt: torch.empty(shape, dtype=dt,
                                                 device="meta")
            batch = {"tokens": meta((b, plen), torch.long)}
            if spec["extra"] == "whisper":
                batch["enc_embeds"] = meta((b, cfg.enc_seq, cfg.d_model),
                                           torch.bfloat16)
            elif spec["extra"] == "qwen":
                batch["img_embeds"] = meta((b, cfg.n_patches, cfg.d_model),
                                           torch.bfloat16)
                batch["pos3"] = meta((3, b, plen), torch.long)
            fn, args = dryrun.prefill_step(cfg, b, plen, cache_len=max_seq,
                                           batch=batch)
            if i == 0:
                traces["prefill"] = dryrun.trace(fn, *args)
                add(traces["prefill"]["launches"], runs)
            else:
                add(dryrun.count_calls(fn, *args), runs)
            fn, args = dryrun.decode_step(cfg, b, max_seq, plen,
                                          absorbed_mla=False)
            if i == 0:
                traces["decode"] = dryrun.trace(fn, *args)
                add(traces["decode"]["launches"], runs)
            else:
                add(dryrun.count_calls(fn, *args), runs)
            params, tokens, cache = args
            for j in range(1, new):
                with torch.inference_mode():
                    add(dryrun.count_calls(model.decode, params, tokens,
                                           cache, plen + j), runs)
    return {"calls": dict(calls), "traces": traces,
            "n_active": active_params(cfg), "n_frames": frame_weights(cfg),
            "secs": time.perf_counter() - t0}


#: phase 20's dry-run observations: rank 0 of (arch, shape, mesh)
MESH_DRY_CELLS = (("llama3-8b", "train_4k", "single"),
                  ("deepseek-v2-lite-16b", "decode_32k", "multi"))


def dry_mesh(src: str, spec: dict) -> dict:
    """In a worker process (no CUDA, no process group of its own: the
    dry run starts PyTorch's fake one): ``{"step": ...}`` traces phase
    20's mesh step (llama3-8b cut to ``spec["layers"]`` layers, a
    ``spec["batch"]`` x ``spec["seq"]`` batch) as rank 0 of a fake (1, 1)
    mesh; ``{"cell": (arch, shape, mesh)}`` is that production record
    (``skip_delta``)."""
    sys.path.insert(0, src)
    import torch
    torch.set_num_threads(1)
    from repro_torch import configs
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    if "cell" in spec:
        arch, shape, mesh = spec["cell"]
        rec = dryrun.trace_cell(arch, shape, mesh, {}, skip_delta=True)
    else:
        cfg = configs.get("llama3-8b").scaled(n_layers=spec["layers"])
        with dryrun.fake_mesh((1, 1)) as mesh:
            fn, args = dryrun.mesh_train_step(cfg, mesh, spec["batch"],
                                              spec["seq"])
            rec = dryrun.trace(fn, *args, mesh=mesh)
    return {"rec": rec, "secs": time.perf_counter() - t0}


def mesh_dry_runs(src: Path):
    """Start phase 20's dry runs (:func:`dry_mesh`) in spawned worker
    processes, to run while the card trains: ``(executor, futures)``."""
    import concurrent.futures
    import multiprocessing
    specs = {"step": {"layers": DENSE_LAYERS, "batch": DENSE_BATCH,
                      "seq": DENSE_SEQ}}
    specs.update({f"{a} {sh} {m}": {"cell": (a, sh, m)}
                  for a, sh, m in MESH_DRY_CELLS})
    ex = concurrent.futures.ProcessPoolExecutor(
        len(specs), mp_context=multiprocessing.get_context("spawn"))
    return ex, {k: ex.submit(dry_mesh, str(src), v)
                for k, v in specs.items()}


def check_mesh_dry_runs(runs, counts: dict, peak: int, card: str) -> None:
    """Phase 20's dry runs: the fake (1, 1) trace's kernel calls, times
    the steps, must equal the launches the mesh step counted on the card,
    family by family; its peak beside the card's; then, as
    observations, the production records: rank 0's peak and fit, the
    wire bytes by kind and the roofline's three terms at the data
    sheet's rates (the collective term at NVLink's, a lower bound across
    nodes)."""
    from repro_torch.perfmodel import gpu_roofline
    ex, futures = runs
    try:
        got = {}
        for k, f in futures.items():
            try:
                got[k] = f.result()
            except Exception as e:        # a worker's failure is the phase's
                raise Failed(f"mesh dry run {k} failed: {e!r}") from e
    finally:
        ex.shutdown()
    step = got.pop("step")
    rec = step["rec"]
    dry = {f: rec["launches"].get(f, 0) * MESH_STEPS for f in DRY_FAMILIES}
    on_card = {f: counts.get(f, 0) for f in DRY_FAMILIES}
    ok = dry == on_card
    say("mesh", f"dry run of the mesh step on a fake (1, 1) mesh "
                f"({step['secs']:.1f} s): calls x {MESH_STEPS} steps {dry} "
                f"| card launches {on_card} {'ok' if ok else 'FAIL'} | "
                f"wire bytes "
                f"{rec['collectives']['total_wire_bytes_per_device']:g} | "
                f"dry-run peak {rec['memory']['peak_bytes'] / 1e9:.2f} GB, "
                f"card max_memory_allocated after step 1 {peak / 1e9:.2f} "
                f"GB | card {card}")
    need(ok, f"mesh dry-run calls {dry} differ from the card's {on_card}")
    for key, res in got.items():
        cell = res["rec"]
        r = gpu_roofline.cell_roofline(cell)
        col = cell["production"]["collectives"]
        wire = ", ".join(f"{k} {v / 1e9:.4f} GB"
                         for k, v in sorted(
                             col["wire_bytes_per_device"].items()))
        say("mesh", f"dry run {key} rank {cell['rank']} of "
                    f"{cell['n_devices']} ({res['secs']:.1f} s): peak "
                    f"{cell['production']['memory']['peak_bytes'] / 1e9:.2f}"
                    f" GB fits {cell['fits']} | wire bytes a device {wire} "
                    f"| compute {r['t_compute_s'] * 1e3:.3f} ms, memory "
                    f"{r['t_memory_s'] * 1e3:.3f} ms, collective "
                    f"{r['t_collective_s'] * 1e3:.3f} ms ({r['dominant']}) "
                    f"at the sheet's rates (observation) | card {card}")


def measure_ceilings(torch) -> dict:
    """The card's own rates: a bf16 torch.matmul at 8192^3, an fp32 one at
    4096^3 (TF32 off), and a 2 GiB device-to-device copy (read and
    written), each timed by CUDA events."""
    dev = torch.device(DEVICE)
    a = torch.randn(8192, 8192, device=dev, dtype=torch.bfloat16)
    bf16 = 2 * 8192 ** 3 / (time_ms(lambda: torch.matmul(a, a), torch,
                                    iters=10) * 1e-3)
    a = torch.randn(4096, 4096, device=dev)
    fp32 = 2 * 4096 ** 3 / (time_ms(lambda: torch.matmul(a, a), torch,
                                    iters=10) * 1e-3)
    n = 2 << 30
    src = torch.empty(n, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    hbm = 2 * n / (time_ms(lambda: dst.copy_(src), torch, iters=10) * 1e-3)
    del a, src, dst
    torch.cuda.empty_cache()
    return {"bf16": bf16, "fp32": fp32, "hbm": hbm}


def frame_weights(cfg) -> int:
    """The weights of an encoder-decoder that run at the encoder's
    ``enc_seq`` frames: the encoder's, and the cross-attention's k and v
    projections (0 for a decoder-only config)."""
    from repro_torch.models import Model
    return sum(p.numel() for n, p in Model(cfg).init(
        0, device="meta").named_parameters()
        if n.startswith("enc_") or ".cross_attn.wk" in n
        or ".cross_attn.wv" in n)


def step_model_flops(cfg, n_active: int, n_frames: int, part: str, b: int,
                     s: int) -> int:
    """The model flops of one training step ("step"), prefill or decode
    step of b sequences of s tokens, as the port computes them: 6 (train)
    or 2 (serve) a weight a token, but the embedding lookup multiplies
    nothing, serving unembeds (vocab x d_model) one position a sequence,
    and the ``n_frames`` weights (:func:`frame_weights`) run at the
    encoder's frames in a training step or a prefill and not at all in a
    decode step. ``gpu_roofline.model_flops`` keeps the reference's
    6 / 2 N D, which counts every weight at every position."""
    n_unembed = cfg.padded_vocab * cfg.d_model
    n_body = n_active - n_frames - n_unembed * (
        1 if cfg.tie_embeddings else 2)
    enc = n_frames * cfg.enc_seq
    if part == "step":
        return 6 * b * (s * (n_body + n_unembed) + enc)
    if part == "decode":
        return 2 * b * (n_body + n_unembed)
    return 2 * b * (s * n_body + n_unembed + enc)


def hand_launches(torch, key: str, spec: dict, cfg) -> dict:
    """The launches the measuring phase predicted by hand for ``key``,
    where it has a predictor: :func:`serve_launches`,
    :func:`train_launches`, :func:`moe_train_launches`, and the SSD
    checks of phases 7 and 15-16."""
    if spec["kind"] == "serve" and spec["extra"]:
        b, plen, max_seq, _, runs = spec["requests"][0]
        return serve_launches(torch, cfg, plen, max_seq, runs)[0]
    if key in ("dense", "whisper_train", "qwen_train"):
        return train_launches(cfg, spec["steps"])
    if key in ("deepseek_train", "phi35_train"):
        return moe_train_launches(cfg, spec["steps"])
    if key == "train":
        return {"ssd": 2 * cfg.n_layers * spec["steps"]}
    if key in ("mamba2_serve", "jamba"):
        n_ssm = sum(not cfg.is_attn_layer(i) for i in range(cfg.n_layers))
        prefills = sum(r[4] for r in spec["requests"])
        return {"ssd_state": n_ssm * prefills, "ssd": 0, "ssd_bwd": 0}
    return {}


def phase_dryrun(torch, src: Path, counts: dict, obs: dict) -> None:
    """Phase 19: (a) the card's ceilings beside the data sheet's; (b) each
    workload that phases 5, 7 and 11-18 measured, dry-run on the meta
    device in worker processes at the phase's own depth cut, batch,
    sequence and step count: its kernel calls must equal the launches the
    phase counted on the card, family by family, and the phase's hand
    predictor where it has one. Then, as observations, each prefill,
    decode step and training step's roofline terms at both ceilings
    beside the measured time, the share of the bound the card reached,
    the roofline fraction, the useful share of the counted flops, and the
    dry run's peak beside the card's."""
    import concurrent.futures
    import multiprocessing
    from repro_torch import configs
    from repro_torch.perfmodel import gpu_roofline

    t_phase = time.perf_counter()
    card = card_line()
    ceil = measure_ceilings(torch)
    say("dryrun", f"ceilings measured: bf16 matmul 8192^3 "
                  f"{ceil['bf16'] / 1e12:.1f} TFLOP/s (sheet 989), fp32 "
                  f"4096^3 {ceil['fp32'] / 1e12:.2f} TFLOP/s (sheet 67), "
                  f"2 GiB copy {ceil['hbm'] / 1e12:.3f} TB/s read + written "
                  f"(sheet 3.35) | card {card}")
    specs = {k: v for k, v in dry_specs().items() if k in counts}
    if not specs:
        say("dryrun", "no measured workload ran (phases 5, 7, 11-18): "
                      "nothing to hold")
        return
    workers = max(1, min(len(specs), (os.cpu_count() or 2) - 1))
    order = sorted(specs, key=lambda k: specs[k]["kind"] != "train")
    with concurrent.futures.ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as ex:
        futures = {k: ex.submit(dry_workload, str(src), specs[k])
                   for k in order}
        results = {}
        for k in specs:
            try:
                results[k] = futures[k].result()
            except Exception as e:        # a worker's failure is the phase's
                raise Failed(f"dry run of {k} failed: {e!r}") from e
    say("dryrun", f"{len(specs)} workloads dry-run on {workers} worker "
                  f"processes in {time.perf_counter() - t_phase:.1f} s "
                  f"(the slowest {max(r['secs'] for r in results.values()):.1f}"
                  f" s)")
    bad = []
    for key, spec in specs.items():
        cfg = configs.get(spec["arch"]).scaled(**spec["cut"])
        dry = results[key]["calls"]
        on_card = {f: counts[key].get(f, 0) for f in DRY_FAMILIES}
        got = {f: dry.get(f, 0) for f in DRY_FAMILIES}
        hand = hand_launches(torch, key, spec, cfg)
        ok = got == on_card and all(got.get(f, 0) == v
                                    for f, v in hand.items())
        say("dryrun", f"{key}: dry-run calls {got} | card launches "
                      f"{on_card} | hand predictor {hand or 'none'} "
                      f"{'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(key)
        n_active = results[key]["n_active"]
        peak_dry = 0
        for part, rec in results[key]["traces"].items():
            if part == "step":
                b, s = spec["batch"], spec["seq"]
                t_ms = obs[key]["step_ms"]
            else:
                b, s = spec["requests"][0][:2]
                t_ms = obs[key]["prefill_ms" if part == "prefill"
                                else "step_ms"]
            mf = step_model_flops(cfg, n_active, results[key]["n_frames"],
                                  part, b, s)
            peak_dry = max(peak_dry, rec["memory"]["peak_bytes"])
            cell = {"arch": key, "shape": part, "mesh": "card",
                    "n_devices": 1, "production": rec}
            line = []
            for name, c in (("sheet", SHEET), ("measured", ceil)):
                r = gpu_roofline.cell_roofline(cell, peak_flops=c["bf16"],
                                               hbm_bw=c["hbm"])
                bound = r["bound_time_s"] * 1e3
                line.append(
                    f"{name} ceilings: compute {r['t_compute_s'] * 1e3:.4f} "
                    f"ms, memory {r['t_memory_s'] * 1e3:.4f} ms, bound_time "
                    f"{bound:.4f} ms ({r['dominant']}), reached "
                    f"{bound / t_ms:.4f}, roofline_fraction "
                    f"{mf / r['bound_time_s'] / c['bf16']:.4f}, MFU "
                    f"{mf / (t_ms * 1e-3) / c['bf16']:.4f}")
            say("dryrun", f"{key} {part}: measured {t_ms:.3f} ms | flops "
                          f"{rec['flops']:.4g} (kernels "
                          f"{rec['kernel_flops']:.4g}), bytes "
                          f"{rec['bytes_accessed']:.4g} (kernels "
                          f"{rec['kernel_bytes']:.4g}) | {' | '.join(line)}"
                          f" | model flops {mf:.4g}, useful_ratio "
                          f"{mf / max(rec['flops'], 1):.4f}"
                          f" | card {card}")
        say("dryrun", f"{key}: dry-run peak {peak_dry / 1e9:.2f} GB | "
                      f"card max_memory_allocated "
                      f"{obs[key]['peak'] / 1e9:.2f} GB | card {card}")
    need(not bad, f"dry-run calls differ from the card's launches in {bad}")
    say("dryrun", f"phase 19 in {time.perf_counter() - t_phase:.1f} s")


def main(argv=None) -> int:
    global ONLY
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default=",".join(map(str, sorted(ALL_PHASES))),
                    help="comma-separated phases to run (default: all)")
    ap.add_argument("--only", default="",
                    help="comma-separated case-name prefixes: check and time "
                         "only these phase 2/3 cases")
    ap.add_argument("--src", default=None,
                    help="take repro_torch from this src/ directory (to "
                         "time another checkout's kernels, e.g. the parent "
                         "commit's, on the same card)")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}
    ONLY = tuple(p for p in args.only.split(",") if p)

    # the training phases run within 10-30 GB of the card's memory, and a
    # step's new parameters land in blocks its activations freed: with
    # fixed segments the free memory can end up in pieces too small for a
    # 4 GB logits block (phase 11 failed so once); growable segments keep
    # it whole.  Read when torch first allocates on the card.
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs the "
              "port on the card only", file=sys.stderr)
        return 2
    src = Path(args.src).resolve() if args.src else ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    try:
        t0 = time.perf_counter()
        _build.library()
        build_s = time.perf_counter() - t0
        spills, fn = [], "?"
        for ln in _build.build_log.splitlines():
            if "Function properties for" in ln:
                fn = ln.split("Function properties for")[-1].strip()
            elif ("spill" in ln and "0 bytes spill stores, 0 bytes spill "
                  "loads" not in ln):
                spills.append(f"{fn}: {ln.strip()}")
        say("build", f"{len(_build.sources())} CUDA sources built and "
                     f"loaded in {build_s:.1f} s; ptxas lines with spills: "
                     f"{spills if spills else 'none'}")
        # the flash backward's wgmma kernels hand registers to their
        # consumers so that nothing spills and no product is serialised
        slow = [ln.strip() for ln in _build.build_log.splitlines()
                if "flash_bwd" in ln and "serialized" in ln]
        need(not slow and not any("flash_bwd" in x for x in spills),
             f"the flash backward's kernels spill or serialise wgmma: "
             f"{slow + [x for x in spills if 'flash_bwd' in x]}")
        card = card_line()
        say("build", f"device {torch.cuda.get_device_name(0)} x "
                     f"{torch.cuda.device_count()} | torch {torch.__version__}"
                     f" cuda {torch.version.cuda}")
        print("nvidia-smi name, power.limit:")
        print(card)
        laps, t_lap = {"build": round(build_s, 1)}, [time.perf_counter()]

        def lap(name) -> None:
            now = time.perf_counter()
            laps[name] = round(now - t_lap[0], 1)
            t_lap[0] = now
        rows = []
        if phases & {2, 3}:
            rows = phase_check_and_time(torch, do_time=3 in phases)
            lap("2-3")
        if 4 in phases:
            phase_width(torch, np)
            lap(4)
        counts, obs = {}, {}

        def record(measured: dict) -> None:
            for key, (c, o) in measured.items():
                counts[key], obs[key] = c, o
        if 5 in phases:
            record(phase_serve(torch, np))
            lap(5)
        if 3 in phases and not ONLY:
            profile_ssd_passes(torch)
            time_ssd_backward(torch)
            lap("3 (SSD)")
        if 6 in phases:
            phase_train_width(torch, np)
            lap(6)
        if 7 in phases:
            record(phase_train(torch, np))
            lap(7)
        if 8 in phases:
            counts["suite"] = phase_suite(torch, np)
            lap(8)
        if 9 in phases:
            counts["policies"], lane_rows, _ = phase_policies(torch, np)
            rows += lane_rows
            lap(9)
        for n, fn in ((10, phase_dense_width), (11, phase_dense_train),
                      (12, phase_deepseek), (13, phase_deepseek_train),
                      (14, phase_phi35), (15, phase_mamba2),
                      (16, phase_jamba), (17, phase_whisper),
                      (18, phase_qwen)):
            if n in phases:
                out = fn(torch, np)
                if n != 10:
                    record(out)
                lap(n)
        if 19 in phases:
            phase_dryrun(torch, src, counts, obs)
            lap(19)
        if 20 in phases:
            record(phase_mesh(torch, np, obs, src))
            lap(20)
        if 21 in phases:
            ctx_rows, measured = phase_ctx(torch, np)
            rows += ctx_rows
            record(measured)
            lap(21)
    except Failed as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    say("done", f"phases {sorted(phases)} passed in "
                f"{time.perf_counter() - t_start:.1f} s, the build included;"
                f" seconds by phase {laps}")

    if {3, 5, 7, 8, 9, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
            21} <= phases:
        table = []
        for case in rows:
            if not case["path"]:
                continue          # checked above, not a shape of a path
            table.append({
                "name": case["name"], "route": "cuda",
                "source": case["source"], "replaces": case["replaces"],
                "launches": counts[case.get("phase", "serve")][
                    case["wrapper"]],
                "max_abs_err": case["max_abs_err"], "ms": case["ms"],
                "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
                "bound_by": case["bound_by"],
                "library_ms": case["library_ms"]})
        print(card_line())
        print(json.dumps({"kernels": table}))
    if phases != ALL_PHASES:
        print(f"chip_smoke: partial run (phases {sorted(phases)}); no result "
              f"line", file=sys.stderr)
        return 3
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
