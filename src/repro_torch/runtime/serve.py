"""Batched serving loop: prefill + decode with a pre-allocated cache.

Counterpart of ``repro.runtime.serve`` for every ported family. A batch
of same-length prompts is prefilled, then decoded token by token against
the model's cache (a list of per-layer dicts: bf16 keys and values or
MLA latents, the encoder-decoder's cross-attention keys and values
beside them; a Mamba-2 layer's fp32 state and bf16 conv tails).
Sampling runs as NTX descriptor
:class:`~repro_torch.core.program.Program`\\ s through the
:class:`~repro_torch.core.executor.Executor`, on the model's device:

* greedy decode (``multistream``): one ARGMAX command per request row;
  the rows are independent uniform sub-streams, so the ``vmap``
  transport runs them as ONE lane-batched reduction launch over the
  rows, read in place from the memory image;
* greedy prefill (``pipeline``): per request COPY (the head -> sampler
  handoff) then ARGMAX; the stage schedule level-izes them into a COPY
  stage and an ARGMAX stage, one lane-batched launch each;
* temperature (``multistream``): per request AXPY ``logits/T + gumbel``
  -> optional THRESH prune -> ARGMAX tail, a fused chain-reduce per
  request, one lane-batched launch for the batch (Gumbel-max: the ARGMAX
  of the perturbed logits is an exact draw from ``softmax(logits/T)``).

The samplers build the same programs and run them under the same
policies as the reference; every policy is bit-equal to ``serial``, so
the tokens equal ``np.argmax``'s and the reference's. The Gumbel noise is
drawn with numpy, as in the reference, so both packages see the same
bytes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import ExecutionPolicy, Executor, Program
from repro_torch.distributed import sharding as shd
from repro_torch.models import ArchConfig, Model, encdec, transformer
from repro_torch.models.common import TensorParallel, tensor_parallel
from .train import check_mesh, local_batch, local_params


@dataclasses.dataclass
class ServeConfig:
    max_seq: int = 512
    max_new_tokens: int = 32
    eos_token: int = 1
    temperature: float = 0.0
    seed: int = 0
    multistream: bool = True        # sampling programs via the cluster mesh
    pipeline: bool = True           # prefill sampling via the stage pipeline
    #: optional THRESH prune in the temperature-sampling chain: perturbed
    #: scaled logits at or below the floor drop to 0 before the ARGMAX
    #: tail (None disables the stage)
    min_logit: Optional[float] = None


#: (b, vocab, device) -> (Program, Executor, row handles, slot handles);
#: the Executor caches its plan on the Program, so steady-state decode
#: re-plans nothing.
_ARGMAX_PROGRAMS: Dict[tuple, Any] = {}
_PREFILL_PROGRAMS: Dict[tuple, Any] = {}
#: (b, vocab, temperature, min_logit, device) -> (Program, Executor, rows,
#: noise handles, slot handles) for the temperature-sampling chains
_TEMPERATURE_PROGRAMS: Dict[tuple, Any] = {}

#: positive bias applied (via the noise operand) when ``min_logit``
#: prunes: THRESH zeroes pruned entries, and the shift keeps every
#: *surviving* perturbed logit above 0 so a pruned token can never win
#: the ARGMAX. Power of two; assumes |logits/T + gumbel| < 1024.
_PRUNE_SHIFT = 1024.0


def _as_logits(logits, device) -> torch.Tensor:
    return torch.as_tensor(logits, dtype=torch.float32, device=device)


def _sampler_entry(cache: Dict[tuple, Any], b: int, vocab: int,
                   staged: bool, policy: str, device: torch.device):
    ent = cache.get((b, vocab, device))
    if ent is None:
        prog = Program()
        rows, slots = [], []
        for i in range(b):
            row = prog.buffer((vocab,), name=f"row{i}")
            if staged:
                # COPY hands the head cluster's row off to the sampler
                # cluster (the inter-cluster DMA), ARGMAX reduces it
                row_staged = prog.copy(row)
                slots.append(prog.argmax(row_staged, name=f"slot{i}"))
            else:
                slots.append(prog.argmax(row, name=f"slot{i}"))
            rows.append(row)
        ent = (prog, Executor(ExecutionPolicy(policy=policy), device=device),
               rows, slots)
        cache[(b, vocab, device)] = ent
    return ent


def _run_sampler(ent, logits: torch.Tensor) -> np.ndarray:
    prog, executor, rows, slots = ent
    res = executor.run(prog, inputs=dict(zip(rows, logits)))
    return np.asarray([res[s][0] for s in slots], np.float32).astype(np.int64)


def greedy_argmax_multistream(logits, device="cuda") -> np.ndarray:
    """Greedy sampling as a multi-cluster descriptor program: one ARGMAX
    command per request row — independent uniform sub-streams the
    ``multistream`` policy runs as lanes (one lane-batched launch),
    cached per batch shape. Ties resolve to the first maximum, matching
    ``np.argmax``."""
    device = torch.device(device)
    logits = _as_logits(logits, device)
    b, vocab = logits.shape
    return _run_sampler(
        _sampler_entry(_ARGMAX_PROGRAMS, b, vocab, staged=False,
                       policy="multistream", device=device), logits)


def greedy_argmax_pipelined(logits, device="cuda") -> np.ndarray:
    """Prefill sampling as a stage-pipelined descriptor program: per
    request a dependent COPY -> ARGMAX chain (the head -> sampler
    handoff, then the reduction). The ``pipeline`` policy level-izes the
    chains into a COPY stage and an ARGMAX stage, each uniform across
    requests, so each is one lane-batched launch. Bit-equal to
    ``np.argmax``."""
    device = torch.device(device)
    logits = _as_logits(logits, device)
    b, vocab = logits.shape
    return _run_sampler(
        _sampler_entry(_PREFILL_PROGRAMS, b, vocab, staged=True,
                       policy="pipeline", device=device), logits)


def temperature_sample_multistream(logits, temperature: float, gumbel,
                                   min_logit: Optional[float] = None,
                                   device="cuda") -> np.ndarray:
    """Batched temperature sampling as a descriptor program on the mesh.

    Per request one fused streaming chain, an independent uniform
    sub-stream the ``multistream`` policy runs as a lane: ``AXPY`` (``logits/T +
    gumbel``) -> optional ``THRESH`` prune -> ``ARGMAX`` tail. By the
    Gumbel-max identity the ARGMAX of the perturbed logits is an exact
    draw from ``softmax(logits/T)``. ``gumbel`` is the (b, vocab) noise,
    drawn by the caller. With ``min_logit`` set, the chain runs shifted by
    ``_PRUNE_SHIFT`` (folded into the noise operand, threshold shifted to
    match) so a pruned token can never out-rank a survivor; when
    everything is pruned the row is all zeros and the first index wins.
    """
    if temperature <= 0:
        raise ValueError(f"temperature must be > 0, got {temperature}")
    device = torch.device(device)
    logits = _as_logits(logits, device)
    b, vocab = logits.shape
    key = (b, vocab, float(temperature),
           None if min_logit is None else float(min_logit), device)
    ent = _TEMPERATURE_PROGRAMS.get(key)
    if ent is None:
        prog = Program()
        rows, noises, slots = [], [], []
        for i in range(b):
            row = prog.buffer((vocab,), name=f"row{i}")
            g = prog.buffer((vocab,), name=f"g{i}")
            z = prog.axpy(1.0 / temperature, row, g)
            if min_logit is not None:
                prog.thresh(z, min_logit + _PRUNE_SHIFT, out=z)
            slots.append(prog.argmax(z, name=f"slot{i}"))
            rows.append(row)
            noises.append(g)
        ent = (prog, Executor(ExecutionPolicy(policy="multistream"),
                              device=device), rows, noises, slots)
        _TEMPERATURE_PROGRAMS[key] = ent
    prog, executor, rows, noises, slots = ent
    gumbel = torch.as_tensor(np.asarray(gumbel, np.float32), device=device)
    if min_logit is not None:
        gumbel = gumbel + np.float32(_PRUNE_SHIFT)
    inputs: Dict[Any, Any] = dict(zip(rows, logits))
    inputs.update(zip(noises, gumbel))
    res = executor.run(prog, inputs=inputs)
    return np.asarray([res[s][0] for s in slots], np.float32).astype(np.int64)


def sampler_stats() -> Dict[str, Any]:
    """Executor stats of the cached sampling programs (one per shape)."""
    out: Dict[str, Any] = {}
    for kind, cache in (("decode", _ARGMAX_PROGRAMS),
                        ("prefill", _PREFILL_PROGRAMS),
                        ("temperature", _TEMPERATURE_PROGRAMS)):
        for key, ent in cache.items():
            b, vocab = key[0], key[1]
            name = f"{kind}_b{b}_v{vocab}"
            if kind == "temperature":
                name += f"_T{key[2]:g}"       # one entry per (T, floor)
                if key[3] is not None:
                    name += f"_floor{key[3]:g}"
            out[f"{name}_{key[-1]}"] = dict(ent[1].stats)
    return out


class Server:
    """Serves ``params`` (a ``Transformer`` on the device it runs on)."""

    def __init__(self, cfg: ArchConfig, params, scfg: ServeConfig):
        self.cfg, self.params, self.scfg = cfg, params, scfg
        self.model = Model(cfg)
        self.device = params.embed.embed.device

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _sample(self, logits: torch.Tensor, rng,
                prefill: bool = False) -> np.ndarray:
        dev = self.device
        if self.scfg.temperature <= 0 and prefill and self.scfg.pipeline:
            # prefill: the logits row is handed off head-cluster ->
            # sampler-cluster (COPY) before the ARGMAX
            return greedy_argmax_pipelined(logits, device=dev)
        if self.scfg.temperature <= 0 and self.scfg.multistream:
            return greedy_argmax_multistream(logits, device=dev)
        if self.scfg.temperature > 0 and self.scfg.multistream:
            # sampling prep runs as a descriptor program on the device;
            # the host only draws the Gumbel noise
            g = rng.gumbel(size=tuple(logits.shape))
            return temperature_sample_multistream(
                logits, self.scfg.temperature, g, self.scfg.min_logit,
                device=dev)
        logits = logits.float().cpu().numpy()
        if self.scfg.temperature <= 0:
            return logits.argmax(-1)
        z = logits / self.scfg.temperature
        z = z - z.max(-1, keepdims=True)
        p = np.exp(z)
        p /= p.sum(-1, keepdims=True)
        return np.array([rng.choice(len(q), p=q) for q in p])

    @torch.inference_mode()
    def generate(self, prompts: List[np.ndarray],
                 extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Greedy/temperature generation for a batch of same-length
        prompts. ``extra``: further model inputs, put on the model's
        device (the encoder-decoder's ``enc_embeds``; the VLM's
        ``img_embeds`` and ``pos3``)."""
        scfg = self.scfg
        rng = np.random.default_rng(scfg.seed)
        b = len(prompts)
        plen = len(prompts[0])
        if not all(len(p) == plen for p in prompts):
            raise ValueError("prompts must have the same length")
        tokens = torch.as_tensor(np.stack(prompts), dtype=torch.long,
                                 device=self.device)
        batch = {"tokens": tokens}
        if extra:
            batch.update({k: torch.as_tensor(v, device=self.device)
                          for k, v in extra.items()})

        self._sync()
        t0 = time.perf_counter()
        logits, cache, fill = self.model.prefill(
            self.params, batch, cache_len=scfg.max_seq)
        self._sync()
        prefill_s = time.perf_counter() - t0

        out = [[] for _ in range(b)]
        done = np.zeros(b, bool)
        cur = self._sample(logits, rng, prefill=True)
        t1 = time.perf_counter()
        steps = 0
        for _ in range(scfg.max_new_tokens):
            for i in range(b):
                if not done[i]:
                    out[i].append(int(cur[i]))
                    if cur[i] == scfg.eos_token:
                        done[i] = True
            if done.all():
                break
            step_tokens = torch.as_tensor(cur[:, None], dtype=torch.long,
                                          device=self.device)
            logits, cache = self.model.decode(self.params, step_tokens,
                                              cache, fill)
            fill = fill + 1
            cur = self._sample(logits[:, -1], rng)
            steps += 1
        decode_s = time.perf_counter() - t1
        return {"completions": out,
                "prefill_s": prefill_s,
                "decode_s": decode_s,
                "decode_tok_per_s": (steps * b / decode_s) if decode_s else 0.0}


# ----------------------------------------------------------------------
# Prefill and decode steps on a mesh
# ----------------------------------------------------------------------
def check_mesh_serve(cfg: ArchConfig, mesh) -> None:
    """Refuse what the mesh steps do not do: what the train step refuses
    (``runtime.train.check_mesh``). Every cache layout of ``cache_specs``
    serves, a GQA cache split by head_dim too."""
    check_mesh(cfg, mesh)


def mesh_cache(cfg: ArchConfig, mesh, batch: int, seq: int, device,
               enc_seq: Optional[int] = None) -> list:
    """An empty cache of ``seq`` slots for a global ``batch`` on ``mesh``:
    each layer's dict of bf16 DTensors (the Mamba-2 state fp32) under the
    reference's ``cache_specs`` (``sharding.layer_cache_specs``), each
    rank allocating only its block."""
    if cfg.encoder_decoder:
        shapes = encdec.cache_shapes(cfg, batch, seq, torch.bfloat16,
                                     enc_seq=enc_seq)
    else:
        shapes = transformer.cache_shapes(cfg, batch, seq, torch.bfloat16)
    specs = shd.layer_cache_specs(mesh, [
        {k: shd._Shape(shape) for k, (shape, _) in layer.items()}
        for layer in shapes], cfg)
    coord = list(mesh.get_coordinate())
    out = []
    for layer, lspec in zip(shapes, specs):
        leaves = {}
        for name, (shape, dtype) in layer.items():
            pl = shd.placements(lspec[name], mesh)
            sl = shd.local_slices(shape, pl, mesh.shape, coord)
            local = torch.zeros([s.stop - s.start for s in sl],
                                dtype=dtype, device=device)
            leaves[name] = shd.as_dtensor(local, mesh, pl, shape)
        out.append(leaves)
    return out


def _mesh_context(cfg: ArchConfig, mesh, params):
    """The serving step's context on ``mesh``: no gradients, the model's
    layers as this rank (:class:`~repro_torch.models.common.
    TensorParallel`, the residual replicated: serving never shards it),
    the parameters read as this rank's blocks."""
    stack = contextlib.ExitStack()
    stack.enter_context(torch.no_grad())
    stack.enter_context(tensor_parallel(TensorParallel(mesh, sp=False)))
    stack.enter_context(local_params(params, {
        n: p.to_local() for n, p in params.named_parameters()}))
    return stack


def _mesh_logits(cfg: ArchConfig, mesh, logits: torch.Tensor,
                 batch: int):
    """This rank's logits (b, ..., its block of the vocabulary) as a
    DTensor of the global batch: the batch over the data axes where it
    divides, the vocabulary over ``model`` (the reference's
    ``P(data, "model")`` / ``P(data, None, "model")``)."""
    da = shd._data_axes(mesh)
    bspec = da if batch % shd._axes_size(mesh, da) == 0 else None
    spec = shd.P(bspec, *([None] * (logits.ndim - 2)), "model")
    shape = (batch, *logits.shape[1:-1], cfg.padded_vocab)
    return shd.as_dtensor(logits.contiguous(), mesh,
                          shd.placements(spec, mesh), shape)


def build_mesh_prefill_fn(cfg: ArchConfig, mesh):
    """The prefill step on a ``(data, model)`` or ``(pod, data, model)``
    mesh, the counterpart of the reference's dry-run ``prefill_step``:
    ``prefill_fn(params, batch, cache_len=None)`` with ``params`` a
    module of DTensor parameters (``shard_params`` under
    ``named_param_specs``) and the global ``batch``; each rank takes its
    block of the batch (``batch_specs``) and returns ``(logits, cache,
    fill)``: the last position's logits as a DTensor, the batch over the
    data axes and the vocabulary over ``model``, and the cache, each
    layer's leaves DTensors under ``cache_specs`` (:func:`mesh_cache`).
    The layers run tensor-parallel over ``model`` as in training (GQA
    self-attention context-parallel with ``cfg.ctx_parallel``), each
    handing its cache entries out in the cache's layout (a GQA prefill's
    kv heads exchanged into the sequence blocks of a ``"seq"`` cache)."""
    check_mesh_serve(cfg, mesh)
    model = Model(cfg)

    def prefill_fn(params, batch, cache_len: Optional[int] = None):
        dev = next(params.parameters()).to_local().device
        b, s = batch["tokens"].shape
        lb = {k: v.to(dev) for k, v in local_batch(mesh, batch).items()}
        enc = batch["enc_embeds"].shape[1] if cfg.encoder_decoder else None
        cache = mesh_cache(cfg, mesh, b, cache_len or s, dev, enc)
        with _mesh_context(cfg, mesh, params):
            logits, cache, fill = model._mod.prefill(cfg, params, lb,
                                                     cache_len, cache=cache)
        return _mesh_logits(cfg, mesh, logits, b), cache, fill

    return prefill_fn


def build_mesh_decode_fn(cfg: ArchConfig, mesh):
    """The decode step on a mesh, the counterpart of the reference's
    dry-run ``serve_step``: ``decode_fn(params, tokens, cache, fill)``
    with the global ``tokens`` (b, s_new) and the cache of
    :func:`build_mesh_prefill_fn` (or :func:`mesh_cache`), updated in
    place (the reference donates it) and returned beside the logits
    (b, s_new, vocab), a DTensor as prefill's. ``cfg.mla_absorb``
    selects MLA's absorbed form, as the reference's step does."""
    check_mesh_serve(cfg, mesh)
    model = Model(cfg)

    def decode_fn(params, tokens, cache, fill: int):
        dev = next(params.parameters()).to_local().device
        lt = local_batch(mesh, {"tokens": tokens})["tokens"].to(dev)
        with _mesh_context(cfg, mesh, params):
            logits, cache = model.decode(params, lt, cache, fill,
                                         absorbed_mla=cfg.mla_absorb)
        return _mesh_logits(cfg, mesh, logits, tokens.shape[0]), cache

    return decode_fn
