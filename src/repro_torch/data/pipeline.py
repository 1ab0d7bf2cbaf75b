"""Deterministic synthetic LM data, the counterpart of
``repro.data.pipeline``.

Host-sharded (each host draws only its slice of the global batch) and
deterministic from (seed, step), so a restart resumes exactly from the
step a checkpoint stores; a background thread prefetches the next
batches while a step runs. ``batch_at`` draws the same numpy tokens as
the reference (a Zipfian unigram mixture with every even position
repeating the previous token, so the loss can fall) and returns them as
int64 CPU tensors, torch's index type. After the tokens the same rng
draws the stub inputs, in the reference's order: the encoder-decoder's
frame embeddings ``enc_embeds`` (b, enc_seq, d) and the VLM's patch
embeddings ``img_embeds`` (b, n_patches, d), both bf16 (rounded once from
numpy's float64, as ``jnp.asarray`` rounds them), with a ``loss_mask``
that is 0 on the patches; M-RoPE's ``pos3`` (3, b, s) is ``arange(s)`` in
all three streams.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.models.common import ArchConfig


@dataclasses.dataclass
class DataState:
    """Everything needed to reproduce the stream: checkpointable."""
    seed: int
    step: int


class SyntheticLM:
    def __init__(self, cfg: ArchConfig, global_batch: int, seq_len: int,
                 seed: int = 0, host_id: int = 0, n_hosts: int = 1,
                 prefetch: int = 2):
        if global_batch % n_hosts:
            raise ValueError(f"global batch {global_batch} does not split "
                             f"over {n_hosts} hosts")
        self.cfg = cfg
        self.b_local = global_batch // n_hosts
        self.seq = seq_len
        self.state = DataState(seed=seed, step=0)
        self.host_id = host_id
        self._prefetch = prefetch
        self._q: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # zipfian unigram weights over a capped effective vocab
        v_eff = min(cfg.vocab, 32768)
        w = 1.0 / np.arange(1, v_eff + 1) ** 1.1
        self._probs = w / w.sum()
        self._v_eff = v_eff

    # -- deterministic batch materialisation ---------------------------
    def batch_at(self, step: int) -> Dict[str, Any]:
        rng = np.random.default_rng(
            (self.state.seed * 1_000_003 + step) * 31 + self.host_id)
        b, s = self.b_local, self.seq
        base = rng.choice(self._v_eff, size=(b, s + 1), p=self._probs)
        # learnable structure: every even position repeats the previous token
        base[:, 2::2] = base[:, 1:-1:2]
        batch = {"tokens": torch.from_numpy(base[:, :-1].astype(np.int64)),
                 "labels": torch.from_numpy(base[:, 1:].astype(np.int64))}
        cfg = self.cfg
        bf16 = lambda a: torch.from_numpy(a).to(torch.bfloat16)
        if cfg.encoder_decoder:
            batch["enc_embeds"] = bf16(rng.standard_normal(
                (b, cfg.enc_seq, cfg.d_model)) * 0.02)
        if cfg.n_patches:
            batch["img_embeds"] = bf16(rng.standard_normal(
                (b, cfg.n_patches, cfg.d_model)) * 0.02)
            mask = np.ones((b, s), np.float32)
            mask[:, :cfg.n_patches] = 0.0
            batch["loss_mask"] = torch.from_numpy(mask)
        if cfg.mrope:
            batch["pos3"] = torch.arange(s).expand(3, b, s).contiguous()
        return batch

    # -- iterator with background prefetch ------------------------------
    def _worker(self, start_step: int, q: queue.Queue):
        step = start_step
        while not self._stop.is_set():
            item = (step, self.batch_at(step))
            while not self._stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    pass
            step += 1

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        if self._thread is None:
            self._stop.clear()
            self._q = queue.Queue(maxsize=self._prefetch)
            self._thread = threading.Thread(
                target=self._worker, args=(self.state.step, self._q),
                daemon=True)
            self._thread.start()
        while True:
            step, batch = self._q.get()
            self.state.step = step + 1
            yield batch

    def close(self) -> None:
        """Stop the prefetch thread; a later ``iter`` starts a new one at
        ``state.step``."""
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=10)
            self._thread = None
