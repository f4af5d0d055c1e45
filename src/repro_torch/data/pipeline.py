"""Data pipeline of the port: a deterministic synthetic LM stream and
memory-mapped token files, with step-indexed sampling so that a restart
from a checkpoint resumes the exact batch sequence (counterpart of
``repro.data.pipeline``). ``DataConfig`` and ``TokenSource`` are numpy and
are the JAX package's, as they are; ``ShardedLoader`` puts each batch on
the device (the mesh and its batch axes wait for the mesh port)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch


@dataclasses.dataclass
class DataConfig:
    seq_len: int
    global_batch: int
    vocab_size: int
    seed: int = 0
    path: Optional[str] = None        # None => synthetic
    n_vision_tokens: int = 0
    d_model: int = 0                  # for vlm/audio stub inputs
    n_frames: int = 0


class TokenSource:
    """step -> global batch of token ids, deterministically."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._mm = None
        if cfg.path:
            self._mm = np.memmap(cfg.path, dtype=np.int32, mode="r")

    def batch_at(self, step: int) -> np.ndarray:
        cfg = self.cfg
        B, S = cfg.global_batch, cfg.seq_len
        if self._mm is None:
            rng = np.random.default_rng((cfg.seed << 32) ^ step)
            # markov-ish synthetic stream: makes loss measurably decrease
            base = rng.integers(0, cfg.vocab_size, size=(B, 1), dtype=np.int32)
            drift = rng.integers(0, 7, size=(B, S), dtype=np.int32)
            toks = (base + np.cumsum(drift, axis=1)) % cfg.vocab_size
            return toks.astype(np.int32)
        n_tok = self._mm.shape[0]
        n_seq = (n_tok - 1) // S
        idx = (step * B + np.arange(B)) % n_seq
        out = np.empty((B, S + 1), np.int32)
        for i, j in enumerate(idx):
            out[i] = self._mm[j * S: j * S + S + 1]
        return out

    def train_batch(self, step: int) -> Dict[str, np.ndarray]:
        toks = self.batch_at(step)
        cfg = self.cfg
        if toks.shape[1] == cfg.seq_len + 1:
            tokens, labels = toks[:, :-1], toks[:, 1:]
        else:
            tokens = toks
            labels = np.concatenate(
                [toks[:, 1:], np.full((toks.shape[0], 1), -100, np.int32)],
                axis=1)
        batch = {"tokens": tokens, "labels": labels.astype(np.int32)}
        if cfg.n_vision_tokens:
            rng = np.random.default_rng((cfg.seed << 32) ^ (step + 7))
            batch["patches"] = rng.normal(
                size=(cfg.global_batch, cfg.n_vision_tokens, cfg.d_model)
            ).astype(np.float32) * 0.02
            batch["labels"][:, :cfg.n_vision_tokens] = -100
        if cfg.n_frames:
            rng = np.random.default_rng((cfg.seed << 32) ^ (step + 13))
            batch["frames"] = rng.normal(
                size=(cfg.global_batch, cfg.n_frames, cfg.d_model)
            ).astype(np.float32) * 0.02
        return batch


class ShardedLoader:
    """Puts host batches on the device; resumable from any step."""

    def __init__(self, source: TokenSource, device: torch.device):
        self.source = source
        self.device = device

    def _shard(self, batch: Dict[str, np.ndarray]):
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in batch.items()}

    def iterate(self, start_step: int = 0) -> Iterator:
        step = start_step
        while True:
            yield step, self._shard(self.source.train_batch(step))
            step += 1
