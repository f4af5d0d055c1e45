"""Batched serving engine with slot-based continuous batching (PyTorch
port of ``repro.serving.engine``; the slot logic is the same line for line).

The *decode step* of a latency-critical model is the real-time gang;
prefills of newly-arrived requests and background jobs are best-effort
work that RT-Gang throttles.

Slots: a fixed decode batch of B slots, each with its own cache position.
The KV cache is one (L, B, S, Hkv, D) tensor per k and v, updated in place
(the JAX engine donates it to the jitted decode step instead); a slot
refill zero-fills the slot and copies the prefilled KV into it.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.device import synchronize
from repro_torch.models.model import ModelApi


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray               # (S,) int32
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    done: bool = False


class ServingEngine:
    def __init__(self, api: ModelApi, params, *, max_batch: int,
                 max_seq: int, greedy: bool = True):
        self.api = api
        self.params = params
        self.B = max_batch
        self.S = max_seq
        self.device = api.device
        cfg = api.cfg
        self.cache_dtype = torch.bfloat16 if cfg.dtype == "bfloat16" \
            else torch.float32
        self._reset()
        self.greedy = greedy

    def _reset(self):
        cfg = self.api.cfg
        if cfg.family not in ("dense", "vlm", "moe"):
            raise ValueError("slot engine currently serves attention-cache "
                             "families")
        shp = (cfg.n_layers, self.B, self.S, cfg.n_kv_heads, cfg.head_dim)
        self.cache = {
            "k": torch.zeros(shp, dtype=self.cache_dtype, device=self.device),
            "v": torch.zeros(shp, dtype=self.cache_dtype, device=self.device)}
        self.pos = torch.zeros((self.B,), dtype=torch.long, device=self.device)
        self.tokens = torch.zeros((self.B, 1), dtype=torch.long,
                                  device=self.device)
        self.active = np.zeros((self.B,), bool)
        self.slot_req: List[Optional[Request]] = [None] * self.B
        self.decode_steps = 0

    # ------------------------------------------------------------------
    def warmup(self, prompt_len: int):
        """Run one request through prefill and decode ahead of serving (on
        the card this builds the model's kernels: flash attention, and the
        grouped matmul of an MoE model), then reset to fresh state and
        wait for the device."""
        dummy = Request(rid=-1, prompt=np.zeros((prompt_len,), np.int32),
                        max_new=1)
        self.add_request(dummy)
        self.decode_step()
        self._reset()
        synchronize(self.device)

    def add_request(self, req: Request) -> bool:
        free = [i for i in range(self.B) if not self.active[i]]
        if not free:
            return False
        slot = free[0]
        S_p = req.prompt.shape[0]
        if S_p > self.S:
            raise ValueError(f"prompt of {S_p} tokens exceeds max_seq "
                             f"{self.S}")
        batch = {"tokens": torch.as_tensor(req.prompt[None, :],
                                           dtype=torch.long,
                                           device=self.device)}
        logits, cache = self.api.prefill_fn(self.params, batch)
        # insert prefilled KV into the live cache at this slot
        for name in ("k", "v"):
            live = self.cache[name][:, slot]
            live.zero_()
            live[:, :S_p] = cache[name][:, 0]
        first = int(torch.argmax(logits[:, -1, :], dim=-1)[0])
        req.out.append(first)
        req.slot = slot
        self.active[slot] = True
        self.slot_req[slot] = req
        self.pos[slot] = S_p
        self.tokens[slot, 0] = first
        return True

    def decode_step(self):
        """One gang-schedulable decode quantum over all active slots."""
        if not self.active.any():
            return
        logits, self.cache = self.api.decode_fn(self.params, self.cache,
                                                self.tokens, self.pos)
        nxt = torch.argmax(logits[:, -1, :], dim=-1)
        nxt_host = nxt.cpu().numpy()
        pos_host = self.pos.cpu().numpy()
        self.decode_steps += 1
        for slot in range(self.B):
            if not self.active[slot]:
                continue
            req = self.slot_req[slot]
            req.out.append(int(nxt_host[slot]))
            if len(req.out) >= req.max_new or \
                    int(pos_host[slot]) + 2 >= self.S:
                req.done = True
                self.active[slot] = False
                self.slot_req[slot] = None
        self.pos = self.pos + 1
        self.tokens = nxt[:, None]

    def run_until_done(self, reqs: List[Request], max_steps: int = 10_000):
        pending = list(reqs)
        steps = 0
        while (pending or self.active.any()) and steps < max_steps:
            while pending and self.add_request(pending[0]):
                pending.pop(0)
            self.decode_step()
            steps += 1
        return reqs
