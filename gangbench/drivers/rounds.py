"""A gang that serves batches in rounds through ``ModelApi.prefill_fn``
and ``ModelApi.decode_fn`` (the path of the families the slot engine does
not serve).

A round's first RT quantum prefills ``batch`` prompts of one length and
takes each one's first token; each later quantum decodes one token of
every sequence, until each has ``new_tokens``. The next quantum starts
the next round.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from gangbench.harness import model as M
from gangbench.harness import traffic as T
from gangbench.harness.spans import Spans


class Driver:
    leaf_spans = ("prefill", "decode")
    token_spans = ("prefill", "decode")

    def __init__(self, *, model: dict, mix: dict, seed: int,
                 seconds: float, device: torch.device, spans: Spans,
                 spec):
        self.m = model
        self.mix = mix
        self.seed = seed
        self.seconds = seconds
        self.device = device
        self.spans = spans
        self.spec = spec

    def setup(self) -> None:
        self.api, self.params = M.build(self.m, self.spec, self.seed,
                                        self.device)
        B = int(self.mix["batch"])
        # the longest and the shortest prompt of the mix, and a decode step
        p = self.mix["prompt"]
        for n in (int(p["hi"]), int(p["lo"])):
            tok = torch.zeros((B, n), dtype=torch.long, device=self.device)
            logits, caches = self.api.prefill_fn(self.params, {"tokens": tok})
            self.api.decode_fn(self.params, caches,
                               logits[:, -1].argmax(-1)[:, None],
                               torch.full((B,), n, device=self.device))
            del logits, caches
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.rounds: List[dict] = []      # finished rounds
        self.cur = None
        self.n_round = 0

    def quantum(self, lane: int, idx: int) -> None:
        sp, api = self.spans, self.api
        B = int(self.mix["batch"])
        if self.cur is None:
            r = self.n_round
            self.n_round += 1
            prompts = T.round_prompts(self.mix, self.seed, r,
                                      self.m["vocab_size"])
            n = prompts.shape[1]
            with sp.span("prefill", lane, round=r, batch=B, length=n,
                         tokens=B):
                logits, caches = api.prefill_fn(
                    self.params, {"tokens": torch.as_tensor(
                        prompts, device=self.device)})
                nxt = logits[:, -1].argmax(-1)
                host = nxt.cpu().numpy()
            self.cur = {"round": r, "prompts": prompts, "caches": caches,
                        "tok": nxt[:, None], "out": [host]}
        else:
            c = self.cur
            pos = c["prompts"].shape[1] + len(c["out"]) - 1
            with sp.span("decode", lane, tokens=B, positions=[pos] * B):
                logits, c["caches"] = api.decode_fn(
                    self.params, c["caches"], c["tok"],
                    torch.full((B,), pos, device=self.device))
                nxt = logits[:, -1].argmax(-1)
                c["out"].append(nxt.cpu().numpy())
            c["tok"] = nxt[:, None]
        if len(self.cur["out"]) == int(self.mix["new_tokens"]):
            c = self.cur
            self.rounds.append({"round": c["round"], "prompts": c["prompts"],
                                "out": np.stack(c["out"], axis=1)})
            self.cur = None

    def requests(self) -> List[dict]:
        return []

    def attempted(self, window_s: float) -> int:
        B = int(self.mix["batch"])
        return B * sum(s.t0 < window_s for s in self.spans.of("prefill"))

    def samples(self, k: int) -> List[Tuple[np.ndarray, int, np.ndarray]]:
        """``k`` sequences of finished rounds drawn from the seed, the
        first of the round with the longest prompts among them."""
        seqs = [(r["prompts"][b], r["out"][b]) for r in self.rounds
                for b in range(r["prompts"].shape[0])]
        if not seqs:
            return []
        first = max(range(len(seqs)), key=lambda i: len(seqs[i][0]))
        rest = [i for i in range(len(seqs)) if i != first]
        rng = T.rng_for(self.seed, 4)
        pick = [first] + [rest[i] for i in sorted(rng.choice(
            len(rest), size=min(k - 1, len(rest)), replace=False))]
        return [(np.concatenate([seqs[i][0], seqs[i][1][:-1]]),
                 len(seqs[i][0]), seqs[i][1]) for i in pick]

    def release(self) -> None:
        self.cur = None
        for name in ("api", "params"):
            setattr(self, name, None)
