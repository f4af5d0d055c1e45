"""Open-loop serving through the port's slot engine.

Each RT quantum admits the requests that are due into free slots
(``ServingEngine.add_request``: the prompt's prefill and its first
token) and then runs one ``ServingEngine.decode_step`` over every busy
slot. A mix with ``prefill_tokens_per_quantum`` admits, after the first,
only prompts that keep the quantum's prompt tokens within it; the rest
wait for the next quantum. A request's time is taken from when it was due. A mix with
``busy_slots`` fills that many slots in set-up, at staggered progress
(``traffic.busy_slots``), so that the window opens in steady decode.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from gangbench.harness import model as M
from gangbench.harness import traffic as T
from gangbench.harness.spans import Spans


class Driver:
    leaf_spans = ("refill", "decode")     # spans inside an RT quantum
    token_spans = ("refill", "decode")    # spans that deliver tokens

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
        from repro_torch.serving.engine import Request, ServingEngine
        self.api, self.params = M.build(self.m, self.spec, self.seed,
                                        self.device)
        self.engine = ServingEngine(self.api, self.params,
                                    max_batch=int(self.mix["slots"]),
                                    max_seq=int(self.mix["max_seq"]))
        # the prompt lengths of the mix, longest first: the allocator grows
        # to the largest prefill before the window
        p = self.mix["prompt"]
        for n in (int(p["hi"]), int(p["lo"])):
            self.engine.warmup(prompt_len=n)
        self.arrivals = T.open_loop(self.mix, self.seed, self.seconds,
                                    self.m["vocab_size"])
        self.reqs = [Request(rid=a.rid, prompt=a.prompt, max_new=a.max_new)
                     for a in self.arrivals]
        self.next = 0
        self.busy = []
        if "busy_slots" in self.mix:
            for a in T.busy_slots(self.mix, self.seed, self.m["vocab_size"]):
                self.busy.append(Request(rid=a.rid, prompt=a.prompt,
                                         max_new=a.max_new))
                self.engine.add_request(self.busy[-1])
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def quantum(self, lane: int, idx: int) -> None:
        sp, eng = self.spans, self.engine
        budget = self.mix.get("prefill_tokens_per_quantum")
        admitted = 0
        while (self.next < len(self.reqs)
               and self.arrivals[self.next].due_s <= sp.now()
               and not eng.active.all()):
            a = self.arrivals[self.next]
            if admitted and budget is not None \
                    and admitted + len(a.prompt) > budget:
                break
            admitted += len(a.prompt)
            with sp.span("refill", lane, rid=a.rid, length=len(a.prompt),
                         tokens=1):
                eng.add_request(self.reqs[self.next])
            self.next += 1
        if eng.active.any():
            pos = [len(r.prompt) + len(r.out) - 1
                   for r in eng.slot_req if r is not None]
            with sp.span("decode", lane, tokens=len(pos), positions=pos):
                eng.decode_step()

    def requests(self) -> List[dict]:
        """Each request's due time, admission and first token (None if
        it never came)."""
        refill = {s.meta["rid"]: s for s in self.spans.of("refill")}
        out = []
        for a in self.arrivals:
            s = refill.get(a.rid)
            out.append({"due": a.due_s,
                        "admit": None if s is None else s.t0,
                        "first": None if s is None else s.t1})
        return out

    def attempted(self, window_s: float) -> int:
        return sum(a.due_s < window_s for a in self.arrivals)

    def samples(self, k: int) -> List[Tuple[np.ndarray, int, np.ndarray]]:
        """``k`` finished requests drawn from the seed, the longest among
        them: (prompt + served tokens but the last, prompt length,
        served tokens)."""
        done = [r for r in self.busy + self.reqs if r.done]
        if not done:
            return []
        longest = max(done, key=lambda r: len(r.prompt) + len(r.out))
        rest = [r for r in done if r is not longest]
        rng = T.rng_for(self.seed, 4)
        pick = [longest] + [rest[i] for i in sorted(rng.choice(
            len(rest), size=min(k - 1, len(rest)), replace=False))]
        return [(np.concatenate([r.prompt, np.asarray(r.out[:-1])]),
                 len(r.prompt), np.asarray(r.out)) for r in pick]

    def release(self) -> None:
        for name in ("engine", "api", "params"):
            setattr(self, name, None)
