"""The one traffic generator: a mix's parameters and a seed in, the work
of a run out.

Every seed gets the same requests, due at the same times, and its own
token ids: lengths are the quantiles ``(i + 0.5) / n`` of the mix's
distribution and gaps those of an exponential at the mix's rate, each
list in one shuffled order that the mix's ``schedule_seed`` fixes; the
token ids are drawn from the run's seed. So two seeds carry the same work
and the same bursts, and a tail such as the 90th percentile of time to
first token does not swing with where a seed puts its longest prompts. A
mix in rounds takes its lengths from the van der Corput sequence, the
same for every seed.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A numpy generator for ``seed`` (any whole number) and a stream."""
    return np.random.default_rng([int(seed) % 2**63, *stream])


def quantiles(dist: dict, n: int) -> np.ndarray:
    """The ``n`` quantiles ``(i + 0.5) / n`` of ``dist``: {"dist":
    "loguniform" | "uniform", "lo", "hi"} as whole numbers in [lo, hi]."""
    u = (np.arange(n) + 0.5) / n
    return _inverse(dist, u)


def _inverse(dist: dict, u: np.ndarray) -> np.ndarray:
    lo, hi = float(dist["lo"]), float(dist["hi"])
    if dist["dist"] == "loguniform":
        x = np.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    elif dist["dist"] == "uniform":
        x = lo + u * (hi - lo)
    else:
        raise ValueError(f"unknown distribution {dist['dist']!r}")
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


def van_der_corput(i: int) -> float:
    """The i-th point (i >= 1) of the base-2 van der Corput sequence:
    0.5, 0.25, 0.75, 0.125, ..."""
    x, f = 0.0, 0.5
    while i:
        x += f * (i & 1)
        i >>= 1
        f /= 2
    return x


@dataclasses.dataclass
class Arrival:
    rid: int
    due_s: float            # seconds after the window opens
    prompt: np.ndarray      # (S,) int32
    max_new: int


def open_loop(mix: dict, seed: int, seconds: float,
              vocab: int) -> List[Arrival]:
    """Requests due in [0, seconds): round(rate x seconds) of them, gaps of
    an exponential at ``rate_per_s`` scaled to end inside the window (the
    first request due after the first gap), prompt lengths
    ``mix["prompt"]``, output lengths ``mix["output"]``; the order from
    ``mix["schedule_seed"]``, the token ids from ``seed``."""
    rate = float(mix["rate_per_s"])
    n = max(1, int(round(rate * seconds)))
    rng = rng_for(int(mix["schedule_seed"]), 1)
    u = (np.arange(n) + 0.5) / n
    gaps = rng.permutation(-np.log1p(-u) / rate)
    due = np.cumsum(gaps)
    # the same gaps for every seed sum to the same total: scale them so
    # that the last request is due a mean gap before the window closes
    due *= seconds * n / (n + 1) / due[-1]
    prompts = rng.permutation(quantiles(mix["prompt"], n))
    outs = rng.permutation(quantiles(mix["output"], n))
    tok = rng_for(seed, 2)
    return [Arrival(rid=i, due_s=float(due[i]),
                    prompt=tok.integers(0, vocab, size=int(prompts[i]),
                                        dtype=np.int64).astype(np.int32),
                    max_new=int(outs[i]))
            for i in range(n)]


def busy_slots(mix: dict, seed: int, vocab: int) -> List[Arrival]:
    """The requests that fill ``mix["busy_slots"]`` slots before the window,
    at staggered progress: request i of n has already been served the
    share (i + 0.5) / n of its output, so its prompt is the mix's prompt
    followed by that many tokens and it has the rest to go. Sizes as in
    ``open_loop`` (order from ``schedule_seed``), token ids from ``seed``."""
    n = int(mix["busy_slots"])
    rng = rng_for(int(mix["schedule_seed"]), 5)
    prompts = rng.permutation(quantiles(mix["prompt"], n))
    outs = rng.permutation(quantiles(mix["output"], n))
    tok = rng_for(seed, 6)
    out = []
    for i in range(n):
        served = int((i + 0.5) / n * outs[i])
        out.append(Arrival(
            rid=-1 - i, due_s=-math.inf,
            prompt=tok.integers(0, vocab, size=int(prompts[i]) + served,
                                dtype=np.int64).astype(np.int32),
            max_new=int(outs[i]) - served))
    return out


def round_length(mix: dict, r: int) -> int:
    """Prompt length of round ``r`` (0, 1, ...): the (r + 1)-th van der
    Corput point of ``mix["prompt"]``, the same for every seed."""
    return int(_inverse(mix["prompt"], np.array([van_der_corput(r + 1)]))[0])


def round_prompts(mix: dict, seed: int, r: int, vocab: int) -> np.ndarray:
    """(batch, length) prompt ids of round ``r``."""
    n = round_length(mix, r)
    return rng_for(seed, 3, r).integers(
        0, vocab, size=(int(mix["batch"]), n), dtype=np.int64)
