"""The comparisons that decide ``correct``.

* Served tokens against the plain reference: for every served token of a
  sample of finished requests, how far its logit lies below the best
  logit of the float32 reference at that position. Greedy serving puts the
  best first, so a sound run reads only the rounding of near ties.
* The gang's isolation: best-effort quanta that start while the RT gang
  runs a quantum may together move no more than the gang's budget per
  regulation interval on their lane, and no two RT quanta overlap.
"""
from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch

from gangbench.harness.spans import Span


def token_gaps(ref_logits: Sequence[torch.Tensor],
               served: Sequence[np.ndarray]) -> np.ndarray:
    """For every served token, how far its logit lies below the
    reference's best logit at that position."""
    out = []
    for lg, tok in zip(ref_logits, served):
        t = torch.as_tensor(np.asarray(tok), device=lg.device).long()
        gap = lg.max(dim=-1).values - lg.gather(-1, t[:, None])[:, 0]
        out.append(gap.double().cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0)


def gap_stats(gaps: np.ndarray) -> dict:
    """The widest gap, the mean gap over every served token, and the share
    of tokens that are not the reference's best."""
    if not len(gaps):
        return {"max": None, "mean": None, "mismatch": None}
    return {"max": float(gaps.max()), "mean": float(gaps.mean()),
            "mismatch": float((gaps > 0).mean())}


def control_gaps(ref_logits: Sequence[torch.Tensor],
                 low_logits: Sequence[torch.Tensor]) -> np.ndarray:
    """The gaps of the tokens that a lower-precision reference puts first
    at each position of the same sequences."""
    return token_gaps(ref_logits, [lo.argmax(-1).cpu().numpy()
                                   for lo in low_logits])


MAX_WINDOWS = 64    # the longest run of regulation windows read


def budget_ratio(spans: Sequence[Span], budget: float, declared: float,
                 interval_s: float) -> float:
    """Worst ratio, over runs of consecutive best-effort quanta on one
    lane that start inside RT quanta, of the bytes they declared to the
    budget of the regulation windows their admissions can span.

    Quanta i..j start at s_i <= ... <= s_j; each was admitted (charged)
    less than two intervals before it started (a lane thread may wait that
    long for the interpreter lock between the two), so their charges fall
    in fewer than floor((s_j - s_i) / interval) + 4 windows of the
    regulator's grid, each of which admits at most ``budget`` bytes. A
    sound executor reads at most 1; one that does not throttle reads the
    quanta a window over 4. Runs spanning up to ``MAX_WINDOWS`` intervals
    are read: a leak shows in short runs first."""
    rt = sorted((s.t0, s.t1) for s in spans if s.name == "quantum")
    if not rt:
        return 0.0
    a = np.array([r[0] for r in rt])
    b = np.array([r[1] for r in rt])
    worst = 0.0
    for lane in sorted({s.lane for s in spans if s.name == "hog"}):
        st = np.sort(np.array([s.t0 for s in spans
                               if s.name == "hog" and s.lane == lane]))
        k = np.searchsorted(a, st, side="right") - 1
        st = st[(k >= 0) & (st < b[np.maximum(k, 0)])]
        if not len(st):
            continue
        first = np.arange(len(st))
        for d in range(MAX_WINDOWS):
            # the last quantum j with floor((s_j - s_i) / interval) <= d
            last = np.searchsorted(st, st + (d + 1) * interval_s,
                                   side="left") - 1
            n = (last - first + 1).max()
            worst = max(worst, float(n * declared / ((d + 4) * budget)))
    return worst


def rt_overlap_s(spans: Sequence[Span]) -> float:
    """Time during which two RT quanta ran at once."""
    rt = sorted((s.t0, s.t1) for s in spans if s.name == "quantum")
    total, end = 0.0, -math.inf
    for t0, t1 in rt:
        total += max(0.0, min(end, t1) - t0)
        end = max(end, t1)
    return total


def finite(x):
    """``x``, or None where it is not a finite number."""
    return x if x is not None and math.isfinite(x) else None


def passes(c: dict) -> bool:
    """A check holds: its value at most its limit, or at least it where
    the check says ``at_least``; a value that is missing fails."""
    if c["value"] is None:
        return False
    if c.get("at_least"):
        return c["value"] >= c["limit"]
    return c["value"] <= c["limit"]


def lines(checks: dict) -> List[str]:
    return [f"check {name} {c['value']!r} "
            f"{'>=' if c.get('at_least') else '<='} limit {c['limit']!r} "
            f"{'ok' if passes(c) else 'FAILED'}"
            for name, c in checks.items()]
