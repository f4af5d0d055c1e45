"""The device trace of a traced run, on the spans' clock.

``torch.profiler`` records every device operation (CUDA activity only:
no host op events). The marker kernel that ``gang.run_window`` launches
on lane 0's stream before the window names that stream and ties the
trace's clock to the spans'.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from gangbench.harness.spans import Span

MARKER = "spin_kernel"


@dataclasses.dataclass
class DeviceTrace:
    names: List[str]        # distinct operation names
    name_id: np.ndarray     # each operation's index into ``names``
    stream: np.ndarray      # resource (stream) id of each operation
    t0: np.ndarray          # seconds after the window's origin
    t1: np.ndarray
    rt_stream: Optional[int]

    def select(self, pattern: str) -> np.ndarray:
        """Mask of the operations whose name matches ``pattern``."""
        rx = re.compile(pattern)
        hit = np.array([bool(rx.search(n)) for n in self.names], bool)
        return hit[self.name_id] if len(self.names) else \
            np.zeros(0, bool)


def start():
    import torch
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    return prof


def read(prof, marker_s: float) -> DeviceTrace:
    """Stop ``prof`` and return its device operations, the marker's start
    put at ``marker_s`` (its host launch time after the origin)."""
    prof.stop()
    ids: Dict[str, int] = {}
    name_id, stream, start, dur = [], [], [], []
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA"):
            name_id.append(ids.setdefault(e.name(), len(ids)))
            stream.append(e.device_resource_id())
            start.append(e.start_ns())
            dur.append(e.duration_ns())
    names = list(ids)
    name_id = np.array(name_id, dtype=np.int64)
    stream = np.array(stream, dtype=np.int64)
    start = np.array(start, dtype=np.int64)
    dur = np.array(dur, dtype=np.int64)
    marks = [i for n, i in ids.items() if MARKER in n]
    if not marks:
        raise RuntimeError("the device trace holds no marker kernel")
    is_mark = np.isin(name_id, marks)
    k = np.nonzero(is_mark)[0][np.argmin(start[is_mark])]
    keep = np.ones(len(start), bool)
    keep[k] = False
    t0 = (start - start[k]) * 1e-9 + marker_s
    return DeviceTrace(names=names, name_id=name_id[keep],
                       stream=stream[keep], t0=t0[keep],
                       t1=t0[keep] + dur[keep] * 1e-9,
                       rt_stream=int(stream[k]))


def union(t0: np.ndarray, t1: np.ndarray, lo: float, hi: float
          ) -> Tuple[np.ndarray, np.ndarray]:
    """Disjoint sorted intervals covering [t0, t1) clipped to [lo, hi)."""
    a = np.clip(t0, lo, hi)
    b = np.clip(t1, lo, hi)
    keep = b > a
    a, b = a[keep], b[keep]
    if not len(a):
        return a, b
    order = np.argsort(a, kind="stable")
    a, b = a[order], np.maximum.accumulate(b[order])
    new = np.ones(len(a), bool)
    new[1:] = a[1:] > b[:-1]
    starts = a[new]
    ends = b[np.r_[np.nonzero(new)[0][1:] - 1, len(a) - 1]]
    return starts, ends


def covered(starts: np.ndarray, ends: np.ndarray, lo: np.ndarray,
            hi: np.ndarray) -> np.ndarray:
    """For each [lo, hi), the time the disjoint intervals cover in it."""
    if not len(starts):
        return np.zeros(len(lo))
    cum = np.r_[0.0, np.cumsum(ends - starts)]

    def upto(t):
        # covered time in (-inf, t)
        i = np.searchsorted(starts, t, side="right")
        prev_end = np.where(i > 0, ends[np.maximum(i - 1, 0)], -np.inf)
        part = np.where(i > 0, np.minimum(t, prev_end)
                        - starts[np.maximum(i - 1, 0)], 0.0)
        return cum[np.maximum(i - 1, 0)] * (i > 0) + np.maximum(part, 0.0)
    return upto(np.asarray(hi, float)) - upto(np.asarray(lo, float))


def busy_s(tr: DeviceTrace, window_s: float) -> float:
    s, e = union(tr.t0, tr.t1, 0.0, window_s)
    return float((e - s).sum())


def top_ops(tr: DeviceTrace, window_s: float, n: int = 10
            ) -> List[List]:
    """The ``n`` device operations that took the most time in the window,
    by name."""
    dur = np.clip(tr.t1, 0, window_s) - np.clip(tr.t0, 0, window_s)
    total = np.bincount(tr.name_id, weights=np.maximum(dur, 0.0),
                        minlength=len(tr.names))
    top = np.argsort(-total)[:n]
    return [[tr.names[i][:160], float(total[i])] for i in top
            if total[i] > 0]


def idle_gaps(tr: DeviceTrace, spans: Sequence[Span], window_s: float,
              leaf_names: Sequence[str], n: int = 10) -> List[List]:
    """Idle time of the device in the window, summed by what the host was
    doing: the innermost of the benchmark's spans open on lane 0 (a leaf
    span, else the RT quantum), else a hog quantum on lane 1, else
    "executor wait". The ``n`` largest sums."""
    s, e = union(tr.t0, tr.t1, 0.0, window_s)
    gap_lo = np.r_[0.0, e]
    gap_hi = np.r_[s, window_s]
    keep = gap_hi > gap_lo
    gap_lo, gap_hi = gap_lo[keep], gap_hi[keep]
    mid = (gap_lo + gap_hi) / 2
    labels = ["executor wait"]
    label = np.zeros(len(mid), np.int64)

    def mark(cands, text_of):
        if not cands:
            return
        cands = sorted(cands, key=lambda sp: sp.t0)
        a = np.array([sp.t0 for sp in cands])
        b = np.array([sp.t1 for sp in cands])
        i = np.searchsorted(a, mid, side="right") - 1
        free = (i >= 0) & (mid < b[np.maximum(i, 0)]) & (label == 0)
        texts = {}
        for k in np.nonzero(free)[0]:
            t = text_of(cands[i[k]])
            if t not in texts:
                texts[t] = len(labels)
                labels.append(t)
            label[k] = texts[t]

    mark([sp for sp in spans if sp.lane == 0 and sp.name in leaf_names],
         lambda sp: sp.name)
    mark([sp for sp in spans if sp.lane == 0 and sp.name == "quantum"],
         lambda sp: "rt quantum, between calls")
    mark([sp for sp in spans if sp.lane == 0 and sp.name == "hog"],
         lambda sp: "hog quantum (lane 0)")
    mark([sp for sp in spans if sp.lane == 1 and sp.name == "hog"],
         lambda sp: "hog quantum (lane 1)")
    total = np.bincount(label, weights=gap_hi - gap_lo,
                        minlength=len(labels))
    top = np.argsort(-total)[:n]
    return [[labels[i], float(total[i])] for i in top if total[i] > 0]
