"""The program's own spans in a traced run, as the readers
``gangbench/metrics/{rt_backlog_ms, rt_dispatch_ms, be_wake_lag_ms,
decode_idle_in_enqueue_pct, decode_host_us_per_launch}`` take them.

``run.program_spans`` holds what ``repro_torch.obs.spans`` recorded
over the window (``drain()`` after the window, with the recorder enabled
before it): ``Span(name, lane, t0, t1, meta)`` in absolute
``time.monotonic()`` seconds, the clock of the benchmark's spans, whose
window origin is ``run.spans.origin``. A run without them (the recorder
was off, or a program that records none) gives each reader None.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def of(run, name: str) -> list:
    """The program's spans named ``name``, in absolute seconds."""
    return [s for s in getattr(run, "program_spans", None) or ()
            if s.name == name]


def rt_parts(run) -> List[Tuple[float, float, float]]:
    """(backlog, dispatch, run) in seconds of each RT quantum released in
    the window: the wait for the same job's previous instance, the time
    from then (or the release) to the quantum's admission, and the
    admission to the return of the job's callable. Their sum is the
    executor's response."""
    out = []
    for s in of(run, "executor.rt_quantum"):
        m = s.meta
        if m["release"] - run.spans.origin >= run.seconds:
            continue
        ready = m["release"] if m["prev_finish"] is None \
            else max(m["release"], m["prev_finish"])
        out.append((ready - m["release"], m["start"] - ready,
                    s.t1 - m["start"]))
    return out


def decode_enqueue(run) -> Optional[Tuple[np.ndarray, ...]]:
    """The window's decode steps (the benchmark's ``decode`` spans) and,
    clipped to them, lane 0's ``model.decode_fn`` spans, all after the
    window's origin: (step_lo, step_hi, enq_lo, enq_hi), or None without
    both."""
    steps = sorted((s.t0, s.t1) for s, _ in run.decodes())
    origin = run.spans.origin
    enq = [(s.t0 - origin, s.t1 - origin)
           for s in of(run, "model.decode_fn") if s.lane == 0]
    if not steps or not enq:
        return None
    lo = np.array([a for a, _ in steps])
    hi = np.array([b for _, b in steps])
    e0 = np.array([a for a, _ in enq])
    e1 = np.array([b for _, b in enq])
    i = np.searchsorted(lo, (e0 + e1) / 2, side="right") - 1
    inside = (i >= 0) & ((e0 + e1) / 2 < hi[np.maximum(i, 0)])
    i = i[inside]
    return (lo, hi, np.maximum(e0[inside], lo[i]),
            np.minimum(e1[inside], hi[i]))
