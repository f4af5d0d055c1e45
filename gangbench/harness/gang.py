"""One measured window of the gang: the program's ``GangExecutor`` with the
cell's real-time job on lane 0 and the memory hog as the best-effort job
on lanes 0 and 1, each quantum bound to its lane's CUDA stream through
``repro_torch.device.Lanes``.

The RT job releases every ``period_s`` at priority 10 and declares the
gang's budget: the bytes of one hog quantum a regulation interval. The
hog copies one device buffer into another (``nbytes`` each, larger than
the card's 50 MB L2) and declares the bytes it moves, read and written.
Every quantum is wrapped in a span; the run waits for every quantum in
flight before it returns.
"""
from __future__ import annotations

import threading
import time
from typing import Callable

import torch

from gangbench.harness.spans import Spans

RT_PRIORITY = 5     # SCHED_RR priority of the lanes of a run on the CPU


class Hog:
    """The best-effort memory hog: per lane, a streaming copy between two
    buffers of ``nbytes``."""

    def __init__(self, device: torch.device, nbytes: int, n_lanes: int = 2):
        n = nbytes // 4
        self.bufs = [(torch.ones(n, dtype=torch.float32, device=device),
                      torch.empty(n, dtype=torch.float32, device=device))
                     for _ in range(n_lanes)]
        self.declared = 2 * 4 * n      # read once, written once

    def __call__(self, lane: int) -> None:
        src, dst = self.bufs[lane]
        dst.copy_(src)


class _Inflight:
    """Counts quanta in flight; ``wait`` until none is."""

    def __init__(self):
        self.n = 0
        self.cv = threading.Condition()

    def __enter__(self):
        with self.cv:
            self.n += 1

    def __exit__(self, *exc):
        with self.cv:
            self.n -= 1
            self.cv.notify_all()

    def wait(self, timeout: float) -> None:
        with self.cv:
            if not self.cv.wait_for(lambda: self.n == 0, timeout):
                raise RuntimeError(f"{self.n} quanta still in flight "
                                   f"{timeout} s after the run ended")


def run_window(*, device: torch.device, rt_fn: Callable[[int, int], None],
               hog: Hog, spans: Spans, seconds: float, drain_s: float,
               period_s: float, interval_s: float,
               profiler=None) -> dict:
    """Run the gang for ``seconds + drain_s``. The window's origin is the
    executor's start; ``spans`` is reset to it. With ``profiler`` (a
    started ``torch.profiler.profile``) a marker kernel on lane 0's stream
    ties the device clock to the spans' before the run. Returns the
    executor's stats, the executor and the lanes; raises the first
    exception a quantum raised."""
    from repro_torch.core.executor import BEJob, GangExecutor, RTJob
    from repro_torch.device import Lanes, host_lanes

    ex = GangExecutor(n_lanes=2, regulation_interval_s=interval_s)
    lanes = Lanes(device, ex.n_lanes)
    errors: list = []
    flight = _Inflight()
    rt_q = lanes.quantum(rt_fn, errors)
    be_q = lanes.quantum(hog, errors)

    def rt(lane, idx):
        with flight:
            t0 = spans.now()
            rt_q(lane, idx)
            spans.add("quantum", lane, t0, spans.now(), idx=idx)

    def be(lane):
        with flight:
            t0 = spans.now()
            be_q(lane)
            spans.add("hog", lane, t0, spans.now())

    ex.submit_rt(RTJob(name="rt", fn=rt, lanes=(0,), prio=10,
                       period_s=period_s, budget_bytes=float(hog.declared)))
    ex.submit_be(BEJob(name="hog", fn=be, lanes=(0, 1),
                       bytes_per_quantum=float(hog.declared)))
    marker = None
    if profiler is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
        with torch.cuda.stream(lanes.streams[0]):
            t_host = time.monotonic()
            torch.cuda._sleep(20000)
        torch.cuda.synchronize(device)
        marker = t_host
    with host_lanes(device, RT_PRIORITY):
        origin = time.monotonic()
        spans.reset(origin)
        stats = ex.run(seconds + drain_s)
    flight.wait(60.0)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if errors:
        raise errors[0]
    return {"stats": stats, "executor": ex, "lanes": lanes,
            "marker_s": None if marker is None else marker - origin}
