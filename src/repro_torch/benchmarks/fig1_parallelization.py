"""Paper Fig.1 on the port: (a) the DAVE-2 control-loop time when a batch
of 8 frames is split over 1/2/4 parts; (b) its slowdown beside a
memory-intensive co-runner.

``benchmarks/fig1_parallelization.py`` on the card. (a) Each part runs on
a CUDA stream of its own, launched from one host thread and joined before
the clock stops: the GPU's form of per-core work. (b) A thread runs
``(a * 1.000001 + a.T).sum()`` on a 1024² f32 tensor back to back, on its
own stream, while the DNN runs on another: PyTorch's current stream is per
thread, so two threads left on the default stream would queue behind each
other instead of contending.

    python -m repro_torch.benchmarks.fig1_parallelization [--device cpu]
"""
from __future__ import annotations

import argparse
import contextlib
import threading
import time
from typing import Callable, Iterator, List, Optional

import torch

from repro_torch.configs.deeppicar import CONFIG
from repro_torch.device import resolve_device, synchronize
from repro_torch.models.dave2 import make_dave2

BATCH = 8
MEM_SHAPE = (1024, 1024)


def new_stream(device: torch.device) -> Optional[torch.cuda.Stream]:
    return torch.cuda.Stream(device) if device.type == "cuda" else None


def on(stream: Optional[torch.cuda.Stream]):
    """Make ``stream`` current (nothing to do on the CPU)."""
    return torch.cuda.stream(stream) if stream is not None else \
        contextlib.nullcontext()


def time_fn(fn: Callable, stream: Optional[torch.cuda.Stream],
            iters: int = 20) -> float:
    """Mean wall ms of ``fn()`` over ``iters`` calls after one warm-up,
    the clock stopped once ``stream`` (where ``fn``'s result is made) has
    drained."""
    fn()
    if stream is not None:
        stream.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    if stream is not None:
        stream.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def mem_benchmark(a: torch.Tensor) -> torch.Tensor:
    return (a * 1.000001 + a.T).sum()


@contextlib.contextmanager
def hammering(device: torch.device) -> Iterator[None]:
    """Run ``mem_benchmark`` back to back in a thread, on a stream of its
    own, for the length of the block (from its first finished call on);
    what the thread raised is raised when the block ends."""
    mem = torch.ones(MEM_SHAPE, device=device)
    stream = new_stream(device)
    synchronize(device)
    stop, started = threading.Event(), threading.Event()
    errors: List[BaseException] = []

    def hammer():
        try:
            with on(stream):
                while not stop.is_set():
                    mem_benchmark(mem)
                    if stream is not None:
                        stream.synchronize()
                    started.set()
        except BaseException as e:
            errors.append(e)
            started.set()

    th = threading.Thread(target=hammer, daemon=True)
    th.start()
    started.wait(timeout=60)
    try:
        yield
    finally:
        stop.set()
        th.join(timeout=60)
    if errors:
        raise errors[0]
    if th.is_alive():
        raise RuntimeError("the memory co-runner did not stop")


def run(device: Optional[str | torch.device] = None) -> List[dict]:
    dev = resolve_device(device)
    cfg = CONFIG
    _, model = make_dave2(cfg, device=dev)
    img = torch.ones((BATCH, *cfg.input_hw, cfg.in_channels), device=dev)
    home = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
    synchronize(dev)

    # (a) parallelization: the frame batch split over n parts, each on a
    # stream of its own, joined on the calling stream
    rows = []
    for n in (1, 2, 4):
        chunk = BATCH // n
        streams = [new_stream(dev) for _ in range(n)]

        def split_fn(streams=streams, chunk=chunk):
            outs = []
            for i, s in enumerate(streams):
                if s is not None:
                    s.wait_stream(home)
                with on(s):
                    outs.append(model(img[i * chunk:(i + 1) * chunk]))
            for s, o in zip(streams, outs):
                if s is not None:
                    home.wait_stream(s)
                    o.record_stream(home)
            return torch.cat(outs)
        t = time_fn(split_fn, home)
        rows.append({"bench": "fig1a", "cores": n, "loop_ms": round(t, 3)})

    # (b) co-run: DNN inference while a memory benchmark hammers the bus
    dnn_stream = new_stream(dev)

    def dnn():
        with on(dnn_stream):
            return model(img)
    solo = time_fn(dnn, dnn_stream)
    with hammering(dev):
        corun = time_fn(dnn, dnn_stream, iters=10)

    mem = torch.ones(MEM_SHAPE, device=dev)
    mem_stream = new_stream(dev)
    synchronize(dev)

    def mem_fn():
        with on(mem_stream):
            return mem_benchmark(mem)
    mem_solo = time_fn(mem_fn, mem_stream)
    rows.append({"bench": "fig1b", "dnn_solo_ms": round(solo, 3),
                 "dnn_corun_ms": round(corun, 3),
                 "dnn_slowdown": round(corun / solo, 2),
                 "mem_solo_ms": round(mem_solo, 3)})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rows = run(args.device)
    for r in rows:
        print(r)
    return rows


if __name__ == "__main__":
    main()
