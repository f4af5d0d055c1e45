"""Device resolution and the GPU lane model.

``resolve_device`` picks the device an entry point runs on: ``cuda``
unless the caller asks for the CPU. Asking for the card where there is
none raises; nothing quietly drops to the CPU.

:class:`Lanes` binds the executor's lanes to the card. Each lane owns a
CUDA stream, and ``on_lane(fn)`` wraps a quantum callable so that, in the
lane's worker thread, ``fn`` runs with that stream current and the stream
is synchronized before the wrapper returns. That synchronize is what ends
a quantum on the GPU, as ``block_until_ready`` or a host read does in the
JAX executor. PyTorch's current stream is per thread: without the wrapper
a quantum would last only as long as its launches, and best-effort
quanta would co-run with the gang unseen by the executor.
``quantum(fn, errors)`` adds what every caller needs on top: an exception
in a quantum ends only its lane's worker thread, so the wrapper keeps it
in ``errors`` for the caller to raise after the run.

``host_lanes(device, priority)`` sets up the host for an executor run on
the CPU, where a lane is one host thread and not a stream.
"""
from __future__ import annotations

import contextlib
import functools
import gc
import os
from typing import Callable, Iterator, List, Optional

import torch


def resolve_device(device: Optional[str | torch.device] = None
                   ) -> torch.device:
    """``None`` means ``cuda``. Raises if the card is asked for and
    ``torch.cuda.is_available()`` is False."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was asked for but torch.cuda.is_available() is "
            "False; pass device='cpu' (--device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@contextlib.contextmanager
def host_lanes(device: torch.device, priority: int) -> Iterator[None]:
    """On the CPU, run the block on one intra-op thread, with this thread
    (and so every lane thread the executor starts from it: threads inherit
    the policy) under ``SCHED_RR`` at ``priority`` where the OS allows it,
    as RT-Gang runs its real-time tasks, and with the cyclic garbage
    collector off after one full collection; all three are restored
    afterwards. Concurrent lanes whose products each fan out over every
    intra-op thread oversubscribe the cores; beside other processes that
    keep every core busy a lane thread of normal priority waits 100-300 ms
    for a core after its release; and in a process that holds a large
    heap (one that has run other work first) a full collection holds the
    interpreter lock for ~200 ms, stalling every lane at once. On the card
    the block runs as it is."""
    if device.type != "cpu":
        yield
        return
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        policy = (os.sched_getscheduler(0), os.sched_getparam(0))
        os.sched_setscheduler(0, os.SCHED_RR, os.sched_param(priority))
    except (AttributeError, OSError):
        policy = None
    collecting = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        if collecting:
            gc.enable()
        torch.set_num_threads(threads)
        if policy is not None:
            os.sched_setscheduler(0, *policy)


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Lanes:
    """One CUDA stream per executor lane (none on the CPU)."""

    def __init__(self, device: torch.device, n_lanes: int):
        self.device = device
        self.streams: List[Optional[torch.cuda.Stream]] = [
            torch.cuda.Stream(device=device) if device.type == "cuda"
            else None for _ in range(n_lanes)]

    def on_lane(self, fn: Callable) -> Callable:
        """Wrap ``fn(lane, *args)`` to run on the lane's stream and end
        only when that stream has drained."""
        if self.device.type != "cuda":
            return fn

        @functools.wraps(fn)
        def run(lane: int, *args):
            stream = self.streams[lane]
            with torch.cuda.stream(stream):
                out = fn(lane, *args)
            stream.synchronize()
            return out
        return run

    def quantum(self, fn: Callable, errors: List[BaseException]) -> Callable:
        """``on_lane(fn)`` that also appends any exception it raises (``fn``'s,
        or a device fault surfacing at the stream's synchronize) to
        ``errors``, and re-raises it. The executor's worker thread dies
        with the exception while ``run`` goes on, so the caller raises
        ``errors[0]`` after the run: no lane fails silently."""
        run = self.on_lane(fn)

        def q(lane: int, *args):
            try:
                return run(lane, *args)
            except BaseException as e:
                errors.append(e)
                raise
        return q
