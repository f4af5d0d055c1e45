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
"""
from __future__ import annotations

import functools
from typing import Callable, List, Optional

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
