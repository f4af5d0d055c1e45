"""The benchmark's own spans around the calls into each layer.

A span is (name, lane, start, end, meta) in seconds after the window's
origin, on the executor's clock (``time.monotonic``). Spans are kept in a
list in memory (appending is atomic under the interpreter lock) and read
when the run ends.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Iterator, List


@dataclasses.dataclass
class Span:
    name: str
    lane: int
    t0: float
    t1: float
    meta: Dict

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


class Spans:
    def __init__(self):
        self.items: List[Span] = []
        self.origin = time.monotonic()

    def now(self) -> float:
        """Seconds since the origin."""
        return time.monotonic() - self.origin

    def reset(self, origin: float) -> None:
        self.items.clear()
        self.origin = origin

    @contextlib.contextmanager
    def span(self, name: str, lane: int, **meta) -> Iterator[Dict]:
        """Record the block as a span; the yielded dict is its meta, which
        the block may fill in."""
        t0 = self.now()
        yield meta
        self.items.append(Span(name, lane, t0, self.now(), meta))

    def add(self, name: str, lane: int, t0: float, t1: float,
            **meta) -> None:
        self.items.append(Span(name, lane, t0, t1, meta))

    def of(self, name: str) -> List[Span]:
        return [s for s in self.items if s.name == name]
