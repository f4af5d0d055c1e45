"""Nested host spans inside the port, on one process-wide recorder.

Off by default. ``enable()`` turns it on, ``disable()`` off, and
``drain()`` hands over what it holds and starts an empty list; nothing
reads the environment. Off, a site costs one attribute test
(``RECORDER.on``): ``span`` returns the one shared ``NOOP`` context
manager and allocates nothing. On, each span closes into one
``Span(name, lane, t0, t1, meta)`` appended to a list (an append is
atomic under the interpreter lock).

Times are absolute ``time.monotonic()`` seconds: the clock of
``GangExecutor`` (its ``_t0``), so a span falls on the executor's
timeline, and on any device trace tied to that clock, without a new
alignment. The lane is a thread-local that the executor's worker sets
once (``set_lane``): code below the executor, such as ``ModelApi``,
records its lane without knowing it; outside a lane it is None.

Names are dotted by layer: ``executor.rt_quantum``,
``executor.be_quantum`` and the instant ``executor.be_denied``
(core/executor.py); ``model.prefill_fn`` and ``model.decode_fn``
(models/model.py). ``obs.perfetto.export_trace`` writes them beside the
executor's lanes.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, NamedTuple, Optional


class Span(NamedTuple):
    name: str
    lane: Optional[int]
    t0: float          # time.monotonic() seconds
    t1: float          # == t0 for an instant
    meta: Dict


class Recorder:
    __slots__ = ("on", "items")

    def __init__(self):
        self.on = False
        self.items: List[Span] = []

    def add(self, name: str, lane: Optional[int], t0: float, t1: float,
            meta: Dict) -> None:
        """Append one finished span (callers test ``on`` first)."""
        self.items.append(Span(name, lane, t0, t1, meta))


RECORDER = Recorder()
_local = threading.local()


def enable() -> None:
    RECORDER.on = True


def disable() -> None:
    RECORDER.on = False


def drain() -> List[Span]:
    """The spans recorded so far, in the order they closed; the recorder
    keeps recording into a new list if it is on."""
    items, RECORDER.items = RECORDER.items, []
    return items


def set_lane(lane: Optional[int]) -> None:
    """Name the calling thread's lane for every span it records."""
    _local.lane = lane


def lane() -> Optional[int]:
    return getattr(_local, "lane", None)


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


class _Open:
    __slots__ = ("name", "meta", "t0")

    def __init__(self, name: str, meta: Dict):
        self.name = name
        self.meta = meta

    def __enter__(self) -> Dict:
        self.t0 = time.monotonic()
        return self.meta

    def __exit__(self, *exc):
        RECORDER.add(self.name, lane(), self.t0, time.monotonic(),
                     self.meta)
        return False


def span(name: str, **meta):
    """``with span(name, **meta) as m:`` records the block on the calling
    thread's lane; ``m`` is the span's meta, which the block may fill in
    (None while the recorder is off)."""
    if not RECORDER.on:
        return NOOP
    return _Open(name, meta)
