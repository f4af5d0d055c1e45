"""Metrics registry: labeled counter/gauge/histogram series (DESIGN.md §12.1).

The instruments are deliberately slotted objects with plain attribute
arithmetic — the engines pre-resolve them once (at construction or run
start) and the hot paths do ``c.value += 1``, so instrumenting the event
loop costs about what the old ad-hoc ``self.x += 1`` fields cost
(bench_sim.py's ``obs_overhead`` entries measure exactly this and
assert < 5% on the 16-core workload).

Series naming: ``name`` plus sorted ``key=value`` labels, rendered as
``name{k=v,k2=v2}`` in snapshots (``name`` alone when unlabeled).
``counter(...)`` is get-or-create: two components asking for the same
(name, labels) share one Counter object — that is how the engines and
the FaultManager co-own ``task.misses{gang=...}`` without double
bookkeeping.

Parity contract: instruments created with ``parity=True`` must be
integers that both simulator engines reproduce *exactly* (lock
acquisitions, preemptions, IPIs, per-core throttle trips, per-task
releases/completions/misses, fault counts). ``parity_snapshot()``
returns only those; tests/test_obs.py asserts byte-identical snapshots
across engines on the fig4/fig5 workloads. Float accumulations
(total traffic, slack, BE progress) carry O(dt) discretization bias by
design and are excluded.

``MetricsRegistry(enabled=False)`` is the bare mode: instruments are
handed out (the callers' accounting still works — several counters
back compatibility properties like ``GLock.acquisitions``) but nothing
is indexed, so there are no snapshots and no per-series dict churn.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple


class Counter:
    """Monotonic counter. Hot paths may use ``c.value += n`` directly."""
    __slots__ = ("value",)

    def __init__(self, value: float = 0):
        self.value = value

    def inc(self, n: float = 1) -> None:
        self.value += n

    def __repr__(self) -> str:
        return f"Counter({self.value})"


class Gauge:
    """Last-written value, plus a ``peak``-style max helper."""
    __slots__ = ("value",)

    def __init__(self, value: float = 0.0):
        self.value = value

    def set(self, v: float) -> None:
        self.value = v

    def update_max(self, v: float) -> None:
        if v > self.value:
            self.value = v

    def __repr__(self) -> str:
        return f"Gauge({self.value})"


# default bucket upper bounds for margin/latency histograms (ms)
DEFAULT_BOUNDS = (0.0, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0,
                  500.0)


class Histogram:
    """Fixed-bound histogram with count/total/min/max summary stats.
    ``bounds`` are bucket upper edges; one overflow bucket is implied."""
    __slots__ = ("bounds", "buckets", "count", "total", "min", "max")

    def __init__(self, bounds: Sequence[float] = DEFAULT_BOUNDS):
        self.bounds = tuple(bounds)
        self.buckets = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, v: float) -> None:
        i = 0
        for i, b in enumerate(self.bounds):
            if v <= b:
                break
        else:
            i = len(self.bounds)
        self.buckets[i] += 1
        self.count += 1
        self.total += v
        if self.min is None or v < self.min:
            self.min = v
        if self.max is None or v > self.max:
            self.max = v

    def summary(self) -> Dict:
        return {"count": self.count,
                "mean": (self.total / self.count) if self.count else None,
                "min": self.min, "max": self.max,
                "buckets": dict(zip([*map(str, self.bounds), "+inf"],
                                    self.buckets))}

    def __repr__(self) -> str:
        return f"Histogram(n={self.count}, min={self.min}, max={self.max})"


def series_key(name: str, labels: Dict[str, object]) -> str:
    """Canonical series key: ``name{k=v,...}`` with sorted label keys."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    """Get-or-create store of labeled metric series.

    ``common_labels`` are folded into every series (e.g. the vgang grid
    stamps ``policy=rtgT`` on a per-cell registry). ``enabled=False``
    hands out detached instruments and indexes nothing — the bare mode
    the instrumentation-overhead benchmark compares against."""

    def __init__(self, enabled: bool = True,
                 common_labels: Optional[Dict[str, object]] = None):
        self.enabled = enabled
        self.common_labels = dict(common_labels or {})
        self._series: Dict[str, object] = {}
        self._parity: Dict[str, Counter] = {}

    # ---- get-or-create ----------------------------------------------
    def _get(self, name: str, labels: Dict[str, object], factory,
             parity: bool = False):
        if not self.enabled:
            return factory()
        key = series_key(name, {**self.common_labels, **labels})
        inst = self._series.get(key)
        if inst is None:
            inst = factory()
            self._series[key] = inst
            if parity:
                self._parity[key] = inst
        return inst

    def counter(self, name: str, parity: bool = False,
                **labels) -> Counter:
        return self._get(name, labels, Counter, parity=parity)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(name, labels, Gauge)

    def histogram(self, name: str,
                  bounds: Sequence[float] = DEFAULT_BOUNDS,
                  **labels) -> Histogram:
        return self._get(name, labels, lambda: Histogram(bounds))

    # ---- snapshots --------------------------------------------------
    def snapshot(self) -> Dict[str, object]:
        """All series: counters/gauges as numbers, histograms as their
        summary dicts. Keys are canonical ``name{k=v}`` strings."""
        out: Dict[str, object] = {}
        for key in sorted(self._series):
            inst = self._series[key]
            out[key] = inst.summary() if isinstance(inst, Histogram) \
                else inst.value
        return out

    def parity_snapshot(self) -> Dict[str, int]:
        """Only the parity-contract counters, coerced to int — the
        engine-parity assertion compares these byte-for-byte."""
        out: Dict[str, int] = {}
        for key in sorted(self._parity):
            v = self._parity[key].value
            iv = int(v)
            if iv != v:
                raise ValueError(
                    f"parity counter {key} holds non-integer {v!r}")
            out[key] = iv
        return out

    def series(self) -> List[Tuple[str, object]]:
        return sorted(self._series.items())
