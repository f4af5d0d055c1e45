"""Task model for RT-Gang: real-time gangs, virtual gangs, best-effort tasks.

Mirrors the paper's model (§III): a real-time gang is a set of threads
(possibly from multiple tasks — a *virtual gang*) sharing one distinct
real-time priority; priorities define gang identity (paper §IV-E: assigning
the same RT priority to several tasks *is* the virtual-gang mechanism).
Best-effort tasks have no RT priority and run under the fair scheduler on
idle cores, throttled to the running gang's declared memory-bandwidth budget.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

_ids = itertools.count(1)


@dataclasses.dataclass
class Thread:
    """One schedulable thread, pinned to a core (no migration, paper §III-A)."""
    task: "RTTask"
    core: int
    index: int = 0

    @property
    def name(self) -> str:
        return f"{self.task.name}/t{self.index}"


@dataclasses.dataclass
class RTTask:
    """Periodic parallel real-time task (gang model: (C, P, k cores)).

    wcet:    per-job execution time of each thread in isolation (paper uses
             equal per-thread compute; a per-thread list is also accepted).
    period:  release period; deadline = period (implicit deadlines).
    cores:   cores its threads are pinned to.
    prio:    distinct fixed RT priority — HIGHER value = higher priority.
             Tasks sharing a prio form a *virtual gang*.
    mem_budget: tolerable best-effort memory traffic (bytes or abstract
             units per regulation interval) while this gang runs; 0 = total
             isolation (paper §III-B).
    mem_intensity: the gang's own memory-traffic intensity in [0, 1] —
             how aggressive a co-runner it is. Used by the virtual-gang
             formation heuristics (vgang/formation.py) to avoid packing
             two memory-hungry gangs into one virtual gang
             (arXiv:1912.10959 §V), and — through ``traffic_rate`` — as
             the traffic each of its threads charges against the
             bandwidth regulator (RTG-throttle, §IV-C: sibling members
             of a virtual gang are regulated like best-effort work).
    mem_rate: explicit per-thread traffic rate (units per ms of
             execution, the BETask.mem_rate scale); None derives it
             from mem_intensity.
    """
    name: str
    wcet: float
    period: float
    cores: Tuple[int, ...]
    prio: int
    mem_budget: float = 0.0
    mem_intensity: float = 0.0
    mem_rate: Optional[float] = None
    release_offset: float = 0.0
    n_jobs: Optional[int] = None          # None = unbounded
    wcet_per_core: Optional[Dict[int, float]] = None
    # mixed-criticality level for degraded-mode enforcement
    # (core/faults.py): under ``degrade``, gangs with strictly lower
    # criticality than an overrunning gang are suspended until it
    # completes. 0 = lowest (default).
    criticality: int = 0
    uid: int = dataclasses.field(default_factory=lambda: next(_ids))

    def __post_init__(self):
        # construction-time declaration validation (ROADMAP item 5,
        # first slice): reject unambiguous nonsense with a clear error
        # instead of producing a garbage schedule. WCET > period is
        # deliberately NOT rejected here — analysis code legitimately
        # builds single-core-equivalent tasks whose inflated WCET
        # exceeds the period (that is exactly how vgang RTA reports an
        # unschedulable formation) and the acceptance grid simulates
        # overloaded sets; use ``validate_declared`` for the strict
        # check where declarations must be trustworthy (enforcement
        # budgets, config ingestion).
        if not self.cores:
            raise ValueError(f"task {self.name!r} pins no cores")
        if len(set(self.cores)) != len(self.cores):
            raise ValueError(
                f"task {self.name!r} pins a core twice: {self.cores}")
        if not self.wcet > 0.0:
            raise ValueError(
                f"task {self.name!r}: wcet must be > 0, got {self.wcet}")
        if not self.period > 0.0:
            raise ValueError(
                f"task {self.name!r}: period must be > 0, "
                f"got {self.period}")
        if self.wcet_per_core:
            for c, w in self.wcet_per_core.items():
                if not w > 0.0:
                    raise ValueError(
                        f"task {self.name!r}: wcet_per_core[{c}] must be "
                        f"> 0, got {w}")
        if not 0.0 <= self.mem_intensity <= 1.0:
            raise ValueError(
                f"task {self.name!r}: mem_intensity must be in [0, 1], "
                f"got {self.mem_intensity}")
        if self.mem_rate is not None and self.mem_rate < 0.0:
            raise ValueError(
                f"task {self.name!r}: mem_rate must be >= 0, "
                f"got {self.mem_rate}")
        if self.mem_budget < 0.0:
            raise ValueError(
                f"task {self.name!r}: mem_budget must be >= 0, "
                f"got {self.mem_budget}")
        if self.release_offset < 0.0:
            raise ValueError(
                f"task {self.name!r}: release_offset must be >= 0, "
                f"got {self.release_offset}")
        if self.n_jobs is not None and self.n_jobs < 0:
            raise ValueError(
                f"task {self.name!r}: n_jobs must be >= 0, "
                f"got {self.n_jobs}")

    @property
    def traffic_rate(self) -> float:
        """Memory traffic each thread generates per ms it executes —
        the declared ``mem_rate``, defaulting to ``mem_intensity`` (an
        intensity-s gang produces s units/ms, the same abstract scale as
        BETask.mem_rate). Charged through the BandwidthRegulator by the
        MemoryModel so RT threads can trip per-core budgets."""
        return self.mem_rate if self.mem_rate is not None \
            else self.mem_intensity

    def thread_wcet(self, core: int) -> float:
        if self.wcet_per_core:
            return self.wcet_per_core.get(core, self.wcet)
        return self.wcet

    def release_time(self, k: int) -> Optional[float]:
        """Absolute release time of job ``k`` (None once past n_jobs)."""
        if self.n_jobs is not None and k >= self.n_jobs:
            return None
        return self.release_offset + k * self.period

    @property
    def deadline(self) -> float:
        """Implicit deadlines: deadline = period (paper §III)."""
        return self.period

    @property
    def n_threads(self) -> int:
        return len(self.cores)

    @property
    def utilization(self) -> float:
        return self.wcet / self.period


@dataclasses.dataclass
class BETask:
    """Best-effort task (CFS class). mem_rate: abstract memory traffic it
    generates per ms of execution (used by the throttling model)."""
    name: str
    cores: Tuple[int, ...]
    mem_rate: float = 0.0
    uid: int = dataclasses.field(default_factory=lambda: next(_ids))

    def __post_init__(self):
        if not self.cores:
            raise ValueError(f"BE task {self.name!r} pins no cores")
        if self.mem_rate < 0.0:
            raise ValueError(
                f"BE task {self.name!r}: mem_rate must be >= 0, "
                f"got {self.mem_rate}")


def make_virtual_gang(name: str, members: Sequence[RTTask], prio: int,
                      mem_budget: float = 0.0) -> List[RTTask]:
    """Link tasks into a virtual gang by assigning them one shared priority
    (exactly the paper's mechanism, §IV-E). Returns the updated members."""
    out = []
    for t in members:
        out.append(dataclasses.replace(t, prio=prio, mem_budget=mem_budget,
                                       name=t.name))
    return out


def validate_declared(tasks: Sequence[RTTask]) -> None:
    """Strict declaration check for consumers that must *trust* the
    declarations (enforcement budgets derived from WCET — core/faults.py
    — and config ingestion): on top of construction-time validation,
    every declared per-thread WCET must fit the implicit deadline
    (= period). Kept separate from ``RTTask.__post_init__`` because the
    RTA layer legitimately constructs inflated-WCET equivalent tasks
    with wcet > period to *report* unschedulability."""
    for t in tasks:
        for c in t.cores:
            w = t.thread_wcet(c)
            if w > t.period + 1e-12:
                raise ValueError(
                    f"task {t.name!r}: declared WCET {w} on core {c} "
                    f"exceeds its period/deadline {t.period} — an "
                    f"enforcement budget derived from this declaration "
                    f"would be meaningless")


def validate_taskset(tasks: Sequence[RTTask]) -> None:
    """Distinct priority per gang; no core pinned twice within one gang."""
    by_prio: Dict[int, List[RTTask]] = {}
    for t in tasks:
        by_prio.setdefault(t.prio, []).append(t)
    for prio, members in by_prio.items():
        cores = [c for t in members for c in t.cores]
        if len(cores) != len(set(cores)):
            raise ValueError(
                f"virtual gang at prio {prio} pins a core twice: {cores}")
