"""Response-time analysis for RT-Gang tasksets.

The paper's central analytical claim (§III-B): under one-gang-at-a-time,
multicore parallel RT scheduling collapses to the classical single-core
fixed-priority problem, so Audsley-style RTA applies with *solo* WCETs:

    R_i = C_i + B_i + gamma_i + sum_{j in hp(i)} ceil(R_i / P_j) * (C_j + gamma_j)

* C_i  — the gang's WCET measured in isolation (threads run in parallel, so
  the gang's C is the max thread WCET; the paper's taskset tables list it).
* B_i  — blocking from non-preemptible quanta of lower-priority gangs
  (0 in the paper's kernel implementation, which preempts at tick
  granularity; our executor preempts at quantum boundaries, so
  B_i = max lower-priority quantum — see DESIGN.md §2.1).
* gamma_i — CRPD-style re-warm penalty per resume (paper §V-C observes CRPD
  on the Pi 3; classic single-core CRPD analysis becomes valid again).

Best-effort interference is bounded by the task's declared budget and does
not enter hp() (strict prioritization).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

from repro_torch.core.gang import RTTask


def gang_wcet(task: RTTask) -> float:
    """A gang's sequential-equivalent WCET = max thread WCET (threads are
    co-scheduled and the gang occupies the machine until its last thread
    finishes; the paper's C values are per-gang)."""
    if task.wcet_per_core:
        return max(task.wcet_per_core.values())
    return task.wcet


def _fixed_point(base: float, hp_terms, period: float,
                 max_iter: int) -> Optional[float]:
    """The Audsley iteration on precomputed ``(P_j, C_j + crpd)`` terms.
    ``gang_wcet(t) + crpd`` is loop-invariant, so hoisting it out of the
    iteration (and the hp scan out of the taskset loop in
    ``schedulable``) cannot change a bit: the same floats are summed in
    the same order."""
    R = base
    cutoff = 1000 * period
    for _ in range(max_iter):
        interference = sum(math.ceil(R / p) * c for p, c in hp_terms)
        R_new = base + interference
        if abs(R_new - R) < 1e-12:
            return R_new
        if R_new > cutoff:
            return None
        R = R_new
    return None


def response_time(task: RTTask, taskset: Sequence[RTTask],
                  blocking: float = 0.0, crpd: float = 0.0,
                  max_iter: int = 10_000) -> Optional[float]:
    """Fixed-point RTA; returns None if divergent (> 1000 periods)."""
    C = gang_wcet(task) + crpd
    hp_terms = [(t.period, gang_wcet(t) + crpd) for t in taskset
                if t.prio > task.prio]
    return _fixed_point(C + blocking, hp_terms, task.period, max_iter)


def schedulable(taskset: Sequence[RTTask], blocking: float = 0.0,
                crpd: float = 0.0) -> Dict[str, Dict]:
    """Per-task response times vs deadlines (deadline = period)."""
    # gang_wcet memoized across the taskset and hp terms hoisted per
    # task: one O(n) pass each instead of O(n^2) recomputes per
    # fixed-point iteration, bit-identical results.
    gws = [gang_wcet(t) + crpd for t in taskset]
    out = {}
    for t, C in zip(taskset, gws):
        hp_terms = [(o.period, gw) for o, gw in zip(taskset, gws)
                    if o.prio > t.prio]
        R = _fixed_point(C + blocking, hp_terms, t.period, 10_000)
        out[t.name] = {
            "wcrt": R,
            "deadline": t.period,
            "ok": R is not None and R <= t.period + 1e-12,
        }
    return out


def total_utilization(taskset: Sequence[RTTask]) -> float:
    """Gang utilization sum C_i / P_i (single-core equivalent after the
    RT-Gang transform)."""
    return sum(gang_wcet(t) / t.period for t in taskset)


def co_sched_wcet(task: RTTask, taskset: Sequence[RTTask],
                  interference) -> float:
    """Pessimistic co-scheduling WCET: solo WCET times the worst pairwise
    slowdown over tasks that can overlap (the 10x-100x factors of paper §II).
    Used to contrast RTA under co-scheduling vs RT-Gang."""
    worst = 1.0
    for other in taskset:
        if other.uid == task.uid:
            continue
        if set(other.cores) & set(task.cores):
            continue  # same cores -> serialized by fixed-priority, not co-run
        worst = max(worst, interference(task.name, other.name))
    return gang_wcet(task) * worst
