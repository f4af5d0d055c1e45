"""The gang-scheduling lock — a faithful transcription of the paper's
Algorithms 1-4 (struct glock; acquire / try_release / gang-preemption /
pick_next_task_rt).

This is deliberately a plain-Python state machine over integer core ids so it
can be (a) unit-tested against every transition in the paper's pseudo-code,
(b) driven by the discrete-event simulator (core = CPU core), and (c) driven
by the fleet executor (core = mesh slice / lane). The spinlock of the paper
becomes a threading.Lock when driven concurrently; the simulator drives it
single-threaded.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, List, Optional, Set

from repro_torch.core.gang import RTTask, Thread
from repro_torch.obs.metrics import MetricsRegistry


@dataclasses.dataclass
class GLock:
    """struct glock (Algorithm 1, line 1-2)."""
    n_cores: int
    held_flag: bool = False
    locked_cores: int = 0                 # bitmask
    blocked_cores: int = 0                # bitmask
    leader: Optional[RTTask] = None
    gthreads: List[Optional[Thread]] = dataclasses.field(default=None)
    lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)
    # instrumentation lives in a MetricsRegistry (obs.metrics); pass one
    # to label/collect the series, or leave None for detached counters
    metrics: Optional[MetricsRegistry] = None

    def __post_init__(self):
        if self.gthreads is None:
            self.gthreads = [None] * self.n_cores
        reg = self.metrics if self.metrics is not None \
            else MetricsRegistry(enabled=False)
        # parity contract: both simulator engines must reproduce these
        # exactly (tests/test_obs.py)
        self.acq = reg.counter("glock.acquisitions", parity=True)
        self.preempt = reg.counter("glock.preemptions", parity=True)
        self.ipi = reg.counter("glock.ipis", parity=True)

    # compatibility views over the metric counters
    @property
    def acquisitions(self) -> int:
        return int(self.acq.value)

    @property
    def preemptions(self) -> int:
        return int(self.preempt.value)

    @property
    def ipis_sent(self) -> int:
        return int(self.ipi.value)

    # ---- bitmask helpers ---------------------------------------------------
    def _set(self, mask: int, cpu: int) -> int:
        return mask | (1 << cpu)

    def _clear(self, mask: int, cpu: int) -> int:
        return mask & ~(1 << cpu)

    def _is_zero(self, mask: int) -> bool:
        return mask == 0

    def cores_in(self, mask: int) -> List[int]:
        return [c for c in range(self.n_cores) if mask & (1 << c)]


class GangScheduler:
    """pick_next_task_rt with the one-gang-at-a-time invariant.

    ``reschedule_cpus`` is a callback(core_list) standing in for the
    rescheduling IPIs; the simulator re-runs scheduling on those cores, the
    executor wakes the slice workers.
    """

    def __init__(self, n_cores: int,
                 reschedule_cpus: Optional[Callable[[List[int]], None]] = None,
                 enabled: bool = True,
                 metrics: Optional[MetricsRegistry] = None):
        self.g = GLock(n_cores=n_cores, metrics=metrics)
        self.reschedule_cpus = reschedule_cpus or (lambda cores: None)
        self.enabled = enabled   # paper: runtime toggle via sched_features
        # gang hand-off hook: called with ("acquire"|"join"|"leave"|
        # "release"|"preempt", leader RTTask or None) whenever lock
        # ownership or membership changes — "join" when a core enters the
        # running gang at equal priority (Algorithm 1 line 14-15),
        # "leave" when a member thread departs while the lock stays held.
        # The event-driven engine counts hand-offs through it; the
        # executor applies throttle budgets on acquire/join/leave (the
        # live-member set moved) and wakes barrier waiters on "release".
        self.on_gang_change: Optional[
            Callable[[str, Optional[RTTask]], None]] = None

    # ---- Algorithm 2: acquire -----------------------------------------------
    def acquire_gang_lock(self, cpu: int, thread: Thread) -> None:
        g = self.g
        g.held_flag = True
        g.locked_cores = g._set(g.locked_cores, cpu)
        # the acquiring core may have blocked at line 18-19 earlier (e.g.
        # it now preempts the gang that blocked it); it is no longer
        # waiting, so drop its blocked bit or the next release sends it a
        # spurious reschedule IPI
        g.blocked_cores = g._clear(g.blocked_cores, cpu)
        g.leader = thread.task
        g.gthreads[cpu] = thread
        g.acq.value += 1
        if self.on_gang_change is not None:
            self.on_gang_change("acquire", g.leader)

    # ---- Algorithm 3: try release -------------------------------------------
    def try_glock_release(self, prev: Optional[Thread]) -> bool:
        """Returns True when ``prev`` departed while the lock stays held
        (a *partial* leave). The "leave" notification is deliberately
        NOT fired here: the caller (pick_next_task_rt) settles it after
        seeing what replaces ``prev`` — a same-task re-join at the next
        quantum means the member set never actually changed, and firing
        leave+join would transiently lift throttle caps a concurrent
        lock-free ``charge`` could slip through."""
        g = self.g
        if prev is None:
            return False
        left = False
        for cpu in g.cores_in(g.locked_cores):
            if g.gthreads[cpu] is prev:
                g.locked_cores = g._clear(g.locked_cores, cpu)
                g.gthreads[cpu] = None
                left = True
        if g._is_zero(g.locked_cores):
            g.held_flag = False
            g.leader = None
            blocked = g.cores_in(g.blocked_cores)
            if blocked:
                g.ipi.value += len(blocked)
                self.reschedule_cpus(blocked)
            g.blocked_cores = 0
            if self.on_gang_change is not None:
                self.on_gang_change("release", None)
            return False
        return left

    def _settle_leave(self, left: bool) -> None:
        """Emit the deferred partial-leave notification: the live-member
        set shrank (per-member budget floors may rise)."""
        if left and self.g.held_flag and self.on_gang_change is not None:
            self.on_gang_change("leave", self.g.leader)

    # ---- Algorithm 4: gang preemption ----------------------------------------
    def do_gang_preemption(self) -> List[int]:
        g = self.g
        victims = g.cores_in(g.locked_cores)
        if victims:
            g.ipi.value += len(victims)
            g.preempt.value += 1
            self.reschedule_cpus(victims)
        g.locked_cores = 0
        for cpu in victims:
            g.gthreads[cpu] = None
        if victims and self.on_gang_change is not None:
            self.on_gang_change("preempt", g.leader)
        return victims

    # ---- Algorithm 1: pick_next_task_rt ---------------------------------------
    def pick_next_task_rt(self, cpu: int, prev: Optional[Thread],
                          next_thread: Optional[Thread]) -> Optional[Thread]:
        """Returns the thread to run on ``cpu`` (None -> fall through to CFS).

        ``prev``: thread going off this core (may be None).
        ``next_thread``: highest-priority ready RT thread on this core's
        runqueue (may be None).
        """
        if not self.enabled:
            return next_thread
        g = self.g
        with g.lock:
            left = False
            if g.held_flag:
                left = self.try_glock_release(prev)              # Line 11
            if next_thread is None:
                self._settle_leave(left)
                return None
            task = next_thread.task
            if not g.held_flag:                                  # Line 12-13
                self.acquire_gang_lock(cpu, next_thread)
                return next_thread
            if task.prio == g.leader.prio:                       # Line 14-15
                g.locked_cores = g._set(g.locked_cores, cpu)
                # a core that blocked at line 18-19 and later joins the
                # running gang is no longer waiting: keep the blocked set
                # honest, or the eventual release IPIs it spuriously and
                # inflates ipis_sent
                g.blocked_cores = g._clear(g.blocked_cores, cpu)
                g.gthreads[cpu] = next_thread
                # same task re-picked at a quantum boundary: the member
                # set never changed — suppress the leave+join pair so
                # budget hooks see no transient cap lift
                if prev is None or task is not prev.task or not left:
                    self._settle_leave(left)
                    if self.on_gang_change is not None:
                        self.on_gang_change("join", g.leader)
                return next_thread
            if task.prio > g.leader.prio:                        # Line 16-17
                # pending leave is subsumed: preempt + acquire re-derive
                # the whole regime
                self.do_gang_preemption()
                self.acquire_gang_lock(cpu, next_thread)
                return next_thread
            # Line 18-19: lower priority -> blocked
            self._settle_leave(left)
            g.blocked_cores = g._set(g.blocked_cores, cpu)
            return None

    # ---- enforcement / watchdog support (DESIGN.md §11) -----------------------
    #
    # Watchdog ordering: an overrun/watchdog abort never mutates glock
    # state directly. The enforcer (FaultManager in the engines, the
    # executor's watchdog monitor) marks the faulty job dead and then
    # routes every held core through ``pick_next_task_rt(cpu, prev=
    # <held thread>, next=...)`` — the ready queue no longer offers the
    # dead job, so line 11's ``try_glock_release`` drops the core and,
    # on the last member, releases the lock. This keeps the abort on
    # the exact same code path as a natural departure: the gang-change
    # hook fires in its normal order ("leave" per surviving member
    # churn, then "release" or a successor's "acquire"), so budget
    # floors, reclaim-grant voiding, and barrier wakeups cannot be
    # reordered against lock ownership. ``force_release`` below is the
    # one-call wrapper for that pattern.

    def force_release(self, thread: Thread) -> List[int]:
        """Evict ``thread`` from every core it holds by driving each
        through the normal pick path with no successor offered (the
        caller must already have removed its job from the ready
        queues). Returns the cores released."""
        g = self.g
        with g.lock:
            held = [c for c in g.cores_in(g.locked_cores)
                    if g.gthreads[c] is thread]
        out = []
        for c in held:
            if self.pick_next_task_rt(c, thread, None) is None:
                out.append(c)
        return out

    def holds(self, task: RTTask) -> List[int]:
        """Cores on which the glock currently holds a thread of
        ``task`` (enforcement audits: after an abort settles, this must
        be empty unless a live successor job re-acquired)."""
        return [c for c, th in enumerate(self.g.gthreads)
                if th is not None and th.task.uid == task.uid]

    # ---- invariant (for property tests) ----------------------------------------
    def running_gang_prios(self) -> Set[int]:
        return {t.task.prio for t in self.g.gthreads if t is not None}

    def check_invariant(self) -> bool:
        """At most one distinct gang priority holds cores at any time."""
        return len(self.running_gang_prios()) <= 1
