"""Fault injection and runtime overrun enforcement (DESIGN.md §11).

RT-Gang is a framework for *safety-critical* systems, yet the base
scheduler trusts every declared parameter: a job running past its
declared WCET holds the gang lock until it finishes, a permanently
stalled thread holds it forever, and a best-effort task generating more
traffic than declared eats into every window. This module supplies the
two missing halves:

* **Seeded, declarative fault plans** (``FaultPlan``) that make a task
  misbehave on purpose: WCET overruns (a job's actual work is a factor
  of its declaration), busy-hung member threads (a thread that never
  finishes its job), lost budget-lift wakeups (a throttle stall whose
  window-end wakeup is delayed or dropped), and best-effort tasks
  exceeding their declared traffic rate. Plans are resolved
  deterministically from ``(seed, task name, job index)`` so the
  quantum and event engines inject the *same* faults.

* **Runtime enforcement** (``Enforcement``): every RT job carries an
  enforcement budget derived from its declared WCET — ``factor`` x the
  declared per-thread work — and crossing it triggers a configurable
  action:

  - ``abort``:  count the miss, zero the job, release the gang lock and
    every held core immediately;
  - ``demote``: take the job off the RT path and run its remaining work
    as best-effort on its own (otherwise idle) cores, under whatever
    throttle budget the then-running gang enforces;
  - ``degrade``: mixed-criticality fallback — suspend every gang with
    lower declared ``criticality`` until the overrunning gang's job
    completes (or its wall-clock watchdog aborts it), then restore.

  The work budget is *isolation work*, not wall time: a legitimate job
  slowed by interference executes exactly its declared work and is
  never spuriously enforced, while a lying job is cut the moment it has
  executed ``factor x C_i`` — so the wall time it can hold the machine
  is bounded by ``factor x C_i x slowdown``, restoring the paper's
  ``B_i`` blocking bound (vgang/rta.py prices this as
  ``schedulable_vgangs_enforced``).

  ``watchdog_factor`` arms a wall-clock watchdog per job: at
  ``release + watchdog_factor x deadline`` an unfinished job is aborted
  regardless of the declared action (the wall clock is the last line of
  defense — it is the only thing that catches a job making *no*
  progress, e.g. one stalled forever by a lost wakeup, which never
  crosses a work budget).

``FaultManager`` is the per-run state machine both engines drive; the
executor (core/executor.py) implements the wall-clock watchdog natively
with real timers instead.
"""
from __future__ import annotations

import dataclasses
import random
from collections import deque
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.gang import RTTask, Thread
from repro_torch.obs.metrics import MetricsRegistry

_EPS = 1e-9

# A busy-hung thread is modeled as a job with this much remaining work:
# effectively infinite for any horizon, but finite so closed-form
# remaining-work arithmetic (executed = total - remaining) stays exact.
HUNG_WORK = 1e9


# ---------------------------------------------------------------------
# fault specs
# ---------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WcetOverrun:
    """Selected jobs of ``task`` execute ``factor`` x their declared
    per-thread work. ``jobs``: explicit job indices; None = every job
    independently with probability ``prob`` (seeded, engine-stable)."""
    task: str
    factor: float = 2.0
    jobs: Optional[Tuple[int, ...]] = None
    prob: float = 1.0


@dataclasses.dataclass(frozen=True)
class HungThread:
    """Thread ``thread`` (index into task.cores) of job ``job`` never
    finishes: it keeps executing — generating traffic and interference
    and holding the gang lock — forever (a runaway loop)."""
    task: str
    job: int = 0
    thread: int = 0


@dataclasses.dataclass(frozen=True)
class LostWakeup:
    """The ``nth`` throttle stall on ``core`` loses its window-end
    wakeup: the stall extends by ``extra`` ms past the scheduled
    release (``float('inf')`` = the wakeup never arrives)."""
    core: int
    nth: int = 1
    extra: float = float("inf")


@dataclasses.dataclass(frozen=True)
class BeOverrun:
    """Best-effort task ``task`` generates ``factor`` x its declared
    memory traffic rate (it lied about its bytes). The regulator
    contains this by construction — the *charged* rate is the actual
    one — so the fault shows up as earlier trips, never as RT misses."""
    task: str
    factor: float = 2.0


_FAULT_TYPES = (WcetOverrun, HungThread, LostWakeup, BeOverrun)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Declarative, seeded fault plan. Resolution is a pure function of
    ``(seed, task name, job index)``, so both engines — and repeated
    runs — inject identical faults."""
    faults: Tuple = ()
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "faults", tuple(self.faults))
        for sp in self.faults:
            if not isinstance(sp, _FAULT_TYPES):
                raise ValueError(f"unknown fault spec {sp!r}")
            if isinstance(sp, (WcetOverrun, BeOverrun)) and not sp.factor > 0:
                raise ValueError(f"{sp!r}: factor must be > 0")
            if isinstance(sp, WcetOverrun) and not 0.0 <= sp.prob <= 1.0:
                raise ValueError(f"{sp!r}: prob must be in [0, 1]")
            if isinstance(sp, HungThread) and (sp.job < 0 or sp.thread < 0):
                raise ValueError(f"{sp!r}: job/thread must be >= 0")
            if isinstance(sp, LostWakeup) and (sp.nth < 1 or
                                               not sp.extra > 0):
                raise ValueError(f"{sp!r}: nth >= 1 and extra > 0 required")

    # -- resolution (deterministic per (seed, name, index)) -----------
    def _hit(self, sp: WcetOverrun, idx: int) -> bool:
        if sp.jobs is not None:
            return idx in sp.jobs
        if sp.prob >= 1.0:
            return True
        # string seeding hashes via sha512: stable across processes
        return random.Random(
            f"{self.seed}:{sp.task}:{idx}").random() < sp.prob

    def overrun_factor(self, name: str, idx: int) -> float:
        f = 1.0
        for sp in self.faults:
            if isinstance(sp, WcetOverrun) and sp.task == name and \
                    self._hit(sp, idx):
                f = max(f, sp.factor)
        return f

    def hung_threads(self, name: str, idx: int) -> Tuple[int, ...]:
        return tuple(sp.thread for sp in self.faults
                     if isinstance(sp, HungThread) and sp.task == name
                     and sp.job == idx)

    def be_factor(self, name: str) -> float:
        f = 1.0
        for sp in self.faults:
            if isinstance(sp, BeOverrun) and sp.task == name:
                f = max(f, sp.factor)
        return f

    def lost_wakeups(self) -> List[LostWakeup]:
        return [sp for sp in self.faults if isinstance(sp, LostWakeup)]

    def faulty_rt_names(self) -> Set[str]:
        """Names of RT tasks this plan makes misbehave (the containment
        benchmarks compare every *other* task against the baseline)."""
        return {sp.task for sp in self.faults
                if isinstance(sp, (WcetOverrun, HungThread))}


# ---------------------------------------------------------------------
# enforcement config
# ---------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Enforcement:
    """Runtime enforcement policy (see module docstring).

    action:          "abort" | "demote" | "degrade".
    factor:          work budget = factor x declared per-thread WCET.
    watchdog_factor: arm a wall-clock watchdog at
                     ``release + watchdog_factor x deadline``; an
                     unfinished job is aborted there regardless of
                     ``action``. None = no watchdog.
    """
    action: str = "abort"
    factor: float = 1.0
    watchdog_factor: Optional[float] = None

    def __post_init__(self):
        if self.action not in ("abort", "demote", "degrade"):
            raise ValueError(f"unknown enforcement action {self.action!r}")
        if not self.factor > 0:
            raise ValueError("enforcement factor must be > 0")
        if self.watchdog_factor is not None and not self.watchdog_factor > 0:
            raise ValueError("watchdog_factor must be > 0 (or None)")


class _JobRecord:
    __slots__ = ("over", "watchdog_at", "enforced")

    def __init__(self, over: Dict[int, float],
                 watchdog_at: Optional[float]):
        # over[c]: remaining-work level at which the work budget is
        # crossed on core c (actual total - cap); <= 0 = cannot cross
        self.over = over
        self.watchdog_at = watchdog_at
        self.enforced: Optional[str] = None   # action taken, if any


class _DemJob:
    """A demoted job's best-effort residual, drained per core."""
    __slots__ = ("task", "index", "release", "residual", "finished")

    def __init__(self, task: RTTask, index: int, release: float,
                 residual: Dict[int, float]):
        self.task = task
        self.index = index
        self.release = release
        self.residual = residual
        self.finished = False


# ---------------------------------------------------------------------
# per-run state machine
# ---------------------------------------------------------------------

class FaultManager:
    """Injects a FaultPlan and enforces an Enforcement policy; one
    instance per Simulator run, driven identically by both engines.

    The engines own the mechanics (descheduling, event re-prediction);
    this object owns the decisions and the bookkeeping: actual-work
    inflation at release, work-budget / watchdog due checks, the
    demoted-residual pool, the criticality suspension set, and the
    lock-leak audit."""

    def __init__(self, tasks: Sequence[RTTask],
                 plan: Optional[FaultPlan],
                 enforcement: Optional[Enforcement],
                 metrics: Optional[MetricsRegistry] = None):
        self.plan = plan or FaultPlan()
        self.enf = enforcement
        self.tasks = {t.uid: t for t in tasks}
        self._rec: Dict[Tuple[int, int], _JobRecord] = {}
        # demoted residuals: core -> FIFO of _DemJob; threads cached so
        # the MemoryModel sees a stable occupant identity per (task, core)
        self._dem: Dict[int, deque] = {}
        self._dem_threads: Dict[Tuple[int, int], Thread] = {}
        # degraded mode
        self.suspended: Set[int] = set()          # suspended task uids
        self.degrading: Optional[Tuple[int, int]] = None   # (uid, job idx)
        self._parked: Dict[int, list] = {}        # event engine ready entries
        self.pending_audit: List[RTTask] = []
        # bound by the engine at run start
        self._misses: Optional[Dict[str, int]] = None
        self._miss_times: Optional[Dict[str, List[float]]] = None
        self._response: Optional[Dict[str, List[float]]] = None
        # fault counts are obs.metrics parity counters — both engines
        # must inject and enforce identically (tests/test_obs.py)
        reg = metrics if metrics is not None \
            else MetricsRegistry(enabled=False)
        self.metrics = metrics
        self._inj = {k: reg.counter("faults.injected", parity=True, kind=k)
                     for k in ("overrun", "hang", "lost_wakeup")}
        self._enf_counts = {a: reg.counter("faults.enforced", parity=True,
                                           action=a)
                            for a in ("abort", "demote", "degrade")}
        self._watchdog = reg.counter("faults.watchdog_fires", parity=True)
        self._leaks = reg.counter("faults.lock_leaks", parity=True)
        self._aborted_jobs: List[Tuple[str, int, float]] = []
        self._by_task: Dict[str, Dict[str, int]] = {}

    @property
    def stats(self) -> Dict:
        """The historical stats-dict shape, assembled from the metric
        counters (``aborted_jobs``/``by_task`` are shared references —
        ``summary()`` is the copying accessor)."""
        return {
            "injected_overruns": int(self._inj["overrun"].value),
            "injected_hangs": int(self._inj["hang"].value),
            "injected_lost_wakeups": int(self._inj["lost_wakeup"].value),
            "enforced": {a: int(c.value)
                         for a, c in self._enf_counts.items()},
            "watchdog_fires": int(self._watchdog.value),
            "lock_leaks": int(self._leaks.value),
            "aborted_jobs": self._aborted_jobs,
            "by_task": self._by_task,
        }

    # -- wiring -------------------------------------------------------
    def bind(self, misses: Dict[str, int],
             miss_times: Dict[str, List[float]],
             response: Dict[str, List[float]]) -> None:
        self._misses = misses
        self._miss_times = miss_times
        self._response = response

    def install(self, regulator) -> None:
        """Install the lost-wakeup fault as the regulator's
        ``stall_fault`` hook (throttle.py): the nth stall on a faulty
        core has its stall-until extended by the spec's ``extra``."""
        specs = self.plan.lost_wakeups()
        if not specs:
            return
        counts: Dict[int, int] = {}

        def hook(core: int, until: float) -> float:
            k = counts.get(core, 0) + 1
            counts[core] = k
            for sp in specs:
                if sp.core == core and sp.nth == k:
                    self._inj["lost_wakeup"].value += 1
                    return until + sp.extra
            return until

        regulator.stall_fault = hook

    # -- injection at release ----------------------------------------
    def on_release(self, job) -> None:
        """Inflate the job's actual work per the plan and register its
        enforcement record. Must run right after Job construction,
        before any engine prediction reads ``remaining``."""
        t = job.task
        f = self.plan.overrun_factor(t.name, job.index)
        hung = self.plan.hung_threads(t.name, job.index)
        if f > 1.0:
            self._inj["overrun"].value += 1
        if hung:
            self._inj["hang"].value += len(hung)
        if f > 1.0 or hung:
            for i, c in enumerate(t.cores):
                if i in hung:
                    job.remaining[c] = HUNG_WORK
                elif f > 1.0:
                    job.remaining[c] = job.remaining[c] * f
        if self.enf is None:
            return
        over = {c: job.remaining[c] - t.thread_wcet(c) * self.enf.factor
                for c in t.cores}
        wd = None
        if self.enf.watchdog_factor is not None:
            wd = job.release + self.enf.watchdog_factor * t.deadline
        if wd is not None or any(v > _EPS for v in over.values()):
            self._rec[(t.uid, job.index)] = _JobRecord(over, wd)

    # -- due checks ---------------------------------------------------
    def over_threshold(self, uid: int, idx: int,
                       core: int) -> Optional[float]:
        """Remaining-work level at which the work budget is crossed on
        ``core`` (the event engine predicts an _ENFORCE event there), or
        None if it cannot cross / was already enforced."""
        r = self._rec.get((uid, idx))
        if r is None or r.enforced is not None:
            return None
        ov = r.over.get(core, 0.0)
        return ov if ov > _EPS else None

    def watchdog_at(self, uid: int, idx: int) -> Optional[float]:
        r = self._rec.get((uid, idx))
        return r.watchdog_at if r is not None else None

    def due(self, job, now: float) -> Optional[str]:
        """Quantum-engine poll: is enforcement due for this job at
        ``now``? Returns "cap", "watchdog", or None."""
        r = self._rec.get((job.task.uid, job.index))
        if r is None:
            return None
        if r.enforced is None:
            for c, ov in r.over.items():
                if ov > _EPS and job.remaining.get(c, 0.0) <= ov + _EPS:
                    return "cap"
        if r.watchdog_at is not None and now >= r.watchdog_at - _EPS and \
                r.enforced in (None, "degrade"):
            return "watchdog"
        return None

    # -- firing -------------------------------------------------------
    def fire(self, job, now: float, via: str = "cap") -> Optional[str]:
        """Decide the enforcement action for ``job``. Returns the action
        the engine must apply, or None (already handled / nothing to
        do). The wall-clock watchdog always aborts: it is the last line
        of defense, and under ``degrade`` it is the escalation path that
        bounds how long lower-criticality gangs stay suspended."""
        r = self._rec.get((job.task.uid, job.index))
        if r is None or self.enf is None:
            return None
        if via == "watchdog":
            if r.enforced in ("abort", "demote"):
                return None          # already off the RT path
            self._watchdog.value += 1
            action = "abort"
        else:
            if r.enforced is not None:
                return None
            action = self.enf.action
        r.enforced = action
        self._enf_counts[action].value += 1
        per = self._by_task.setdefault(
            job.task.name, {"abort": 0, "demote": 0, "degrade": 0})
        per[action] += 1
        if action in ("abort", "demote"):
            # the gang lock must leave this job's cores once the
            # engine's scheduling round settles — audited there
            self.pending_audit.append(job.task)
        return action

    def record_abort(self, job, now: float) -> None:
        """An aborted job is a counted deadline miss at the abort
        instant (it will never complete)."""
        name = job.task.name
        self._misses[name] += 1
        self._miss_times[name].append(now)
        self._aborted_jobs.append((name, job.index, now))

    def audit(self, g, has_work) -> None:
        """Called by the engine after the scheduling round that follows
        an abort/demote settles: the glock may hold a core for the task
        only if a live successor job still has work there. ``has_work``:
        callable(uid, core) -> bool, engine-specific."""
        pending, self.pending_audit = self.pending_audit, []
        for t in pending:
            for th in g.gthreads:
                if th is not None and th.task.uid == t.uid and \
                        not has_work(t.uid, th.core):
                    self._leaks.value += 1

    # -- demoted-residual pool ---------------------------------------
    def begin_demote(self, job, now: float) -> None:
        """Snapshot the job's remaining work as a best-effort residual
        on its own cores (call *before* the engine zeroes
        ``remaining``). The residual runs whenever its core is free,
        ahead of best-effort fillers, under the ambient throttle budget;
        the late completion is recorded as the job's response."""
        t = job.task
        residual = {c: r for c, r in job.remaining.items() if r > _EPS}
        if not residual:
            return
        d = _DemJob(t, job.index, job.release, residual)
        for c in residual:
            self._dem.setdefault(c, deque()).append(d)
            if (t.uid, c) not in self._dem_threads:
                self._dem_threads[(t.uid, c)] = Thread(
                    task=t, core=c, index=t.cores.index(c))

    def dem_head(self, core: int) -> Optional[_DemJob]:
        q = self._dem.get(core)
        return q[0] if q else None

    def dem_thread(self, core: int) -> Optional[Thread]:
        q = self._dem.get(core)
        if not q:
            return None
        return self._dem_threads[(q[0].task.uid, core)]

    def dem_finish_core(self, core: int, now: float) -> bool:
        """Core ``core`` drained its share of the head residual. Returns
        True when the whole demoted job just completed (response and —
        inevitably — the miss are recorded then)."""
        q = self._dem[core]
        d = q.popleft()
        d.residual[core] = 0.0
        if d.finished or any(v > _EPS for v in d.residual.values()):
            return False
        d.finished = True
        rt = now - d.release
        self._response[d.task.name].append(rt)
        if rt > d.task.deadline + 1e-9:
            self._misses[d.task.name] += 1
            self._miss_times[d.task.name].append(now)
        return True

    # -- degraded mode ------------------------------------------------
    def begin_degrade(self, job, tasks: Sequence[RTTask]) -> Set[int]:
        """Suspend every task with strictly lower criticality than the
        overrunning job's until that job completes (or its watchdog
        aborts it). Returns the suspended uids (the engine dirties
        their cores)."""
        crit = job.task.criticality
        sus = {t.uid for t in tasks
               if t.uid != job.task.uid and t.criticality < crit}
        self.suspended = sus
        self.degrading = (job.task.uid, job.index)
        return sus

    def park(self, core: int, entry) -> None:
        """Event engine: a suspended task's ready-heap entry, popped on
        peek; re-pushed verbatim on restore."""
        self._parked.setdefault(core, []).append(entry)

    def maybe_restore(self, uid: int, idx: int):
        """Called on any job completion/abort: if it was the degrading
        job, lift the suspension. Returns (parked entries by core,
        previously suspended uids) for the engine to re-arm, or None."""
        if self.degrading != (uid, idx):
            return None
        self.degrading = None
        sus, self.suspended = self.suspended, set()
        parked, self._parked = self._parked, {}
        return parked, sus

    # -- reporting ----------------------------------------------------
    def summary(self) -> Dict:
        out = self.stats
        out["aborted_jobs"] = list(out["aborted_jobs"])
        out["by_task"] = {k: dict(v) for k, v in out["by_task"].items()}
        return out
