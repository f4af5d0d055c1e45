"""Memory-bandwidth throttling of best-effort work (paper §III-D / §IV-F,
adapting BWLOCK [53]).

Paper mechanism: per-core perf counters count memory transactions per 1 ms
regulation interval; on budget overflow an interrupt stalls the core until
the next interval. The budget is the *currently running RT gang's* declared
tolerable traffic.

Two modes (DESIGN.md §7.3):

* ``reactive``  — paper-faithful: usage accumulates as best-effort work runs;
  the core is stalled the moment the budget is exceeded (overshoot of at most
  one accounting quantum, like one sampling period of the counter).
* ``admission`` — TPU-native: a quantum of work with statically-known bytes
  (from ``compiled.cost_analysis()``) is admitted only if it fits the
  remaining budget. No overshoot; suits hardware without mid-program
  preemption.

Dynamic reclaiming (``reclaim=True``, DESIGN.md §7.5, after the analysis
of arXiv:1809.05921): a core that sits idle inside a regulation window
leaves its unspent quota *donatable*, and a charging core that exhausts
its own quota may *draw* that quota instead of tripping. The pool is
pull-based — nothing is banked; ``donatable`` is computed on demand from
the donor's fresh window state, a draw marks the donor's ``donated``
counter (so quota is never handed out twice) and credits the drawer's
``drawn`` counter, and both reset at the window roll. The per-window
limit a core charges against is therefore

    limit = budget - donated + drawn

Eligibility (who may donate to whom) is policy, not accounting: the
MemoryModel restricts donors to idle cores and gates draws on an
interference-dominance rule (memmodel.py); the executor restricts
donors to lanes with no pending RT work. A budget *decrease* revokes
the core's unspent reclaimed grant (``drawn`` cleared) and — fixing the
mid-window lowering bug — stalls the core immediately when its usage
already exceeds the new limit, instead of letting it overrun until the
next window roll.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.obs.metrics import Counter, Gauge, MetricsRegistry

_INF = float("inf")


@dataclasses.dataclass
class ThrottleState:
    budget: float                # allowed traffic per interval (bytes/units)
    interval: float = 1.0        # regulation interval (ms in the sim)
    core: int = -1               # which core this state regulates
    used: float = 0.0
    window_start: float = 0.0
    stalled_until: float = 0.0
    # dynamic reclaiming (per-window, reset on roll — DESIGN.md §7.5)
    donated: float = 0.0         # quota pulled out of this core's window
    drawn: float = 0.0           # quota granted to this core's window
    # instrumentation: obs.metrics instruments — the regulator binds
    # registry-owned series (throttle.trips{core=} is on the engine
    # parity contract) or detached instances when unmetered
    trips: Counter = dataclasses.field(default_factory=Counter)
    used_total: Counter = dataclasses.field(default_factory=Counter)
    denied_total: Counter = dataclasses.field(default_factory=Counter)
    # worst observed charge past the per-window limit (the enforcement
    # invariant ``used <= limit`` up to one accounting quantum; the
    # event engine's closed-form charging keeps this at float epsilon,
    # the quantum engine at one reactive overshoot <= rate x dt, and
    # admission mode at exactly 0 — asserted by tests/test_faults.py)
    overrun: Gauge = dataclasses.field(default_factory=Gauge)

    # compatibility views over the metric instruments
    @property
    def throttle_events(self) -> int:
        return int(self.trips.value)

    @property
    def total_used(self) -> float:
        return self.used_total.value

    @property
    def total_denied(self) -> float:
        return self.denied_total.value

    @property
    def max_overrun(self) -> float:
        return self.overrun.value

    @property
    def limit(self) -> float:
        """Effective per-window allowance: the enforced budget minus what
        this core donated plus what it drew from donors."""
        if self.budget == _INF:
            return _INF
        return self.budget - self.donated + self.drawn


class BandwidthRegulator:
    """Per-core regulator bank; budget is set by the running gang."""

    def __init__(self, n_cores: int, interval: float = 1.0,
                 mode: str = "reactive", reclaim: bool = False,
                 metrics: Optional[MetricsRegistry] = None,
                 record_history: bool = False):
        assert mode in ("reactive", "admission")
        self.mode = mode
        self.interval = interval
        self.reclaim = reclaim
        # fault-injection hook (core/faults.py "lost wakeup"): every
        # stall routes its stall-until through this callable(core, t) ->
        # t', so a fault plan can delay or drop the window-end wakeup.
        # None = stalls land exactly at the window boundary.
        self.stall_fault = None
        reg = metrics if metrics is not None \
            else MetricsRegistry(enabled=False)
        self.metrics = metrics
        self._reclaimed = reg.counter("reclaim.drawn")
        self.cores: Dict[int, ThrottleState] = {
            c: ThrottleState(
                budget=float("inf"), interval=interval, core=c,
                trips=reg.counter("throttle.trips", parity=True, core=c),
                used_total=reg.counter("throttle.used_total", core=c),
                denied_total=reg.counter("throttle.denied_total", core=c),
                overrun=reg.gauge("throttle.max_overrun", core=c))
            for c in range(n_cores)}
        # counter-track samples for the Perfetto export (obs.perfetto):
        # ("window", t_end, core, used, limit) per closed finite-budget
        # window, ("draw", t, cumulative) per reclaim transfer. Opt-in:
        # unbounded growth is wrong for long executor runs.
        self.history: Optional[List[Tuple]] = [] if record_history else None
        self._lock = threading.Lock()

    @property
    def total_reclaimed(self) -> float:
        """Units drawn from donors, lifetime."""
        return self._reclaimed.value

    def set_gang_budget(self, budget: Optional[float]) -> Set[int]:
        """Called on gang-lock acquisition: the new gang's declared budget is
        enforced on every core that runs best-effort work (paper §IV-F).
        A budget increase (e.g. the throttling gang departed) lifts stalls
        from the previous regime; usage within the window is kept."""
        return self.set_core_budgets({}, default=budget)

    def set_core_budgets(self, budgets: Dict[int, Optional[float]],
                         default: Optional[float] = None) -> Set[int]:
        """Per-core budget assignment (virtual gangs: each member gang
        declares its own tolerable traffic, so the enforced budget can
        differ per core — see vgang/sched.py). Cores absent from
        ``budgets`` get ``default``. Same stall-lift rule as
        ``set_gang_budget``: a budget increase releases the stall.

        Returns the cores whose regime actually changed (budget moved or
        a stall was lifted) — the event engine folds exactly these into
        its dirty-core set instead of rescanning every core.

        Mid-window lowering: a cut below the core's already-consumed
        usage takes effect *immediately* — ``is_stalled`` treats
        ``used > limit`` as a trip the moment it is next consulted (both
        engines consult it right after truing up the core's usage), so
        the core cannot overrun the new regime until the next
        ``_roll_window``. A decrease also revokes any unspent reclaimed
        grant (``drawn``): the stricter incoming regime wins over quota
        donated under the old one."""
        changed: Set[int] = set()
        with self._lock:
            for c, st in self.cores.items():
                raw = budgets.get(c, default)
                b = float("inf") if raw is None else float(raw)
                if b == st.budget:
                    continue
                if b > st.budget and st.stalled_until > 0.0:
                    st.stalled_until = 0.0
                if b < st.budget:
                    st.drawn = 0.0
                st.budget = b
                changed.add(c)
        return changed

    def _set_stall(self, core: int, st: ThrottleState) -> None:
        """Stall ``core`` until the end of its current window, routed
        through the ``stall_fault`` hook (a lost-wakeup fault extends
        the stall past the boundary). Every stall site goes through
        here so the fault applies uniformly in both engines and the
        executor."""
        until = st.window_start + st.interval
        if self.stall_fault is not None:
            until = self.stall_fault(core, until)
        st.stalled_until = until

    def _note_overrun(self, st: ThrottleState, before: float) -> None:
        """Record how far a *charge* pushed usage past the limit.
        Pre-existing excess (``before`` already over: a mid-window
        budget cut below consumed quota, which ``is_stalled`` converts
        to an immediate stall) is the regime's doing, not a charging
        overrun, and is excluded."""
        if st.budget == _INF or before > st.limit + 1e-12:
            return
        st.overrun.update_max(st.used - st.limit)

    def max_overrun(self) -> float:
        """Worst charge past a per-window limit across all cores."""
        return max(st.max_overrun for st in self.cores.values())

    def _roll_window(self, st: ThrottleState, now: float) -> None:
        delta = now - st.window_start
        if delta >= st.interval:
            if self.history is not None and st.budget != _INF:
                t_end = st.window_start + st.interval
                self.history.append(
                    ("window", t_end, st.core, st.used, st.limit))
                if delta >= 2 * st.interval:
                    # skipped windows carried no usage: one zero sample
                    # steps the counter track down instead of holding
                    self.history.append(
                        ("window", t_end + st.interval, st.core,
                         0.0, st.budget))
            # jump directly to the window containing ``now`` (O(1) even
            # after a long idle gap; every skipped window resets usage)
            st.window_start += int(delta / st.interval) * st.interval
            st.used = 0.0
            st.donated = 0.0
            st.drawn = 0.0

    def charge(self, core: int, amount: float, now: float) -> bool:
        """Account ``amount`` of traffic at time ``now``.

        reactive: always charges; returns False (and stalls the core until
        the next interval) if the budget is now exceeded.
        admission: charges only if it fits; returns False if denied.

        All-or-nothing view of ``charge_partial``: a reactive trip always
        admits a fraction < 1 (the overflowing amount never fully fit)."""
        return self.charge_partial(core, amount, now) >= 1.0

    def charge_partial(self, core: int, amount: float, now: float) -> float:
        """Charge one quantum, admitting a *fraction* of it: the counter
        accounts the full amount (reactive hardware overshoots by less
        than one sampling quantum), the core stalls when the budget is
        exceeded, and the return value is the fraction of the quantum
        that executed before the trip. This keeps the dt-stepped
        engine's progress aligned with the closed-form engine, which
        runs work up to the exact exhaustion instant — without it, a
        lost tripping quantum per window can tip a completion past a
        whole stall period. Admission mode stays all-or-nothing."""
        st = self.cores[core]
        self._roll_window(st, now)
        if now < st.stalled_until:
            st.denied_total.value += amount
            return 0.0
        limit = st.limit
        if self.mode == "admission":
            if st.used + amount > limit:
                st.trips.value += 1
                st.denied_total.value += amount
                self._set_stall(core, st)
                return 0.0
            st.used += amount
            st.used_total.value += amount
            return 1.0
        before = st.used
        st.used += amount
        st.used_total.value += amount
        if st.used > limit:
            st.trips.value += 1
            self._note_overrun(st, before)
            self._set_stall(core, st)
            if amount <= 0.0:
                return 0.0
            return max(0.0, min(1.0, (limit - before) / amount))
        return 1.0

    def is_stalled(self, core: int, now: float) -> bool:
        """Whether ``core`` may not run at ``now``. Usage above the
        current per-window limit counts as stalled even without an
        explicit trip — that is how a mid-window budget cut below the
        already-consumed quota (or a revoked reclaim grant) takes hold
        immediately; the implicit state is converted to an explicit
        stall-until-window-end here (counted once as a throttle event),
        so window-boundary wakeup predictions see it."""
        st = self.cores[core]
        self._roll_window(st, now)
        if now < st.stalled_until:
            return True
        if st.used > st.limit + 1e-12:
            st.trips.value += 1
            self._set_stall(core, st)
            return True
        return False

    def next_release(self, core: int, now: float) -> float:
        st = self.cores[core]
        return max(st.stalled_until, now)

    # ---- continuous-time interface (event-driven engine) -----------------
    # The quantum simulator charges dt-sized packets through ``charge``;
    # the exact engine instead runs best-effort work over closed intervals
    # and needs (a) span accounting, (b) the closed-form time at which the
    # current budget trips, (c) an explicit trip. These are the dt -> 0
    # limit of the reactive mode (no one-quantum overshoot).

    def window_end(self, core: int, now: float) -> float:
        st = self.cores[core]
        self._roll_window(st, now)
        return st.window_start + st.interval

    def charge_span(self, core: int, rate: float, t0: float,
                    t1: float) -> None:
        """Account continuous traffic at ``rate`` units/ms over [t0, t1].
        Spans may cross regulation-window boundaries; usage carried into
        the window containing ``t1`` is exactly the traffic generated since
        that window opened."""
        st = self.cores[core]
        self._roll_window(st, t0)
        amount = rate * (t1 - t0)
        if t1 < st.window_start + st.interval:
            before = st.used
            st.used += amount
        else:
            self._roll_window(st, t1)
            before = 0.0
            st.used = rate * (t1 - st.window_start)
        st.used_total.value += amount
        self._note_overrun(st, before)

    def next_trip_time(self, core: int, rate: float, now: float) -> float:
        """Absolute time at which continuous traffic at ``rate`` exceeds the
        per-window limit, assuming the rate holds; inf if it never does.
        Exactly reaching the limit at a window boundary does not trip
        (usage never *exceeds* it). Under reclaiming the current window's
        limit includes the pool draw already granted to this core
        (``drawn``) minus what it donated; a prediction crossing into the
        next window prices the plain budget (both counters reset at the
        roll, and future donations only *raise* the limit, so the
        prediction is re-derived at the trip event, never missed)."""
        st = self.cores[core]
        self._roll_window(st, now)
        if st.budget == float("inf") or rate <= 0.0:
            return float("inf")
        we = st.window_start + st.interval
        t = now + max(0.0, st.limit - st.used) / rate
        if t < we - 1e-12:
            return t
        if st.budget / rate < st.interval - 1e-12:
            return we + st.budget / rate
        return float("inf")

    def trip(self, core: int, now: float) -> None:
        """Stall ``core`` until the end of the current regulation window
        (the budget was exhausted at ``now``)."""
        st = self.cores[core]
        self._roll_window(st, now)
        st.trips.value += 1
        self._set_stall(core, st)

    # ---- dynamic reclaiming (DESIGN.md §7.5) -------------------------
    # Pure accounting: eligibility (which cores may donate, which
    # occupants may draw) is decided by the caller — the MemoryModel for
    # the simulator engines, the executor for lanes.

    def donatable(self, core: int, now: float) -> float:
        """Unspent quota of ``core``'s current window that a donor scan
        may hand out: limit - used, for finite budgets only (an
        unthrottled core has no meaningful quota to give)."""
        st = self.cores[core]
        self._roll_window(st, now)
        if st.budget == _INF:
            return 0.0
        return max(0.0, st.limit - st.used)

    def draw_from(self, core: int, donors: Iterable[int], need: float,
                  now: float, require_full: bool = False) -> float:
        """Pull up to ``need`` units out of ``donors``' windows (scanned
        in the given order — callers pass core order, which both engines
        and the analysis replicate) and grant them to ``core``'s window.
        Returns the amount actually drawn; 0 when reclaiming is off.

        ``require_full``: draw nothing unless the donors can cover the
        whole ``need`` — an admission-mode caller gains nothing from a
        partial grant (the quantum is still denied whole), while the
        donors would lose the quota for the rest of the window."""
        if not self.reclaim or need <= 0.0:
            return 0.0
        got = 0.0
        with self._lock:
            donors = [d for d in donors if d != core]
            if require_full:
                avail = sum(self.donatable(d, now) for d in donors)
                if avail < need - 1e-15:
                    return 0.0
            for d in donors:
                got += self._transfer(d, core, need - got, now)
                if got >= need - 1e-15:
                    break
        return got

    def _transfer(self, donor: int, drawer: int, amount: float,
                  now: float) -> float:
        """Move up to ``amount`` of ``donor``'s unspent window quota to
        ``drawer``'s window — the one place the donation invariant
        (donor ``donated`` marked so quota is never handed out twice,
        drawer ``drawn`` credited, ``total_reclaimed`` accounted) is
        maintained; ``draw_from`` and MemoryModel.claim both route
        through it. Returns the amount moved."""
        take = min(self.donatable(donor, now), amount)
        if take <= 0.0:
            return 0.0
        self.cores[donor].donated += take
        st = self.cores[drawer]
        self._roll_window(st, now)
        st.drawn += take
        self._reclaimed.value += take
        if self.history is not None:
            self.history.append(("draw", now, self._reclaimed.value))
        return take

    def unstall(self, core: int) -> None:
        """Lift ``core``'s stall (a reclaim draw restored its quota)."""
        self.cores[core].stalled_until = 0.0

    def reset_reclaim(self) -> None:
        """Void every core's window donation state. The engines and the
        executor call this on each gang-lock *acquire*: grants and
        donation marks belong to
        the regime that issued them, and an incoming gang whose budget
        values happen to equal the old ones would otherwise inherit
        them (``set_core_budgets`` diffs values and cannot see the
        leadership change)."""
        with self._lock:
            for st in self.cores.values():
                st.donated = 0.0
                st.drawn = 0.0
