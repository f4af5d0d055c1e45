"""Discrete-event (fixed-quantum) scheduler simulator.

Drives the faithful ``GangScheduler`` state machine over N cores with:
* periodic parallel RT tasks (threads pinned to cores, no migration),
* best-effort tasks under a CFS-like fair scheduler on idle cores,
* a pluggable pairwise interference model (co-scheduled task X slows task Y
  by factor f(Y, X) — the paper's DNN/BwWrite case gives f = 10.33),
* BWLOCK-style bandwidth throttling of best-effort cores.

``enabled=False`` turns RT-Gang off: each core independently runs its
highest-priority ready RT thread (Linux SCHED_FIFO baseline = the paper's
"Co-Sched" configuration). This reproduces Fig.4(a)/(c); enabling RT-Gang
reproduces Fig.4(b) and Fig.5(b).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.faults import Enforcement, FaultManager, FaultPlan
from repro_torch.core.gang import (BETask, RTTask, Thread, validate_declared,
                                   validate_taskset)
from repro_torch.core.glock import GangScheduler
from repro_torch.core.memmodel import BE, MemoryModel
from repro_torch.core.throttle import BandwidthRegulator
from repro_torch.core.tracing import NullTrace, Trace
from repro_torch.obs.margins import margin_summary
from repro_torch.obs.metrics import MetricsRegistry


@dataclasses.dataclass
class Job:
    task: RTTask
    release: float
    remaining: Dict[int, float]          # core -> remaining work
    index: int
    start: Optional[float] = None
    finish: Optional[float] = None
    aborted: bool = False                # enforcement killed this job

    @property
    def done(self) -> bool:
        return all(r <= 1e-12 for r in self.remaining.values())

    def response_time(self) -> Optional[float]:
        if self.finish is None:
            return None
        return self.finish - self.release


PairwiseInterference = Callable[[str, str], float]


def no_interference(victim: str, aggressor: str) -> float:
    return 1.0


def matrix_interference(table: Dict[Tuple[str, str], float]
                        ) -> PairwiseInterference:
    def f(victim: str, aggressor: str) -> float:
        return table.get((victim, aggressor), 1.0)
    return f


@dataclasses.dataclass
class SimResult:
    trace: Trace
    response_times: Dict[str, List[float]]
    deadline_misses: Dict[str, int]
    be_progress: Dict[str, float]
    throttle_events: int
    ipis: int
    preemptions: int
    slack_time: float                    # core-ms of idle+BE time
    horizon: float
    events: int = 0                      # event-engine: events processed
    engine: str = "quantum"              # "quantum" (dt-stepped) | "event"
    reclaimed: float = 0.0               # traffic units drawn from donors
    # absolute times of each deadline miss (including enforcement
    # aborts, stamped at the abort instant) — keyed like deadline_misses
    miss_times: Dict[str, List[float]] = dataclasses.field(
        default_factory=dict)
    faults: Optional[Dict] = None        # FaultManager.summary() when armed
    # observability (DESIGN.md §12): RTA-margin summary per task (when
    # the run was given analytic bounds), and the metric snapshots
    # (when the run was given a MetricsRegistry)
    rta_margins: Optional[Dict] = None   # obs.margins.margin_summary()
    metrics: Optional[Dict] = None       # MetricsRegistry.snapshot()
    parity_metrics: Optional[Dict] = None  # engine-parity counters only

    def wcrt(self, name: str) -> float:
        rs = self.response_times.get(name) or [float("nan")]
        return max(rs)

    def percentile(self, name: str, q: float) -> float:
        """q-th percentile (0..100) of the task's response times, linear
        interpolation between order statistics (numpy's default rule, but
        dependency-free — SimResult is consumed by pure-python sweeps)."""
        rs = sorted(self.response_times.get(name) or ())
        if not rs:
            return float("nan")
        k = (len(rs) - 1) * q / 100.0
        lo = math.floor(k)
        hi = min(lo + 1, len(rs) - 1)
        return rs[lo] + (rs[hi] - rs[lo]) * (k - lo)

    def percentiles(self, name: str) -> Dict[str, float]:
        """p50/p95/p99/p999 latency summary for long-horizon CDF runs
        (Fig.6-style statistics at >= 10^6 ms horizons)."""
        return {"p50": self.percentile(name, 50.0),
                "p95": self.percentile(name, 95.0),
                "p99": self.percentile(name, 99.0),
                "p999": self.percentile(name, 99.9),
                "max": self.wcrt(name),
                "n": len(self.response_times.get(name) or ())}


class Simulator:
    def __init__(self, n_cores: int, rt_tasks: Sequence[RTTask],
                 be_tasks: Sequence[BETask] = (),
                 interference: PairwiseInterference = no_interference,
                 rt_gang_enabled: bool = True,
                 throttle_mode: str = "reactive",
                 regulation_interval: float = 1.0,
                 dt: Optional[float] = 0.05,
                 budget_policy: Optional["BudgetPolicy"] = None,
                 reclaim: bool = False,
                 fault_plan: Optional[FaultPlan] = None,
                 enforcement: Optional[Enforcement] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 rta_bounds: Optional[Dict[str, float]] = None,
                 record_counters: bool = False,
                 trace: bool = True, **unknown):
        """``dt``: quantum length in ms for the fixed-quantum engine, or
        ``None`` to run the exact event-driven engine (core/events.py) —
        same SimResult, O(events) instead of O(horizon/dt).

        ``reclaim``: enable mid-window bandwidth donation (DESIGN.md
        §7.5): idle cores' unspent window quota is drawn — through the
        MemoryModel's dominance gate — by RT threads that would
        otherwise trip, in both engines identically.

        ``budget_policy``: optional object with ``apply(glock, regulator)``
        called whenever scheduling settles to set throttle budgets,
        replacing the default leader-budget rule. ``apply`` must return
        the set of cores whose throttle regime it changed (what
        ``BandwidthRegulator.set_core_budgets`` returns) — the event
        engine re-predicts trip/stall events only for those cores — or
        ``None`` to force a conservative all-cores refresh. Virtual
        gangs use it to enforce the minimum budget over co-running
        member gangs, and RTG-throttle to cap sibling members
        (vgang/sched.py).

        ``fault_plan`` / ``enforcement``: seeded fault injection and
        runtime overrun enforcement (core/faults.py, DESIGN.md §11) —
        both engines drive the same FaultManager, so injected faults
        and enforcement decisions are engine-identical. Passing an
        ``enforcement`` policy additionally runs the strict
        ``validate_declared`` check: enforcement budgets are derived
        from declarations, so the declarations must be trustworthy.

        Observability (DESIGN.md §12): ``metrics`` plumbs one
        MetricsRegistry through the scheduler, regulator and fault
        layer and stamps its snapshots into the SimResult (None = the
        components run detached instruments, the bare mode).
        ``rta_bounds`` maps task name -> analytic response-time bound
        (ms); every completed job's margin against it is summarized in
        ``SimResult.rta_margins``.

        ``trace=False`` skips timeline recording entirely (a no-op
        NullTrace): identical SimResult counters, misses, percentiles
        and margins, but ``result.trace`` stays empty — the analysis
        fast path for Monte-Carlo sim-checks (DESIGN.md §13.4).

        ``record_counters`` keeps the
        regulator's per-window history and the gang-change log for
        Perfetto counter tracks (obs.perfetto.export_sim)."""
        if unknown:
            raise TypeError(
                f"Simulator: unknown option(s) {sorted(unknown)}; valid "
                f"options: be_tasks, budget_policy, dt, enforcement, "
                f"fault_plan, interference, metrics, reclaim, "
                f"record_counters, regulation_interval, rt_gang_enabled, "
                f"rta_bounds, throttle_mode, trace")
        validate_taskset(rt_tasks)
        if not regulation_interval > 0.0:
            raise ValueError(
                f"regulation_interval must be > 0, "
                f"got {regulation_interval}")
        if dt is not None and not dt > 0.0:
            raise ValueError(f"dt must be > 0 (or None), got {dt}")
        if enforcement is not None:
            validate_declared(rt_tasks)
        self.n_cores = n_cores
        self.rt_tasks = list(rt_tasks)
        self.be_tasks = list(be_tasks)
        self.interference = interference
        self.dt = dt
        self.budget_policy = budget_policy
        self.metrics = metrics
        self.rta_bounds = dict(rta_bounds) if rta_bounds else None
        self.record_counters = record_counters
        mreg = metrics if metrics is not None \
            else MetricsRegistry(enabled=False)
        self._mreg = mreg
        self.sched = GangScheduler(n_cores, enabled=rt_gang_enabled,
                                   metrics=mreg)
        self.reg = BandwidthRegulator(n_cores, interval=regulation_interval,
                                      mode=throttle_mode, reclaim=reclaim,
                                      metrics=mreg,
                                      record_history=record_counters)
        self.mm = MemoryModel(n_cores, interference, self.reg)
        # trace=False swaps in a no-op recorder: Segment construction is
        # the top allocator on the hot path and Monte-Carlo sim-checks
        # never read the timeline (DESIGN.md §13.4)
        self.trace = Trace(n_cores) if trace else NullTrace(n_cores)
        self.profile = False        # event engine: record phase breakdown
        # per-core best-effort fair-share tables, shared by both engines
        # (candidates, their names, and the aggregate sum(mem_rate)/n
        # traffic a free core charges — DESIGN.md §8.3)
        self.be_cands: List[Tuple[BETask, ...]] = [
            tuple(b for b in self.be_tasks if c in b.cores)
            for c in range(n_cores)]
        self.be_names = [tuple(b.name for b in cands)
                         for cands in self.be_cands]
        # fault injection + enforcement state machine (shared by both
        # engines; a no-op shell when neither plan nor policy is given)
        self.fm = FaultManager(rt_tasks, fault_plan, enforcement,
                               metrics=mreg)
        self.fm.install(self.reg)
        # per-task parity counters, pre-created at construction so both
        # engines' registries index identical series even for tasks
        # that never release or complete within the horizon; trued up
        # from the authoritative result dicts in ``finalize_result``
        self._task_counters = {t.name: (
            mreg.counter("task.releases", parity=True, gang=t.name),
            mreg.counter("task.completions", parity=True, gang=t.name),
            mreg.counter("task.misses", parity=True, gang=t.name))
            for t in self.rt_tasks}
        # gang-change log for the Perfetto glock-hold counter track:
        # (t, event, leader name) — filled only when record_counters
        self.gang_events: List[Tuple[float, str, Optional[str]]] = []
        # a lying BE task charges its *actual* (inflated) traffic — the
        # regulator contains the overrun by construction
        bef = self.fm.plan.be_factor
        self.be_share_rate = [
            sum(b.mem_rate * bef(b.name) for b in cands) / len(cands)
            if cands else 0.0
            for cands in self.be_cands]

    def apply_budget_rule(self):
        """Refresh throttle budgets from the gang-lock state: the
        ``budget_policy`` when given, else the paper's rule — the
        leader's declared budget on every core not occupied by the
        running gang; gang-occupied cores run unthrottled (RT threads
        charge their own traffic since the MemoryModel refactor, so the
        default rule must not turn a gang's budget on itself — only an
        explicit policy such as RTG-throttle regulates RT members).
        Returns the cores whose throttle regime changed."""
        g = self.sched.g
        if self.sched.enabled and self.budget_policy is not None:
            changed = self.budget_policy.apply(g, self.reg)
            return changed if changed is not None else \
                set(range(self.n_cores))
        if self.sched.enabled and g.held_flag and g.leader is not None:
            occupied = {th.core for th in g.gthreads if th is not None}
            return self.reg.set_core_budgets(
                {c: None for c in occupied}, default=g.leader.mem_budget)
        return self.reg.set_gang_budget(None)

    def gang_hook(self, time_cell: List[float]):
        """Compose the gang-change callbacks a run needs: reclaim-grant
        voiding on acquire, and the gang-event log (Perfetto glock-hold
        counter track) stamped at the driving engine's current time —
        the engine keeps ``time_cell[0]`` current. Returns None when
        there is nothing to observe."""
        hooks = []
        if self.reg.reclaim:
            hooks.append(lambda ev, ldr: self.reg.reset_reclaim()
                         if ev == "acquire" else None)
        if self.record_counters:
            log = self.gang_events
            hooks.append(lambda ev, ldr: log.append(
                (time_cell[0], ev, None if ldr is None else ldr.name)))
        if not hooks:
            return None
        if len(hooks) == 1:
            return hooks[0]

        def fire(ev, ldr):
            for h in hooks:
                h(ev, ldr)
        return fire

    def finalize_result(self, trace: Trace,
                        response: Dict[str, List[float]],
                        misses: Dict[str, int],
                        miss_times: Dict[str, List[float]],
                        be_progress: Dict[str, float],
                        slack: float, horizon: float,
                        releases: Dict[str, int],
                        events: int = 0,
                        engine: str = "quantum") -> SimResult:
        """Shared result assembly for both engines: true up the
        per-task parity counters from the authoritative result dicts
        (releases/completions/misses — including enforcement aborts and
        late demoted completions, which the FaultManager folds into the
        same dicts), compute RTA margins against any declared bounds,
        and stamp the metric snapshots."""
        fm = self.fm
        for name, (c_rel, c_comp, c_miss) in self._task_counters.items():
            c_rel.value = releases.get(name, 0)
            c_comp.value = len(response.get(name) or ())
            c_miss.value = misses.get(name, 0)
        rta_margins = None
        if self.rta_bounds:
            rta_margins = margin_summary(response, self.rta_bounds,
                                         metrics=self.metrics)
        throttle_events = sum(st.throttle_events
                              for st in self.reg.cores.values())
        return SimResult(
            trace=trace, response_times=response, deadline_misses=misses,
            be_progress=be_progress, throttle_events=throttle_events,
            ipis=self.sched.g.ipis_sent,
            preemptions=self.sched.g.preemptions,
            slack_time=slack, horizon=horizon,
            events=events, engine=engine,
            reclaimed=self.reg.total_reclaimed,
            miss_times=miss_times,
            faults=fm.summary()
            if (fm.enf is not None or fm.plan.faults) else None,
            rta_margins=rta_margins,
            metrics=self.metrics.snapshot()
            if self.metrics is not None else None,
            parity_metrics=self.metrics.parity_snapshot()
            if self.metrics is not None else None)

    # -----------------------------------------------------------------
    def run(self, horizon: float) -> SimResult:
        if self.dt is None:
            from repro_torch.core.events import EventEngine
            eng = EventEngine(self)
            self.last_engine = eng       # bench_sim.py reads phase_wall
            return eng.run(horizon)
        dt = self.dt
        nsteps = int(round(horizon / dt))
        jobs: Dict[int, List[Job]] = {t.uid: [] for t in self.rt_tasks}
        threads: Dict[Tuple[int, int], Thread] = {}
        for t in self.rt_tasks:
            for i, c in enumerate(t.cores):
                threads[(t.uid, c)] = Thread(task=t, core=c, index=i)

        current: List[Optional[Thread]] = [None] * self.n_cores
        be_progress = {b.name: 0.0 for b in self.be_tasks}
        be_cands, be_names = self.be_cands, self.be_names
        be_agg = self.be_share_rate
        mm = self.mm
        response: Dict[str, List[float]] = {t.name: [] for t in self.rt_tasks}
        misses = {t.name: 0 for t in self.rt_tasks}
        miss_times: Dict[str, List[float]] = {t.name: []
                                              for t in self.rt_tasks}
        fm = self.fm
        fm.bind(misses, miss_times, response)
        slack = 0.0

        def release_jobs(now: float):
            for t in self.rt_tasks:
                done_jobs = len(jobs[t.uid])
                if t.n_jobs is not None and done_jobs >= t.n_jobs:
                    continue
                next_rel = t.release_offset + done_jobs * t.period
                if now + 1e-9 >= next_rel:
                    j = Job(task=t, release=next_rel, index=done_jobs,
                            remaining={c: t.thread_wcet(c) for c in t.cores})
                    fm.on_release(j)
                    jobs[t.uid].append(j)

        def active_job(t: RTTask) -> Optional[Job]:
            for j in jobs[t.uid]:
                if not j.done:
                    return j
            return None

        def has_work(uid: int, core: int) -> bool:
            j = active_job(fm.tasks[uid])
            return j is not None and j.remaining.get(core, 0.0) > 1e-12

        def ready_thread(core: int) -> Optional[Thread]:
            best: Optional[Thread] = None
            for t in self.rt_tasks:
                if core not in t.cores or t.uid in fm.suspended:
                    continue
                j = active_job(t)
                if j is None or j.remaining.get(core, 0) <= 1e-12:
                    continue
                if best is None or t.prio > best.task.prio:
                    best = threads[(t.uid, core)]
            return best

        dirty = set(range(self.n_cores))
        self.sched.reschedule_cpus = lambda cores: dirty.update(cores)
        time_cell = [0.0]
        self.sched.on_gang_change = self.gang_hook(time_cell)

        for step in range(nsteps):
            now = step * dt
            time_cell[0] = now
            release_jobs(now)

            # ---- scheduling passes until fixed point --------------------
            dirty.update(range(self.n_cores))
            for _ in range(4 + len(self.rt_tasks)):
                if not dirty:
                    break
                todo = sorted(dirty)
                dirty.clear()
                for c in todo:
                    prev = current[c]
                    nxt = ready_thread(c)
                    picked = self.sched.pick_next_task_rt(c, prev, nxt)
                    current[c] = picked
            # preempted cores cleared by do_gang_preemption: sync with glock
            for c in range(self.n_cores):
                if current[c] is not None and \
                        self.sched.enabled and \
                        self.sched.g.gthreads[c] is not current[c]:
                    current[c] = self.sched.g.gthreads[c]
            # lock-leak audit: an abort/demote in the previous step must
            # have left the gang lock by the time this step's pass settles
            if fm.pending_audit:
                fm.audit(self.sched.g, has_work)

            # set throttle budgets from the running gang / budget policy
            self.apply_budget_rule()

            # ---- occupancy (MemoryModel): who runs, who is stalled ------
            # Best-effort candidates share a free core fractionally (the
            # event engine's fair-sharing semantics, the dt -> 0 limit of
            # the old per-step round-robin): every unstalled candidate is
            # present for interference and the core charges the aggregate
            # traffic sum(mem_rate)/n. RT threads with traffic charge too
            # and pause mid-job while their core's budget is tripped.
            rt_stalled = set()
            for c in range(self.n_cores):
                # a demoted residual occupies an otherwise-free core as
                # an RT-kind occupant (charges its own traffic, stalls
                # under the ambient budget)
                occ = current[c] if current[c] is not None \
                    else fm.dem_thread(c)
                if mm.refresh_core(c, occ, be_names[c], be_agg[c],
                                   now):
                    rt_stalled.add(c)
            if self.reg.reclaim and rt_stalled:
                # mid-window donation: a stalled RT thread retries the
                # pool (a donor may have gone idle); a granted draw
                # lifts the stall and the thread resumes this quantum —
                # the same instant the event engine resumes it
                # (demoted residuals never claim: they are best-effort)
                for c in sorted(rt_stalled):
                    if current[c] is not None and \
                            mm.claim_lift(c, current[c].task, now):
                        rt_stalled.discard(c)
                        mm.refresh_core(c, current[c], be_names[c],
                                        be_agg[c], now)

            # ---- advance RT work + best-effort progress ------------------
            for c in range(self.n_cores):
                th = current[c]
                if th is None:
                    d = fm.dem_head(c)
                    if d is not None:
                        # demoted residual: drains ahead of BE fillers
                        # whenever the core is free, under the ambient
                        # throttle budget; not counted as slack
                        if c in rt_stalled:
                            self.trace.record(
                                c, "throttled:" + d.task.name, now,
                                now + dt)
                            continue
                        frac = mm.charge_quantum(c, dt, now)
                        if frac <= 0.0:
                            self.trace.record(
                                c, "throttled:" + d.task.name, now,
                                now + dt)
                            continue
                        slow = mm.slowdown(d.task.name, c)
                        d.residual[c] = max(
                            0.0, d.residual[c] - dt * frac / slow)
                        self.trace.record(c, "dem:" + d.task.name, now,
                                          now + dt * frac)
                        if frac < 1.0:
                            self.trace.record(
                                c, "throttled:" + d.task.name,
                                now + dt * frac, now + dt)
                        if d.residual[c] <= 1e-12:
                            fm.dem_finish_core(c, now + dt)
                        continue
                    slack += dt
                    cands = be_cands[c]
                    if mm.kind[c] == BE:
                        frac = mm.charge_quantum(c, dt, now)
                        run = dt * frac
                        if frac > 0.0:
                            sub = run / len(cands)
                            for i, b in enumerate(cands):
                                be_progress[b.name] += sub
                                self.trace.record(c, b.name, now + i * sub,
                                                  now + (i + 1) * sub)
                        if frac < 1.0:
                            heavy = max(cands, key=lambda b: b.mem_rate)
                            self.trace.record(c, "throttled:" + heavy.name,
                                              now + run, now + dt)
                    elif cands:
                        heavy = max(cands, key=lambda b: b.mem_rate)
                        self.trace.record(c, "throttled:" + heavy.name,
                                          now, now + dt)
                    else:
                        self.trace.record(c, None, now, now + dt)
                    continue
                j = active_job(th.task)
                if j is None:
                    continue
                if j.start is None:
                    j.start = now
                if c in rt_stalled:
                    self.trace.record(c, "throttled:" + th.task.name,
                                      now, now + dt)
                    continue
                frac = mm.charge_quantum(c, dt, now)
                if frac <= 0.0:
                    self.trace.record(c, "throttled:" + th.task.name,
                                      now, now + dt)
                    continue
                # budget tripping mid-quantum: the thread pauses mid-job
                # after the admitted fraction and stays stalled until the
                # regulation window ends
                slow = mm.slowdown(th.task.name, c)
                j.remaining[c] = max(0.0, j.remaining[c] - dt * frac / slow)
                self.trace.record(c, th.task.name, now, now + dt * frac)
                if frac < 1.0:
                    self.trace.record(c, "throttled:" + th.task.name,
                                      now + dt * frac, now + dt)
                if j.done and j.finish is None:
                    j.finish = now + dt
                    rt = j.response_time()
                    response[th.task.name].append(rt)
                    if rt > th.task.deadline + 1e-9:
                        misses[th.task.name] += 1
                        miss_times[th.task.name].append(now + dt)
                    # if this was the degrading job, lift the suspension
                    fm.maybe_restore(th.task.uid, j.index)

            # ---- overrun enforcement (work budgets + watchdog) ----------
            if fm.enf is not None:
                t_end = now + dt
                for t in self.rt_tasks:
                    for j in jobs[t.uid]:
                        if j.done or j.aborted:
                            continue
                        via = fm.due(j, t_end)
                        if via is None:
                            continue
                        action = fm.fire(j, t_end, via)
                        if action is None:
                            continue
                        if action == "degrade":
                            fm.begin_degrade(j, self.rt_tasks)
                            continue
                        if action == "demote":
                            # snapshot the residual before zeroing
                            fm.begin_demote(j, t_end)
                        else:
                            j.aborted = True
                            fm.record_abort(j, t_end)
                        for c in j.remaining:
                            j.remaining[c] = 0.0
                        if j.aborted:
                            fm.maybe_restore(t.uid, j.index)

        return self.finalize_result(
            self.trace, response, misses, miss_times, be_progress,
            slack, horizon,
            releases={t.name: len(jobs[t.uid]) for t in self.rt_tasks})
