"""Exact, event-driven scheduling engine — the dt -> 0 limit of the
fixed-quantum simulator in sim.py, at O(events) instead of
O(horizon/dt x cores x jobs) cost.

Design (DESIGN.md §8, §10):

* **Heap event queue.** A single heapq holds job releases, thread
  completions, throttle trips (budget exhaustion) and throttle replenish /
  un-stall wakeups. Gang hand-offs (lock release -> blocked cores wake,
  gang preemption IPIs) are zero-delay events: the GangScheduler's
  ``reschedule_cpus`` callback feeds the dirty-core set that the same-
  timestamp scheduling fixed point drains, and ``on_gang_change`` counts
  them.
* **Lazy closed-form advancement.** Between two regime changes a core's
  occupant, slowdown and traffic rate are constant, so its remaining
  work decreases linearly and nothing needs stepping: each core carries
  a ``mat`` watermark and is *materialized* (work subtracted, traffic
  charged, trace recorded — all in closed form over the whole span)
  only when its own regime is about to change. A steady-state event
  therefore touches O(dirty) cores; untouched cores cost nothing, no
  matter how many cores the machine has.
* **Active-job pointers.** Each task keeps a deque of released-but-
  unfinished jobs; the head is the active job (O(1)), replacing the
  quantum loop's linear rescan of every completed job.
* **Priority-indexed ready queues.** Each core keeps a lazy max-heap of
  (−prio, submission-order, task-uid) entries pushed on job activation;
  stale entries (no pending work on that core) are popped on peek. This
  replaces the per-core O(tasks) scan.
* **Incremental co-runner sets (MemoryModel, DESIGN.md §10).** The old
  per-event ``recompute_rates`` rescan of every (core, core) pair is
  gone: occupancy lives in the shared MemoryModel, updates flow through
  a ``changed``-core set (scheduling deltas, budget-regime deltas,
  trip/unstall wakeups), and interference aggregates are memoized per
  victim name against the occupant-name-set epoch. Only a distinct-
  name-set change pays one cached-lookup sweep to re-pin completion
  predictions.
* **RT-thread bandwidth charging.** Running RT threads charge
  ``RTTask.traffic_rate`` through the regulator exactly like best-effort
  work; a tripped RT thread pauses mid-job — removed from occupancy (no
  traffic, no interference), its completion re-predicted on un-stall at
  the window boundary. This is what RTG-throttle (vgang/sched.py)
  drives: sibling members of a virtual gang are capped while the
  critical member runs unthrottled.

Semantic parity with the quantum engine (asserted by tests/test_events.py
and tests/test_memmodel.py on the paper's Fig.4 and Fig.5 tasksets):
identical GangScheduler state machine, identical MemoryModel, and the
continuous-time limit of the reactive bandwidth regulator (a core stalls
the instant its window budget is exhausted — the quantum engine
overshoots by at most one accounting quantum, which is exactly its O(dt)
discretization bias). Best-effort candidates sharing a core are modeled
as fair fractional co-runners (each gets 1/n of the core and generates
1/n of its traffic) in both engines.
"""
from __future__ import annotations

import heapq
import itertools
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from repro_torch.core.gang import RTTask, Thread
from repro_torch.core.memmodel import BE

_EPS_T = 1e-9       # time comparison tolerance (ms)
_EPS_W = 1e-9       # work comparison tolerance (ms of compute)
_INF = float("inf")

# event kinds (heap tiebreak after time+seq; values are cosmetic).
# _ENFORCE:     predicted work-budget crossing of a job (faults.py) —
#               validated against the materialized remaining at pop, so
#               stale predictions are harmless.
# _WATCHDOG:    a job's absolute wall-clock abort deadline (pushed once
#               at release; FaultManager decides whether it still applies).
# _DEMCOMPLETE: a demoted residual drains its share on one core.
(_RELEASE, _COMPLETE, _EXHAUST, _UNSTALL,
 _ENFORCE, _WATCHDOG, _DEMCOMPLETE) = range(7)


class _TaskState:
    """Per-task release bookkeeping + the active-job pointer."""
    __slots__ = ("task", "queue", "released")

    def __init__(self, task: RTTask):
        self.task = task
        self.queue: deque = deque()      # released, unfinished jobs (FIFO)
        self.released = 0

    @property
    def active(self):
        return self.queue[0] if self.queue else None


class EventEngine:
    """Drives a Simulator's GangScheduler/BandwidthRegulator/MemoryModel/
    Trace to an exact SimResult. Constructed by ``Simulator.run`` when
    ``dt is None``."""

    def __init__(self, sim):
        self.sim = sim
        self.events_processed = 0
        self.handoffs = 0
        self.releases = 0
        self.phase_wall: Dict[str, float] = {}
        self._gang_dirty = False

    # -----------------------------------------------------------------
    def run(self, horizon: float):
        from repro_torch.core.sim import Job

        sim = self.sim
        n = sim.n_cores
        sched, reg, trace, mm = sim.sched, sim.reg, sim.trace, sim.mm
        record = trace.record       # hot: bound once (no-op for NullTrace)
        tasks = list(sim.rt_tasks)
        order = {t.uid: i for i, t in enumerate(tasks)}
        threads: Dict[Tuple[int, int], Thread] = {
            (t.uid, c): Thread(task=t, core=c, index=i)
            for t in tasks for i, c in enumerate(t.cores)}
        tstate = {t.uid: _TaskState(t) for t in tasks}

        profile = bool(getattr(sim, "profile", False))
        phase_wall = self.phase_wall
        if profile:
            for k in ("fixed_point", "rates", "push_updates", "advance",
                      "events"):
                phase_wall[k] = 0.0
        perf = time.perf_counter

        response: Dict[str, List[float]] = {t.name: [] for t in tasks}
        misses = {t.name: 0 for t in tasks}
        miss_times: Dict[str, List[float]] = {t.name: [] for t in tasks}
        be_progress = {b.name: 0.0 for b in sim.be_tasks}
        fm = sim.fm
        fm.bind(misses, miss_times, response)
        slack = 0.0

        current: List[Optional[Thread]] = [None] * n
        slow = [1.0] * n                     # interference slowdown per core
        mat = [0.0] * n                      # per-core materialized-to time
        rt_sig: List[Optional[tuple]] = [None] * n   # completion-push sig
        chg_sig: List[Optional[tuple]] = [None] * n  # charging-push sig
        core_epoch = [0] * n                 # _EXHAUST validity guard
        rt_stalled = [False] * n
        stall_label: List[Optional[str]] = [None] * n
        be_cands, be_names = sim.be_cands, sim.be_names
        be_rate = sim.be_share_rate
        reclaim = reg.reclaim
        mm_epoch = mm.agg_epoch - 1          # force first reconcile sweep

        ready: List[list] = [[] for _ in range(n)]
        heap: list = []
        seq = itertools.count()

        def push(t: float, kind: int, data) -> None:
            heapq.heappush(heap, (t, next(seq), kind, data))

        dirty = set()        # cores needing a scheduling pass
        changed = set()      # cores whose occupancy/throttle regime moved

        def _resched(cores):                 # gang hand-off / preemption IPI
            dirty.update(cores)
        sched.reschedule_cpus = _resched

        # reclaim-grant voiding + the gang-event log live in the shared
        # Simulator.gang_hook (the quantum engine installs the same
        # callbacks); cur_t keeps the log stamped with event time
        cur_t = [0.0]
        extra_hook = sim.gang_hook(cur_t)

        def _gang_change(event, leader):
            # joins/leaves mark the regime dirty but are membership
            # churn, not lock hand-offs — keep the metric's meaning
            if event in ("acquire", "release", "preempt"):
                self.handoffs += 1
            if extra_hook is not None:
                extra_hook(event, leader)
            self._gang_dirty = True
        sched.on_gang_change = _gang_change

        # ---- lazy advancement ---------------------------------------
        def materialize(c: int, t: float) -> None:
            """Apply core ``c``'s constant regime over [mat[c], t): work
            progress, traffic charging and trace, all closed-form. Must
            run before any regime ingredient of ``c`` changes (occupant,
            slowdown, stall state, active job)."""
            nonlocal slack
            t0 = mat[c]
            mat[c] = t
            if t - t0 < 1e-12:
                return
            if profile:
                t_p = perf()
            th = current[c]
            if th is not None:
                j = tstate[th.task.uid].active
                if j is None:        # drained; idle until rescheduled
                    record(c, None, t0, t)
                    slack += t - t0
                elif rt_stalled[c]:
                    # paused mid-job: no progress, no traffic
                    record(c, stall_label[c] or
                                 "throttled:" + th.task.name, t0, t)
                else:
                    if j.start is None:
                        j.start = t0
                    j.remaining[c] = max(0.0,
                                         j.remaining[c] - (t - t0) / slow[c])
                    r = mm.rates[c]
                    if r > 0.0:
                        reg.charge_span(c, r, t0, t)
                    record(c, th.task.name, t0, t)
            elif fm.dem_thread(c) is not None:
                # demoted residual (faults.py): drains on the free core
                # ahead of BE fillers, charging its own traffic, under
                # the ambient throttle budget; not counted as slack
                dth = fm.dem_thread(c)
                d = fm.dem_head(c)
                if rt_stalled[c]:
                    record(c, stall_label[c] or
                                 "throttled:" + dth.task.name, t0, t)
                else:
                    d.residual[c] = max(0.0,
                                        d.residual[c] - (t - t0) / slow[c])
                    r = mm.rates[c]
                    if r > 0.0:
                        reg.charge_span(c, r, t0, t)
                    record(c, "dem:" + dth.task.name, t0, t)
            else:
                slack += t - t0
                if mm.kind[c] == BE:
                    cands = be_cands[c]
                    k = len(cands)
                    if k == 1:
                        be_progress[cands[0].name] += t - t0
                        record(c, cands[0].name, t0, t)
                    else:
                        sub = (t - t0) / k
                        for i, b in enumerate(cands):
                            be_progress[b.name] += sub
                            record(c, b.name, t0 + i * sub,
                                         t0 + (i + 1) * sub)
                    r = mm.rates[c]
                    if r > 0.0:
                        reg.charge_span(c, r, t0, t)
                elif be_cands[c]:    # idle-with-candidates == stalled
                    record(c, stall_label[c] or
                                 "throttled:" + be_cands[c][0].name, t0, t)
                else:
                    record(c, None, t0, t)
            if profile:
                phase_wall["advance"] += perf() - t_p

        # ---- releases / activation ----------------------------------
        def activate(job) -> None:
            for c in job.task.cores:
                if job.remaining[c] > _EPS_W:
                    heapq.heappush(ready[c],
                                   (-job.task.prio, order[job.task.uid],
                                    job.task.uid))
                    dirty.add(c)
                    changed.add(c)   # a continuing thread needs a re-push

        def do_release(uid: int) -> None:
            ts = tstate[uid]
            t = ts.task
            rel = t.release_time(ts.released)
            if rel is None:
                return
            job = Job(task=t, release=rel, index=ts.released,
                      remaining={c: t.thread_wcet(c) for c in t.cores})
            fm.on_release(job)
            ts.released += 1
            ts.queue.append(job)
            if len(ts.queue) == 1:
                activate(job)
            wd = fm.watchdog_at(t.uid, job.index)
            if wd is not None and wd <= horizon + _EPS_T:
                push(wd, _WATCHDOG, (t.uid, job.index))
            nxt = t.release_time(ts.released)
            if nxt is not None and nxt < horizon:
                push(nxt, _RELEASE, uid)

        for t in tasks:
            first = t.release_time(0)
            if first is not None and first < horizon:
                push(first, _RELEASE, t.uid)

        # ---- ready queue (lazy max-heap peek) -----------------------
        def ready_thread(c: int) -> Optional[Thread]:
            h = ready[c]
            while h:
                e = h[0]
                uid = e[2]
                if uid in fm.suspended:
                    # degraded mode: park the entry; re-pushed verbatim
                    # when the suspension lifts
                    heapq.heappop(h)
                    fm.park(c, e)
                    continue
                j = tstate[uid].active
                if j is None or j.remaining.get(c, 0.0) <= _EPS_W:
                    heapq.heappop(h)
                    continue
                return threads[(uid, c)]
            return None

        def has_work(uid: int, core: int) -> bool:
            j = tstate[uid].active
            return j is not None and j.remaining.get(core, 0.0) > _EPS_W

        def find_job(uid: int, idx: int):
            for j in tstate[uid].queue:
                if j.index == idx:
                    return j
            return None

        # ---- scheduling fixed point (mirrors sim.py's pass loop) ----
        def fixed_point(now: float) -> set:
            touched = set()
            for _ in range(4 + len(tasks)):
                if not dirty:
                    break
                todo = sorted(dirty)
                dirty.clear()
                for c in todo:
                    prev = current[c]
                    picked = sched.pick_next_task_rt(c, prev,
                                                     ready_thread(c))
                    if picked is not prev:
                        materialize(c, now)
                        current[c] = picked
                        touched.add(c)
            if sched.enabled and self._gang_dirty:
                # sync preempted cores with the glock (only needed when
                # lock ownership actually moved this round)
                g = sched.g
                for c in range(n):
                    if current[c] is not None and \
                            g.gthreads[c] is not current[c]:
                        materialize(c, now)
                        current[c] = g.gthreads[c]
                        touched.add(c)
            return touched

        # ---- occupancy refresh (dirty cores only) -------------------
        def refresh(cores, now: float) -> None:
            for c in cores:
                if mat[c] < now:
                    materialize(c, now)
                occ = current[c] if current[c] is not None \
                    else fm.dem_thread(c)
                stalled = mm.refresh_core(c, occ, be_names[c],
                                          be_rate[c], now)
                if stalled and not rt_stalled[c]:
                    stall_label[c] = "throttled:" + occ.task.name
                rt_stalled[c] = stalled

        def reconcile(push_set, now: float) -> None:
            """Re-read slowdown aggregates. If the distinct occupant-name
            set moved, sweep RT cores against the per-victim memo (cache
            hits, O(1) each) and re-pin only the cores whose aggregate
            actually changed; otherwise only the dirty cores can have a
            new victim."""
            nonlocal mm_epoch
            if mm.agg_epoch != mm_epoch:
                mm_epoch = mm.agg_epoch
                for c in range(n):
                    th = current[c] if current[c] is not None \
                        else fm.dem_thread(c)
                    if th is None or rt_stalled[c]:
                        continue
                    s = mm.slowdown(th.task.name, c)
                    if s != slow[c]:
                        materialize(c, now)
                        slow[c] = s
                        push_set.add(c)
            else:
                for c in tuple(push_set):
                    th = current[c] if current[c] is not None \
                        else fm.dem_thread(c)
                    if th is not None and not rt_stalled[c]:
                        slow[c] = mm.slowdown(th.task.name, c)

        # ---- event (re)prediction for dirty cores -------------------
        def push_updates(cores, now: float) -> None:
            for c in cores:
                th = current[c]
                if th is not None:
                    j = tstate[th.task.uid].active
                    if j is None:        # drained; reschedule at next event
                        dirty.add(c)
                        rt_sig[c] = None
                        chg_sig[c] = None
                        continue
                    if rt_stalled[c]:
                        st = reg.cores[c]
                        s = ("rt-stalled", st.stalled_until)
                        if chg_sig[c] != s:
                            chg_sig[c] = s
                            core_epoch[c] += 1
                            push(st.stalled_until, _UNSTALL, c)
                        rt_sig[c] = None     # re-pin completion on resume
                        continue
                    s = (th.task.uid, j.index, slow[c])
                    if rt_sig[c] != s:
                        rt_sig[c] = s
                        push(now + j.remaining[c] * slow[c], _COMPLETE, c)
                        # work-budget crossing (faults.py): predicted at
                        # the instant the remaining work sinks to the
                        # over-threshold; validated at pop so stale
                        # predictions (slowdown changed, stalled) are
                        # harmless
                        ov = fm.over_threshold(th.task.uid, j.index, c)
                        if ov is not None and j.remaining[c] > ov + _EPS_W:
                            te = now + (j.remaining[c] - ov) * slow[c]
                            if te <= horizon + _EPS_T:
                                push(te, _ENFORCE, (th.task.uid, j.index))
                    trip = mm.next_trip_time(c, now)
                    s = ("rt-run", th.task.uid, j.index, mm.rates[c],
                         reg.cores[c].budget, trip)
                    if chg_sig[c] != s:
                        chg_sig[c] = s
                        core_epoch[c] += 1
                        if trip != _INF and trip < horizon + _EPS_T:
                            push(trip, _EXHAUST, (c, core_epoch[c]))
                    continue
                dth = fm.dem_thread(c)
                if dth is not None:
                    d = fm.dem_head(c)
                    if rt_stalled[c]:
                        st = reg.cores[c]
                        s = ("dem-stalled", st.stalled_until)
                        if chg_sig[c] != s:
                            chg_sig[c] = s
                            core_epoch[c] += 1
                            push(st.stalled_until, _UNSTALL, c)
                        rt_sig[c] = None
                        continue
                    s = ("dem", dth.task.uid, d.index, slow[c])
                    if rt_sig[c] != s:
                        rt_sig[c] = s
                        push(now + d.residual[c] * slow[c],
                             _DEMCOMPLETE, c)
                    trip = mm.next_trip_time(c, now)
                    s = ("dem-run", dth.task.uid, d.index, mm.rates[c],
                         reg.cores[c].budget, trip)
                    if chg_sig[c] != s:
                        chg_sig[c] = s
                        core_epoch[c] += 1
                        if trip != _INF and trip < horizon + _EPS_T:
                            push(trip, _EXHAUST, (c, core_epoch[c]))
                    continue
                rt_sig[c] = None
                st = reg.cores[c]
                if st.stalled_until > now + _EPS_T:
                    s = ("stalled", st.stalled_until)
                    if chg_sig[c] != s:
                        chg_sig[c] = s
                        core_epoch[c] += 1
                        push(st.stalled_until, _UNSTALL, c)
                elif mm.kind[c] == BE and mm.rates[c] > 0.0 and \
                        st.budget != _INF:
                    trip = mm.next_trip_time(c, now)
                    s = ("be-run", mm.names[c], mm.rates[c], st.budget,
                         trip)
                    if chg_sig[c] != s:
                        chg_sig[c] = s
                        core_epoch[c] += 1
                        if trip != _INF and trip < horizon + _EPS_T:
                            push(trip, _EXHAUST, (c, core_epoch[c]))
                else:
                    s = ("free", mm.names[c])
                    if chg_sig[c] != s:
                        chg_sig[c] = s
                        core_epoch[c] += 1

        def detect_completions(cores, now: float) -> None:
            for c in sorted(cores):
                th = current[c]
                if th is None:
                    continue
                if mat[c] < now:
                    materialize(c, now)
                ts = tstate[th.task.uid]
                j = ts.active
                if j is None:
                    # a sibling core's completion popped the finished job
                    # and the queue drained — this core must reschedule
                    dirty.add(c)
                    changed.add(c)
                    continue
                r = j.remaining.get(c)
                if r is None or r > _EPS_W:
                    continue             # stale prediction: superseded
                j.remaining[c] = 0.0
                dirty.add(c)
                changed.add(c)
                if j.done and j.finish is None:
                    j.finish = now
                    rt = now - j.release
                    response[th.task.name].append(rt)
                    if rt > th.task.deadline + 1e-9:
                        misses[th.task.name] += 1
                        miss_times[th.task.name].append(now)
                    ts.queue.popleft()
                    if ts.queue:
                        activate(ts.queue[0])
                    restore_from(th.task.uid, j.index)

        # ---- enforcement mechanics (faults.py, DESIGN.md §11) -------
        def restore_from(uid: int, idx: int) -> None:
            """If (uid, idx) was the degrading job, lift the suspension:
            re-arm parked ready entries and reschedule the restored
            tasks' cores."""
            res = fm.maybe_restore(uid, idx)
            if res is None:
                return
            parked, sus = res
            for c, entries in parked.items():
                for e in entries:
                    heapq.heappush(ready[c], e)
                dirty.add(c)
                changed.add(c)
            for u in sus:
                for c in tstate[u].task.cores:
                    dirty.add(c)
                    changed.add(c)

        def apply_enforcement(action: str, j, now: float) -> None:
            """Apply a FaultManager decision: settle the job's cores,
            then degrade (suspend lower-criticality gangs), demote
            (snapshot the residual), or abort — the latter two take the
            job off the RT path; the scheduling fixed point that follows
            releases its gang-lock cores through the normal pick path."""
            t = j.task
            ts = tstate[t.uid]
            for c in t.cores:
                if mat[c] < now:
                    materialize(c, now)
            if action == "degrade":
                sus = fm.begin_degrade(j, tasks)
                for u in sus:
                    for c in tstate[u].task.cores:
                        dirty.add(c)
                        changed.add(c)
                return
            if action == "demote":
                # snapshot the residual before zeroing
                fm.begin_demote(j, now)
            for c in t.cores:
                j.remaining[c] = 0.0
            if action == "abort":
                j.aborted = True
                fm.record_abort(j, now)
            if ts.queue and ts.queue[0] is j:
                ts.queue.popleft()
                if ts.queue:
                    activate(ts.queue[0])
            else:
                try:
                    ts.queue.remove(j)
                except ValueError:
                    pass
            if action == "abort":
                restore_from(t.uid, j.index)
            for c in t.cores:
                dirty.add(c)
                changed.add(c)
                rt_sig[c] = None

        def timed(key, t_p, a0):
            phase_wall[key] += (perf() - t_p) - (phase_wall["advance"] - a0)

        # ---- main loop ----------------------------------------------
        now = 0.0
        changed.update(range(n))
        changed.update(sim.apply_budget_rule())
        refresh(sorted(changed), now)
        reconcile(changed, now)
        push_updates(sorted(changed), now)
        changed.clear()
        while True:
            now = min(heap[0][0], horizon) if heap else horizon
            cur_t[0] = now
            if profile:
                t_p, a0 = perf(), phase_wall["advance"]
            comp = ()
            while heap and heap[0][0] <= now + _EPS_T:
                _, _, kind, data = heapq.heappop(heap)
                self.events_processed += 1
                if kind == _RELEASE:
                    if now >= horizon - _EPS_T:
                        continue         # quantum engine never releases at T
                    self.releases += 1
                    do_release(data)
                elif kind == _COMPLETE:
                    if not comp:
                        comp = set()
                    comp.add(data)
                elif kind == _EXHAUST:
                    c, epoch = data
                    if epoch != core_epoch[c]:
                        continue         # superseded prediction
                    materialize(c, now)
                    st = reg.cores[c]
                    if mm.rates[c] > 0.0 and st.budget != _INF and \
                            st.used >= st.limit - 1e-6:
                        th = current[c]
                        if reclaim and th is not None and \
                                mm.claim(c, th.task.name, mm.rates[c],
                                         now) > 0.0:
                            # donated quota covers (part of) the rest of
                            # the window: don't trip — the raised limit
                            # re-pins the trip prediction
                            changed.add(c)
                        else:
                            mm.trip(c, now)
                            occ = th if th is not None \
                                else fm.dem_thread(c)
                            if occ is not None:
                                stall_label[c] = ("throttled:"
                                                  + occ.task.name)
                            elif be_cands[c]:
                                heavy = max(be_cands[c],
                                            key=lambda b: b.mem_rate)
                                stall_label[c] = "throttled:" + heavy.name
                            changed.add(c)
                elif kind == _UNSTALL:   # pure wakeup
                    changed.add(data)
                elif kind == _ENFORCE:
                    uid, idx = data
                    j = find_job(uid, idx)
                    if j is not None and not j.aborted:
                        for c in j.task.cores:
                            if mat[c] < now:
                                materialize(c, now)
                        # completion at the same instant wins (the
                        # quantum engine's advance-then-enforce order)
                        via = fm.due(j, now) if not j.done else None
                        if via is not None:
                            action = fm.fire(j, now, via)
                            if action is not None:
                                apply_enforcement(action, j, now)
                elif kind == _WATCHDOG:
                    uid, idx = data
                    j = find_job(uid, idx)
                    if j is not None and not j.aborted:
                        for c in j.task.cores:
                            if mat[c] < now:
                                materialize(c, now)
                        action = None if j.done else \
                            fm.fire(j, now, "watchdog")
                        if action is not None:
                            apply_enforcement(action, j, now)
                else:                    # _DEMCOMPLETE
                    c = data
                    if mat[c] < now:
                        materialize(c, now)
                    d = fm.dem_head(c)
                    if d is not None and current[c] is None and \
                            d.residual.get(c, 1.0) <= _EPS_W:
                        fm.dem_finish_core(c, now)
                        dirty.add(c)
                        changed.add(c)
                        rt_sig[c] = None
            if comp:
                detect_completions(comp, now)
            if profile:
                timed("events", t_p, a0)
            if now >= horizon - _EPS_T:
                for c in range(n):
                    if mat[c] < horizon:
                        materialize(c, horizon)
                break
            if profile:
                t_p, a0 = perf(), phase_wall["advance"]
            touched = fixed_point(now)
            changed.update(touched)
            if fm.pending_audit:
                # the scheduling round after an abort/demote settled:
                # the gang lock must have left the dead job's cores
                fm.audit(sched.g, has_work)
            if profile:
                timed("fixed_point", t_p, a0)
                t_p, a0 = perf(), phase_wall["advance"]
            if touched or self._gang_dirty:
                self._gang_dirty = False
                changed.update(sim.apply_budget_rule())
            if changed:
                refresh(sorted(changed), now)
                reconcile(changed, now)
                if reclaim:
                    # a donor may have gone idle in this round: retry
                    # stalled RT threads against the pool (core order —
                    # the quantum engine's per-step retry order); a
                    # granted draw lifts the stall and resumes the
                    # thread at this very instant
                    lifted = [c for c in range(n)
                              if rt_stalled[c] and current[c] is not None
                              and mm.claim_lift(c, current[c].task, now)]
                    if lifted:
                        changed.update(lifted)
                        refresh(lifted, now)
                        reconcile(set(lifted), now)
                if profile:
                    timed("rates", t_p, a0)
                    t_p, a0 = perf(), phase_wall["advance"]
                push_updates(sorted(changed), now)
                changed.clear()
                if profile:
                    timed("push_updates", t_p, a0)
            elif profile:
                timed("rates", t_p, a0)

        return sim.finalize_result(
            trace, response, misses, miss_times, be_progress, slack,
            horizon,
            releases={t.name: tstate[t.uid].released for t in tasks},
            events=self.events_processed, engine="event")
