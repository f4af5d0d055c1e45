"""Gang-scheduled executor for real device workloads (PyTorch port).

The TPU-fleet adaptation of RT-Gang (DESIGN.md §2): "cores" become *lanes*
(device slices / host workers), threads become per-lane quanta of a job step
(one inference, one training microstep), and the gang lock serializes RT jobs
fleet-wide while best-effort quanta fill idle lanes under byte-budget
admission control.

Differences from the kernel implementation, modeled explicitly:
* no mid-quantum preemption — gang preemption takes effect at quantum
  boundaries, contributing the blocking term B_i = max lower-prio quantum to
  RTA (core/rta.py);
* throttling is admission-based (quantum bytes declared per job: JAX reads
  them from ``compiled.cost_analysis()``, the port's callers declare them
  until a torch cost estimate exists) rather than perf-counter-reactive;
* straggler mitigation: per-quantum deadline monitor with optional
  speculative backup dispatch of idempotent quanta onto idle lanes.

Virtual gangs (DESIGN.md §2.4): ``submit_vgang`` flattens a formed
``vgang.formation.VirtualGang`` onto disjoint lane blocks (the same
member remapping the simulator policy uses) and a ``budget_policy`` —
normally ``vgang.sched.VirtualGangPolicy`` — sets per-lane throttle
budgets from the glock's live-member state. Budgets are applied *only*
from the gang-change hook, under the glock: a worker that picked a gang
but lost the ownership race (or is still draining the gang-isolation
barrier) never writes budgets, so a stale lane cannot clobber the
running gang's regime.

Works with any callables. The executor itself is device-agnostic: the
GPU lane model (one CUDA stream per lane, a quantum ends when its stream
synchronizes) lives in ``repro_torch.device``.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.gang import RTTask, Thread, _ids
from repro_torch.core.glock import GangScheduler
from repro_torch.core.throttle import BandwidthRegulator
from repro_torch.core.tracing import Trace

# job uids share the RTTask counter so that virtual-gang members —
# whose RTJobs reuse the member task's uid (submit_vgang) — can never
# collide with uids handed to plain submit_rt jobs
_uid = _ids


@dataclasses.dataclass
class RTJob:
    """A periodic real-time job: each release runs ``fn(lane, job_idx)`` on
    every lane in ``lanes`` simultaneously (the gang)."""
    name: str
    fn: Callable[[int, int], None]
    lanes: Tuple[int, ...]
    prio: int
    period_s: Optional[float] = None       # None => single job
    budget_bytes: float = 0.0              # BE budget while this gang runs
    n_jobs: Optional[int] = None
    # bytes one quantum of *this* job moves. When the lane's enforced
    # budget is finite (an RTG-throttle sibling cap), the quantum is
    # admission-charged against it and the lane stalls to the next
    # regulation window on denial — the executor analogue of the
    # engines' RT-thread charging (DESIGN.md §10.1). 0 = never gated.
    bytes_per_quantum: float = 0.0
    # declared wall-clock WCET of one quantum (seconds). Feeds the
    # glock mirror task and — with the executor's ``watchdog_factor`` —
    # the per-quantum watchdog deadline (DESIGN.md §11.4).
    wcet_s: Optional[float] = None
    # explicit per-quantum watchdog deadline (seconds): a quantum still
    # in flight this long after dispatch has its whole gang aborted so
    # a hung member thread cannot deadlock the gang-isolation barrier.
    # None = derive from wcet_s x watchdog_factor, or the executor-wide
    # ``watchdog_s`` default.
    watchdog_s: Optional[float] = None
    uid: int = dataclasses.field(default_factory=lambda: next(_uid))


@dataclasses.dataclass
class BEJob:
    name: str
    fn: Callable[[int], None]              # fn(lane)
    lanes: Tuple[int, ...]
    bytes_per_quantum: float = 0.0
    uid: int = dataclasses.field(default_factory=lambda: next(_uid))


@dataclasses.dataclass
class _JobInstance:
    job: RTJob
    index: int
    release: float
    remaining_lanes: set
    start: Optional[float] = None
    finish: Optional[float] = None
    aborted: bool = False          # watchdog killed this gang release


class GangExecutor:
    def __init__(self, n_lanes: int, *, enabled: bool = True,
                 regulation_interval_s: float = 0.010,
                 straggler_factor: float = 3.0,
                 backup_dispatch: bool = False,
                 budget_policy=None, reclaim: bool = False,
                 watchdog_s: Optional[float] = None,
                 watchdog_factor: Optional[float] = None,
                 metrics=None):
        """``budget_policy``: optional object with ``apply(glock,
        regulator)`` — the same interface ``Simulator`` takes
        (vgang/sched.py) — invoked from the gang-change hook to set
        per-lane budgets from the live-member state. ``None`` falls back
        to the paper's rule: the leader's declared budget on every lane
        the gang does not occupy.

        ``reclaim``: mid-window bandwidth donation (DESIGN.md §7.5) at
        admission granularity — a gated sibling quantum that would be
        denied first draws the unspent window quota of member lanes
        whose work for this release already retired.

        ``watchdog_s`` / ``watchdog_factor`` arm the per-lane wall-clock
        watchdog (DESIGN.md §11.4): a quantum still in flight past its
        deadline — ``job.watchdog_s``, else ``watchdog_factor x
        job.wcet_s``, else ``watchdog_s`` — has its whole gang aborted:
        the instance is marked, the gang's glock hold is released lane
        by lane through ``pick_next_task_rt`` (so budget floors and
        wakeups run in the normal gang-change hook order) and the hung
        lane retires from the gang-isolation barrier, unblocking waiting
        gangs. The hung callable itself cannot be killed — it keeps
        running on its worker thread and its eventual return is
        discarded — but it no longer holds any scheduling state."""
        self.n_lanes = n_lanes
        self.enabled = enabled
        self.budget_policy = budget_policy
        # observability (DESIGN.md §12): one registry shared with the
        # glock and regulator; None = detached instruments (bare mode)
        from repro_torch.obs.metrics import MetricsRegistry
        self.metrics = metrics
        self._mreg = metrics if metrics is not None \
            else MetricsRegistry(enabled=False)
        self.sched = GangScheduler(n_lanes, enabled=enabled,
                                   metrics=self._mreg)
        # wake blocked lanes promptly on gang hand-off (lock released or
        # preempted) instead of having them poll. Lock order: glock.g.lock
        # is only ever taken *outside* self._lock, so notifying under
        # self._lock from inside the glock callback cannot deadlock.
        self.sched.on_gang_change = self._on_gang_change
        self.reg = BandwidthRegulator(n_lanes,
                                      interval=regulation_interval_s,
                                      mode="admission", reclaim=reclaim,
                                      metrics=self._mreg)
        self.trace = Trace(n_lanes)
        self.rt_jobs: List[RTJob] = []
        self.be_jobs: List[BEJob] = []
        self._jobs: Dict[int, RTJob] = {}          # uid -> job (O(1) map)
        self._instances: Dict[int, List[_JobInstance]] = {}
        self._tasks: Dict[int, RTTask] = {}
        self._threads: Dict[Tuple[int, int], Thread] = {}
        # per-lane lazy max-heaps of (-prio, seq, job uid, instance idx),
        # pushed on release, stale entries popped on peek — the event
        # engine's ready-queue structure, so fleet-size dispatch over
        # hundreds of lanes is O(log n) instead of an O(jobs) scan
        self._ready: List[list] = [[] for _ in range(n_lanes)]
        self._ready_seq = itertools.count()
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._stop = False
        self.straggler_factor = straggler_factor
        self.backup_dispatch = backup_dispatch
        self.stragglers: List[Tuple[str, int, float]] = []
        self.response_times: Dict[str, List[float]] = {}
        # per-name obs.metrics counters (executor.* series); the
        # be_quanta / rt_stalls / aborted properties expose the
        # historical plain-dict views
        self._be_q: Dict[str, object] = {}
        self._stall_c: Dict[str, object] = {}
        self._abort_c: Dict[str, object] = {}
        self._ema: Dict[str, float] = {}
        self._budget_sig = None     # last glock state budgets derive from
        # gang prios whose in-flight quanta were still draining when the
        # current leader's budgets were applied: until they retire, the
        # enforced regime is the element-wise min over (outgoing,
        # incoming) — see _apply_budgets / _end_drain
        self._draining: frozenset = frozenset()
        self._t0 = 0.0
        # lanes currently *executing* an RT quantum -> gang prio. A newly
        # scheduled gang waits for other gangs' in-flight quanta to drain
        # (the executor analogue of the preemption IPI + context switch;
        # bounded by one quantum = the B_i blocking term in core/rta.py).
        self._inflight: Dict[int, int] = {}
        # watchdog bookkeeping: lane -> (job uid, instance idx, dispatch
        # time, deadline or None), maintained exactly alongside _inflight
        self.watchdog_s = watchdog_s
        self.watchdog_factor = watchdog_factor
        self._inflight_info: Dict[int, tuple] = {}
        self.watchdog_aborts: List[Tuple[str, int, int, float]] = []

    # compatibility dict views over the executor.* metric counters
    @property
    def be_quanta(self) -> Dict[str, int]:
        return {k: int(c.value) for k, c in self._be_q.items()}

    @property
    def rt_stalls(self) -> Dict[str, int]:
        return {k: int(c.value) for k, c in self._stall_c.items()}

    @property
    def aborted(self) -> Dict[str, int]:
        return {k: int(c.value) for k, c in self._abort_c.items()}

    def _counter_for(self, table: Dict[str, object], series: str,
                     name: str):
        c = table.get(name)
        if c is None:
            c = table[name] = self._mreg.counter(series, gang=name)
        return c

    # ------------------------------------------------------------------
    def submit_rt(self, job: RTJob):
        if job.uid in self._instances:
            raise ValueError(f"duplicate RT job uid {job.uid} "
                             f"({job.name!r})")
        if job.lanes and max(job.lanes) >= self.n_lanes:
            raise ValueError(f"job {job.name!r} pins lane "
                             f"{max(job.lanes)}, executor has "
                             f"{self.n_lanes}")
        self.rt_jobs.append(job)
        self._jobs[job.uid] = job
        self._instances[job.uid] = []
        self.response_times.setdefault(job.name, [])
        # mirror as an RTTask (same uid!) so the glock state machine sees
        # gang identity and picked.task.uid maps back to the job. The
        # mirror's wcet is the declared quantum wall time (sim-ms scale);
        # undeclared jobs get a positive placeholder — the glock never
        # reads it, and RTTask rejects wcet <= 0 at construction.
        self._tasks[job.uid] = RTTask(
            name=job.name, wcet=max(job.wcet_s or 0.0, 1e-9) * 1e3,
            period=(job.period_s or 1e9) * 1e3,
            cores=job.lanes, prio=job.prio, mem_budget=job.budget_bytes,
            uid=job.uid)
        for i, lane in enumerate(job.lanes):
            self._threads[(job.uid, lane)] = Thread(
                task=self._tasks[job.uid], core=lane, index=i)

    def submit_be(self, job: BEJob):
        self.be_jobs.append(job)
        self._counter_for(self._be_q, "executor.be_quanta", job.name)

    def submit_vgang(self, vg, fns: Dict[str, Callable[[int, int], None]],
                     *, n_jobs: Optional[int] = None,
                     time_scale: float = 1e-3,
                     bytes_per_quantum: Optional[Dict[str, float]] = None
                     ) -> List[RTJob]:
        """Submit a formed virtual gang (vgang/formation.VirtualGang):
        members are flattened onto disjoint lane blocks with the same
        remapping the simulator policy uses (vgang/sched.remap_members),
        share the vgang's priority, and — sharing one period with zero
        offset — release synchronously, so the glock dispatches them as
        one unit (Algorithm 1 line 14-15). Member uids are preserved, so
        a ``VirtualGangPolicy`` installed as ``budget_policy`` resolves
        its per-member budget tables against the mirrored threads.

        ``fns`` maps member task name -> quantum callable(lane, idx);
        ``time_scale`` converts task-time periods (sim ms) to wall
        seconds; ``bytes_per_quantum`` optionally declares per-member
        quantum traffic for RTG-throttle admission gating."""
        from repro_torch.vgang.sched import remap_members
        members = remap_members(vg)
        # validate the whole gang before submitting any member: a lane
        # or uid rejection halfway through must not leave a half gang
        # behind (one member dispatching at the vgang's priority without
        # its siblings or their budget floors)
        for m in members:
            if m.uid in self._instances:
                raise ValueError(f"duplicate RT job uid {m.uid} "
                                 f"({m.name!r})")
            if m.cores and max(m.cores) >= self.n_lanes:
                raise ValueError(
                    f"virtual gang {vg.name!r} needs lane "
                    f"{max(m.cores)}, executor has {self.n_lanes}")
            if m.name not in fns:
                raise ValueError(f"virtual gang {vg.name!r}: no quantum "
                                 f"callable for member {m.name!r}")
        jobs = []
        for m in members:
            job = RTJob(
                name=m.name, fn=fns[m.name], lanes=m.cores, prio=m.prio,
                period_s=m.period * time_scale,
                budget_bytes=m.mem_budget,
                n_jobs=n_jobs if n_jobs is not None else m.n_jobs,
                bytes_per_quantum=(bytes_per_quantum or {}).get(m.name,
                                                                0.0),
                uid=m.uid)
            self.submit_rt(job)
            jobs.append(job)
        return jobs

    # ------------------------------------------------------------------
    def _apply_budgets(self) -> None:
        """Set per-lane throttle budgets from the glock state. Runs only
        inside the gang-change hook (under ``glock.g.lock``), so budget
        writes are serialized with lock-ownership transitions: the
        enforced regime always belongs to the *current* leader, never to
        a stale lane that lost the pick ordering. Memoized on the
        (leader, live member thread uids) signature — consecutive hook
        events for a regime that did not move (e.g. the leave+join pair
        when a different same-prio task replaces a member on one lane:
        the leave already sees the successor installed) skip the lane
        rescan. The member uids must be part of the signature: that
        same replacement keeps leader and core mask identical while the
        budget floor moves with the member set.

        Drain-window ordering (ROADMAP item 1): a gang acquiring after
        a preemption applies its budgets while the outgoing gang's last
        quanta still drain (no mid-quantum preemption — the preemptor
        waits at the gang-isolation barrier). Best-effort work admitted
        under the incoming regime alone would pierce the *outgoing*
        gang's isolation, so while foreign in-flight quanta remain, the
        enforced regime is the element-wise min over (budgets before
        the change, incoming budgets); ``_end_drain`` re-derives the
        pure incoming regime when the last foreign quantum retires."""
        g = self.sched.g
        sig = (g.held_flag,
               None if g.leader is None else g.leader.uid,
               tuple(None if th is None else th.task.uid
                     for th in g.gthreads))
        if sig == self._budget_sig:
            return
        self._budget_sig = sig

        def derive(reg):
            if self.budget_policy is not None:
                self.budget_policy.apply(g, reg)
            elif g.held_flag and g.leader is not None:
                occupied = {th.core for th in g.gthreads
                            if th is not None}
                reg.set_core_budgets({c: None for c in occupied},
                                     default=g.leader.mem_budget)

        # the foreign-in-flight snapshot and the drain publication must
        # be one atomic step against _quantum_retired (a quantum
        # retiring in between would miss the _draining flag and never
        # run _end_drain, pinning the min regime forever), and the min
        # regime must reach the live regulator in a *single* write:
        # deriving the incoming regime in place first would expose its
        # looser budgets to concurrent lock-free BE charges while the
        # outgoing gang still drains — so it is derived on a shadow
        # bank and only min(outgoing, incoming) is ever published.
        with self._lock:
            draining = frozenset(
                p for ln, p in self._inflight.items()
                if g.leader is not None and p != g.leader.prio)
            if draining:
                shadow = BandwidthRegulator(
                    self.n_lanes, interval=self.reg.interval,
                    mode=self.reg.mode)
                derive(shadow)
                self.reg.set_core_budgets(
                    {c: min(st.budget, shadow.cores[c].budget)
                     for c, st in self.reg.cores.items()})
                self._draining = draining
                # force a clean re-derivation once the drain completes
                self._budget_sig = None
        if not draining:
            derive(self.reg)

    def _end_drain(self) -> None:
        """The outgoing gang's last foreign in-flight quantum retired:
        drop the element-wise min regime and re-derive budgets from the
        live glock state alone."""
        g = self.sched.g
        with g.lock:
            self._budget_sig = None
            self._apply_budgets()
        with self._wake:
            self._wake.notify_all()

    def _quantum_retired(self, lane: int) -> bool:
        """Remove ``lane`` from the in-flight set (caller does NOT hold
        the lock); returns True when this retirement completed a
        drain — the caller must then run ``_end_drain``."""
        with self._wake:
            self._inflight.pop(lane, None)
            self._inflight_info.pop(lane, None)
            drain_done = bool(self._draining) and not any(
                p in self._draining for p in self._inflight.values())
            if drain_done:
                self._draining = frozenset()
            self._wake.notify_all()
        return drain_done

    def _on_release(self) -> None:
        """Full release: extend the departed gang's *tightest* enforced
        budget to every lane — its own former lanes included, which were
        exempt while occupied. Best-effort work on any lane thus stays
        behind the last declared lid (the paper's §IV-F rule) until the
        next gang's acquire overwrites it; nothing between two gangs is
        ever admitted more than the most conservative recent regime."""
        self._budget_sig = None
        floor = min(st.budget for st in self.reg.cores.values())
        if floor != float("inf"):
            self.reg.set_core_budgets({}, default=floor)

    def _on_gang_change(self, event: str, leader) -> None:
        # acquire/join/leave move the live-member set -> re-derive
        # budgets while still under g.lock; release floors every lane at
        # the departing gang's regime (conservative hand-off).
        if event in ("acquire", "join", "leave"):
            if event == "acquire" and self.reg.reclaim:
                # grants issued under the departing regime must not
                # leak into the acquiring gang's windows — even when
                # the budget values happen to coincide
                self.reg.reset_reclaim()
            self._apply_budgets()
            if event == "leave":
                # a leave only raises budgets (min over fewer members) —
                # wake admission-stalled and idle lanes so a lifted
                # stall is observed now, not at the next poll timeout
                with self._wake:
                    self._wake.notify_all()
        elif event == "release":
            self._on_release()
            with self._wake:
                self._wake.notify_all()
        elif event == "preempt":
            with self._wake:
                self._wake.notify_all()

    def _next_release_in(self, now: float) -> Optional[float]:
        """Seconds until the earliest future RT release (None = no more)."""
        best: Optional[float] = None
        for job in self.rt_jobs:
            insts = self._instances[job.uid]
            n = len(insts)
            if job.n_jobs is not None and n >= job.n_jobs:
                continue
            if n == 0:
                return 0.0
            if job.period_s is None:
                continue
            delta = insts[-1].release + job.period_s - now
            if best is None or delta < best:
                best = delta
        return best

    def _now(self) -> float:
        return time.monotonic() - self._t0

    def _release_jobs(self):
        now = self._now()
        for job in self.rt_jobs:
            insts = self._instances[job.uid]
            n = len(insts)
            if job.n_jobs is not None and n >= job.n_jobs:
                continue
            period = job.period_s
            next_rel = 0.0 if n == 0 else (insts[-1].release + (period or 0))
            if period is None and n > 0:
                continue
            if now + 1e-9 >= next_rel:
                insts.append(_JobInstance(
                    job=job, index=n, release=next_rel,
                    remaining_lanes=set(job.lanes)))
                seq = next(self._ready_seq)
                for lane in job.lanes:
                    heapq.heappush(self._ready[lane],
                                   (-job.prio, seq, job.uid, n))

    def _ready_thread(self, lane: int) -> Optional[Thread]:
        """Highest-priority released job with work left on this lane —
        lazy max-heap peek (same-priority ties go to the earlier
        release). Callers hold self._lock."""
        h = self._ready[lane]
        while h:
            _, _, uid, idx = h[0]
            inst = self._instances[uid][idx]
            if lane not in inst.remaining_lanes:
                heapq.heappop(h)         # quantum retired: stale entry
                continue
            return self._threads[(uid, lane)]
        return None

    def _active_instance(self, job: RTJob, lane: int) -> Optional[_JobInstance]:
        return next((i for i in self._instances[job.uid]
                     if lane in i.remaining_lanes), None)

    def _admit_rt_quantum(self, lane: int,
                          job: RTJob) -> Tuple[str, bool]:
        """Admission-charge one RT quantum against the lane's enforced
        budget (RTG-throttle: sibling lanes carry a finite cap while the
        critical member's lanes are uncapped — vgang/sched.py). On
        denial the lane stalls to the next regulation window, exactly
        the engines' RT-stall semantics at quantum granularity. The
        caller must declare budgets that admit at least one quantum per
        window (``bytes_per_quantum <= cap``), the same no-starvation
        condition rta.rtg_throttle_wcet prices as an infinite bound.

        Returns ``(verdict, stalled)``: verdict ``"run"`` when admitted,
        ``"stop"`` when the executor shut down mid-stall, ``"requeue"``
        when the gang lost the lock while waiting — a preemptor's budget
        regime may never admit this quantum (its floor can sit below our
        bytes), and starting it under a foreign regime would also be
        wrong, so the worker must re-enter the scheduler instead of
        spinning on denials while the preemptor waits at the
        gang-isolation barrier. ``stalled`` reports whether a denial
        actually delayed the quantum (so the caller traces a throttled
        span only for real stalls, not admission overhead). Gating needs
        a gang regime: with the scheduler disabled (passthrough mode,
        held_flag never set) quanta run ungated."""
        if job.bytes_per_quantum <= 0.0 or not self.sched.enabled:
            return "run", False
        g = self.sched.g
        stalled = False
        while True:
            # ownership check and charge are one atomic step under
            # g.lock (budget writes happen under it, in the gang-change
            # hook): a preemptor's acquire may have raised this lane's
            # budget — lifting our stall — and a charge made after
            # losing the lock would admit our quantum against the
            # *foreign* regime instead of requeueing
            with g.lock:
                if not (g.held_flag and g.leader is not None
                        and g.leader.prio == job.prio):
                    return "requeue", stalled
                now = self._now()
                st = self.reg.cores[lane]
                stalled_now = self.reg.is_stalled(lane, now)
                short = st.used + job.bytes_per_quantum - st.limit
                if self.reg.reclaim and short > 0.0 and \
                        st.budget != float("inf") and \
                        self._reclaim_rt_draw(lane, job, short,
                                              now) >= short:
                    # mid-window donation (DESIGN.md §7.5): the window
                    # was topped up from retired member lanes — this
                    # also lifts an existing stall (the executor
                    # analogue of the engines' claim_lift: a donor that
                    # retired after our trip rescues the quantum)
                    if stalled_now:
                        self.reg.unstall(lane)
                    admitted = self.reg.charge(
                        lane, job.bytes_per_quantum, now)
                elif stalled_now:
                    # existing stall (ours or a BE quantum's trip) and
                    # no covering donation: don't re-charge (each
                    # denied retry would inflate total_denied by a
                    # spurious-wakeup-dependent factor), wait it out
                    admitted = False
                else:
                    admitted = self.reg.charge(
                        lane, job.bytes_per_quantum, now)
            if admitted:
                return "run", stalled
            if not stalled:
                # first delay for this quantum: count it once, whether
                # the window was tripped by our own charge or was
                # already spent (e.g. by a best-effort filler)
                with self._lock:
                    self._counter_for(self._stall_c, "executor.rt_stalls",
                                      job.name).value += 1
            stalled = True
            wait = self.reg.next_release(lane, now) - now
            with self._wake:
                if self._stop:
                    return "stop", stalled
                self._wake.wait(timeout=min(max(wait, 0.0002), 0.05))

    def _reclaim_rt_draw(self, lane: int, job: RTJob, need: float,
                         now: float) -> float:
        """Admission-mode reclaiming (DESIGN.md §2.4/§7.5): draw
        ``need`` bytes of unspent window quota — all or nothing — from
        lanes of the running gang's *retired* members: members with no
        pending work this release and nothing in flight, whose
        interference dominates the drawing member's for every other
        member. This is the quota-for-quota half of the engines'
        exchange gate; the continuous-time offset cap has no admission
        analogue (the admission-mode analysis prices whole windows, not
        offsets — the executor bound's extra window slop absorbs the
        difference, DESIGN.md §2.4). Caller holds ``g.lock``; needs a
        ``budget_policy`` exposing ``interference``."""
        pol = self.budget_policy
        intf = getattr(pol, "interference", None)
        g = self.sched.g
        if intf is None or not g.held_flag or g.leader is None:
            return 0.0
        members = [j for j in self.rt_jobs if j.prio == g.leader.prio]
        names = [j.name for j in members]
        donors = []
        with self._lock:
            for m in members:
                if m.uid == job.uid or not m.lanes:
                    continue
                if any(ln in self._inflight for ln in m.lanes):
                    continue
                if any(self._active_instance(m, ln) is not None
                       for ln in m.lanes):
                    continue            # still has pending work
                if all(intf(v, job.name) <= intf(v, m.name) + 1e-12
                       for v in names if v not in (job.name, m.name)):
                    donors.extend(m.lanes)
        if not donors:
            return 0.0
        return self.reg.draw_from(lane, sorted(donors), need, now,
                                  require_full=True)

    # ------------------------------------------------------------------
    # watchdog (DESIGN.md §11.4)

    def _watchdog_deadline(self, job: RTJob) -> Optional[float]:
        """Wall-clock in-flight deadline for one quantum of ``job``."""
        if job.watchdog_s is not None:
            return job.watchdog_s
        if self.watchdog_factor is not None and job.wcet_s is not None:
            return self.watchdog_factor * job.wcet_s
        return self.watchdog_s

    def _watchdog_armed(self) -> bool:
        return self.watchdog_s is not None or any(
            self._watchdog_deadline(j) is not None for j in self.rt_jobs)

    def _watchdog_monitor(self, tick: float):
        while True:
            with self._wake:
                if self._stop:
                    return
                now = self._now()
                victims = [(ln, info[0], info[1])
                           for ln, info in self._inflight_info.items()
                           if info[3] is not None and now - info[2] > info[3]]
            for ln, uid, idx in victims:
                self._watchdog_abort(ln, uid, idx)
            time.sleep(tick)

    def _watchdog_abort(self, lane: int, uid: int, idx: int) -> bool:
        """Abort the gang release whose quantum is hung on ``lane``:
        mark the instance aborted (siblings' pending entries go stale
        and their in-flight returns are discarded), release every lane
        the gang still holds through ``pick_next_task_rt`` — i.e.
        through the glock state machine, so ``try_glock_release`` fires
        the gang-change hook and budget floors / wakeups happen in the
        normal hook order (glock.py "watchdog ordering") — then retire
        the hung lane from the gang-isolation barrier. Lock order:
        instance state under self._lock first, then g.lock via the pick
        (never nested the other way)."""
        with self._wake:
            info = self._inflight_info.get(lane)
            if info is None or info[0] != uid or info[1] != idx:
                return False         # retired between scan and abort
        job = self._jobs[uid]
        with self._lock:
            inst = self._instances[uid][idx]
            # a second hung lane of an already-aborted gang still needs
            # retiring from the barrier below; only the marking and the
            # glock release are once-per-instance
            first = not inst.aborted and inst.finish is None
            if first:
                inst.aborted = True
                inst.remaining_lanes.clear()
                self.watchdog_aborts.append(
                    (job.name, lane, idx, self._now()))
                self._counter_for(self._abort_c, "executor.aborted",
                                  job.name).value += 1
        if first:
            g = self.sched.g
            for ln in job.lanes:
                th = self._threads.get((uid, ln))
                if th is not None and g.gthreads[ln] is th:
                    self.sched.pick_next_task_rt(ln, th, None)
        if self._quantum_retired(lane):
            self._end_drain()
        return first

    # ------------------------------------------------------------------
    def _worker(self, lane: int):
        prev: Optional[Thread] = None
        while True:
            with self._lock:
                if self._stop:
                    return
                self._release_jobs()
                nxt = self._ready_thread(lane)
            picked = self.sched.pick_next_task_rt(lane, prev, nxt)
            prev = None
            if picked is not None:
                job = self._jobs[picked.task.uid]
                # NOTE: no budget write here. Budgets are applied from
                # the gang-change hook under g.lock (_apply_budgets); a
                # pre-barrier write from this thread could land *after*
                # another gang preempted us and clobber the running
                # gang's regime (the stale-lane race pinned by
                # tests/test_executor_vgang.py).
                inst = None
                with self._lock:
                    inst = self._active_instance(job, lane)
                if inst is None:
                    prev = picked
                    continue
                # gang-isolation barrier: wait out other gangs' in-flight
                # quanta. Condition-variable wakeups (notified when any
                # quantum retires and on gang hand-offs) replace the old
                # sleep-poll so idle lanes don't burn CPU while they wait.
                with self._wake:
                    while True:
                        if self._stop:
                            return
                        others = [p for ln, p in self._inflight.items()
                                  if ln != lane and p != job.prio]
                        if not others:
                            self._inflight[lane] = job.prio
                            self._inflight_info[lane] = (
                                job.uid, inst.index, self._now(),
                                self._watchdog_deadline(job))
                            break
                        self._wake.wait(timeout=0.05)
                t0 = self._now()
                if inst.start is None:
                    inst.start = t0
                requeue = False
                stalled = False
                try:
                    verdict, stalled = self._admit_rt_quantum(lane, job)
                    if verdict == "stop":
                        return               # stopped while stalled
                    if verdict == "requeue":
                        requeue = True       # preempted while stalled
                    else:
                        t_run = self._now()
                        job.fn(lane, inst.index)
                finally:
                    if self._quantum_retired(lane):
                        self._end_drain()
                if requeue:
                    # the quantum never started: leave the instance
                    # pending and re-enter the scheduler (the preempting
                    # gang proceeds; we block at Algorithm 1 line 18-19)
                    prev = picked
                    continue
                t1 = self._now()
                dur = t1 - t_run
                key = job.name
                with self._lock:
                    if inst.aborted:
                        # the watchdog killed this gang release while we
                        # ran: the late return is discarded — no sample,
                        # no EMA poisoning, no finish
                        self.trace.record(lane, f"aborted:{key}",
                                          t0 * 1e3, t1 * 1e3)
                        prev = picked
                        continue
                    if stalled:              # admission stall (§2.4)
                        self.trace.record(lane, f"throttled:{key}",
                                          t0 * 1e3, t_run * 1e3)
                    self.trace.record(lane, key, t_run * 1e3, t1 * 1e3)
                    ema = self._ema.get(key)
                    if ema is not None and \
                            dur > self.straggler_factor * ema:
                        self.stragglers.append((key, lane, dur))
                    self._ema[key] = dur if ema is None else \
                        0.9 * ema + 0.1 * dur
                    inst.remaining_lanes.discard(lane)
                    if not inst.remaining_lanes and inst.finish is None:
                        inst.finish = t1
                        self.response_times[job.name].append(
                            inst.finish - inst.release)
                prev = picked
                continue

            # best-effort filling under admission throttling
            ran_be = False
            for be in self.be_jobs:
                if lane not in be.lanes:
                    continue
                now = self._now()
                if self.reg.charge(lane, be.bytes_per_quantum, now):
                    t0 = self._now()
                    be.fn(lane)
                    t1 = self._now()
                    with self._lock:
                        self.trace.record(lane, be.name,
                                          t0 * 1e3, t1 * 1e3)
                        self._be_q[be.name].value += 1
                    ran_be = True
                    break
            if not ran_be:
                # idle lane: sleep on the condition variable until the next
                # RT release is due, a quantum retires, or a gang hand-off
                # frees work — not a fixed-period poll.
                with self._wake:
                    if self._stop:
                        return
                    delta = self._next_release_in(self._now())
                    timeout = 0.05 if delta is None else \
                        min(max(delta, 0.0002), 0.05)
                    self._wake.wait(timeout=timeout)

    # ------------------------------------------------------------------
    def run(self, duration_s: float):
        self._t0 = time.monotonic()
        workers = [threading.Thread(target=self._worker, args=(lane,),
                                    daemon=True)
                   for lane in range(self.n_lanes)]
        for w in workers:
            w.start()
        if self._watchdog_armed():
            deadlines = [d for d in (self._watchdog_deadline(j)
                                     for j in self.rt_jobs)
                         if d is not None]
            tick = min(deadlines) / 4 if deadlines else 0.01
            threading.Thread(target=self._watchdog_monitor,
                             args=(min(max(tick, 0.001), 0.05),),
                             daemon=True).start()
        time.sleep(duration_s)
        with self._wake:
            self._stop = True
            self._wake.notify_all()
        for w in workers:
            w.join(timeout=5.0)
        self.trace.finish_view()
        return {
            "response_times": self.response_times,
            "be_quanta": dict(self.be_quanta),
            "stragglers": list(self.stragglers),
            "rt_stalls": dict(self.rt_stalls),
            "preemptions": self.sched.g.preemptions,
            "acquisitions": self.sched.g.acquisitions,
            "ipis": self.sched.g.ipis_sent,
            "reclaimed_bytes": self.reg.total_reclaimed,
            "watchdog_aborts": list(self.watchdog_aborts),
            "aborted": dict(self.aborted),
            "metrics": self.metrics.snapshot()
            if self.metrics is not None else None,
        }
