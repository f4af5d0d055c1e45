"""VirtualGangPolicy — run formed virtual gangs on the simulator engines.

The glock state machine already *is* the virtual-gang mechanism: gangs
sharing one RT priority join the running gang (Algorithm 1 line 14-15,
RT-Gang §IV-E). The policy therefore:

* flattens the formed virtual gangs into member RTTasks sharing the
  virtual gang's priority, remapped onto disjoint core blocks and
  released synchronously — so the event engine (core/events.py)
  dispatches each virtual gang as a unit;
* acts as the Simulator's ``budget_policy``: while a virtual gang holds
  the lock, every core's throttle budget is the minimum over the
  *currently co-running* members (per-member budgets — when a short
  member finishes its job mid-gang, the surviving members' higher
  tolerance is applied immediately). Cores occupied by members carry no
  best-effort work, so they are set unconstrained. This replaces the
  engine's default leader-budget rule, which would arbitrarily pick
  whichever member acquired the lock first.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from repro_torch.core.gang import BETask, RTTask
from repro_torch.core.rta import gang_wcet
from repro_torch.core.sim import (PairwiseInterference, SimResult, Simulator,
                                  no_interference)
from repro_torch.vgang.formation import (Partitioning, VirtualGang,
                                         assign_priorities, critical_member,
                                         rtg_sibling_budget)
from repro_torch.vgang.rta import (schedulable_partitions,
                                   schedulable_rtg_throttle,
                                   schedulable_vgangs)


def remap_members(vg: VirtualGang) -> List[RTTask]:
    """Flatten one virtual gang's members onto a disjoint core/lane
    block starting at 0: members share the vgang's priority and a
    synchronous release (zero offset), so the glock dispatches them as
    one unit. uids are preserved across the remap, so per-member tables
    keyed by uid (budgets, critical-member choice) remain valid. Shared
    by the simulator policy below and GangExecutor.submit_vgang
    (DESIGN.md §2.4)."""
    out = []
    cursor = 0
    for m in vg.members:
        cores = tuple(range(cursor, cursor + m.n_threads))
        cursor += m.n_threads
        wpc = None
        if m.wcet_per_core:
            wpc = {new: m.wcet_per_core.get(old, m.wcet)
                   for old, new in zip(m.cores, cores)}
        out.append(dataclasses.replace(
            m, prio=vg.prio, cores=cores, release_offset=0.0,
            wcet_per_core=wpc))
    return out


class VirtualGangPolicy:
    """Budget policy + taskset builder for a formed virtual-gang set.

    ``vgangs`` need distinct priorities; pass ``auto_prio=True`` (default)
    to (re)assign rate-monotonic priorities via formation.assign_priorities.

    ``rtg_throttle=True`` enables RTG-throttle (arXiv:1912.10959 §IV-C):
    while a virtual gang runs, its *critical* member (formation.
    critical_member — the interference-inflated bottleneck) executes
    unthrottled, and every sibling member's cores are capped at the
    critical member's tolerable traffic (formation.rtg_sibling_budget).
    Sibling RT threads charge their ``traffic_rate`` against that cap
    through the engines' MemoryModel and pause mid-job when they trip;
    once the critical member finishes its job, the surviving members run
    unthrottled (the protection target is gone). vgang/rta.py prices
    this regime with a per-window duty-cycle WCET bound
    (``rtg_throttle_wcet``).
    """

    def __init__(self, vgangs: Sequence[VirtualGang], n_cores: int,
                 interference: PairwiseInterference = no_interference,
                 auto_prio: bool = True, rtg_throttle: bool = False,
                 reclaim: bool = False, **unknown):
        if unknown:
            raise TypeError(
                f"VirtualGangPolicy: unknown option(s) {sorted(unknown)}; "
                f"valid options: interference, auto_prio, rtg_throttle, "
                f"reclaim")
        prios = [vg.prio for vg in vgangs]
        if auto_prio and len(set(prios)) != len(prios):
            vgangs = assign_priorities(vgangs)
        self.vgangs: List[VirtualGang] = list(vgangs)
        self.n_cores = n_cores
        self.interference = interference
        self.rtg_throttle = rtg_throttle
        # mid-window donation (DESIGN.md §7.5): completed sibling cores
        # keep their per-window grant so stalled co-siblings can draw it
        self.reclaim = reclaim
        for vg in self.vgangs:
            if vg.width > n_cores:
                raise ValueError(f"virtual gang {vg.name!r} needs "
                                 f"{vg.width} cores, machine has {n_cores}")
        self._by_prio: Dict[int, VirtualGang] = {
            vg.prio: vg for vg in self.vgangs}
        if len(self._by_prio) != len(self.vgangs):
            raise ValueError("virtual gangs must have distinct priorities")
        self._members: List[RTTask] = []
        self._budget: Dict[int, float] = {}       # member uid -> budget
        self._critical: Dict[int, int] = {}       # vgang prio -> member uid
        # vgang prio -> remapped core footprint of its sibling members
        # (reclaim: a completed sibling's cores keep the cap so their
        # unspent window quota stays donatable)
        self._sibling_cores: Dict[int, tuple] = {}
        # (vgang prio, regulation interval) -> sibling cap: the headroom
        # fallback scales with the interval, and one policy object may
        # drive both a simulator (interval in sim-ms) and an executor
        # (interval in wall-s)
        self._sibling_budget: Dict[tuple, float] = {}
        for vg in self.vgangs:
            self._critical[vg.prio] = critical_member(
                vg, self.interference).uid
        for vg in self.vgangs:
            # members of one virtual gang release together (one unit)
            sib_cores = []
            for member in remap_members(vg):
                self._members.append(member)
                self._budget[member.uid] = member.mem_budget
                if member.uid != self._critical[vg.prio]:
                    sib_cores.extend(member.cores)
            self._sibling_cores[vg.prio] = tuple(sib_cores)

    # ---- taskset --------------------------------------------------------
    def taskset(self) -> List[RTTask]:
        """Flattened member gangs: shared per-vgang priority, disjoint
        core blocks, synchronous release — feed to Simulator."""
        return list(self._members)

    # ---- BudgetPolicy interface (Simulator.budget_policy) ---------------
    def apply(self, g, reg):
        """Set throttle budgets from the running virtual gang's live
        members (called by both engines whenever scheduling settles).
        Returns the cores whose throttle regime changed (the event
        engine folds them into its dirty-core set)."""
        if not g.held_flag or g.leader is None:
            return reg.set_gang_budget(None)
        vg = self._by_prio.get(g.leader.prio)
        if vg is None:                   # foreign gang: default rule
            occupied = {th.core for th in g.gthreads if th is not None}
            return reg.set_core_budgets({c: None for c in occupied},
                                        default=g.leader.mem_budget)
        live_uids = {th.task.uid for th in g.gthreads if th is not None}
        budgets = [self._budget[u] for u in live_uids if u in self._budget]
        if not budgets:                  # hand-off instant: whole gang
            budgets = [m.mem_budget for m in vg.members]
        floor = min(budgets)
        occupied = {th.core for th in g.gthreads if th is not None}
        crit_uid = self._critical.get(vg.prio)
        if self.rtg_throttle and crit_uid in live_uids:
            # RTG-throttle: the critical member runs unthrottled, every
            # other live member's cores (and the best-effort fillers)
            # are capped at the critical member's tolerable traffic
            cap = self._sibling_budget.get((vg.prio, reg.interval))
            if cap is None:
                cap = rtg_sibling_budget(vg, self.interference,
                                         reg.interval)
                self._sibling_budget[(vg.prio, reg.interval)] = cap
            per_core = {th.core: (None if th.task.uid == crit_uid
                                  else cap)
                        for th in g.gthreads if th is not None}
            if self.reclaim:
                # a completed sibling's cores keep the cap: the static
                # bound granted them Q per window, and that unspent
                # grant is exactly what the donation pool hands to
                # stalled co-siblings (DESIGN.md §7.5)
                for c in self._sibling_cores[vg.prio]:
                    per_core.setdefault(c, cap)
            return reg.set_core_budgets(per_core,
                                        default=min(floor, cap))
        return reg.set_core_budgets({c: None for c in occupied},
                                    default=floor)

    # ---- drivers --------------------------------------------------------
    def build_simulator(self, be_tasks: Sequence[BETask] = (),
                        interference: Optional[PairwiseInterference] = None,
                        dt: Optional[float] = None,
                        **kwargs) -> Simulator:
        """Simulator over the flattened members with this policy wired in
        (dt=None: exact event engine)."""
        interval = kwargs.get("regulation_interval", 1.0)
        if self.rtg_throttle and interval > 0.0:
            # declaration sanity on the *intensity* scale (every sibling
            # traffic_rate <= 1, so a core generates at most ``interval``
            # units per window): a sibling cap above that can never trip
            # — almost certainly a bytes-scale budget (executor units)
            # fed to a simulator. The executor's byte-scale caps are
            # deliberately exempt: there the comparison is meaningless.
            for vg in self.vgangs:
                sibs = [m for m in vg.members
                        if m.uid != self._critical[vg.prio]]
                if not sibs or any(m.traffic_rate > 1.0 for m in sibs):
                    continue
                cap = rtg_sibling_budget(vg, self.interference, interval)
                if cap > interval + 1e-12:
                    raise ValueError(
                        f"virtual gang {vg.name!r}: RTG-throttle sibling "
                        f"budget {cap} exceeds the regulation interval "
                        f"{interval} — on the intensity scale "
                        f"(traffic_rate <= 1) a core cannot generate "
                        f"that much traffic per window, so the cap can "
                        f"never take effect; declare the critical "
                        f"member's mem_budget in simulator units")
        return Simulator(self.n_cores, self.taskset(), be_tasks=be_tasks,
                         interference=interference or self.interference,
                         rt_gang_enabled=True, dt=dt,
                         budget_policy=self, reclaim=self.reclaim,
                         **kwargs)

    def simulate(self, horizon: float, **kwargs) -> SimResult:
        return self.build_simulator(**kwargs).run(horizon)

    def build_executor(self, fns, *, n_lanes: Optional[int] = None,
                       n_jobs: Optional[int] = None,
                       time_scale: float = 1e-3,
                       bytes_per_quantum=None, **kwargs):
        """GangExecutor (core/executor.py) over the formed set: each
        virtual gang's members land on disjoint lane blocks via
        ``remap_members`` and this policy is installed as the executor's
        ``budget_policy``, so the glock's gang-change hook enforces
        min-over-live-member lane budgets — and, under ``rtg_throttle``,
        uncaps the critical member's lanes while admission-capping
        sibling lanes (and their best-effort fillers) at
        ``rtg_sibling_budget``. Give sibling jobs a ``bytes_per_quantum``
        (name -> bytes) to have their quanta admission-charged against
        that cap. ``fns`` maps member task name -> callable(lane, idx);
        ``time_scale`` converts task-time (sim ms) to wall seconds.

        Note: executor-side RTG-throttle wants members with a declared
        positive ``mem_budget`` (bytes per regulation window); the
        headroom fallback ``(1 - intensity) * interval`` is in simulator
        units."""
        from repro_torch.core.executor import GangExecutor
        ex = GangExecutor(
            self.n_cores if n_lanes is None else n_lanes,
            budget_policy=self, reclaim=self.reclaim, **kwargs)
        for vg in self.vgangs:
            ex.submit_vgang(vg, fns, n_jobs=n_jobs,
                            time_scale=time_scale,
                            bytes_per_quantum=bytes_per_quantum)
        return ex

    def rta(self) -> Dict[str, Dict]:
        """Vgang RTA verdicts for the formed set (vgang/rta.py)."""
        return schedulable_vgangs(self.vgangs, self.interference)

    def member_bounds(self, interval: float = 1.0,
                      blocking: float = 0.0) -> Dict[str, float]:
        """Per-*member* analytic response-time bounds (ms) for this
        policy's regime — the vgang-level WCRT from the pricing the
        policy actually enforces (plain vgang RTA, or the RTG-throttle
        duty-cycle bound with reclaim credit when armed). Every member
        of a virtual gang completes within the vgang's WCRT (members
        release together and the vgang retires as a unit), so the vgang
        bound is a sound per-member bound. Feed the result to
        ``Simulator(rta_bounds=...)`` for measured-margin accounting
        (DESIGN.md §12.3)."""
        if self.rtg_throttle:
            verdicts = schedulable_rtg_throttle(
                self.vgangs, self.interference, interval=interval,
                blocking=blocking, reclaim=self.reclaim)
        else:
            verdicts = schedulable_vgangs(self.vgangs, self.interference,
                                          blocking=blocking)
        out: Dict[str, float] = {}
        for vg in self.vgangs:
            wcrt = verdicts[vg.name]["wcrt"]
            for m in vg.members:
                out[m.name] = wcrt
        return out


class StrictPartitionPolicy:
    """Run a strict ``Partitioning`` (formation.strict_partition) on the
    simulator engines — the runtime counterpart of
    ``rta.schedulable_partitions``.

    Dispatch model: RT-Gang's global one-gang-at-a-time lock is *off*
    (``rt_gang_enabled=False`` — plain per-core preemptive fixed
    priority). Each gang is widened to occupy its entire partition with
    a uniform per-thread WCET of ``gang_wcet`` and a synchronous zero
    release offset. Within a partition all gangs then share the same
    core set with globally distinct RM priorities, so on every core of
    the partition the highest-priority pending gang wins — the gangs of
    one partition serialize exactly one-after-another, which is the
    uniprocessor the partition RTA analyzes. The widened threads stay in
    lockstep (identical WCET, release, priority on every core, and the
    MemoryModel never slows a thread by its own gang's occupancy), so
    widening adds no execution time: a gang's threads finish exactly
    when its critical thread would.

    Soundness of the RTA cross-check: at any instant the co-runners a
    gang observes are a subset of the gangs of *other* partitions, so
    the engines' occupancy slowdown never exceeds the cross-partition
    inflation factor the analysis prices into C'.
    """

    def __init__(self, partitioning: Partitioning,
                 interference: PairwiseInterference = no_interference,
                 **unknown):
        if unknown:
            raise TypeError(
                f"StrictPartitionPolicy: unknown option(s) "
                f"{sorted(unknown)}; valid options: interference")
        if getattr(interference, "distance_aware", False):
            raise ValueError(
                "StrictPartitionPolicy cannot dispatch a distance-aware "
                "interference model: gangs are widened to their whole "
                "partition, so runtime distances differ from the declared "
                "member placements — price placement analytically via "
                "rta.schedulable_partitions/pair_factor instead")
        self.partitioning = partitioning
        self.n_cores = partitioning.n_cores
        self.interference = interference
        self._members: List[RTTask] = []
        for p in partitioning.partitions:
            for g in p.gangs:
                self._members.append(dataclasses.replace(
                    g, cores=tuple(p.cores), release_offset=0.0,
                    wcet=gang_wcet(g), wcet_per_core=None))

    def taskset(self) -> List[RTTask]:
        """Widened gangs: each pinned to its whole partition, distinct
        global RM priorities — feed to Simulator."""
        return list(self._members)

    def build_simulator(self, be_tasks: Sequence[BETask] = (),
                        interference: Optional[PairwiseInterference] = None,
                        dt: Optional[float] = None,
                        **kwargs) -> Simulator:
        """Simulator over the widened gangs, RT-Gang lock disabled —
        per-core preemptive FP is exactly partition-local uniprocessor
        scheduling here (dt=None: exact event engine)."""
        return Simulator(self.n_cores, self.taskset(), be_tasks=be_tasks,
                         interference=interference or self.interference,
                         rt_gang_enabled=False, dt=dt, **kwargs)

    def simulate(self, horizon: float, **kwargs) -> SimResult:
        return self.build_simulator(**kwargs).run(horizon)

    def rta(self) -> Dict[str, Dict]:
        """Partition RTA verdicts for this partitioning (vgang/rta.py)."""
        return schedulable_partitions(self.partitioning, self.interference)

    def member_bounds(self, interval: float = 1.0,
                      blocking: float = 0.0) -> Dict[str, float]:
        """Per-gang analytic response-time bounds from the partition RTA
        — same contract as VirtualGangPolicy.member_bounds (the
        ``interval`` argument is accepted for signature parity; strict
        partitioning has no regulation windows)."""
        del interval
        verdicts = schedulable_partitions(self.partitioning,
                                          self.interference,
                                          blocking=blocking)
        return {name: v["wcrt"] for name, v in verdicts.items()}
