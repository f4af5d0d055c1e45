"""Virtual-gang formation: width-constrained bin packing of real-time
gangs into virtual gangs (arXiv:1912.10959 §IV-V).

A virtual gang is a fixed set of member gangs dispatched as one
scheduling unit: members share one release, one period and one RT
priority, and co-execute on disjoint cores. Packing constraints:

* members share the same period (the virtual gang is one periodic
  entity);
* the summed width of the members fits the machine (sum w_i <= M);
* the virtual gang must not be unschedulable by construction — its
  interference-inflated WCET must fit its period.

The *inflated* WCET models intra-gang interference exactly the way the
simulator engines do: a member is slowed by the worst pairwise factor
over its co-members, and the virtual gang runs until its slowest member
finishes:

    C_v = max_i  C_i * max_{j != i} intf(i, j)

Under one-gang-at-a-time the machine then behaves as a single core with
the virtual gangs as its tasks, so formation quality is measured by the
total inflated utilization sum C_v / P_v — lower is better — which
core/rta.py turns into acceptance verdicts (vgang/rta.py).

Heuristics (the evaluation grid compares all of them against the
singleton baseline = plain RT-Gang):

* ``first_fit_decreasing``  — sort by width, descending; place each gang
  in the first open virtual gang that fits.
* ``best_fit_utilization``  — sort by utilization, descending; place in
  the open virtual gang left tightest (least spare width) by the merge.
* ``interference_aware``    — the paper's pairing rule: co-locate
  low-memory-intensity gangs. Greedy cost comparison of "open a new
  virtual gang" (cost = solo utilization) vs "merge into an existing
  one" (cost = utilization increase, which embeds the pairwise
  interference inflation), taking the cheapest feasible option.
* ``exhaustive_optimal``    — exact minimizer of total inflated
  utilization by set-partition enumeration per period group; small-N
  cross-check baseline for the heuristics.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core.gang import RTTask
from repro_torch.core.rta import gang_wcet
from repro_torch.core.sim import PairwiseInterference, no_interference


def pair_factor(interference: PairwiseInterference,
                victim: str, aggressor: str,
                victim_cores: Optional[Sequence[int]] = None,
                aggressor_cores: Optional[Sequence[int]] = None) -> float:
    """Worst-case pairwise slowdown factor, placement-aware when the
    model is.

    Location-free models are called exactly as before —
    ``interference(victim, aggressor)`` — so every existing verdict is
    bit-identical. A ``distance_interference``-decorated model
    (core/memmodel.py, ``fn.distance_aware``) takes the core distance as
    a third argument; the analysis must then price the worst pair over
    the two units' core placements, matching the per-(victim, core)
    slowdown the MemoryModel applies at runtime."""
    if getattr(interference, "distance_aware", False):
        if not victim_cores or not aggressor_cores:
            raise ValueError(
                "distance-aware interference model needs core placements "
                "for both the victim and the aggressor")
        return max(interference(victim, aggressor, abs(v - a))
                   for v in victim_cores for a in aggressor_cores)
    return interference(victim, aggressor)


def member_core_blocks(members: Sequence[RTTask]) -> Dict[str, tuple]:
    """Member name -> consecutive core block, mirroring the layout
    ``sched.remap_members`` dispatches (cursor from core 0, members in
    list order). This is the placement the placement-aware analysis
    prices."""
    blocks: Dict[str, tuple] = {}
    cursor = 0
    for m in members:
        blocks[m.name] = tuple(range(cursor, cursor + m.n_threads))
        cursor += m.n_threads
    return blocks


@dataclasses.dataclass
class VirtualGang:
    """A fixed-composition set of member gangs scheduled as one unit."""
    name: str
    members: List[RTTask]
    prio: int = 0

    def __post_init__(self):
        periods = {m.period for m in self.members}
        if len(periods) != 1:
            raise ValueError(
                f"virtual gang {self.name!r} mixes periods {periods}")

    @property
    def period(self) -> float:
        return self.members[0].period

    @property
    def width(self) -> int:
        return sum(m.n_threads for m in self.members)

    @property
    def mem_budget(self) -> float:
        """Tolerable best-effort traffic while this virtual gang runs =
        the most sensitive member's budget."""
        return min(m.mem_budget for m in self.members)

    def inflated_wcet(self,
                      interference: PairwiseInterference = no_interference
                      ) -> float:
        """C_v: the gang runs until its slowest member finishes, each
        member slowed by the worst pairwise factor over co-members —
        the same max-of-pairwise model the simulator engines apply.

        Distance-aware models are priced over the consecutive core
        blocks ``sched.remap_members`` will dispatch; location-free
        models take the exact pre-existing call path."""
        blocks = (member_core_blocks(self.members)
                  if getattr(interference, "distance_aware", False)
                  else None)
        worst = 0.0
        for m in self.members:
            slow = 1.0
            for o in self.members:
                if o is not m:
                    if blocks is None:
                        slow = max(slow, interference(m.name, o.name))
                    else:
                        slow = max(slow, pair_factor(
                            interference, m.name, o.name,
                            blocks[m.name], blocks[o.name]))
            worst = max(worst, gang_wcet(m) * slow)
        return worst

    def utilization(self,
                    interference: PairwiseInterference = no_interference
                    ) -> float:
        return self.inflated_wcet(interference) / self.period


def total_vgang_utilization(
        vgangs: Sequence[VirtualGang],
        interference: PairwiseInterference = no_interference) -> float:
    """Single-core-equivalent utilization of the formed taskset — the
    formation objective (lower packs better)."""
    return sum(vg.utilization(interference) for vg in vgangs)


def intensity_interference(tasks: Sequence[RTTask],
                           gamma: float = 0.5) -> PairwiseInterference:
    """Pairwise interference derived from each gang's declared memory
    intensity: an aggressor at intensity s slows any victim by
    1 + gamma * s (slowdown tracks the co-runner's traffic,
    arXiv:1912.10959 §III)."""
    intensity = {t.name: t.mem_intensity for t in tasks}

    def f(victim: str, aggressor: str) -> float:
        return 1.0 + gamma * intensity.get(aggressor, 0.0)
    return f


def critical_member(vg: VirtualGang,
                    interference: PairwiseInterference = no_interference
                    ) -> RTTask:
    """RTG-throttle's protected member (arXiv:1912.10959 §IV-C): the
    member whose interference-inflated solo term C_i * max_j intf(i, j)
    bounds the virtual gang's WCET — the bottleneck whose timing the
    sibling regulation protects. Ties break by name (deterministic
    across the policy, the RTA and the evaluation grid)."""
    blocks = (member_core_blocks(vg.members)
              if getattr(interference, "distance_aware", False)
              else None)

    def key(m: RTTask):
        slow = 1.0
        for o in vg.members:
            if o is not m:
                if blocks is None:
                    slow = max(slow, interference(m.name, o.name))
                else:
                    slow = max(slow, pair_factor(
                        interference, m.name, o.name,
                        blocks[m.name], blocks[o.name]))
        return (-gang_wcet(m) * slow, m.name)
    return min(vg.members, key=key)


def rtg_sibling_budget(vg: VirtualGang,
                       interference: PairwiseInterference = no_interference,
                       interval: float = 1.0) -> float:
    """Per-core traffic budget RTG-throttle enforces on the critical
    member's sibling members (and best-effort fillers): the critical
    member's declared tolerable traffic when it has one, else its
    bandwidth headroom — a critical member of intensity s leaves
    (1 - s) * interval units per regulation window for everyone else."""
    crit = critical_member(vg, interference)
    if crit.mem_budget > 0.0:
        return crit.mem_budget
    return max(0.0, 1.0 - crit.mem_intensity) * interval


def singleton_vgangs(tasks: Sequence[RTTask]) -> List[VirtualGang]:
    """The degenerate formation: every real gang is its own virtual gang.
    This *is* plain RT-Gang — vgang RTA on it must reproduce core/rta.py
    verdicts exactly (tests/test_vgang.py)."""
    return [VirtualGang(name=t.name, members=[t], prio=t.prio)
            for t in tasks]


def _feasible(members: List[RTTask], extra: RTTask, n_cores: int,
              interference: PairwiseInterference) -> bool:
    """Capacity + self-schedulability guard for merging ``extra``."""
    cand = VirtualGang(name="_cand", members=members + [extra])
    if cand.width > n_cores:
        return False
    return cand.inflated_wcet(interference) <= cand.period + 1e-12


def _by_period(tasks: Sequence[RTTask]) -> Dict[float, List[RTTask]]:
    groups: Dict[float, List[RTTask]] = {}
    for t in tasks:
        groups.setdefault(t.period, []).append(t)
    return groups


def _finalize(bins: List[List[RTTask]]) -> List[VirtualGang]:
    out = []
    for members in bins:
        name = "+".join(m.name for m in members)
        out.append(VirtualGang(name=name, members=list(members)))
    return out


def first_fit_decreasing(
        tasks: Sequence[RTTask], n_cores: int,
        interference: PairwiseInterference = no_interference
        ) -> List[VirtualGang]:
    """FFD by gang width (ties: heavier utilization first)."""
    vgangs: List[VirtualGang] = []
    for period, group in sorted(_by_period(tasks).items()):
        bins: List[List[RTTask]] = []
        order = sorted(group, key=lambda t: (-t.n_threads,
                                             -gang_wcet(t) / t.period,
                                             t.name))
        for t in order:
            for b in bins:
                if _feasible(b, t, n_cores, interference):
                    b.append(t)
                    break
            else:
                bins.append([t])
        vgangs.extend(_finalize(bins))
    return vgangs


def best_fit_utilization(
        tasks: Sequence[RTTask], n_cores: int,
        interference: PairwiseInterference = no_interference
        ) -> List[VirtualGang]:
    """Best-fit by utilization: heaviest gangs placed first, each into
    the feasible virtual gang the merge leaves tightest (least spare
    width; ties broken toward the higher-utilization bin)."""
    vgangs: List[VirtualGang] = []
    for period, group in sorted(_by_period(tasks).items()):
        bins: List[List[RTTask]] = []
        order = sorted(group, key=lambda t: (-gang_wcet(t) / t.period,
                                             -t.n_threads, t.name))
        for t in order:
            best: Optional[List[RTTask]] = None
            best_key = None
            for b in bins:
                if not _feasible(b, t, n_cores, interference):
                    continue
                spare = n_cores - (sum(m.n_threads for m in b)
                                   + t.n_threads)
                util = sum(gang_wcet(m) / m.period for m in b)
                key = (spare, -util)
                if best_key is None or key < best_key:
                    best, best_key = b, key
            if best is None:
                bins.append([t])
            else:
                best.append(t)
        vgangs.extend(_finalize(bins))
    return vgangs


def interference_aware(
        tasks: Sequence[RTTask], n_cores: int,
        interference: PairwiseInterference = no_interference
        ) -> List[VirtualGang]:
    """The paper's pairing rule: co-locate low-memory-intensity gangs.

    Greedy over gangs in increasing memory intensity: merging task t
    into bin b costs util(b + t) - util(b) (the interference inflation
    is embedded in the inflated WCET), opening a new bin costs t's solo
    utilization; take the cheapest feasible option. Two memory-hungry
    gangs inflate each other, making their merge expensive — so they
    land in separate virtual gangs and the low-intensity gangs pack
    together."""
    vgangs: List[VirtualGang] = []
    for period, group in sorted(_by_period(tasks).items()):
        bins: List[List[RTTask]] = []
        order = sorted(group, key=lambda t: (t.mem_intensity,
                                             -t.n_threads, t.name))
        for t in order:
            solo_cost = gang_wcet(t) / t.period
            best: Optional[List[RTTask]] = None
            best_cost = solo_cost
            for b in bins:
                if not _feasible(b, t, n_cores, interference):
                    continue
                before = VirtualGang("_b", list(b)).utilization(interference)
                after = VirtualGang("_a", b + [t]).utilization(interference)
                cost = after - before
                if cost < best_cost - 1e-15:
                    best, best_cost = b, cost
            if best is None:
                bins.append([t])
            else:
                best.append(t)
        vgangs.extend(_finalize(bins))
    return vgangs


def _partitions(items: List[RTTask]) -> Iterable[List[List[RTTask]]]:
    """All set partitions (Bell-number enumeration, small N only)."""
    if not items:
        yield []
        return
    first, rest = items[0], items[1:]
    for p in _partitions(rest):
        for i in range(len(p)):
            yield p[:i] + [p[i] + [first]] + p[i + 1:]
        yield p + [[first]]


def exhaustive_optimal(
        tasks: Sequence[RTTask], n_cores: int,
        interference: PairwiseInterference = no_interference,
        max_group: int = 9) -> List[VirtualGang]:
    """Exact minimizer of total inflated utilization over all feasible
    partitions, per period group (groups pack independently). Bell(9) =
    21147 partitions per group — a cross-check baseline, not a scalable
    heuristic."""
    vgangs: List[VirtualGang] = []
    for period, group in sorted(_by_period(tasks).items()):
        if len(group) > max_group:
            raise ValueError(
                f"exhaustive formation capped at {max_group} same-period "
                f"gangs; got {len(group)} at period {period}")
        best_bins: Optional[List[List[RTTask]]] = None
        best_util = float("inf")
        for p in _partitions(list(group)):
            util = 0.0
            ok = True
            for members in p:
                vg = VirtualGang("_p", members)
                if vg.width > n_cores or \
                        vg.inflated_wcet(interference) > vg.period + 1e-12:
                    ok = False
                    break
                util += vg.utilization(interference)
            if ok and util < best_util - 1e-15:
                best_bins, best_util = p, util
        if best_bins is None:
            # no feasible grouping at all (some gang unschedulable solo):
            # fall back to singletons so RTA reports the failure
            best_bins = [[t] for t in group]
        vgangs.extend(_finalize(best_bins))
    return vgangs


HEURISTICS: Dict[str, Callable] = {
    "ffd": first_fit_decreasing,
    "bestfit": best_fit_utilization,
    "intfaware": interference_aware,
}


def assign_priorities(vgangs: Sequence[VirtualGang]) -> List[VirtualGang]:
    """Rate-monotonic priorities over virtual gangs — shorter period =
    higher priority, ties broken by name so every virtual gang gets a
    distinct priority (gang identity, RT-Gang §IV-E)."""
    order = sorted(vgangs, key=lambda vg: (vg.period, vg.name))
    out = []
    for rank, vg in enumerate(order):
        out.append(dataclasses.replace(vg, prio=len(order) - rank))
    return out


# --------------------------------------------------------------------------
# Strict partitioning (arXiv:2403.10726): instead of merging gangs into
# virtual gangs and inflating WCETs, carve the machine into static,
# disjoint core partitions and bin-pack whole gangs into them. Gangs of
# one partition never co-run (each occupies its whole partition while
# executing), so intra-partition interference vanishes and the analysis
# collapses to classic uniprocessor fixed-priority RTA per partition —
# while the partitions themselves run concurrently, paying only the
# cross-partition interference inflation.
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Partition:
    """A static block of cores and the gangs pinned to it."""
    name: str
    cores: Tuple[int, ...]
    gangs: List[RTTask]

    @property
    def size(self) -> int:
        return len(self.cores)

    def utilization(self) -> float:
        """Plain (uninflated) uniprocessor-equivalent utilization."""
        return sum(gang_wcet(g) / g.period for g in self.gangs)


@dataclasses.dataclass
class Partitioning:
    """A strict partitioning of the machine: disjoint consecutive core
    blocks, every gang assigned to exactly one."""
    n_cores: int
    partitions: List[Partition]

    @property
    def gangs(self) -> List[RTTask]:
        return [g for p in self.partitions for g in p.gangs]


def strict_partition(tasks: Sequence[RTTask], n_cores: int,
                     interference: PairwiseInterference = no_interference
                     ) -> Partitioning:
    """Bin-pack gangs into static core partitions (arXiv:2403.10726).

    Deterministic worst-fit decreasing: gangs sorted by (width desc,
    utilization desc, name) each go to the feasible option — an existing
    partition at least as wide as the gang, or a new partition carved
    from the remaining cores — that leaves the target partition least
    loaded. While spare cores remain this opens new partitions (maximal
    parallelism); once the machine is carved up, the remaining gangs
    balance load across the partitions wide enough to host them.

    Priorities are global rate-monotonic (period, name) — distinct
    everywhere, hence valid locally within each partition. Core blocks
    are consecutive, so a distance-aware interference model prices
    cross-partition pairs over real placements (``pair_factor``).

    The ``interference`` argument is accepted for signature parity with
    the virtual-gang heuristics; packing itself needs no factors because
    intra-partition interference is structurally zero.
    """
    del interference  # intra-partition interference is zero by design
    order = sorted(tasks, key=lambda t: (-t.n_threads,
                                         -gang_wcet(t) / t.period,
                                         t.name))
    bins: List[Tuple[int, List[RTTask]]] = []   # (size, members)
    used = 0
    for t in order:
        w = t.n_threads
        if w > n_cores:
            raise ValueError(
                f"gang {t.name!r} is wider ({w}) than the machine "
                f"({n_cores} cores)")
        u = gang_wcet(t) / t.period
        options = []
        for i, (size, members) in enumerate(bins):
            if w <= size:
                load = sum(gang_wcet(m) / m.period for m in members)
                options.append((load + u, 1, i))
        if used + w <= n_cores:
            # a fresh partition is always the least-loaded option; the
            # flag 0 prefers it on (impossible in practice) ties
            options.append((u, 0, len(bins)))
        _, is_existing, i = min(options)
        if is_existing:
            bins[i][1].append(t)
        else:
            bins.append((w, [t]))
            used += w
    # global RM priorities, distinct via name tiebreak
    ranked = sorted((g for _, members in bins for g in members),
                    key=lambda g: (g.period, g.name))
    prio_of = {g.uid: len(ranked) - r for r, g in enumerate(ranked)}
    partitions: List[Partition] = []
    cursor = 0
    for idx, (size, members) in enumerate(bins):
        cores = tuple(range(cursor, cursor + size))
        cursor += size
        gangs = [dataclasses.replace(g, prio=prio_of[g.uid])
                 for g in members]
        partitions.append(Partition(name=f"P{idx}", cores=cores,
                                    gangs=gangs))
    return Partitioning(n_cores=n_cores, partitions=partitions)
