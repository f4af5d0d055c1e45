"""Response-time analysis for virtual-gang tasksets.

Under one-gang-at-a-time, a virtual gang is one scheduling unit, so the
RT-Gang transform (core/rta.py, paper §III-B) applies unchanged with the
virtual gang's *inflated* WCET standing in for the gang WCET:

    R_v = C_v + B_v + sum_{u in hp(v)} ceil(R_v / P_u) * C_u
    C_v = max_i C_i * max_{j != i} intf(i, j)      (formation.py)

Implementation is literal reuse: each virtual gang collapses to its
single-core-equivalent RTTask and the existing Audsley fixed point runs
verbatim. A real gang is the degenerate one-member virtual gang (C_v =
gang WCET exactly — the factor over zero co-members is 1.0), so
``schedulable_vgangs(singleton_vgangs(ts))`` reproduces
``core.rta.schedulable(ts)`` bit-for-bit; tests/test_vgang.py asserts
float equality.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.gang import RTTask
from repro_torch.core import rta as core_rta
from repro_torch.core.rta import gang_wcet
from repro_torch.core.sim import PairwiseInterference, no_interference
from repro_torch.vgang.formation import (Partitioning, VirtualGang,
                                         critical_member, pair_factor,
                                         rtg_sibling_budget)


def vgang_equivalent_task(
        vg: VirtualGang,
        interference: PairwiseInterference = no_interference) -> RTTask:
    """Collapse a virtual gang to the RTTask the single-core transform
    sees: inflated WCET, the virtual gang's period and priority."""
    return RTTask(name=vg.name, wcet=vg.inflated_wcet(interference),
                  period=vg.period, cores=tuple(range(max(1, vg.width))),
                  prio=vg.prio, mem_budget=vg.mem_budget)


def vgang_taskset(vgangs: Sequence[VirtualGang],
                  interference: PairwiseInterference = no_interference
                  ) -> List[RTTask]:
    """Collapse a formed set for analysis. Distinct priority per virtual
    gang is the gang-identity requirement — freshly formed vgangs all
    carry the default prio 0, and analyzing them that way would silently
    drop every inter-vgang interference term (hp() is strictly-higher
    priorities only), so duplicates are an error, not a verdict."""
    prios = [vg.prio for vg in vgangs]
    if len(set(prios)) != len(prios):
        raise ValueError(
            "virtual gangs must carry distinct priorities before RTA — "
            "run formation output through formation.assign_priorities()")
    return [vgang_equivalent_task(vg, interference) for vg in vgangs]


def response_time_vgang(
        vg: VirtualGang, vgangs: Sequence[VirtualGang],
        interference: PairwiseInterference = no_interference,
        blocking: float = 0.0, crpd: float = 0.0) -> Optional[float]:
    """WCRT of one virtual gang within a formed taskset (None =
    divergent, as in core/rta.py). ``vg`` is matched by name, which is
    unique within a formed set (each gang joins exactly one vgang)."""
    eq = vgang_taskset(vgangs, interference)
    mine = [t for t in eq if t.name == vg.name]
    if not mine:
        raise ValueError(f"{vg.name!r} is not in the formed set "
                         f"{[v.name for v in vgangs]}")
    return core_rta.response_time(mine[0], eq, blocking=blocking,
                                  crpd=crpd)


def schedulable_vgangs(
        vgangs: Sequence[VirtualGang],
        interference: PairwiseInterference = no_interference,
        blocking: float = 0.0, crpd: float = 0.0) -> Dict[str, Dict]:
    """Per-virtual-gang response times vs deadlines, keyed by vgang name
    — same row shape as core.rta.schedulable."""
    return core_rta.schedulable(vgang_taskset(vgangs, interference),
                                blocking=blocking, crpd=crpd)


def accepts(vgangs: Sequence[VirtualGang],
            interference: PairwiseInterference = no_interference,
            blocking: float = 0.0, crpd: float = 0.0) -> bool:
    """Single-bit admission verdict for the evaluation grid."""
    res = schedulable_vgangs(vgangs, interference, blocking=blocking,
                             crpd=crpd)
    return all(v["ok"] for v in res.values())


def schedulable_vgangs_enforced(
        vgangs: Sequence[VirtualGang],
        interference: PairwiseInterference = no_interference,
        enforcement=None,
        blocking: float = 0.0, crpd: float = 0.0) -> Dict[str, Dict]:
    """Admission with runtime overrun enforcement priced in
    (core/faults.py, DESIGN.md §11) — the enforcement-aware restoration
    of the paper's interference/blocking bound.

    Without enforcement the RTA is vacuous against misbehavior: a job
    that overruns its declared WCET occupies the machine for as long as
    it pleases (one-gang-at-a-time makes that occupancy everyone else's
    interference), so no bound computed from declarations survives a
    single lying task. With an ``Enforcement`` policy, *no* job —
    compliant or not — can occupy the machine for more than:

    * ``factor x C_v`` of executed work (the work budget cuts it
      there), and,
    * when the watchdog is armed, ``watchdog_factor x P_v`` of wall
      time since release (the watchdog aborts it there even if it
      executes nothing at all — e.g. a thread stalled forever by a
      lost wakeup, which no work budget can catch).

    Each virtual gang's equivalent-task WCET is therefore replaced by
    the tighter of the two occupancy bounds and the standard fixed
    point runs unchanged: the resulting per-gang response times hold
    for every *compliant* gang no matter how any other task misbehaves.
    With ``enforcement=None`` (or factor 1.0, no watchdog) this is
    exactly ``schedulable_vgangs`` — the declared-WCET bound, sound
    only when every task is honest."""
    factor = 1.0 if enforcement is None else enforcement.factor
    wd = None if enforcement is None else enforcement.watchdog_factor
    eq = []
    for t in vgang_taskset(vgangs, interference):
        w = t.wcet * factor
        if wd is not None:
            w = min(w, wd * t.period)
        eq.append(dataclasses.replace(t, wcet=w) if w != t.wcet else t)
    return core_rta.schedulable(eq, blocking=blocking, crpd=crpd)


# ---------------------------------------------------------------------
# RTG-throttle (arXiv:1912.10959 §IV-C): within a virtual gang the
# critical member runs unthrottled while sibling members' cores are
# bandwidth-capped (VirtualGangPolicy(rtg_throttle=True)). The engines
# realize this through RT-thread charging: a sibling runs from each
# regulation-window boundary until its per-core budget Q is exhausted
# (q_j = Q / traffic_rate_j wall-ms), then pauses — generating neither
# traffic nor interference — until the window ends. The per-window WCET
# bound below prices exactly that duty-cycle regime.
# ---------------------------------------------------------------------

def _window_runtimes(vg: VirtualGang, interference: PairwiseInterference,
                     interval: float) -> Dict[str, float]:
    """Unstalled run time per regulation window for every member: the
    critical member owns the whole window; a sibling with traffic rate
    r runs min(interval, Q / r)."""
    crit = critical_member(vg, interference)
    budget = rtg_sibling_budget(vg, interference, interval)
    run = {}
    for m in vg.members:
        r = m.traffic_rate
        if m is crit or r <= 0.0 or r * interval <= budget + 1e-12:
            run[m.name] = interval
        elif budget <= 0.0:
            run[m.name] = 0.0
        else:
            run[m.name] = budget / r
    return run


def _throttle_profile(vg: VirtualGang, m: RTTask, run: Dict[str, float],
                      interference: PairwiseInterference
                      ) -> List[Tuple[float, float]]:
    """Piecewise ``(seg_len, slowdown)`` profile of member ``m`` within
    one regulation window under the static duty cycle ``run`` — the
    exact profile ``rtg_throttle_wcet`` integrates, shared with the
    vectorized evaluator (analysis/batched_rta.window_eval) so both
    paths see identical segments."""
    q_m = run[m.name]
    cuts = sorted({min(run[o.name], q_m) for o in vg.members
                   if o is not m} | {q_m})
    profile: List[Tuple[float, float]] = []
    t_prev = 0.0
    for b in cuts:
        if b <= t_prev + 1e-15:
            continue
        s = 1.0
        for o in vg.members:
            if o is not m and run[o.name] > t_prev + 1e-15:
                f = interference(m.name, o.name)
                if f > s:
                    s = f
        profile.append((b - t_prev, s))
        t_prev = b
    return profile


def rtg_throttle_wcet(vg: VirtualGang,
                      interference: PairwiseInterference = no_interference,
                      interval: float = 1.0) -> float:
    """Stand-alone completion bound of a virtual gang under RTG-throttle
    (inf = a starved sibling can never finish).

    Per window, member m is unstalled over [0, q_m); its slowdown at
    offset t is the worst pairwise factor over co-members still
    unstalled at t (a stalled co-member is absent from the engines'
    MemoryModel occupancy), so its work per window is the piecewise
    integral of 1/s(t) over [0, q_m). Co-members are conservatively
    assumed present in every window (finishing early only removes
    interference), and the finish offset inside the last window follows
    the same piecewise profile. Sound against the engines for
    window-aligned releases (period a multiple of ``interval``, zero
    offset — the evaluation grid's regime); mid-window resumes after a
    preemption are priced separately by the per-preemption window slop
    in ``schedulable_rtg_throttle``."""
    if len(vg.members) == 1:
        return vg.inflated_wcet(interference)
    run = _window_runtimes(vg, interference, interval)
    worst = 0.0
    for m in vg.members:
        q_m = run[m.name]
        if q_m <= 0.0:
            return float("inf")
        profile = _throttle_profile(vg, m, run, interference)
        work_per_window = sum(d / s for d, s in profile)
        if work_per_window <= 1e-12:
            return float("inf")
        need = gang_wcet(m)
        full = int((need - 1e-12) / work_per_window)
        rem = need - full * work_per_window
        offset = 0.0
        for d, s in profile:              # finish offset in last window
            seg_work = d / s
            if rem <= seg_work + 1e-15:
                offset += rem * s
                break
            rem -= seg_work
            offset += d
        worst = max(worst, full * interval + offset)
    return worst


def _stall_prone(vg: VirtualGang, interference: PairwiseInterference,
                 interval: float) -> bool:
    run = _window_runtimes(vg, interference, interval)
    return any(q < interval - 1e-12 for q in run.values())


# ---------------------------------------------------------------------
# Dynamic reclaiming (DESIGN.md §7.5 / §9.3.2, after arXiv:1809.05921's
# analysis of dynamic regulation): a sibling that finishes its job
# mid-window leaves its per-window grant donatable, and a stalled
# co-sibling draws it — donor by donor, each drawn unit confined to the
# donor's own static window and factor-dominated by the donor (the
# engines' exchange gate, memmodel.py). The gate keeps the *static*
# duty-cycle bound sound under reclaiming; the bound below additionally
# tracks bounded completions and guaranteed donations for a usually
# tighter verdict. ``schedulable_rtg_throttle(..., reclaim=True)``
# prices min(static, reclaim) — both are sound for the reclaiming
# dispatch, so the rtgT+dr acceptance dominates plain rtgT.
# ---------------------------------------------------------------------


def _member_cores(vg: VirtualGang) -> Dict[str, range]:
    """The remapped core block of each member (vgang/sched.remap_members
    packs members onto consecutive cores in member order) — the engines'
    donor/drawer scan order, which the greedy below replicates."""
    out, cursor = {}, 0
    for m in vg.members:
        out[m.name] = range(cursor, cursor + m.n_threads)
        cursor += m.n_threads
    return out


def _reclaim_extensions(vg: VirtualGang,
                        interference: PairwiseInterference,
                        interval: float, Q: float,
                        run: Dict[str, float],
                        donors: Sequence[RTTask],
                        drawers: Sequence[RTTask],
                        victims: Sequence[RTTask]) -> Dict[str, float]:
    """Per-window unstalled time of each drawer after greedy donation:
    drawers claim in trip-offset order (ties: core order), donor cores
    scanned in core order, each donor funding only the sub-span inside
    its occupant's static window [0, Q / r_donor). A drawer's effective
    extension is the worst over its cores (its job waits for the
    slowest thread) — the engines' draw schedule in the window-aligned
    regime.

    The two gates point in opposite conservative directions: pool
    *consumption* ignores the dominance filter entirely (the runtime
    gate only checks the victims actually present, so a competitor the
    full-member check would block may still drain the pool first),
    while a drawer is *credited* extension only while contiguously
    funded by donors that dominate it over every ``victim`` — a
    superset of any runtime victim set, so credited draws never exceed
    actual ones even under contention."""
    cores = _member_cores(vg)
    # donor pool: (core, avail, offset cap, donor task), core order
    pool = []
    for o in sorted(donors, key=lambda m: cores[m.name].start):
        r_o = o.traffic_rate
        q_o = interval if r_o <= 0.0 else min(interval, Q / r_o)
        for c in cores[o.name]:
            pool.append([c, Q, q_o, o])
    covers: Dict[Tuple[str, str], bool] = {}

    def dominated(s: RTTask, o: RTTask) -> bool:
        key = (s.name, o.name)
        hit = covers.get(key)
        if hit is None:
            hit = all(interference(v.name, s.name)
                      <= interference(v.name, o.name) + 1e-12
                      for v in victims if v.name not in (s.name, o.name))
            covers[key] = hit
        return hit

    u = {m.name: run[m.name] for m in drawers}
    order = sorted((m for m in drawers if run[m.name] < interval - 1e-12
                    and m.traffic_rate > 0.0),
                   key=lambda m: (run[m.name], cores[m.name].start))
    for s in order:
        r_s = s.traffic_rate
        worst = interval
        for _ in cores[s.name]:          # each thread-core draws alone
            covered = run[s.name]
            credit = covered
            credit_open = True
            for entry in pool:
                c, avail, q_o, o = entry
                if avail <= 0.0 or q_o <= covered + 1e-15:
                    continue
                take = min(avail, r_s * (q_o - covered))
                entry[1] -= take
                covered += take / r_s
                if credit_open and dominated(s, o):
                    credit = covered
                else:
                    credit_open = False   # gap: credit must stay
                                          # contiguous from run[s]
                if covered >= interval - 1e-15:
                    break
            worst = min(worst, credit)
        u[s.name] = worst
    return u


def _presence_profile(m: RTTask, present: Dict[str, float], u_m: float,
                      interference: PairwiseInterference
                      ) -> List[Tuple[float, float]]:
    """Piecewise ``(seg_len, slowdown)`` profile of member ``m``
    unstalled over [0, u_m) against co-members present over
    [0, present[o]) — the profile ``reclaim_wcet`` integrates, shared
    with the vectorized evaluator so both paths see identical
    segments."""
    cuts = sorted({min(p, u_m) for o, p in present.items()} | {u_m})
    profile: List[Tuple[float, float]] = []
    t_prev = 0.0
    for b in cuts:
        if b <= t_prev + 1e-15:
            continue
        s = 1.0
        for o, p in present.items():
            if p > t_prev + 1e-15:
                f = interference(m.name, o)
                if f > s:
                    s = f
        profile.append((b - t_prev, s))
        t_prev = b
    return profile


def _window_work(m: RTTask, present: Dict[str, float], u_m: float,
                 interference: PairwiseInterference
                 ) -> Tuple[float, List[Tuple[float, float]]]:
    """Work member ``m`` completes per window when unstalled over
    [0, u_m) against co-members present over [0, present[o]): piecewise
    integral of 1/s(t), plus the profile for finish-offset pricing."""
    profile = _presence_profile(m, present, u_m, interference)
    return sum(d / s for d, s in profile), profile


def reclaim_wcet(vg: VirtualGang,
                 interference: PairwiseInterference = no_interference,
                 interval: float = 1.0) -> float:
    """Stand-alone completion bound of a virtual gang under RTG-throttle
    *with dynamic reclaiming* (inf = some member can never finish).

    Window-phase iteration: members complete one at a time (in bound
    order); within a phase the per-window schedule is constant, so the
    number of windows to the next completion is closed-form. Per phase:

    * progress — an alive capped member is guaranteed its static run
      q_m plus the greedy donation extension funded by *completed*
      members' cores (actual completions happen no later than the bound,
      so actual donors appear no later than assumed; dominance is
      checked against every member — a superset of the runtime victim
      set — so credited draws never exceed actual ones);
    * interference — an alive co-member is priced as present over its
      *supremum* extension (every other member's full grant offered to
      it, no dominance filter): whatever phase the real system is in,
      its extension never exceeds that, and completed members drop out
      of the profile only once their bounded completion has passed.

    Sound against the engines in the same window-aligned regime as
    ``rtg_throttle_wcet``; preemption realignment is priced by the same
    per-hp-job window surcharge in ``schedulable_rtg_throttle``."""
    members = list(vg.members)
    if len(members) == 1:
        return vg.inflated_wcet(interference)
    crit = critical_member(vg, interference)
    Q = rtg_sibling_budget(vg, interference, interval)
    run = _window_runtimes(vg, interference, interval)
    # supremum extension per member: everyone else's grant offered to it
    u_sup: Dict[str, float] = {}
    for m in members:
        if run[m.name] >= interval - 1e-12:
            u_sup[m.name] = interval
            continue
        # realizable supremum: every sibling grant offered to it alone,
        # no dominance filter (the critical member's core is uncapped
        # and can never donate, so it is not a donor here either)
        others = [o for o in members if o is not m and o is not crit]
        u_sup[m.name] = _reclaim_extensions(
            vg, interference, interval, Q, run,
            donors=others, drawers=[m], victims=[])[m.name]
    remaining = {m.name: gang_wcet(m) for m in members}
    alive = list(members)
    completion: Dict[str, float] = {}
    t = 0.0
    while alive:
        done = [m for m in members if m.name in completion]
        drawers = [m for m in alive if m is not crit]
        u_grt = _reclaim_extensions(
            vg, interference, interval, Q, run,
            donors=[m for m in done if m is not crit],
            drawers=drawers, victims=members)
        best = None
        phase_work: Dict[str, float] = {}
        for m in alive:
            u_m = interval if (m is crit or
                               run[m.name] >= interval - 1e-12) \
                else u_grt[m.name]
            present = {o.name: u_sup[o.name] for o in alive if o is not m}
            work, profile = _window_work(m, present, u_m, interference)
            phase_work[m.name] = work
            if work <= 1e-12:
                continue
            need = remaining[m.name]
            full = int((need - 1e-12) / work)
            rem = need - full * work
            offset = 0.0
            for d, s in profile:
                seg = d / s
                if rem <= seg + 1e-15:
                    offset += rem * s
                    break
                rem -= seg
                offset += d
            row = (full + 1, offset, m)
            if best is None or (row[0], row[1]) < (best[0], best[1]):
                best = row
        if best is None:
            return float("inf")
        k, offset, m = best
        completion[m.name] = t + (k - 1) * interval + offset
        for o in alive:
            if o is not m:
                remaining[o.name] = max(
                    0.0, remaining[o.name] - k * phase_work[o.name])
        t += k * interval
        alive.remove(m)
    return max(completion.values())


def schedulable_rtg_throttle(
        vgangs: Sequence[VirtualGang],
        interference: PairwiseInterference = no_interference,
        interval: float = 1.0, blocking: float = 0.0,
        reclaim: bool = False) -> Dict[str, Dict]:
    """Per-vgang response times under RTG-throttle dispatch: the RT-Gang
    single-core transform with ``rtg_throttle_wcet`` standing in for the
    inflated WCET. Preemptions realign members to mid-window resumes
    where a stalled sibling may find its budget already spent, wasting
    up to one regulation window per resume; every release of a
    higher-priority vgang causes at most one preemption machine-wide,
    so a per-hp-job ``crpd = interval`` (plus one initial window on the
    analyzed gang) prices all realignment waste. Vgangs no member of
    which can ever stall skip that surcharge.

    ``reclaim=True`` prices the reclaiming dispatch
    (``VirtualGangPolicy(rtg_throttle=True, reclaim=True)``): the
    per-window WCET becomes ``min(rtg_throttle_wcet, reclaim_wcet)`` —
    the engines' exchange gate keeps the static bound sound under
    donation, and the reclaim bound is sound by construction, so the
    tighter of the two holds and rtgT+dr acceptance dominates rtgT."""
    prios = [vg.prio for vg in vgangs]
    if len(set(prios)) != len(prios):
        raise ValueError(
            "virtual gangs must carry distinct priorities before RTA — "
            "run formation output through formation.assign_priorities()")
    for vg in vgangs:
        # the duty-cycle bound is only sound in the window-aligned
        # regime (see rtg_throttle_wcet): refuse to price anything else
        ratio = vg.period / interval
        if abs(ratio - round(ratio)) > 1e-9:
            raise ValueError(
                f"RTG-throttle RTA needs window-aligned releases: vgang "
                f"{vg.name!r} period {vg.period} is not a multiple of "
                f"the regulation interval {interval}")
        off = [m.release_offset for m in vg.members
               if m.release_offset != 0.0]
        if off:
            raise ValueError(
                f"RTG-throttle RTA needs zero release offsets: vgang "
                f"{vg.name!r} members carry offsets {off}")
    def wcet_of(vg: VirtualGang) -> float:
        w = rtg_throttle_wcet(vg, interference, interval)
        if reclaim:
            w = min(w, reclaim_wcet(vg, interference, interval))
        return w

    eq = [RTTask(name=vg.name, wcet=wcet_of(vg),
                 period=vg.period, cores=tuple(range(max(1, vg.width))),
                 prio=vg.prio, mem_budget=vg.mem_budget)
          for vg in vgangs]
    out = {}
    for vg, task in zip(vgangs, eq):
        if task.wcet == float("inf"):
            out[vg.name] = {"wcrt": None, "deadline": vg.period,
                            "ok": False}
            continue
        crpd = interval if _stall_prone(vg, interference, interval) \
            else 0.0
        R = core_rta.response_time(task, eq, blocking=blocking, crpd=crpd)
        out[vg.name] = {"wcrt": R, "deadline": vg.period,
                        "ok": R is not None and R <= vg.period + 1e-12}
    return out


def accepts_rtg_throttle(
        vgangs: Sequence[VirtualGang],
        interference: PairwiseInterference = no_interference,
        interval: float = 1.0, blocking: float = 0.0,
        reclaim: bool = False) -> bool:
    """Single-bit RTG-throttle admission verdict for the grid
    (``reclaim=True``: the rtgT+dr column)."""
    res = schedulable_rtg_throttle(vgangs, interference,
                                   interval=interval, blocking=blocking,
                                   reclaim=reclaim)
    return all(v["ok"] for v in res.values())


# ---------------------------------------------------------------------------
# Batched entry points (analysis fast path, DESIGN.md §13)
#
# The single-core-equivalent collapse makes each formed set a dense row of
# (C_v, P_v, prio_v), so a shard of formed sets maps straight onto the
# masked batched fixed point in analysis/batched_rta.py.  Each wrapper is a
# drop-in for mapping its scalar counterpart over the shard: same
# validation errors (raised for the first offending set, in shard order),
# same result dicts, bit-identical WCRTs and accept bits.


def _collapse_rows(vgangs: Sequence[VirtualGang],
                   interference: PairwiseInterference
                   ) -> List[Tuple[str, float, float, float]]:
    """(name, C_v, P_v, prio_v) rows for one formed set, with the same
    distinct-priority validation as vgang_taskset (the RTTask
    construction itself is bypassed: gang_wcet of an equivalent task is
    its plain wcet, so the collapse value feeds the kernel directly)."""
    prios = [vg.prio for vg in vgangs]
    if len(set(prios)) != len(prios):
        raise ValueError(
            "virtual gangs must carry distinct priorities before RTA — "
            "run formation output through formation.assign_priorities()")
    return [(vg.name, vg.inflated_wcet(interference), vg.period,
             float(vg.prio)) for vg in vgangs]


def _per_set_interference(vgang_sets, interferences):
    if callable(interferences):
        return [interferences] * len(vgang_sets)
    if len(interferences) != len(vgang_sets):
        raise ValueError("need one interference model per vgang set")
    return list(interferences)


def batched_schedulable_vgangs(
        vgang_sets: Sequence[Sequence[VirtualGang]],
        interferences=no_interference,
        blocking: float = 0.0, crpd: float = 0.0,
        backend: str = "auto") -> List[Dict[str, Dict]]:
    """Shard-batched ``schedulable_vgangs``: one result dict per formed
    set, bit-identical to the scalar loop.  ``interferences`` is a single
    model shared by every set or one model per set."""
    from repro_torch.analysis import batched_rta as _bat

    intfs = _per_set_interference(vgang_sets, interferences)
    rows = [_collapse_rows(vgs, intf)
            for vgs, intf in zip(vgang_sets, intfs)]
    batch = _bat.pad_rows(rows)
    R = _bat.fixed_point(batch, blocking=blocking, crpd=crpd,
                         backend=backend)
    out: List[Dict[str, Dict]] = []
    for s, vgs in enumerate(vgang_sets):
        res = {}
        for i, vg in enumerate(vgs):
            wcrt = None if R[s, i] != R[s, i] else float(R[s, i])
            res[vg.name] = {"wcrt": wcrt, "deadline": vg.period,
                            "ok": wcrt is not None
                            and wcrt <= vg.period + 1e-12}
        out.append(res)
    return out


def batched_accepts(vgang_sets: Sequence[Sequence[VirtualGang]],
                    interferences=no_interference,
                    blocking: float = 0.0, crpd: float = 0.0,
                    backend: str = "auto") -> List[bool]:
    """Shard-batched ``accepts``: one admission bit per formed set.
    Skips the per-task result dicts entirely — the bits come straight
    off the kernel's WCRT array."""
    from repro_torch.analysis import batched_rta as _bat

    intfs = _per_set_interference(vgang_sets, interferences)
    rows = [_collapse_rows(vgs, intf)
            for vgs, intf in zip(vgang_sets, intfs)]
    batch = _bat.pad_rows(rows)
    R = _bat.fixed_point(batch, blocking=blocking, crpd=crpd,
                         backend=backend)
    return _bat.accept_bits(batch, R).tolist()


def _rtg_static_bounds(vg: VirtualGang, interference: PairwiseInterference,
                       interval: float, cache: Optional[dict]
                       ) -> Tuple[float, bool]:
    """(rtg_throttle_wcet, stall_prone) for one vgang, memoized so the
    rtgT and rtgT+dr columns of a grid cell price each vgang once.  The
    cache key retains the (vg, interference) objects, so id() reuse
    after garbage collection cannot alias entries."""
    if cache is None:
        return (rtg_throttle_wcet(vg, interference, interval),
                _stall_prone(vg, interference, interval))
    key = (id(vg), id(interference), interval)
    hit = cache.get(key)
    if hit is None:
        hit = (vg, interference,
               rtg_throttle_wcet(vg, interference, interval),
               _stall_prone(vg, interference, interval))
        cache[key] = hit
    return hit[2], hit[3]


def batched_schedulable_rtg_throttle(
        vgang_sets: Sequence[Sequence[VirtualGang]],
        interferences=no_interference,
        interval: float = 1.0, blocking: float = 0.0,
        reclaim: bool = False, backend: str = "auto",
        wcet_cache: Optional[dict] = None) -> List[Dict[str, Dict]]:
    """Shard-batched ``schedulable_rtg_throttle``.

    The per-window WCET bounds (``rtg_throttle_wcet`` /
    ``reclaim_wcet``) evaluate through the vectorized closed-form
    kernel (``analysis/batched_rta.window_eval``) across the whole
    shard, and every set's Audsley iteration runs in the batched
    fixed-point kernel with per-analyzed-lane ``crpd`` (the stall-prone
    realignment surcharge).  Infinite-WCET vgangs are excluded from
    analysis but still interfere, exactly like the scalar skip."""
    import numpy as _np

    from repro_torch.analysis import batched_rta as _bat

    intfs = _per_set_interference(vgang_sets, interferences)
    rows, crpd_rows = _rtg_rows(vgang_sets, intfs, interval, reclaim,
                                wcet_cache)
    batch = _bat.pad_rows(rows)
    S, T = batch.shape
    crpd = _np.zeros((S, T))
    for s, cr in enumerate(crpd_rows):
        crpd[s, :len(cr)] = cr
    R = _bat.fixed_point(batch, blocking=blocking, crpd=crpd,
                         backend=backend)
    out: List[Dict[str, Dict]] = []
    for s, vgs in enumerate(vgang_sets):
        res = {}
        for i, vg in enumerate(vgs):
            wcrt = None if R[s, i] != R[s, i] else float(R[s, i])
            res[vg.name] = {"wcrt": wcrt, "deadline": vg.period,
                            "ok": wcrt is not None
                            and wcrt <= vg.period + 1e-12}
        out.append(res)
    return out


def _rtg_rows(vgang_sets, intfs, interval, reclaim, wcet_cache):
    """Validated ``(name, C, P, prio)`` rows plus per-set crpd lists for
    the rtgT / rtgT+dr columns, in shard order — same checks and error
    messages as scalar ``schedulable_rtg_throttle``.

    The per-window WCET bounds are priced through the vectorized
    closed-form evaluator (analysis/batched_rta) across the whole
    shard: static bounds for every cache-miss vgang in one batch, and
    (reclaim=True) every vgang's phase iteration in lockstep — both
    bit-identical to their scalar twins."""
    from repro_torch.analysis.batched_rta import (batched_reclaim_wcet,
                                                  batched_rtg_throttle_wcet)
    for vgs, intf in zip(vgang_sets, intfs):
        prios = [vg.prio for vg in vgs]
        if len(set(prios)) != len(prios):
            raise ValueError(
                "virtual gangs must carry distinct priorities before RTA "
                "— run formation output through "
                "formation.assign_priorities()")
        for vg in vgs:
            ratio = vg.period / interval
            if abs(ratio - round(ratio)) > 1e-9:
                raise ValueError(
                    f"RTG-throttle RTA needs window-aligned releases: "
                    f"vgang {vg.name!r} period {vg.period} is not a "
                    f"multiple of the regulation interval {interval}")
            off = [m.release_offset for m in vg.members
                   if m.release_offset != 0.0]
            if off:
                raise ValueError(
                    f"RTG-throttle RTA needs zero release offsets: vgang "
                    f"{vg.name!r} members carry offsets {off}")
    flat = [(vg, intf) for vgs, intf in zip(vgang_sets, intfs)
            for vg in vgs]
    # static bound + stall flag per vgang, batched over cache misses
    statics: Dict[int, Tuple[float, bool]] = {}
    miss_pairs, miss_pos = [], []
    for pos, (vg, intf) in enumerate(flat):
        if wcet_cache is not None:
            hit = wcet_cache.get((id(vg), id(intf), interval))
            if hit is not None:
                statics[pos] = (hit[2], hit[3])
                continue
        miss_pairs.append((vg, intf))
        miss_pos.append(pos)
    if miss_pairs:
        ws = batched_rtg_throttle_wcet([p[0] for p in miss_pairs],
                                       [p[1] for p in miss_pairs],
                                       interval)
        for (vg, intf), w, pos in zip(miss_pairs, ws, miss_pos):
            stall = _stall_prone(vg, intf, interval)
            statics[pos] = (w, stall)
            if wcet_cache is not None:
                # key retains the objects, see _rtg_static_bounds
                wcet_cache[(id(vg), id(intf), interval)] = \
                    (vg, intf, w, stall)
    reclaims = None
    if reclaim:
        reclaims = batched_reclaim_wcet([vg for vg, _ in flat],
                                        [i for _, i in flat], interval)
    rows, crpd_rows = [], []
    pos = 0
    for vgs, intf in zip(vgang_sets, intfs):
        row, crpd_row = [], []
        for vg in vgs:
            w, stall = statics[pos]
            if reclaim:
                w = min(w, reclaims[pos])
            row.append((vg.name, w, vg.period, float(vg.prio)))
            crpd_row.append(interval if stall else 0.0)
            pos += 1
        rows.append(row)
        crpd_rows.append(crpd_row)
    return rows, crpd_rows


def batched_accepts_rtg_throttle(
        vgang_sets: Sequence[Sequence[VirtualGang]],
        interferences=no_interference,
        interval: float = 1.0, blocking: float = 0.0,
        reclaim: bool = False, backend: str = "auto",
        wcet_cache: Optional[dict] = None) -> List[bool]:
    """Shard-batched ``accepts_rtg_throttle`` (``reclaim=True``: the
    rtgT+dr column), bits straight off the kernel's WCRT array."""
    import numpy as _np

    from repro_torch.analysis import batched_rta as _bat

    intfs = _per_set_interference(vgang_sets, interferences)
    rows, crpd_rows = _rtg_rows(vgang_sets, intfs, interval, reclaim,
                                wcet_cache)
    batch = _bat.pad_rows(rows)
    S, T = batch.shape
    crpd = _np.zeros((S, T))
    for s, cr in enumerate(crpd_rows):
        crpd[s, :len(cr)] = cr
    R = _bat.fixed_point(batch, blocking=blocking, crpd=crpd,
                         backend=backend)
    return _bat.accept_bits(batch, R).tolist()


# ---------------------------------------------------------------------------
# Strict partitioning (arXiv:2403.10726): within a partition, gangs never
# co-run — a gang occupies its whole partition while executing — so the
# partition IS a uniprocessor whose tasks are the gangs with their plain
# (uninflated) WCETs, and core/rta.py applies verbatim. Partitions run
# concurrently, so a gang's WCET is inflated by the worst pairwise factor
# over the gangs of *other* partitions (the MemoryModel's occupancy max
# never exceeds that bound: present co-runners are always a subset of the
# other partitions' gangs). A single-partition machine has no co-runners
# at all, so the analysis collapses to core.rta.schedulable bit-for-bit
# (the inflation factor is exactly 1.0 and C * 1.0 == C in IEEE floats).


def _partition_rows(partitioning: Partitioning,
                    interference: PairwiseInterference
                    ) -> List[List[Tuple[str, float, float, float]]]:
    """One ``(name, C', P, prio)`` row per partition: C' is the gang's
    WCET inflated by the worst pairwise factor over all gangs of other
    partitions (placement-aware via ``pair_factor`` when the model is
    distance-aware — partitions are consecutive core blocks)."""
    parts = partitioning.partitions
    rows = []
    for p in parts:
        row = []
        for g in p.gangs:
            f = 1.0
            for q in parts:
                if q is p:
                    continue
                for o in q.gangs:
                    f = max(f, pair_factor(interference, g.name, o.name,
                                           p.cores, q.cores))
            row.append((g.name, gang_wcet(g) * f, g.period,
                        float(g.prio)))
        rows.append(row)
    return rows


def schedulable_partitions(
        partitioning: Partitioning,
        interference: PairwiseInterference = no_interference,
        blocking: float = 0.0) -> Dict[str, Dict]:
    """Per-gang response times under strict partitioning, keyed by gang
    name — same row shape as core.rta.schedulable plus the hosting
    partition. Each partition runs the classic uniprocessor Audsley
    fixed point (core/rta.py) over its own gangs only."""
    out: Dict[str, Dict] = {}
    for p, row in zip(partitioning.partitions,
                      _partition_rows(partitioning, interference)):
        eq = [RTTask(name=n, wcet=c, period=per, cores=(0,), prio=int(pr))
              for n, c, per, pr in row]
        res = core_rta.schedulable(eq, blocking=blocking)
        for n, v in res.items():
            v["partition"] = p.name
            out[n] = v
    return out


def accepts_partitioned(
        partitioning: Partitioning,
        interference: PairwiseInterference = no_interference,
        blocking: float = 0.0) -> bool:
    """Single-bit admission verdict for the grid's ``part`` column."""
    res = schedulable_partitions(partitioning, interference,
                                 blocking=blocking)
    return all(v["ok"] for v in res.values())


def batched_accepts_partitioned(
        partitionings: Sequence[Partitioning],
        interferences=no_interference,
        blocking: float = 0.0, backend: str = "auto") -> List[bool]:
    """Shard-batched ``accepts_partitioned``: every partition of every
    taskset becomes one lane-row of the masked batched fixed point
    (analysis/batched_rta.py, bit-identical to core/rta.py), and a
    taskset's bit is the AND over its partitions' rows."""
    from repro_torch.analysis import batched_rta as _bat

    intfs = _per_set_interference(partitionings, interferences)
    flat_rows: List[List[Tuple[str, float, float, float]]] = []
    owners: List[int] = []
    for s, (pg, intf) in enumerate(zip(partitionings, intfs)):
        for row in _partition_rows(pg, intf):
            flat_rows.append(row)
            owners.append(s)
    out = [True] * len(partitionings)
    if not flat_rows:
        return out
    batch = _bat.pad_rows(flat_rows)
    R = _bat.fixed_point(batch, blocking=blocking, backend=backend)
    bits = _bat.accept_bits(batch, R).tolist()
    for s, b in zip(owners, bits):
        out[s] = out[s] and bool(b)
    return out
