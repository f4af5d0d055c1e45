"""Virtual gangs on the port: the vgang subsystem's copies against the
JAX package, ``GangExecutor.submit_vgang``, and the drivers that bind
device work to it.

* The 19 scenarios of tests/test_executor_vgang.py, run against
  ``repro_torch.core.executor`` and ``repro_torch.vgang``: the budget
  hand-off ordering, drain windows, ``submit_vgang`` /
  ``build_executor`` lane remapping and live-member budgets,
  RTG-throttle admission and reclaiming.
* Parity of the copies (``core/{rta,sim,events,faults,memmodel}.py``,
  ``obs/margins.py``, ``vgang/*``, ``experiment/*``) with the JAX package
  on seeded task sets: formation and priorities, every RTA entry point,
  every policy family's bounds, and the event engine's parity counters.
* The executor vgang bench and the fleet example on the CPU, and both
  raising without a card when no device is given.
"""
import dataclasses
import json
import os
import random
import time

import pytest

import repro.core.faults as jfaults
import repro.core.gang as jgang
import repro.core.sim as jsim
import repro.obs.metrics as jmetrics
import repro.experiment as jexp
import repro.vgang.family as jfam
import repro.vgang.formation as jform
import repro.vgang.rta as jrta
import repro.vgang.sched as jsched
from repro.launch.sweep import taskset_seed
from repro.vgang.grid import n_tasks_for, random_vgang_taskset

import repro_torch.core.faults as tfaults
import repro_torch.core.gang as tgang
import repro_torch.core.sim as tsim
import repro_torch.obs.metrics as tmetrics
import repro_torch.experiment as texp
import repro_torch.vgang.family as tfam
import repro_torch.vgang.formation as tform
import repro_torch.vgang.rta as trta
import repro_torch.vgang.sched as tsched
from repro_torch.benchmarks import bench_executor_vgang as bench
from repro_torch.core.executor import GangExecutor, RTJob
from repro_torch.core.gang import RTTask
from repro_torch.examples import vgang_fleet
from repro_torch.vgang.formation import (VirtualGang, assign_priorities,
                                         intensity_interference)
from repro_torch.vgang.sched import VirtualGangPolicy, remap_members


def _sleep_fn(dur):
    def fn(lane, idx):
        time.sleep(dur)
    return fn


# ---------------------------------------------------------------------
# the pre-barrier budget-clobber regression
# ---------------------------------------------------------------------

def test_stale_lane_cannot_clobber_running_gang_budget():
    """Pins the old racy interleaving: lane 0 picks gang A (acquiring
    the glock) but is descheduled before it can touch the regulator;
    lane 1's higher-priority gang B preempts A and starts. The old code
    had lane 0 resume with ``reg.set_gang_budget(A.budget)`` — clobbering
    running gang B's best-effort budget fleet-wide. Fixed code applies
    budgets inside the gang-change hook under g.lock, so (a) B's budget
    is already enforced the instant B acquires, and (b) the stale lane-0
    worker has no budget write at all between pick and the barrier.

    On the old code the first assertion fails (the hook applied no
    budgets; lanes still carry the boot-time inf budget)."""
    ex = GangExecutor(n_lanes=3, regulation_interval_s=0.01)
    a = RTJob("A", _sleep_fn(0.001), lanes=(0,), prio=1,
              budget_bytes=100.0, n_jobs=1)
    b = RTJob("B", _sleep_fn(0.001), lanes=(1,), prio=9,
              budget_bytes=0.0, n_jobs=1)
    ex.submit_rt(a)
    ex.submit_rt(b)
    ex._release_jobs()

    th_a = ex._threads[(a.uid, 0)]
    th_b = ex._threads[(b.uid, 1)]

    picked_a = ex.sched.pick_next_task_rt(0, None, th_a)
    assert picked_a is th_a
    # A leads: its budget is enforced on the non-member lanes at the
    # acquire instant, from inside the glock — not later by the worker
    assert ex.reg.cores[2].budget == pytest.approx(100.0)
    assert ex.reg.cores[1].budget == pytest.approx(100.0)
    assert ex.reg.cores[0].budget == float("inf")   # gang lane exempt

    # lane 0 is now "descheduled between pick and barrier"; gang B
    # preempts A from lane 1
    picked_b = ex.sched.pick_next_task_rt(1, None, th_b)
    assert picked_b is th_b
    assert ex.sched.g.leader is ex._tasks[b.uid]
    assert ex.reg.cores[2].budget == pytest.approx(0.0)
    assert ex.reg.cores[0].budget == pytest.approx(0.0)

    # the stale lane-0 worker resumes: everything it still does before
    # the barrier (instance lookup) leaves the regulator untouched
    inst = ex._active_instance(a, 0)
    assert inst is not None
    assert ex.reg.cores[2].budget == pytest.approx(0.0), \
        "stale lane clobbered the running gang's budget"
    assert ex.sched.check_invariant()


def test_budget_persists_across_release_until_next_acquire():
    """Full release extends the departing gang's tightest budget to
    every lane — including its own former (exempt-while-occupied)
    lanes, so best-effort work there stays behind the last declared lid
    (paper §IV-F); the next gang's acquire overwrites it."""
    ex = GangExecutor(n_lanes=2, regulation_interval_s=0.01)
    a = RTJob("A", _sleep_fn(0.001), lanes=(0,), prio=5,
              budget_bytes=7.0, n_jobs=1)
    ex.submit_rt(a)
    ex._release_jobs()
    th_a = ex._threads[(a.uid, 0)]
    picked = ex.sched.pick_next_task_rt(0, None, th_a)
    assert ex.reg.cores[1].budget == pytest.approx(7.0)
    assert ex.reg.cores[0].budget == float("inf")   # occupied: exempt
    ex.sched.pick_next_task_rt(0, picked, None)     # full release
    assert not ex.sched.g.held_flag
    assert ex.reg.cores[1].budget == pytest.approx(7.0)
    assert ex.reg.cores[0].budget == pytest.approx(7.0)


# ---------------------------------------------------------------------
# drain-window budgets: element-wise min over the
# (outgoing, incoming) regimes until the outgoing gang's last in-flight
# quantum retires
# ---------------------------------------------------------------------

def test_drain_window_applies_min_over_outgoing_and_incoming():
    """Pins the budget-ordering trace across a preemption with a
    draining quantum: tight gang A (budget 5) has a quantum in flight on
    lane 0 when loose gang B (budget 1e9) preempts from lane 1. The old
    code applied B's budget fleet-wide at the acquire — best-effort
    work admitted at 1e9 bytes while A still executed pierced A's
    isolation. Fixed code enforces min(outgoing, incoming) = 5 on every
    lane until A's quantum retires, then re-derives B's pure regime."""
    ex = GangExecutor(n_lanes=3, regulation_interval_s=0.01)
    a = RTJob("A", _sleep_fn(0.001), lanes=(0,), prio=1,
              budget_bytes=5.0, n_jobs=1)
    b = RTJob("B", _sleep_fn(0.001), lanes=(1,), prio=9,
              budget_bytes=1e9, n_jobs=1)
    ex.submit_rt(a)
    ex.submit_rt(b)
    ex._release_jobs()
    picked_a = ex.sched.pick_next_task_rt(0, None, ex._threads[(a.uid, 0)])
    assert picked_a is not None
    with ex._lock:
        ex._inflight[0] = a.prio          # A's quantum starts draining
    assert ex.reg.cores[2].budget == pytest.approx(5.0)

    ex.sched.pick_next_task_rt(1, None, ex._threads[(b.uid, 1)])  # preempt
    assert ex.sched.g.leader is ex._tasks[b.uid]
    # drain active: the incoming regime is floored by the outgoing one
    # on the best-effort lane (lane 0 is still executing A's quantum;
    # its enforced value only matters once the drain ends)
    assert ex._draining == frozenset({a.prio})
    assert ex.reg.cores[2].budget == pytest.approx(5.0)

    # A's quantum retires -> drain completes -> B's regime applies alone
    assert ex._quantum_retired(0) is True
    ex._end_drain()
    assert ex._draining == frozenset()
    assert ex.reg.cores[2].budget == pytest.approx(1e9)
    assert ex.reg.cores[0].budget == pytest.approx(1e9)
    assert ex.reg.cores[1].budget == float("inf")   # B's own lane exempt


def test_drain_window_keeps_tighter_incoming_regime():
    """The min is element-wise: an incoming regime tighter than the
    outgoing one is enforced during the drain and stays afterwards."""
    ex = GangExecutor(n_lanes=3, regulation_interval_s=0.01)
    a = RTJob("A", _sleep_fn(0.001), lanes=(0,), prio=1,
              budget_bytes=100.0, n_jobs=1)
    b = RTJob("B", _sleep_fn(0.001), lanes=(1,), prio=9,
              budget_bytes=2.0, n_jobs=1)
    ex.submit_rt(a)
    ex.submit_rt(b)
    ex._release_jobs()
    ex.sched.pick_next_task_rt(0, None, ex._threads[(a.uid, 0)])
    with ex._lock:
        ex._inflight[0] = a.prio
    ex.sched.pick_next_task_rt(1, None, ex._threads[(b.uid, 1)])
    assert ex.reg.cores[2].budget == pytest.approx(2.0)
    assert ex._quantum_retired(0) is True
    ex._end_drain()
    assert ex.reg.cores[2].budget == pytest.approx(2.0)


# ---------------------------------------------------------------------
# submit_vgang / build_executor: lane remapping + live-member budgets
# ---------------------------------------------------------------------

def _two_member_vgang(b1=5.0, b2=2.0, w2=2):
    m1 = RTTask("m1", wcet=8.0, period=40.0, cores=(3,), prio=0,
                mem_budget=b1)
    m2 = RTTask("m2", wcet=6.0, period=40.0, cores=(5, 6)[:w2], prio=0,
                mem_budget=b2)
    return VirtualGang("m1+m2", members=[m1, m2], prio=4)


def test_submit_vgang_remaps_onto_disjoint_lane_blocks():
    vg = _two_member_vgang(w2=2)
    ex = GangExecutor(n_lanes=4)
    jobs = ex.submit_vgang(vg, {"m1": _sleep_fn(0), "m2": _sleep_fn(0)},
                           n_jobs=1)
    assert [j.lanes for j in jobs] == [(0,), (1, 2)]
    assert all(j.prio == 4 for j in jobs)
    assert all(j.period_s == pytest.approx(0.040) for j in jobs)
    # uids preserved from the member tasks (policy budget tables match)
    assert [j.uid for j in jobs] == [m.uid for m in vg.members]
    remapped = remap_members(vg)
    assert [m.cores for m in remapped] == [(0,), (1, 2)]
    assert [m.uid for m in remapped] == [m.uid for m in vg.members]


def test_vgang_live_member_budgets_through_executor_hook():
    """min-over-live-members on the free lanes, member lanes uncapped;
    a member leaving mid-gang raises the floor immediately (the glock's
    new join/leave events drive VirtualGangPolicy.apply)."""
    vg = _two_member_vgang(b1=5.0, b2=2.0, w2=1)
    policy = VirtualGangPolicy([vg], n_cores=4, auto_prio=False)
    ex = policy.build_executor({"m1": _sleep_fn(0), "m2": _sleep_fn(0)},
                               n_jobs=1)
    ex._release_jobs()
    m1, m2 = vg.members
    th1 = ex._threads[(m1.uid, 0)]
    th2 = ex._threads[(m2.uid, 1)]

    p1 = ex.sched.pick_next_task_rt(0, None, th1)    # m1 acquires
    assert ex.reg.cores[2].budget == pytest.approx(5.0)
    assert ex.reg.cores[0].budget == float("inf")

    p2 = ex.sched.pick_next_task_rt(1, None, th2)    # m2 joins
    assert p1 is th1 and p2 is th2
    assert ex.sched.check_invariant()
    assert ex.reg.cores[2].budget == pytest.approx(2.0)   # min over live
    assert ex.reg.cores[3].budget == pytest.approx(2.0)
    assert ex.reg.cores[0].budget == float("inf")
    assert ex.reg.cores[1].budget == float("inf")

    # the sensitive member m2 finishes -> "leave" -> floor rises to m1's
    ex.sched.pick_next_task_rt(1, p2, None)
    assert ex.sched.g.held_flag                       # m1 still holds
    assert ex.reg.cores[2].budget == pytest.approx(5.0)


def test_rtg_throttle_caps_sibling_lanes_not_critical():
    """RTG-throttle through the executor hook: the critical member's
    lanes stay uncapped; sibling lanes (and the best-effort fillers) are
    capped at the critical member's declared tolerable traffic."""
    # m1 has the larger WCET -> critical; cap = its mem_budget
    vg = _two_member_vgang(b1=3.0, b2=50.0, w2=1)
    policy = VirtualGangPolicy([vg], n_cores=4, auto_prio=False,
                               rtg_throttle=True)
    ex = policy.build_executor({"m1": _sleep_fn(0), "m2": _sleep_fn(0)},
                               n_jobs=1)
    ex._release_jobs()
    m1, m2 = vg.members
    ex.sched.pick_next_task_rt(0, None, ex._threads[(m1.uid, 0)])
    ex.sched.pick_next_task_rt(1, None, ex._threads[(m2.uid, 1)])
    assert ex.reg.cores[0].budget == float("inf")     # critical lane
    assert ex.reg.cores[1].budget == pytest.approx(3.0)   # sibling lane
    assert ex.reg.cores[2].budget == pytest.approx(3.0)   # BE filler
    assert ex.reg.cores[3].budget == pytest.approx(3.0)


def test_executor_vgang_end_to_end_sync_release():
    """Members of one virtual gang co-run (same prio passes the
    gang-isolation barrier together) and both record response times."""
    vg = _two_member_vgang(w2=1)
    policy = VirtualGangPolicy([vg], n_cores=2, auto_prio=False)
    seen = []
    ex = policy.build_executor(
        {"m1": lambda lane, idx: (seen.append(("m1", lane)),
                                  time.sleep(0.002)),
         "m2": lambda lane, idx: (seen.append(("m2", lane)),
                                  time.sleep(0.002))},
        n_jobs=5)
    stats = ex.run(0.5)
    assert len(stats["response_times"]["m1"]) == 5
    assert len(stats["response_times"]["m2"]) == 5
    assert {lane for name, lane in seen if name == "m1"} == {0}
    assert {lane for name, lane in seen if name == "m2"} == {1}
    assert ex.sched.check_invariant()


def test_rt_admission_stall_on_sibling_cap():
    """A sibling whose quanta exceed the per-window cap stalls to the
    next regulation window (executor analogue of the engines' RT-thread
    charging); the critical member is never gated."""
    m1 = RTTask("crit", wcet=8.0, period=10.0, cores=(0,), prio=0,
                mem_budget=4.0)
    m2 = RTTask("sib", wcet=1.0, period=10.0, cores=(1,), prio=0,
                mem_budget=100.0)
    vg = VirtualGang("crit+sib", members=[m1, m2], prio=3)
    policy = VirtualGangPolicy([vg], n_cores=2, auto_prio=False,
                               rtg_throttle=True)
    # period 10 ms * 1e-3 = 0.01 s; window = 0.05 s -> 5 sibling quanta
    # land per window, cap 4.0 admits only one 3.0-byte quantum
    ex = policy.build_executor(
        {"crit": _sleep_fn(0.001), "sib": _sleep_fn(0.001)},
        n_jobs=20, bytes_per_quantum={"sib": 3.0},
        regulation_interval_s=0.05)
    stats = ex.run(0.8)
    assert stats["rt_stalls"].get("sib", 0) > 0
    assert stats["rt_stalls"].get("crit", 0) == 0
    assert ex.reg.cores[1].throttle_events > 0
    assert ex.reg.cores[0].throttle_events == 0
    assert len(stats["response_times"]["sib"]) == 20
    assert ex.sched.check_invariant()
    # stalled quanta show up as throttled:<name> trace segments
    assert any(s.label == "throttled:sib" for s in ex.trace.segments)


def test_admission_requeues_when_another_gang_leads():
    """A quantum whose gang lost the lock while it waited for admission
    must requeue, never charge: the preemptor's regime could admit it
    (its acquire may have lifted the stall), but the bytes would come
    out of the preemptor's regulation window."""
    ex = GangExecutor(n_lanes=2, regulation_interval_s=0.01)
    a = RTJob("A", _sleep_fn(0), lanes=(0,), prio=2, budget_bytes=0.0,
              bytes_per_quantum=1.0, n_jobs=1)
    b = RTJob("B", _sleep_fn(0), lanes=(1,), prio=9, budget_bytes=1e9,
              n_jobs=1)
    ex.submit_rt(a)
    ex.submit_rt(b)
    ex._release_jobs()
    ex.sched.pick_next_task_rt(0, None, ex._threads[(a.uid, 0)])
    ex.sched.pick_next_task_rt(1, None, ex._threads[(b.uid, 1)])  # preempt
    used_before = ex.reg.cores[0].total_used
    assert ex._admit_rt_quantum(0, a)[0] == "requeue"
    assert ex.reg.cores[0].total_used == used_before   # nothing charged


def test_admission_gating_bypassed_when_scheduler_disabled():
    """Passthrough mode (enabled=False) never sets held_flag, so gated
    quanta must run ungated instead of requeue-spinning forever."""
    ex = GangExecutor(n_lanes=1, enabled=False)
    a = RTJob("A", _sleep_fn(0), lanes=(0,), prio=2,
              bytes_per_quantum=1.0, period_s=0.005, n_jobs=5)
    ex.submit_rt(a)
    stats = ex.run(0.3)
    assert len(stats["response_times"]["A"]) == 5
    assert stats["rt_stalls"] == {}


def test_budget_memo_tracks_member_identity_not_just_mask():
    """A different same-prio task replacing a member on the same lane
    keeps leader and core mask identical while the floor moves with the
    member set — the apply memo must not swallow that re-derivation."""
    vg = _two_member_vgang(b1=5.0, b2=2.0, w2=1)
    policy = VirtualGangPolicy([vg], n_cores=3, auto_prio=False)
    ex = GangExecutor(n_lanes=3, budget_policy=policy)
    m1, m2 = vg.members
    # both members submitted on the *same* lane: m2 replaces m1 at a
    # quantum boundary without the core mask ever changing
    for m, fn in ((m1, _sleep_fn(0)), (m2, _sleep_fn(0))):
        ex.submit_rt(RTJob(m.name, fn, lanes=(0,), prio=vg.prio,
                           budget_bytes=m.mem_budget, n_jobs=1,
                           uid=m.uid))
    ex._release_jobs()
    th1 = ex._threads[(m1.uid, 0)]
    th2 = ex._threads[(m2.uid, 0)]
    picked = ex.sched.pick_next_task_rt(0, None, th1)
    assert ex.reg.cores[2].budget == pytest.approx(5.0)   # m1's floor
    assert ex.sched.pick_next_task_rt(0, picked, th2) is th2
    assert ex.reg.cores[2].budget == pytest.approx(2.0)   # m2's floor


def test_rtg_sibling_cap_cache_is_per_interval():
    """One policy object drives both engines and the executor; the
    headroom fallback cap scales with the regulation interval, so the
    cache must not leak a sim-unit cap into the executor's regulator."""
    m1 = RTTask("c0", wcet=8.0, period=40.0, cores=(0,), prio=0,
                mem_budget=0.0, mem_intensity=0.6)   # headroom fallback
    m2 = RTTask("s0", wcet=2.0, period=40.0, cores=(1,), prio=0,
                mem_budget=9.0)
    vg = VirtualGang("c0+s0", members=[m1, m2], prio=5)
    policy = VirtualGangPolicy([vg], n_cores=3, auto_prio=False,
                               rtg_throttle=True)

    def caps_with(interval):
        ex = policy.build_executor({"c0": _sleep_fn(0), "s0": _sleep_fn(0)},
                                   n_jobs=1,
                                   regulation_interval_s=interval)
        ex._release_jobs()
        ex.sched.pick_next_task_rt(0, None, ex._threads[(m1.uid, 0)])
        ex.sched.pick_next_task_rt(1, None, ex._threads[(m2.uid, 1)])
        return ex.reg.cores[1].budget

    assert caps_with(1.0) == pytest.approx(0.4)      # (1-0.6)*1.0
    assert caps_with(0.010) == pytest.approx(0.004)  # (1-0.6)*0.010


def test_submit_vgang_rejects_duplicate_uids_and_oversized_gangs():
    vg = _two_member_vgang()
    ex = GangExecutor(n_lanes=4)
    fns = {"m1": _sleep_fn(0), "m2": _sleep_fn(0)}
    ex.submit_vgang(vg, fns)
    n_before = len(ex.rt_jobs)
    with pytest.raises(ValueError):
        ex.submit_vgang(vg, fns)          # same member uids again
    assert len(ex.rt_jobs) == n_before    # atomic: no partial submit
    wide = GangExecutor(n_lanes=2)
    with pytest.raises(ValueError):
        wide.submit_vgang(_two_member_vgang(w2=2), fns)
    # rejection must not leave a half gang behind (m1 fits, m2 doesn't)
    assert wide.rt_jobs == []
    # a missing member callable is caught up front, not mid-submit
    nofn = GangExecutor(n_lanes=4)
    with pytest.raises(ValueError):
        nofn.submit_vgang(_two_member_vgang(), {"m1": _sleep_fn(0)})
    assert nofn.rt_jobs == []


# ---------------------------------------------------------------------
# admission-mode reclaiming (DESIGN.md §7.5): retired member lanes
# donate, and a preemption revokes unspent grants
# ---------------------------------------------------------------------

def _reclaim_vgang():
    """crit c0 (intensity 0.9: most intense, so both siblings are
    dominated by the donor d0), donor d0, drawer s0."""
    c0 = RTTask("c0", wcet=9.0, period=50.0, cores=(0,), prio=0,
                mem_budget=4.0, mem_intensity=0.9)
    d0 = RTTask("d0", wcet=1.0, period=50.0, cores=(1,), prio=0,
                mem_budget=50.0, mem_intensity=0.5)
    s0 = RTTask("s0", wcet=2.0, period=50.0, cores=(2,), prio=0,
                mem_budget=50.0, mem_intensity=0.3)
    intf = intensity_interference([c0, d0, s0])
    return VirtualGang("c+d+s", members=[c0, d0, s0], prio=3), intf


def test_reclaim_draws_from_retired_member_lanes():
    """A gated sibling quantum that would be denied draws the unspent
    window quota of a member whose work this release already retired,
    instead of stalling."""
    vg, intf = _reclaim_vgang()
    policy = VirtualGangPolicy([vg], n_cores=4, interference=intf,
                               auto_prio=False, rtg_throttle=True,
                               reclaim=True)
    fns = {n: _sleep_fn(0) for n in ("c0", "d0", "s0")}
    ex = policy.build_executor(fns, n_jobs=1,
                               bytes_per_quantum={"s0": 3.0},
                               regulation_interval_s=0.05)
    ex._release_jobs()
    c0, d0, s0 = vg.members
    for m, lane in ((c0, 0), (d0, 1), (s0, 2)):
        ex.sched.pick_next_task_rt(lane, None, ex._threads[(m.uid, lane)])
    cap = ex.reg.cores[2].budget            # sibling cap = crit budget
    assert cap == pytest.approx(4.0)
    # d0's only job retires on its lane -> lane 1 becomes a donor
    d_job = ex._jobs[d0.uid]
    inst = ex._active_instance(d_job, 1)
    inst.remaining_lanes.discard(1)
    # s0's window is nearly spent: the next quantum would be denied
    now = 0.01
    assert ex.reg.charge(2, 3.0, now)
    got = ex._reclaim_rt_draw(2, ex._jobs[s0.uid], 2.0, now)
    assert got == pytest.approx(2.0)
    assert ex.reg.cores[1].donated == pytest.approx(2.0)
    assert ex.reg.charge(2, 3.0, now + 0.001)   # admitted on the grant
    # the drawer is dominated by the donor for the crit (0.3 <= 0.5);
    # a hungrier-than-the-donor drawer would be refused
    assert ex._reclaim_rt_draw(2, ex._jobs[c0.uid], 1.0, now) == 0.0


def test_reclaim_lifts_already_stalled_lane():
    """A lane tripped earlier in the window (e.g. by a filler charge) is
    lifted the moment a covering donation exists — the admission
    analogue of the engines' claim_lift — instead of waiting out the
    window; and a pool too small to admit the quantum strands nothing."""
    vg, intf = _reclaim_vgang()
    policy = VirtualGangPolicy([vg], n_cores=4, interference=intf,
                               auto_prio=False, rtg_throttle=True,
                               reclaim=True)
    fns = {n: _sleep_fn(0) for n in ("c0", "d0", "s0")}
    ex = policy.build_executor(fns, n_jobs=1,
                               bytes_per_quantum={"s0": 3.0},
                               regulation_interval_s=10.0)
    ex._t0 = time.monotonic()      # _admit_rt_quantum reads ex._now()
    ex._release_jobs()
    c0, d0, s0 = vg.members
    for m, lane in ((c0, 0), (d0, 1), (s0, 2)):
        ex.sched.pick_next_task_rt(lane, None, ex._threads[(m.uid, lane)])
    # trip lane 2: an admission denial stalls it to the window end
    assert ex.reg.charge(2, 3.0, ex._now())
    assert ex.reg.charge(2, 3.0, ex._now()) is False
    assert ex.reg.is_stalled(2, ex._now())
    # no donor yet: the quantum stays stalled and no quota is stranded
    assert ex._reclaim_rt_draw(2, ex._jobs[s0.uid], 2.0, ex._now()) == 0.0
    # d0 retires -> its lane's unspent cap covers the shortfall
    inst = ex._active_instance(ex._jobs[d0.uid], 1)
    inst.remaining_lanes.discard(1)
    verdict, stalled = ex._admit_rt_quantum(2, ex._jobs[s0.uid])
    assert verdict == "run"
    assert not ex.reg.is_stalled(2, ex._now())
    assert ex.reg.cores[1].donated > 0.0


def test_reclaim_grant_revoked_when_preemption_races_donation():
    """A donor's quota lift racing a preemption must not leak into the
    preemptor's regime: the acquire lowers the drawer lane's budget,
    which revokes the unspent reclaimed grant and stalls the lane that
    already consumed more than the new limit allows."""
    vg, intf = _reclaim_vgang()
    policy = VirtualGangPolicy([vg], n_cores=4, interference=intf,
                               auto_prio=False, rtg_throttle=True,
                               reclaim=True)
    fns = {n: _sleep_fn(0) for n in ("c0", "d0", "s0")}
    ex = policy.build_executor(fns, n_jobs=1,
                               bytes_per_quantum={"s0": 3.0},
                               regulation_interval_s=0.05)
    p = RTJob("P", _sleep_fn(0.001), lanes=(3,), prio=9,
              budget_bytes=1.0, n_jobs=1)
    ex.submit_rt(p)
    ex._release_jobs()
    c0, d0, s0 = vg.members
    for m, lane in ((c0, 0), (d0, 1), (s0, 2)):
        ex.sched.pick_next_task_rt(lane, None, ex._threads[(m.uid, lane)])
    inst = ex._active_instance(ex._jobs[d0.uid], 1)
    inst.remaining_lanes.discard(1)
    now = 0.01
    assert ex.reg.charge(2, 3.0, now)
    assert ex._reclaim_rt_draw(2, ex._jobs[s0.uid], 2.0, now) > 0.0
    assert ex.reg.cores[2].drawn == pytest.approx(2.0)

    # preemption lands while the grant is still unspent
    ex.sched.pick_next_task_rt(3, None, ex._threads[(p.uid, 3)])
    assert ex.sched.g.leader is ex._tasks[p.uid]
    st = ex.reg.cores[2]
    assert st.drawn == 0.0                   # grant revoked
    assert st.budget == pytest.approx(1.0)   # preemptor's floor
    # lane 2 already consumed 3.0 > 1.0: it may not run again this
    # window under the stricter regime
    assert ex.reg.is_stalled(2, now + 0.001)
    # requeue path: the waiting sibling quantum re-enters the scheduler
    assert ex._admit_rt_quantum(2, ex._jobs[s0.uid])[0] == "requeue"


def test_formed_multi_vgang_executor_one_gang_at_a_time():
    """Two formed vgangs at distinct priorities never co-run; budgets
    observed on the free lane during each gang's quantum are that
    gang's floor (no cross-gang clobber under load)."""
    a1 = RTTask("a1", wcet=2.0, period=30.0, cores=(0,), prio=0,
                mem_budget=8.0)
    a2 = RTTask("a2", wcet=2.0, period=30.0, cores=(1,), prio=0,
                mem_budget=6.0)
    b1 = RTTask("b1", wcet=2.0, period=60.0, cores=(0, 1), prio=0,
                mem_budget=1.0)
    vgangs = assign_priorities([
        VirtualGang("a1+a2", members=[a1, a2]),
        VirtualGang("b1", members=[b1])])
    policy = VirtualGangPolicy(vgangs, n_cores=3)
    floors = {vg.prio: min(m.mem_budget for m in vg.members)
              for vg in policy.vgangs}
    bad = []
    overlap = []

    def mk(name, width):
        my_prio = next(vg.prio for vg in policy.vgangs
                       for m in vg.members if m.name == name)

        def fn(lane, idx):
            inflight = dict(ex._inflight)
            if len(set(inflight.values())) > 1:
                overlap.append(inflight)
            g = ex.sched.g
            # budget writes happen under g.lock (gang-change hook), so
            # leader + budget sampled under it form a consistent pair
            with g.lock:
                leader_prio = g.leader.prio if g.leader else None
                live = sum(1 for t in g.gthreads if t is not None)
                b = ex.reg.cores[2].budget
            if leader_prio == my_prio and live == width:
                if b > floors[my_prio] + 1e-9:
                    bad.append((name, b))
            time.sleep(0.002)
        return fn

    ex = policy.build_executor(
        {"a1": mk("a1", 2), "a2": mk("a2", 2), "b1": mk("b1", 1)},
        n_jobs=8)
    stats = ex.run(1.0)
    assert overlap == [], overlap
    assert bad == [], bad
    assert len(stats["response_times"]["b1"]) == 8
    assert ex.sched.check_invariant()


# ---------------------------------------------------------------------
# parity of the copies with the JAX package on seeded task sets
# ---------------------------------------------------------------------

def _port_task(t):
    """The same task in the port's task model (uids are per package)."""
    kw = {f.name: getattr(t, f.name) for f in dataclasses.fields(t)
          if f.name != "uid"}
    return tgang.RTTask(**kw)


def _seeded_sets(n_sets, seed, cores=(4, 8, 16), dist="mixed"):
    """(n_cores, jax tasks, port tasks, gamma), drawn as the grid draws."""
    out = []
    for k in range(n_sets):
        m = cores[k % len(cores)]
        rng = random.Random(taskset_seed(seed, k, 1.1))
        tasks = random_vgang_taskset(rng, m, n_tasks_for(m),
                                     rng.uniform(0.3, 2.0), dist)
        gamma = (0.5, 2.0)[k % 2]
        out.append((m, tasks, [_port_task(t) for t in tasks], gamma))
    return out


def _vgang_key(vgangs):
    return [(vg.name, vg.prio, [(m.name, tuple(m.cores), m.prio)
                                for m in vg.members]) for vg in vgangs]


def _partition_key(part):
    return (part.n_cores, [(p.name, tuple(p.cores), [g.name for g in p.gangs])
                           for p in part.partitions])


FORMERS = ("first_fit_decreasing", "best_fit_utilization",
           "interference_aware", "exhaustive_optimal", "strict_partition")


@pytest.mark.parametrize("former", FORMERS)
def test_formation_and_rta_parity_with_jax(former):
    """For each heuristic, on seeded task sets: the formed units and their
    priorities, ``schedulable_vgangs`` (with blocking), the enforced
    variant, RTG-throttle with and without reclaim, and partition RTA
    equal the JAX package's exactly."""
    # the exhaustive optimum is capped at 9 same-period gangs: 4 and 8
    # cores draw 5 and 7 gangs
    cores = (4, 8) if former == "exhaustive_optimal" else (4, 8, 16)
    enf = {"j": jfaults.Enforcement("abort", factor=1.2,
                                    watchdog_factor=2.0),
           "t": tfaults.Enforcement("abort", factor=1.2,
                                    watchdog_factor=2.0)}
    checked = 0
    for m, jt, tt, gamma in _seeded_sets(12, seed=3, cores=cores):
        ji = jform.intensity_interference(jt, gamma)
        ti = tform.intensity_interference(tt, gamma)
        jf = getattr(jform, former)(jt, m, ji)
        tf = getattr(tform, former)(tt, m, ti)
        if former == "strict_partition":
            assert _partition_key(tf) == _partition_key(jf)
            assert trta.schedulable_partitions(tf, ti) == \
                jrta.schedulable_partitions(jf, ji)
            assert trta.schedulable_partitions(tf, ti, blocking=1.5) == \
                jrta.schedulable_partitions(jf, ji, blocking=1.5)
            checked += 1
            continue
        jv, tv = jform.assign_priorities(jf), tform.assign_priorities(tf)
        assert _vgang_key(tv) == _vgang_key(jv)
        assert trta.schedulable_vgangs(tv, ti, blocking=2.0) == \
            jrta.schedulable_vgangs(jv, ji, blocking=2.0)
        assert trta.schedulable_vgangs_enforced(tv, ti, enforcement=enf["t"]) \
            == jrta.schedulable_vgangs_enforced(jv, ji, enforcement=enf["j"])
        for reclaim in (False, True):
            assert trta.schedulable_rtg_throttle(
                tv, ti, interval=1.0, blocking=2.0, reclaim=reclaim) == \
                jrta.schedulable_rtg_throttle(
                    jv, ji, interval=1.0, blocking=2.0, reclaim=reclaim)
        checked += 1
    assert checked == 12


@pytest.mark.parametrize("family", jfam.family_names())
def test_family_bounds_parity_with_jax(family):
    """Every registered policy family forms, prices and bounds the same
    units in both packages (the bench reads ``bounds``)."""
    assert tfam.family_names() == jfam.family_names()
    jf, tf = jfam.get_family(family), tfam.get_family(family)
    assert (tf.form_key, tf.kind, tf.throttled) == \
        (jf.form_key, jf.kind, jf.throttled)
    for m, jt, tt, gamma in _seeded_sets(9, seed=5):
        ji = jform.intensity_interference(jt, gamma)
        ti = tform.intensity_interference(tt, gamma)
        jformed = jf.assign(jf.form(jt, m, ji))
        tformed = tf.assign(tf.form(tt, m, ti))
        for interval, blocking in ((1.0, 0.0), (10.0, 3.0)):
            assert tf.bounds(tformed, ti, interval=interval,
                             blocking=blocking) == \
                jf.bounds(jformed, ji, interval=interval, blocking=blocking)
        assert tf.verdict(tformed, ti) == jf.verdict(jformed, ji)
        if tf.utilization is not None:
            assert tf.utilization(tformed, ti) == \
                jf.utilization(jformed, ji)


def _fig4(pkg):
    g, s = pkg
    t1 = g.RTTask("tau1", wcet=2, period=10, cores=(0, 1), prio=2,
                  mem_budget=0.5, mem_intensity=0.3)
    t2 = g.RTTask("tau2", wcet=4, period=10, cores=(2, 3), prio=1,
                  mem_budget=0.2, mem_intensity=0.6)
    intf = s.matrix_interference({("tau1", "tau2"): 1.5,
                                  ("tau2", "tau1"): 1.5})
    return [t1, t2], intf, 40.0


def _fig5(pkg):
    g, s = pkg
    t1 = g.RTTask("tau1", wcet=3.5, period=20, cores=(0, 1), prio=2,
                  mem_budget=0.1, mem_intensity=0.4)
    t2 = g.RTTask("tau2", wcet=6.5, period=30, cores=(2, 3), prio=1,
                  mem_budget=0.1, mem_intensity=0.2)
    intf = s.matrix_interference({("tau1", "tau2"): 2.0,
                                  ("tau2", "tau1"): 2.0})
    return [t1, t2], intf, 20 * 30.0


@pytest.mark.parametrize("workload,mode", [
    (_fig4, "singletons"), (_fig4, "merged"), (_fig4, "rtgT+dr"),
    (_fig5, "singletons")])             # fig5's periods differ: no merge
def test_policy_simulate_parity_with_jax(workload, mode):
    """``VirtualGangPolicy.simulate`` (the exact event engine) on the
    fig4/fig5 task sets gives the same parity counters, misses and
    response times in both packages."""
    out = []
    for g, s, f, sch, reg in (
            (jgang, jsim, jform, jsched, jmetrics.MetricsRegistry),
            (tgang, tsim, tform, tsched, tmetrics.MetricsRegistry)):
        tasks, intf, horizon = workload((g, s))
        if mode == "singletons":
            vgangs = f.assign_priorities(f.singleton_vgangs(tasks))
        else:
            vgangs = f.assign_priorities([f.VirtualGang("v", tasks)])
        pol = sch.VirtualGangPolicy(vgangs, 4, intf, auto_prio=False,
                                    rtg_throttle=mode == "rtgT+dr",
                                    reclaim=mode == "rtgT+dr")
        r = pol.simulate(horizon, metrics=reg())
        assert r.engine == "event"
        out.append((r.parity_metrics, r.deadline_misses, r.response_times,
                    pol.member_bounds()))
    assert out[0][0]                      # the counters exist
    assert out[1] == out[0]


def test_experiment_config_parity_with_jax():
    """The bench's config and its digest are the JAX bench's; the port's
    batched-RTA backends are numpy and torch."""
    j = jexp.default_bench_executor_config()
    t = texp.default_bench_executor_config()
    assert t.to_dict() == j.to_dict()
    assert t.content_digest() == j.content_digest()
    t.with_value("engine.backend", "torch")
    with pytest.raises(texp.ConfigurationError):
        t.with_value("engine.backend", "jax")


# ---------------------------------------------------------------------
# the executor vgang bench and the fleet example on the CPU
# ---------------------------------------------------------------------

def test_bench_executor_vgang_cpu_smoke(tmp_path):
    """All four modes on the CPU: exit 0, no violation, every member ran
    and stayed within its bound; the file carries the JAX bench's header
    and config digest."""
    out = tmp_path / "bench.json"
    rc = bench.main(["--device", "cpu", "--smoke", "--reclaim",
                     "--out", str(out)])
    doc = json.loads(out.read_text())
    assert rc == 0, doc["failures"]
    assert doc["ok"] and doc["failures"] == []
    assert doc["device"] == {"kind": "cpu"}
    assert list(doc["modes"]) == ["solo", "vgang", "rtgT", "rtgT+dr"]
    assert doc["modes"]["vgang"]["vgangs"] == ["cam+imu+lidar", "dnn",
                                               "plan"]
    for mode, row in doc["modes"].items():
        assert row["invariant_violations"] == 0
        assert row["budget_violations"] == 0
        for name, e in row["members"].items():
            assert e["jobs"] > 0 and e["rta_ok"], (mode, name)
            assert e["max_response_ms"] <= e["rta_bound_ms"]
            assert e["first_response_ms"] <= e["max_response_ms"]
    assert doc["schema_version"] == 2
    assert doc["config_digest"] == texp.default_bench_executor_config() \
        .with_value("smoke", True).with_value("policy.reclaim", True) \
        .with_value("output.out", str(out)).content_digest()


def test_cpu_bench_calibrates_on_thread_time_and_restores_policy(
        tmp_path, monkeypatch):
    """On the CPU the bench prices a member at its lane thread's CPU time
    (a lost time slice on a loaded host is not the quantum's cost), and
    leaves the calling thread's scheduling policy as it found it."""
    clocks = []

    def calibrate(step, clock):
        clocks.append(clock)
        return 1e-4
    monkeypatch.setattr(bench, "calibrate", calibrate)
    before = (os.sched_getscheduler(0), os.sched_getparam(0))
    bench.main(["--device", "cpu", "--smoke", "--duration", "0.3",
                "--out", str(tmp_path / "bench.json")])
    assert len(clocks) == len(bench.MEMBERS)
    assert all(c is time.thread_time for c in clocks)
    assert (os.sched_getscheduler(0), os.sched_getparam(0)) == before


def test_bench_raising_quantum_fails_the_run(tmp_path, monkeypatch):
    """A quantum that raises ends its lane's thread; the bench reports it
    and exits nonzero instead of passing on the surviving lanes."""
    real = bench.Quanta.make_step

    def make_step(self, name, n):
        step = real(self, name, n)
        if name != "dnn":
            return step
        calls = {"n": 0}

        def body(lane, idx):
            calls["n"] += 1
            if calls["n"] > 20:            # after the warm-up's 20 calls
                raise RuntimeError("injected fault")
            return step(lane, idx)
        return self.lanes.quantum(body, self.errors)
    monkeypatch.setattr(bench.Quanta, "make_step", make_step)
    # a fixed calibration keeps the formation (3 vgangs) off the host's
    # timing noise: this test is about the fault, not the bounds
    monkeypatch.setattr(bench, "calibrate", lambda step, clock: 1e-4)
    out = tmp_path / "bench.json"
    rc = bench.main(["--device", "cpu", "--smoke", "--duration", "0.5",
                     "--out", str(out)])
    doc = json.loads(out.read_text())
    assert rc == 1
    assert any("raised" in f and "injected fault" in f
               for f in doc["failures"])


def test_device_overlap_counts_cross_vgang_pairs():
    vg = {"a": "A+B", "b": "A+B", "c": "C"}
    ivs = [{"name": "a", "lane": 0, "start_ms": 0.0, "end_ms": 2.0},
           {"name": "b", "lane": 1, "start_ms": 1.0, "end_ms": 3.0},
           {"name": "c", "lane": 2, "start_ms": 3.0, "end_ms": 4.0},
           {"name": "a", "lane": 0, "start_ms": 5.0, "end_ms": 6.0}]
    ov = bench.device_overlap(ivs, vg)
    assert (ov["cross_pairs"], ov["same_pairs"]) == (0, 1)
    assert ov["same_ms"] == pytest.approx(1.0)
    assert ov["same_busy_ms"] == pytest.approx(5.0)
    ivs.append({"name": "c", "lane": 3, "start_ms": 5.5, "end_ms": 7.0})
    ov = bench.device_overlap(ivs, vg)
    assert ov["cross_pairs"] == 1 and ov["cross_ms"] == pytest.approx(0.5)


@pytest.mark.parametrize("flags", [[], ["--rtg-throttle"], ["--reclaim"]])
def test_vgang_fleet_cpu(flags):
    stats = vgang_fleet.main(["--device", "cpu", "--duration", "0.6"]
                             + flags)
    assert stats["invariant_ok"]
    assert all(len(stats["response_times"][n]) > 0
               for n in ("perception", "fusion", "planner"))


def test_vgang_entry_points_need_a_card_by_default(tmp_path):
    """Without ``--device`` the bench and the example run on the card, and
    raise where there is none; nothing drops to the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points would run on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main(["--smoke", "--out", str(tmp_path / "b.json")])
    with pytest.raises(RuntimeError, match="CUDA"):
        vgang_fleet.main(["--duration", "0.1"])
    assert not (tmp_path / "b.json").exists()
