"""MemoryModel — the shared interference/bandwidth layer of both
simulator engines (DESIGN.md §10).

Both engines used to carry their own copy of the co-runner bookkeeping:
the quantum loop rebuilt a ``running_names`` map and took a max over
co-runners per core per step, and the event engine's ``recompute_rates``
rescanned every (core, other-core) pair per event — O(cores^2) at every
steady-state throttle event. This module replaces both with one
incrementally-maintained model:

* **Occupancy** — each core holds one occupant record: an RT thread, a
  fractional set of best-effort candidates, or nothing. Updates are
  diffed: an unchanged assignment is a no-op, a changed one adjusts the
  global occupant-name multiset only for that core (O(dirty) per event).
* **Interference** — the engines' slowdown rule is
  ``max(1, max_{name present, name != victim} interference(victim, name))``:
  same-named threads never interfere and a gang's own threads share one
  name, so the slowdown depends only on the victim's name and the *set*
  of distinct occupant names — not on which core anyone sits on. The
  model therefore versions the distinct-name set with an ``epoch``
  (bumped only on a 0<->1 presence transition) and memoizes slowdowns
  per victim name against it: a steady-state event where the name set
  is unchanged reuses every cached aggregate.
* **Bandwidth charging** — RT threads charge their ``traffic_rate``
  (RTTask.mem_rate, derived from mem_intensity) through the same
  ``BandwidthRegulator`` best-effort work uses, so RT threads can trip
  per-core budgets (RTG-throttle: sibling members of a virtual gang are
  regulated while the critical member runs unthrottled). A tripped RT
  thread *pauses mid-job* — the engines stop its progress and remove it
  from occupancy (a stalled thread generates no traffic and no
  interference) until the regulation window ends.
* **Dynamic reclaiming** (``BandwidthRegulator(reclaim=True)``,
  DESIGN.md §7.5) — an RT thread that exhausts its window quota *claims*
  the unspent quota of idle cores that previously hosted RT work (the
  regulator's pull-based donation pool) before tripping, and a stalled
  thread is re-tried when a donor appears. Each drawn unit is funded by
  a specific donor core under the *exchange gate* that keeps the static
  RTG-throttle RTA bound sound (vgang/rta.py, DESIGN.md §9.3.2): the
  funded extension must lie inside the donor occupant's own static
  unstalled window (offsets the static analysis already priced the
  donor as present at), and for every present-or-stalled RT victim the
  drawer's interference factor must not exceed the absent donor's —
  under the engines' max-of-pairwise slowdown rule the extension then
  never raises any victim's slowdown above what the static profile
  already assumed at those offsets.

Location-dependent interference: a pairwise model may declare
``distance_aware = True`` and accept ``(victim, aggressor, distance)``
(core index distance). The name-keyed slowdown memo is then invalid —
the same co-runner set at different cores gives different aggregates —
so the memo keys on ``(victim, core)`` and is versioned by a *location*
epoch that bumps on every occupancy change, not only on 0<->1 presence
transitions (ROADMAP: formation under per-core locality).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.gang import RTTask
from repro_torch.core.throttle import BandwidthRegulator

# occupant kinds
IDLE, RT, BE = 0, 1, 2

_INF = float("inf")


def distance_interference(fn: Callable[[str, str, int], float]
                          ) -> Callable[[str, str, int], float]:
    """Mark ``fn(victim, aggressor, distance)`` as a location-dependent
    pairwise model (distance = |victim core - aggressor core|)."""
    fn.distance_aware = True       # type: ignore[attr-defined]
    return fn


class MemoryModel:
    """Incremental co-runner sets + slowdown aggregates + traffic
    charging, driven by both engines (core/sim.py and core/events.py).

    ``kind``/``names``/``rates`` are per-core views the engines read in
    their hot loops; mutate occupancy only through ``set_rt``/``set_be``
    /``clear`` so the name multiset and epoch stay consistent.
    """

    def __init__(self, n_cores: int,
                 interference: Callable[[str, str], float],
                 regulator: BandwidthRegulator):
        self.n_cores = n_cores
        self.interference = interference
        self.distance_aware = bool(getattr(interference, "distance_aware",
                                           False))
        self.reg = regulator
        self.kind: List[int] = [IDLE] * n_cores
        self.names: List[Tuple[str, ...]] = [()] * n_cores
        self.rates: List[float] = [0.0] * n_cores
        self.epoch = 0                       # distinct-name-set version
        self.loc_epoch = 0                   # any-occupancy-change version
        self._count: Dict[str, int] = {}     # occupant-name multiset
        # location-free: victim -> (epoch, s); distance-aware:
        # (victim, core) -> (loc_epoch, s)
        self._slow: Dict = {}
        # reclaiming: the last RT task a core hosted — kept across
        # clear(), a now-idle core donates on its former occupant's
        # behalf, but only to drawers of the *same gang* (equal RT
        # priority): leftover grants of a previously scheduled gang
        # must never fund another gang's extension, whose static bound
        # never priced those members as co-runners. Plus the stalled
        # threads' names (a stalled thread is cleared from occupancy
        # but is still a victim the exchange gate must protect).
        self._last_rt: List[Optional[RTTask]] = [None] * n_cores
        self.stalled_victims: Dict[int, str] = {}

    @property
    def agg_epoch(self) -> int:
        """The version the slowdown memo is valid against — the distinct-
        name-set epoch for location-free interference, the location epoch
        (every occupancy change) for distance-aware models. Engines that
        cache aggregates must key on this, not on ``epoch``."""
        return self.loc_epoch if self.distance_aware else self.epoch

    # ---- occupancy (incremental) ------------------------------------
    def _assign(self, core: int, kind: int, names: Tuple[str, ...],
                rate: float) -> None:
        if self.kind[core] == kind and self.names[core] == names:
            self.rates[core] = rate
            return
        self.loc_epoch += 1
        cnt = self._count
        for nm in self.names[core]:
            left = cnt[nm] - 1
            if left:
                cnt[nm] = left
            else:
                del cnt[nm]
                self.epoch += 1
        for nm in names:
            had = cnt.get(nm, 0)
            cnt[nm] = had + 1
            if not had:
                self.epoch += 1
        self.kind[core] = kind
        self.names[core] = names
        self.rates[core] = rate

    def set_rt(self, core: int, task: RTTask) -> None:
        """An RT thread of ``task`` occupies ``core`` (running, i.e. not
        throttle-stalled — stalled threads are ``clear``-ed)."""
        self._last_rt[core] = task
        self._assign(core, RT, (task.name,), task.traffic_rate)

    def set_be(self, core: int, names: Tuple[str, ...],
               rate: float) -> None:
        """Fractional best-effort co-runners occupy ``core``: every
        candidate is present for interference purposes and the core
        charges their aggregate ``rate`` (sum of mem_rate / n)."""
        self._assign(core, BE, names, rate)

    def clear(self, core: int) -> None:
        """Core idle (or its occupant is throttle-stalled: a stalled
        thread generates no traffic and no interference)."""
        self._assign(core, IDLE, (), 0.0)

    def refresh_core(self, core: int, thread, be_names: Tuple[str, ...],
                     be_rate: float, now: float) -> bool:
        """Re-derive ``core``'s occupancy from the engine's scheduling
        state — the one shared stall policy both engines apply: an RT
        occupant with traffic whose budget is tripped pauses (cleared:
        no traffic, no interference) and True is returned; otherwise
        the RT thread occupies the core. A free core hosts its
        best-effort candidates fractionally unless stalled."""
        if thread is not None:
            if thread.task.traffic_rate > 0.0 and \
                    self.reg.is_stalled(core, now):
                self.clear(core)
                self.stalled_victims[core] = thread.task.name
                return True
            self.stalled_victims.pop(core, None)
            self.set_rt(core, thread.task)
            return False
        self.stalled_victims.pop(core, None)
        if be_names and not self.reg.is_stalled(core, now):
            self.set_be(core, be_names, be_rate)
        else:
            self.clear(core)
        return False

    # ---- interference aggregate (epoch-memoized) --------------------
    def slowdown(self, victim: str, core: Optional[int] = None) -> float:
        """max(1, max over present occupant names != victim) — cached
        against the distinct-name-set epoch, so steady-state events
        reuse every aggregate and a name-set change costs one
        O(#distinct names) rebuild per victim, not O(cores^2).

        Distance-aware interference (``distance_interference``): the
        aggregate depends on *where* the victim and its co-runners sit,
        so the memo keys on ``(victim, core)`` and validates against the
        location epoch — a co-runner moving cores without any 0<->1 name
        transition must invalidate it (the name-keyed memo would return
        the stale aggregate)."""
        if self.distance_aware:
            if core is None:
                raise ValueError("distance-aware interference needs the "
                                 "victim's core for slowdown()")
            key = (victim, core)
            hit = self._slow.get(key)
            if hit is not None and hit[0] == self.loc_epoch:
                return hit[1]
            s = 1.0
            intf = self.interference
            for oc in range(self.n_cores):
                if oc == core:
                    continue
                dist = abs(oc - core)
                for nm in self.names[oc]:
                    if nm != victim:
                        f = intf(victim, nm, dist)
                        if f > s:
                            s = f
            self._slow[key] = (self.loc_epoch, s)
            return s
        hit = self._slow.get(victim)
        if hit is not None and hit[0] == self.epoch:
            return hit[1]
        s = 1.0
        intf = self.interference
        for nm in self._count:
            if nm != victim:
                f = intf(victim, nm)
                if f > s:
                    s = f
        self._slow[victim] = (self.epoch, s)
        return s

    # ---- bandwidth charging -----------------------------------------
    # Thin seams over the regulator so both engines charge RT and BE
    # occupants identically: the dt-stepped loop uses charge_quantum;
    # the closed-form engine predicts trips via next_trip_time/trip and
    # span-charges reg.charge_span(core, rates[core], ...) directly in
    # its materialization hot path.

    def charge_quantum(self, core: int, dt: float, now: float) -> float:
        """Charge one quantum of the core's occupant traffic; returns
        the fraction of the quantum that executed (reactive: the
        traffic is fully accounted, the occupant runs until the exact
        trip point within the quantum and then stalls until the window
        ends — the same progress the closed-form engine realizes).

        Reclaiming: when the quantum would exhaust an RT occupant's
        window limit, the claim happens first, at the *exact* sub-
        quantum exhaustion instant — the same instant the closed-form
        engine's trip event fires — so both engines draw identical
        amounts in identical order."""
        r = self.rates[core]
        if r <= 0.0:
            return 1.0
        amount = r * dt
        reg = self.reg
        if reg.reclaim and self.kind[core] == RT:
            st = reg.cores[core]
            reg._roll_window(st, now)
            if now >= st.stalled_until:
                # claim as soon as the quantum *reaches* the limit (the
                # event engine's exhaustion event fires the moment
                # used == limit, before any overshoot) — but only when
                # the exhaustion instant lies strictly inside the
                # current window: a future-dated t_x at/past the
                # boundary would roll the drawer's window early, erase
                # its usage, and let the straddling quantum's traffic
                # slip past the trip (next window's charges claim on
                # their own, with usage freshly rolled)
                head = st.limit - st.used
                t_x = now + max(0.0, head) / r
                if amount >= head - 1e-12 and \
                        t_x < st.window_start + st.interval - 1e-12:
                    self.claim(core, self.names[core][0], r, t_x)
        return reg.charge_partial(core, amount, now)

    def next_trip_time(self, core: int, now: float) -> float:
        r = self.rates[core]
        if r <= 0.0 or self.reg.cores[core].budget == _INF:
            return _INF
        return self.reg.next_trip_time(core, r, now)

    def trip(self, core: int, now: float) -> None:
        self.reg.trip(core, now)

    # ---- dynamic reclaiming (DESIGN.md §7.5) ------------------------
    # Eligibility policy on top of the regulator's pull accounting.
    # Donors are idle cores that previously hosted RT work; each drawn
    # unit is funded by a specific donor under the *exchange gate* that
    # keeps the static RTG-throttle bound sound (DESIGN.md §9.3.2):
    #
    #  * offset cap — the funded extension lies inside the donor
    #    occupant's static unstalled window [0, budget/rate_donor): the
    #    static analysis already priced the donor present at exactly
    #    those offsets, and the donor is provably absent now (idle);
    #  * factor dominance — for every present-or-stalled RT victim the
    #    drawer's pairwise factor is <= the donor's, so under the
    #    max-of-pairwise slowdown rule the substitution never raises any
    #    victim's slowdown above the static profile.
    #
    # Both engines call these at the same instants (the exact trip
    # point / the stall-retry when occupancy changes), scanning donors
    # in core order, so the accounting is byte-identical across engines.

    def _dominated(self, victim: str, victim_core: int, drawer: str,
                   drawer_core: int, donor: str, donor_core: int) -> bool:
        intf = self.interference
        if self.distance_aware:
            f_o = intf(victim, drawer, abs(victim_core - drawer_core))
            f_d = intf(victim, donor, abs(victim_core - donor_core))
        else:
            f_o = intf(victim, drawer)
            f_d = intf(victim, donor)
        return f_o <= f_d + 1e-12

    def _donor_covers(self, drawer: str, drawer_core: int, donor: str,
                      donor_core: int) -> bool:
        """Factor dominance over every victim: RT occupants plus
        stalled threads (cleared from occupancy, but they may resume
        mid-window through their own draw and must stay protected)."""
        for mc in range(self.n_cores):
            if mc == drawer_core:
                continue
            if self.kind[mc] == RT:
                victim = self.names[mc][0]
            else:
                victim = self.stalled_victims.get(mc)
            if victim is None or victim in (drawer, donor):
                continue
            if not self._dominated(victim, mc, drawer, drawer_core,
                                   donor, donor_core):
                return False
        return True

    def claim(self, core: int, drawer: str, rate: float,
              t_x: float) -> float:
        """At the exhaustion instant ``t_x`` of ``core``'s RT occupant
        ``drawer``, claim donated quota to keep charging at ``rate``
        past its own window limit — donor by donor, in core order,
        each funding only the contiguous extension sub-span inside its
        own static window (first-to-trip claims first; later trippers
        get what is left). Returns the drawn amount."""
        reg = self.reg
        if not reg.reclaim or rate <= 0.0:
            return 0.0
        st = reg.cores[core]
        reg._roll_window(st, t_x)
        interval = st.interval
        covered = t_x - st.window_start      # extension starts here
        if covered >= interval - 1e-15:
            return 0.0
        drawer_task = self._last_rt[core]
        if drawer_task is None:
            return 0.0
        got = 0.0
        for d in range(self.n_cores):
            if d == core or self.kind[d] != IDLE:
                continue
            last = self._last_rt[d]
            # same-gang scope: only a co-member's grant (equal RT
            # priority = gang identity) may fund this drawer
            if last is None or last.prio != drawer_task.prio:
                continue
            donor, donor_rate = last.name, last.traffic_rate
            dst = reg.cores[d]
            reg._roll_window(dst, t_x)
            if dst.budget == _INF:
                continue
            # the donor occupant's static unstalled window offset
            q_d = interval if donor_rate <= 0.0 \
                else min(interval, dst.budget / donor_rate)
            if q_d <= covered + 1e-15:
                continue
            if not self._donor_covers(drawer, core, donor, d):
                continue
            # accounting routed through the regulator's one transfer
            # primitive (engines are single-threaded; the executor path
            # goes through draw_from, which locks)
            take = reg._transfer(d, core, rate * (q_d - covered), t_x)
            if take <= 0.0:
                continue
            got += take
            covered += take / rate
            if covered >= interval - 1e-15:
                break
        return got

    def claim_lift(self, core: int, task: RTTask, now: float) -> bool:
        """Retry a throttle-stalled RT thread against the donation pool
        (a donor appeared after the trip): draw what the rest of the
        window needs; any positive grant lifts the stall. Engines call
        this for stalled cores — in core order — whenever occupancy
        changes while reclaiming is on."""
        reg = self.reg
        r = task.traffic_rate
        if not reg.reclaim or r <= 0.0:
            return False
        if not reg.is_stalled(core, now):
            return False
        if self.claim(core, task.name, r, now) <= 0.0:
            return False
        st = reg.cores[core]
        if st.used >= st.limit - 1e-12:
            # the grant does not even cover the trip overshoot (the
            # quantum engine's counter runs ahead of the exact trip
            # point by up to one quantum): lifting now would just
            # re-trip on the next consultation and double-count the
            # stall — stay stalled until the window ends
            return False
        reg.unstall(core)
        return True
