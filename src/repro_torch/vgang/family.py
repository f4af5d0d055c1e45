"""PolicyFamily registry — the pluggable policy stack (DESIGN.md §15).

Every admission policy the evaluation surfaces compare (the rtgang
singleton baseline, the formation heuristics, RTG-throttle with and
without reclaiming, strict partitioning) is one ``PolicyFamily``: a
bundle of

* a formation strategy (``form``/``assign``) producing the policy's
  scheduling units from a raw taskset,
* an RTA verdict (``verdict`` scalar, ``batched_verdict`` through
  analysis/batched_rta.py — bit-identical pair),
* a Simulator policy constructor (``make_policy``) for the
  event-engine soundness cross-check, and
* the column label the grid/sweep/bench surfaces report under.

The consumers (vgang/grid.py, launch/sweep.py,
benchmarks/bench_executor_vgang.py, experiment.PolicyStackConfig
validation) iterate the registry instead of special-casing column
strings, so a new policy lands by registering one family here.

``form_key`` lets families share one formed object per taskset: the
rtgT and rtgT+dr columns both analyze the packed ``intfaware``
formation, and sharing the *identical* object (not an equal copy) keeps
the id()-keyed priority/WCET memoization in the grid exact — the same
sharing the pre-registry code did by hand.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

from repro_torch.vgang import rta as vrta
from repro_torch.vgang.formation import (HEURISTICS, assign_priorities,
                                         singleton_vgangs, strict_partition,
                                         total_vgang_utilization)
from repro_torch.vgang.sched import StrictPartitionPolicy, VirtualGangPolicy

BASELINE_COLUMN = "rtgang"
RTG_COLUMN = "rtgT"
RECLAIM_COLUMN = "rtgT+dr"
PART_COLUMN = "part"

# special policy columns appended after the plain formation heuristics,
# in this canonical report order (grid_columns)
SPECIAL_COLUMNS = (RTG_COLUMN, RECLAIM_COLUMN, PART_COLUMN)


def _identity(formed):
    return formed


@dataclasses.dataclass(frozen=True)
class PolicyFamily:
    """One admission policy as the evaluation surfaces consume it.

    ``formed`` below is whatever ``assign(form(tasks, n_cores, intf))``
    produced — a ``List[VirtualGang]`` for vgang-kind families, a
    ``Partitioning`` for partition-kind ones. Callable contracts:

    * ``form(tasks, n_cores, interference) -> units``
    * ``assign(units) -> units``  (priority assignment; identity when
      ``form`` already assigns)
    * ``verdict(formed, interference) -> bool``
    * ``batched_verdict(formed_sets, interferences, wcet_cache=None)
      -> List[bool]``  (bit-identical to mapping ``verdict``; families
      without a per-unit WCET memo ignore ``wcet_cache``)
    * ``bounds(formed, interference, interval=, blocking=) ->
      Dict[name, row]``  (per-unit WCRT rows, row["wcrt"]/"ok")
    * ``make_policy(formed, n_cores, interference) -> policy`` with
      ``.simulate(horizon, rta_bounds=, trace=, dt=)`` and
      ``.member_bounds()`` — the soundness cross-check driver
    * ``utilization(formed, interference) -> float`` or None — the
      formation objective (single-core-equivalent utilization); None
      means the family has no comparable packing objective and is
      excluded from the grid's best-formation utilization gain
    """
    name: str
    form_key: str
    form: Callable
    verdict: Callable
    batched_verdict: Callable
    bounds: Callable
    make_policy: Callable
    assign: Callable = _identity
    utilization: Optional[Callable] = None
    kind: str = "vgang"
    throttled: bool = False
    aligned_releases_only: bool = False


FAMILIES: Dict[str, PolicyFamily] = {}


def register_family(family: PolicyFamily) -> PolicyFamily:
    """Add a family to the registry (its ``name`` becomes the column)."""
    if family.name in FAMILIES:
        raise ValueError(
            f"policy family {family.name!r} is already registered")
    FAMILIES[family.name] = family
    return family


def family_names() -> Tuple[str, ...]:
    """Registered column labels, registration order."""
    return tuple(FAMILIES)


def get_family(name: str) -> PolicyFamily:
    f = FAMILIES.get(name)
    if f is None:
        raise ValueError(
            f"unknown policy family {name!r}; "
            f"known: {list(FAMILIES)}")
    return f


def grid_columns(heuristics: Sequence[str]) -> Tuple[str, ...]:
    """Canonical grid column order for a requested heuristics list: the
    rtgang baseline first, plain formation heuristics in request order,
    then the special policy columns (rtgT, rtgT+dr, part) in canonical
    order — exactly the ordering the pre-registry grid produced."""
    for h in heuristics:
        get_family(h)
    plain = [h for h in heuristics
             if h != BASELINE_COLUMN and h not in SPECIAL_COLUMNS]
    specials = [s for s in SPECIAL_COLUMNS if s in heuristics]
    return (BASELINE_COLUMN, *plain, *specials)


# ---------------------------------------------------------------------------
# The built-in families


def _vgang_family(name: str, form: Callable, form_key: Optional[str] = None,
                  rtg: bool = False, dr: bool = False) -> PolicyFamily:
    """Family over virtual-gang formation: plain vgang RTA, or the
    RTG-throttle duty-cycle pricing (``rtg``, with reclaim credit under
    ``dr``), simulated through VirtualGangPolicy."""
    if rtg:
        def verdict(formed, intf):
            return vrta.accepts_rtg_throttle(formed, intf, reclaim=dr)

        def batched_verdict(formed_sets, intfs, wcet_cache=None):
            return vrta.batched_accepts_rtg_throttle(
                formed_sets, intfs, reclaim=dr, wcet_cache=wcet_cache)

        def bounds(formed, intf, interval=1.0, blocking=0.0):
            return vrta.schedulable_rtg_throttle(
                formed, intf, interval=interval, blocking=blocking,
                reclaim=dr)
    else:
        def verdict(formed, intf):
            return vrta.accepts(formed, intf)

        def batched_verdict(formed_sets, intfs, wcet_cache=None):
            del wcet_cache
            return vrta.batched_accepts(formed_sets, intfs)

        def bounds(formed, intf, interval=1.0, blocking=0.0):
            del interval
            return vrta.schedulable_vgangs(formed, intf,
                                           blocking=blocking)

    def make_policy(formed, n_cores, intf):
        return VirtualGangPolicy(formed, n_cores, intf, auto_prio=False,
                                 rtg_throttle=rtg, reclaim=dr)

    return PolicyFamily(
        name=name, form_key=form_key or name, form=form,
        assign=assign_priorities, verdict=verdict,
        batched_verdict=batched_verdict, bounds=bounds,
        make_policy=make_policy, utilization=total_vgang_utilization,
        kind="vgang", throttled=rtg, aligned_releases_only=rtg)


def _rtgang_form(tasks, n_cores, interference):
    del n_cores, interference
    return singleton_vgangs(tasks)


register_family(_vgang_family(BASELINE_COLUMN, _rtgang_form))
for _h, _fn in HEURISTICS.items():
    register_family(_vgang_family(_h, _fn))
register_family(_vgang_family(RTG_COLUMN, HEURISTICS["intfaware"],
                              form_key="intfaware", rtg=True))
register_family(_vgang_family(RECLAIM_COLUMN, HEURISTICS["intfaware"],
                              form_key="intfaware", rtg=True, dr=True))


def _part_verdict(formed, intf):
    return vrta.accepts_partitioned(formed, intf)


def _part_batched(formed_sets, intfs, wcet_cache=None):
    del wcet_cache
    return vrta.batched_accepts_partitioned(formed_sets, intfs)


def _part_bounds(formed, intf, interval=1.0, blocking=0.0):
    del interval
    return vrta.schedulable_partitions(formed, intf, blocking=blocking)


def _part_policy(formed, n_cores, intf):
    del n_cores  # the Partitioning carries the machine size
    return StrictPartitionPolicy(formed, intf)


register_family(PolicyFamily(
    name=PART_COLUMN, form_key=PART_COLUMN, form=strict_partition,
    verdict=_part_verdict, batched_verdict=_part_batched,
    bounds=_part_bounds, make_policy=_part_policy,
    kind="partition"))
