"""Virtual-gang subsystem (arXiv:1912.10959).

RT-Gang's one-gang-at-a-time policy idles every core a gang does not
occupy. The Virtual-Gang follow-up recovers that utilization by packing
real-time gangs into fixed-composition *virtual gangs* that are scheduled
as single units. This package layers that idea on the existing core:

    formation.py  width-constrained bin packing of gangs into virtual
                  gangs (FFD, best-fit, interference-aware, exhaustive)
    rta.py        response-time analysis of virtual-gang tasksets by
                  collapsing each virtual gang to its single-core
                  equivalent and reusing core/rta.py verbatim
    sched.py      VirtualGangPolicy — dispatches the members of one
                  virtual gang as a unit on the simulator engines with
                  per-member throttle budgets (core/throttle.py)
    family.py     the policy families (rtgang, ffd, bestfit, intfaware,
                  rtgT, rtgT+dr, part) the executor vgang bench runs

See DESIGN.md §9.
"""
from repro_torch.vgang.formation import (
    VirtualGang, assign_priorities, best_fit_utilization, exhaustive_optimal,
    first_fit_decreasing, interference_aware, intensity_interference,
    singleton_vgangs, total_vgang_utilization)
from repro_torch.vgang.rta import (response_time_vgang, schedulable_vgangs,
                                   vgang_equivalent_task)
from repro_torch.vgang.sched import VirtualGangPolicy, remap_members

__all__ = [
    "VirtualGang", "assign_priorities", "best_fit_utilization",
    "exhaustive_optimal", "first_fit_decreasing", "interference_aware",
    "intensity_interference", "singleton_vgangs",
    "total_vgang_utilization", "response_time_vgang", "schedulable_vgangs",
    "vgang_equivalent_task", "VirtualGangPolicy", "remap_members",
]
