"""RT-Gang core, as far as the PyTorch port needs it.

* gang.py     — task model (RT gangs, virtual gangs, best-effort tasks)
* glock.py    — Algorithms 1-4 state machine (one-gang-at-a-time invariant)
* sim.py      — fixed-quantum scheduler simulator (reproduces Fig.4/5)
* events.py   — exact event-driven engine (Simulator dt=None; O(events))
* memmodel.py — co-runner / interference / charging layer of both engines
* faults.py   — fault injection and overrun enforcement
* throttle.py — BWLOCK-adapted bandwidth regulation (reactive + admission)
* rta.py      — classical response-time analysis enabled by the transform
* executor.py — gang-scheduled executor; lanes bind CUDA streams through
  ``repro_torch.device``
* tracing.py  — KernelShark-lite execution traces
"""
from repro_torch.core.gang import BETask, RTTask, Thread, make_virtual_gang
from repro_torch.core.glock import GangScheduler, GLock
from repro_torch.core.sim import (Simulator, SimResult, matrix_interference,
                                  no_interference)
from repro_torch.core.events import EventEngine
from repro_torch.core.throttle import BandwidthRegulator
from repro_torch.core.rta import response_time, schedulable, total_utilization
from repro_torch.core.executor import BEJob, GangExecutor, RTJob
from repro_torch.core.faults import (BeOverrun, Enforcement, FaultPlan,
                                     HungThread, LostWakeup, WcetOverrun)
from repro_torch.core.tracing import Trace

__all__ = ["BETask", "RTTask", "Thread", "make_virtual_gang",
           "GangScheduler", "GLock", "Simulator", "SimResult", "EventEngine",
           "matrix_interference", "no_interference", "BandwidthRegulator",
           "response_time", "schedulable", "total_utilization",
           "BEJob", "GangExecutor", "RTJob", "Trace",
           "FaultPlan", "Enforcement", "WcetOverrun", "HungThread",
           "LostWakeup", "BeOverrun"]
