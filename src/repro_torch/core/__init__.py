"""RT-Gang core, as far as the PyTorch port needs it.

* gang.py     — task model (RT gangs, best-effort tasks)
* glock.py    — Algorithms 1-4 state machine (one-gang-at-a-time invariant)
* throttle.py — BWLOCK-adapted bandwidth regulation (reactive + admission)
* executor.py — gang-scheduled executor; lanes bind CUDA streams through
  ``repro_torch.device``
* tracing.py  — KernelShark-lite execution traces
"""
from repro_torch.core.gang import BETask, RTTask, Thread
from repro_torch.core.glock import GangScheduler, GLock
from repro_torch.core.throttle import BandwidthRegulator
from repro_torch.core.executor import BEJob, GangExecutor, RTJob
from repro_torch.core.tracing import Trace

__all__ = ["BETask", "RTTask", "Thread", "GangScheduler", "GLock",
           "BandwidthRegulator", "BEJob", "GangExecutor", "RTJob", "Trace"]
