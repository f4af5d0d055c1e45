"""Fleet scenario on the port: formed virtual gangs on the real executor,
their quanta on the card.

Three latency-critical pipelines (perception / fusion / planning) are
packed into virtual gangs by the interference-aware heuristic and
dispatched as units through ``VirtualGangPolicy.build_executor``; each
quantum is ``tanh(x @ x)`` on an (n, n) f32 tensor on its lane's CUDA
stream and ends when the stream drains (``device.Lanes.quantum``). The
glock's gang-change hook enforces min-over-live-member lane budgets, so a
best-effort analytics filler only moves the bytes the most sensitive
co-running member tolerates. ``--rtg-throttle`` switches to RTG-throttle
dispatch (critical member uncapped, sibling lanes admission-capped), and
``--reclaim`` adds mid-window bandwidth donation on top (DESIGN.md §7.5).

    python -m repro_torch.examples.vgang_fleet [--device cpu]
        [--rtg-throttle] [--reclaim] [--duration 2]

Without ``--device cpu`` it runs on the card and raises where there is
none. ``main`` returns the executor's stats, with ``invariant_ok`` (the
glock's one-gang-at-a-time check after the run) added.
"""
import argparse
import time

import torch

from repro_torch.core.executor import BEJob
from repro_torch.core.gang import RTTask
from repro_torch.device import Lanes, resolve_device, synchronize
from repro_torch.vgang.formation import (assign_priorities, interference_aware,
                                         intensity_interference)
from repro_torch.vgang.rta import schedulable_vgangs
from repro_torch.vgang.sched import VirtualGangPolicy

N_LANES = 4


def device_step(n, device, lanes, errors):
    """A quantum: ``tanh(x @ x)`` on an (n, n) f32 tensor, warmed once."""
    x0 = torch.full((n, n), 0.01, dtype=torch.float32, device=device)
    synchronize(device)

    def body(lane, idx):
        torch.tanh(x0 @ x0)
    step = lanes.quantum(body, errors)
    for lane in range(N_LANES):
        step(lane, 0)
    return step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rtg-throttle", action="store_true")
    ap.add_argument("--reclaim", action="store_true",
                    help="mid-window donation on top of RTG-throttle")
    ap.add_argument("--duration", type=float, default=2.0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False

    # (width, intensity, tolerable BE bytes/window); periods in task-ms
    tasks = [
        RTTask("perception", wcet=6.0, period=100.0, cores=(0,), prio=0,
               mem_intensity=0.2, mem_budget=6e6),
        RTTask("fusion", wcet=6.0, period=100.0, cores=(0,), prio=0,
               mem_intensity=0.1, mem_budget=8e6),
        RTTask("planner", wcet=8.0, period=200.0, cores=(0, 1, 2),
               prio=0, mem_intensity=0.6, mem_budget=1e6),
    ]
    intf = intensity_interference(tasks)
    vgangs = assign_priorities(interference_aware(tasks, N_LANES, intf))
    print("formed:", ", ".join(
        f"{vg.name} (prio {vg.prio}, width {vg.width})" for vg in vgangs))

    policy = VirtualGangPolicy(vgangs, n_cores=N_LANES, interference=intf,
                               auto_prio=False,
                               rtg_throttle=args.rtg_throttle
                               or args.reclaim,
                               reclaim=args.reclaim)
    lanes = Lanes(dev, N_LANES)
    errors = []
    fns = {"perception": device_step(96, dev, lanes, errors),
           "fusion": device_step(112, dev, lanes, errors),
           "planner": device_step(144, dev, lanes, errors)}
    ex = policy.build_executor(
        fns, regulation_interval_s=0.010,
        bytes_per_quantum={n: 2e6 for n in fns}
        if policy.rtg_throttle else None)
    ex.submit_be(BEJob("analytics", lambda lane: time.sleep(3e-4),
                       lanes=tuple(range(N_LANES)),
                       bytes_per_quantum=5e5))
    stats = ex.run(args.duration)
    if errors:
        raise errors[0]
    stats["invariant_ok"] = ex.sched.check_invariant()

    rta = schedulable_vgangs(vgangs, intf, blocking=10.0)
    print(f"gang invariant holds: {stats['invariant_ok']}; "
          f"acquisitions={stats['acquisitions']} "
          f"preemptions={stats['preemptions']} "
          f"rt_stalls={stats['rt_stalls']} "
          f"reclaimed={stats['reclaimed_bytes']:.3g}")
    for vg in vgangs:
        wcrt = rta[vg.name]["wcrt"]
        bound = "divergent" if wcrt is None else f"{wcrt:.2f} ms"
        for m in vg.members:
            rts = stats["response_times"][m.name]
            worst = max(rts) * 1e3 if rts else float("nan")
            print(f"  {m.name:10s} jobs={len(rts):3d} "
                  f"worst={worst:6.2f} ms  "
                  f"rta[{vg.name}]={bound}")
    print(f"analytics best-effort quanta: {stats['be_quanta']['analytics']}"
          f" (admitted within the running gang's budget)")
    return stats


if __name__ == "__main__":
    main()
