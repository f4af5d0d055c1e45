"""Executor-side virtual gangs on the port, end to end (DESIGN.md §2.4):
formed vgangs of device quanta driven through the port's GangExecutor in
three or four modes, with measured response times cross-checked against
the vgang RTA bounds. The executor bench of the JAX package
(``benchmarks/bench_executor_vgang.py``) with its members, budgets,
declared bytes, modes, periods rule and checks, on CUDA streams.

Workload: five real-time gangs (cam / lidar / imu / dnn / plan, a
DeepPicar-style fleet mix) whose quanta run ``x = tanh(x @ x) * 0.5``
three times on an (n, n) f32 tensor (TF32 off), n from 64 to 160. Every
quantum runs on its lane's CUDA stream and ends when that stream has
drained (``device.Lanes.quantum``); a quantum that raises fails the run.
WCETs are calibrated on the same wrapped quanta the executor runs (solo
max x a safety margin, after every member ran on every lane's stream
from as many threads as there are lanes), and the periods derived from
them.

Modes:
  solo   — singleton vgangs: plain RT-Gang, one real gang at a time;
  vgang  — interference-aware formation (3 virtual gangs), dispatched
           through VirtualGangPolicy.build_executor with
           min-over-live-member lane budgets;
  rtgT   — same formation under RTG-throttle: critical-member lanes
           uncapped, sibling lanes (and BE fillers) admission-capped at
           rtg_sibling_budget, sibling quanta charged bytes_per_quantum
           (the declared SIBLING_BYTES: no cost estimate measures them);
  rtgT+dr (with --reclaim) — rtgT plus mid-window bandwidth donation
           (DESIGN.md §7.5). rt_stalls 0 / reclaimed 0 is the expected
           steady state (releases land on window boundaries); the mode
           checks that the reclaiming dispatch keeps every bound and
           invariant.

Checks (the script exits nonzero if any fails):
  * gang invariant: at no sampled instant do two distinct gang
    priorities hold lanes (``check_invariant`` + in-flight snapshots);
  * budget ordering: while a vgang is fully in flight and leads the
    glock, the free lane's enforced budget equals that vgang's floor;
  * RTA soundness: every member's measured response time <= its
    vgang/rta.py bound (wcrt with blocking B_i) plus one quantum; the
    rtgT bound adds the admission-quantization window slop. The
    blocking term carries a dispatch-jitter allowance (--jitter,
    default 60 ms) for the OS wakeup latency of the worker threads;
  * no quantum raised.

On the card each quantum also records a CUDA event at its start and one
at its end on its lane's stream, timed against one reference event per
mode: ``device_quanta`` holds these intervals, and ``device_overlap``
counts the quanta of different vgangs that overlap on the device (the
gang invariant where the work runs) and how long members of one vgang
ran side by side. Each member's first response is reported beside its
max: the lanes are new threads in every mode.

    python -m repro_torch.benchmarks.bench_executor_vgang [--device cpu]
        [--smoke] [--reclaim] [--out PATH] [--duration S] [--margin M]
        [--jitter MS]

Without ``--device cpu`` it runs on the card and raises where there is
none. It writes ``BENCH_executor_vgang_torch.json`` (the JAX bench's file
stays its own).
"""
from __future__ import annotations

import argparse
import math
import os
import sys
import threading
import time
from typing import Dict, List, Optional

import torch

from repro_torch.benchmarks.report import ROOT, device_info, write_bench_json
from repro_torch.core.executor import BEJob
from repro_torch.core.gang import RTTask
from repro_torch.device import Lanes, resolve_device, synchronize
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.vgang.family import get_family
from repro_torch.vgang.formation import (intensity_interference,
                                         rtg_sibling_budget)

N_LANES = 4
INTERVAL_S = 0.010            # regulation window (wall seconds)
INTERVAL_MS = INTERVAL_S * 1e3   # task-time ms (time_scale = 1e-3)
GAMMA = 0.5

# name -> (matrix size, width, memory intensity, budget bytes/window).
# cam/lidar/imu pack into one low-intensity virtual gang: lidar (largest
# inflated WCET) is its critical member, cam and imu its regulated
# siblings (the JAX bench's mix, unchanged).
MEMBERS = {
    "cam":   (96, 1, 0.10, 8e6),
    "lidar": (112, 1, 0.15, 6e6),
    "imu":   (64, 1, 0.12, 8e6),
    "dnn":   (160, 3, 0.70, 8e6),
    "plan":  (128, 2, 0.40, 4e6),
}
# rtgT: bytes one quantum of each member charges against its lane cap
# (declared, as in the JAX bench; not measured).
SIBLING_BYTES = {"cam": 4e6, "lidar": 3e6, "imu": 1e6,
                 "dnn": 3e6, "plan": 3e6}
BE_BYTES = 5e5                # filler quantum traffic
RT_PRIORITY = 10              # SCHED_RR priority of the CPU bench's lanes

# bench mode -> registry policy family (vgang/family.py); the three vgang
# modes share one formed object via the families' common form_key
MODE_FAMILY = {"solo": "rtgang", "vgang": "intfaware",
               "rtgT": "rtgT", "rtgT+dr": "rtgT+dr"}
# rtgT+dr keeps the static rtgT pricing: the reclaim bound's guaranteed
# donations assume donor-lane quota is unspent, which the BE fillers
# (charging the same lane caps) violate; the static bound stays sound
# under the reclaiming dispatch (DESIGN.md §7.5)
PRICING_FAMILY = {"rtgT+dr": "rtgT"}


class Quanta:
    """The members' device quanta on one device: one CUDA stream per lane
    (``device.Lanes``), every exception kept in ``errors``, and, on the
    card while ``timeline`` is a list, each quantum's start and end CUDA
    events on its lane's stream appended to it."""

    def __init__(self, device, n_lanes: int = N_LANES):
        self.device = device
        self.lanes = Lanes(device, n_lanes)
        self.n_lanes = n_lanes
        self.errors: List[BaseException] = []
        self.timeline: Optional[list] = None

    def make_step(self, name: str, n: int):
        """A quantum: ``x = tanh(x @ x) * 0.5`` three times on an (n, n)
        f32 tensor, on the lane's stream, ending when the stream drains."""
        x0 = torch.full((n, n), 0.01, dtype=torch.float32,
                        device=self.device)
        synchronize(self.device)      # x0 was made on another stream
        timing = self.device.type == "cuda"

        def body(lane, idx):
            tl = self.timeline
            if timing and tl is not None:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            x = x0
            for _ in range(3):
                x = torch.tanh(x @ x) * 0.5
            if timing and tl is not None:
                end.record()
                tl.append((name, lane, start, end))
        return self.lanes.quantum(body, self.errors)

    def warm(self, steps: Dict[str, object]) -> None:
        """Run every member on every lane's stream from ``n_lanes``
        threads at once: the executor's lanes are new threads, and a
        thread's first product on a stream may set up a cuBLAS handle
        and workspace (returned to the pool when the thread ends)."""
        card = self.device.type == "cuda"
        index = (self.device.index if self.device.index is not None
                 else torch.cuda.current_device()) if card else None

        def sweep():
            if card:                  # a new thread has no current context
                torch.cuda.set_device(index)
            for step in steps.values():
                for lane in range(self.n_lanes):
                    step(lane, 0)
        threads = [threading.Thread(target=sweep)
                   for _ in range(self.n_lanes)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        sweep()                       # and from this thread
        if self.errors:
            raise self.errors[0]


def calibrate(step, reps: int = 12, clock=time.perf_counter) -> float:
    """Solo per-quantum time of the wrapped quantum on ``clock`` (max over
    reps, seconds)."""
    best = 0.0
    for _ in range(reps):
        t0 = clock()
        step(0, 0)
        best = max(best, clock() - t0)
    return best


def build_taskset(margin: float, quanta: Quanta):
    steps = {name: quanta.make_step(name, n)
             for name, (n, _, _, _) in MEMBERS.items()}
    quanta.warm(steps)
    # on the card a quantum costs its wall time (launches, the stream's
    # drain). On the CPU a lane is a host thread running the products
    # itself (one intra-op thread), and on a loaded host the OS takes the
    # core away for whole time slices (4 ms and more): a wall-clock max
    # then prices a member at a slice it happened to lose, the formation
    # follows that noise, and descheduling is already what the blocking
    # term's jitter allowance covers. So the CPU calibrates on the
    # thread's CPU time.
    clock = time.thread_time if quanta.device.type == "cpu" \
        else time.perf_counter
    quanta_s = {name: calibrate(step, clock=clock)
                for name, step in steps.items()}
    wcet_ms = {name: max(margin * q * 1e3, 2.0)
               for name, q in quanta_s.items()}
    # periods from the calibrated WCETs: total utilization <= ~1/3,
    # every period a multiple of the regulation window (rtgT RTA needs
    # window-aligned releases), plan at the double period; the 160 ms
    # floor keeps the five-singleton solo RTA feasible when the WCETs
    # are small beside the blocking + dispatch-jitter term
    S = sum(wcet_ms.values())
    p1 = math.ceil(max(160.0, 3.0 * S) / INTERVAL_MS) * INTERVAL_MS
    periods = {"cam": p1, "lidar": p1, "imu": p1, "dnn": p1,
               "plan": 2 * p1}
    tasks = [RTTask(name, wcet=wcet_ms[name], period=periods[name],
                    cores=tuple(range(w)), prio=0,
                    mem_intensity=s, mem_budget=b)
             for name, (_, w, s, b) in MEMBERS.items()]
    return tasks, steps, quanta_s, wcet_ms


def instrumented(name, step, ctx):
    """Wrap a member quantum with the gang-invariant and budget-ordering
    probes (reads executor state from ``ctx``, which is filled in after
    build_executor)."""
    def fn(lane, idx):
        ex = ctx["ex"]
        inflight = dict(ex._inflight)
        if len(set(inflight.values())) > 1:
            ctx["invariant_violations"] += 1
        g = ex.sched.g
        # budget writes happen inside the gang-change hook under g.lock,
        # so sampling leader + enforced budget under the same lock is a
        # consistent snapshot
        with g.lock:
            leader_prio = g.leader.prio if g.leader is not None else None
            live = sum(1 for t in g.gthreads if t is not None)
            enforced = ex.reg.cores[ctx["free_lane"]].budget
        my_prio, width, floor = ctx["gang_of"][name]
        if leader_prio == my_prio and live == width:
            if enforced > floor + 1e-6:
                ctx["budget_violations"] += 1
        step(lane, idx)
    return fn


def run_mode(mode, vgangs, steps, intf, duration_s, quanta: Quanta,
             be_bytes=BE_BYTES):
    fam = get_family(MODE_FAMILY[mode])
    policy = fam.make_policy(vgangs, N_LANES, intf)
    ctx = {"ex": None, "invariant_violations": 0,
           "budget_violations": 0, "free_lane": N_LANES - 1,
           "gang_of": {}}
    for vg in policy.vgangs:
        floor = min(m.mem_budget for m in vg.members)
        if fam.throttled:
            floor = min(floor, rtg_sibling_budget(vg, intf, INTERVAL_S))
        for m in vg.members:
            ctx["gang_of"][m.name] = (vg.prio, vg.width, floor)
    fns = {name: instrumented(name, step, ctx)
           for name, step in steps.items()}
    bpq = dict(SIBLING_BYTES) if fam.throttled else None
    ex = policy.build_executor(fns, regulation_interval_s=INTERVAL_S,
                               bytes_per_quantum=bpq,
                               metrics=MetricsRegistry())
    assert all(max(m.cores) < ctx["free_lane"]
               for m in policy.taskset()), "free lane must stay BE-only"
    ex.submit_be(BEJob("be_fill", lambda lane: time.sleep(3e-4),
                       lanes=tuple(range(N_LANES)),
                       bytes_per_quantum=be_bytes))
    ctx["ex"] = ex
    ref = None
    if quanta.device.type == "cuda":
        synchronize(quanta.device)
        ref = torch.cuda.Event(enable_timing=True)
        ref.record()
        quanta.timeline = []
    stats = ex.run(duration_s)
    stats["invariant_ok"] = ex.sched.check_invariant()
    intervals = []
    if ref is not None:
        synchronize(quanta.device)
        intervals = [{"name": name, "lane": lane,
                      "start_ms": ref.elapsed_time(a),
                      "end_ms": ref.elapsed_time(b)}
                     for name, lane, a, b in quanta.timeline]
        quanta.timeline = None
    return policy, ctx, stats, intervals


def device_overlap(intervals: List[dict], vgang_of: Dict[str, str]
                   ) -> dict:
    """From per-quantum device intervals: the pairs of quanta of
    different vgangs that overlap (``cross_pairs``, ``cross_ms``: the gang
    invariant on the device), and how long quanta of different members of
    one vgang ran side by side (``same_ms``) beside the busy time of the
    members of multi-member vgangs (``same_busy_ms``)."""
    ivs = sorted(intervals, key=lambda q: q["start_ms"])
    sizes: Dict[str, int] = {}
    for v in vgang_of.values():
        sizes[v] = sizes.get(v, 0) + 1
    cross_pairs, cross_ms, same_pairs, same_ms = 0, 0.0, 0, 0.0
    for i, a in enumerate(ivs):
        for b in ivs[i + 1:]:
            if b["start_ms"] >= a["end_ms"]:
                break
            both = min(a["end_ms"], b["end_ms"]) - b["start_ms"]
            if both <= 0:
                continue
            va, vb = vgang_of[a["name"]], vgang_of[b["name"]]
            if va != vb:
                cross_pairs += 1
                cross_ms += both
            elif a["name"] != b["name"]:
                same_pairs += 1
                same_ms += both
    same_busy = sum(q["end_ms"] - q["start_ms"] for q in ivs
                    if sizes[vgang_of[q["name"]]] > 1)
    return {"quanta": len(ivs), "cross_pairs": cross_pairs,
            "cross_ms": cross_ms, "same_pairs": same_pairs,
            "same_ms": same_ms, "same_busy_ms": same_busy,
            "same_share": same_ms / same_busy if same_busy else 0.0}


def bounds_for(mode, policy, intf, b_ms):
    # the family whose analytic bound prices this mode
    fam = get_family(PRICING_FAMILY.get(mode, MODE_FAMILY[mode]))
    rta = fam.bounds(policy.vgangs, intf, interval=INTERVAL_MS,
                     blocking=b_ms)
    # executor admission is quantum-grained and the wall-clock
    # regulator's windows are not phase-locked to releases: one window
    # of quantization plus one of release-vs-window misalignment
    slop = 2.0 * INTERVAL_MS if fam.throttled else 0.0
    out = {}
    for vg in policy.vgangs:
        wcrt = rta[vg.name]["wcrt"]
        for m in vg.members:
            out[m.name] = {
                "vgang": vg.name, "ok": rta[vg.name]["ok"],
                "bound_ms": None if wcrt is None else wcrt + slop}
    return out


# config fields this surface exposes as flags (DESIGN.md §14.2), as the
# JAX bench exposes them
BENCH_EXEC_FLAG_PATHS = ("smoke", "duration_s", "margin", "jitter_ms",
                         "policy.reclaim", "output.out")
BENCH_EXEC_FLAG_ALIASES = {"duration_s": "--duration",
                           "jitter_ms": "--jitter"}
BENCH_EXEC_FLAG_HELPS = {
    "smoke": "short CI run (~1.2 s per mode)",
    "duration_s": "seconds per mode (default: 12 plan periods)",
    "margin": "WCET safety factor over the calibrated quantum",
    "jitter_ms": "dispatch-jitter allowance folded into the blocking "
                 "term (ms of OS thread-wakeup latency outside the task "
                 "model)",
    "policy.reclaim": "add the rtgT+dr mode: RTG-throttle with "
                      "mid-window bandwidth donation (DESIGN.md §7.5)",
    "output.out": "output JSON path (default "
                  "BENCH_executor_vgang_torch.json)",
}


def resolve_bench_executor_config(argv=None):
    """(config, device) from the command line: the JAX bench's flags plus
    ``--device`` (default: the card)."""
    from repro_torch.experiment import (ExperimentConfig, add_flags,
                                        cli_main,
                                        default_bench_executor_config,
                                        derive_flags)
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    base = default_bench_executor_config()
    flags = derive_flags(ExperimentConfig, BENCH_EXEC_FLAG_PATHS,
                         aliases=BENCH_EXEC_FLAG_ALIASES,
                         helps=BENCH_EXEC_FLAG_HELPS)
    add_flags(ap, flags, base)
    cfg = cli_main(ap, flags, base, argv, expected_kind="bench_executor")
    return cfg, ap.parse_args(argv).device


def realtime_lanes():
    """Run this thread, and so every lane thread the executor starts from
    it (threads inherit the policy), under ``SCHED_RR`` where the OS
    allows it, as RT-Gang runs its real-time tasks. Returns the policy and
    parameters to restore, or None where the OS refuses."""
    try:
        old = (os.sched_getscheduler(0), os.sched_getparam(0))
        os.sched_setscheduler(0, os.SCHED_RR, os.sched_param(RT_PRIORITY))
    except (AttributeError, OSError):
        return None
    return old


def main(argv=None) -> int:
    cfg, device = resolve_bench_executor_config(argv)
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    if dev.type != "cpu":
        return run(cfg, dev)
    # on the CPU a lane is one host thread: concurrent lanes whose
    # products each fan out over every intra-op thread oversubscribe the
    # cores, and the calibrated WCETs (hence periods and durations) blow
    # up on a busy host. Beside other processes that keep every core busy,
    # a lane thread of normal priority also waits 100-300 ms for a core
    # after its release, past the jitter allowance: the lanes run as
    # real-time threads where the OS lets them
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    policy = realtime_lanes()
    try:
        return run(cfg, dev)
    finally:
        torch.set_num_threads(threads)
        if policy is not None:
            os.sched_setscheduler(0, *policy)


def run(cfg, dev) -> int:
    out_path = cfg.output.out or str(ROOT / "BENCH_executor_vgang_torch.json")

    quanta = Quanta(dev)
    tasks, steps, quanta_s, wcet_ms = build_taskset(cfg.margin, quanta)
    intf = intensity_interference(tasks, gamma=GAMMA)
    # blocking B_i: one non-preemptible quantum of any other gang (the
    # declared WCET bounds the measured quantum) plus one best-effort
    # filler quantum, plus the dispatch-jitter allowance
    b_ms = max(wcet_ms.values()) + 5.0 + cfg.jitter_ms

    mode_names = ["solo", "vgang", "rtgT"]
    if cfg.policy.reclaim:
        mode_names.append("rtgT+dr")
    # one formation per form_key: vgang/rtgT/rtgT+dr all analyze and
    # dispatch the identical intfaware formed object
    formed_of_key, modes = {}, {}
    for mode in mode_names:
        fam = get_family(MODE_FAMILY[mode])
        if fam.form_key not in formed_of_key:
            formed_of_key[fam.form_key] = fam.assign(
                fam.form(tasks, N_LANES, intf))
        modes[mode] = formed_of_key[fam.form_key]
    assert len(modes["vgang"]) == 3, [vg.name for vg in modes["vgang"]]
    plan_period_s = max(t.period for t in tasks) * 1e-3
    duration = cfg.duration_s or max(
        (1.2 if cfg.smoke else 2.5), (6 if cfg.smoke else 12)
        * plan_period_s)

    report = {"device": device_info(dev), "n_lanes": N_LANES,
              "interval_s": INTERVAL_S, "margin": cfg.margin,
              "duration_s": duration,
              "quanta_ms": {n: q * 1e3 for n, q in quanta_s.items()},
              "wcet_ms": wcet_ms, "blocking_ms": b_ms,
              "periods_ms": {t.name: t.period for t in tasks},
              "bytes": {"sibling_bytes": SIBLING_BYTES,
                        "be_bytes": BE_BYTES, "declared": True},
              "modes": {}}
    failures = []
    for mode, vgangs in modes.items():
        policy, ctx, stats, intervals = run_mode(mode, vgangs, steps, intf,
                                                 duration, quanta)
        if quanta.errors:
            failures.append(f"{mode}: a quantum raised "
                            f"{quanta.errors[0]!r}")
            break
        bnd = bounds_for(mode, policy, intf, b_ms)
        members = {}
        for name in steps:
            rts = stats["response_times"].get(name, [])
            bound_ms = bnd[name]["bound_ms"]
            max_s = max(rts) if rts else None
            entry = {
                "vgang": bnd[name]["vgang"], "jobs": len(rts),
                "max_response_ms": None if max_s is None
                else max_s * 1e3,
                "first_response_ms": rts[0] * 1e3 if rts else None,
                "rta_bound_ms": bound_ms, "rta_ok": bnd[name]["ok"],
                # slack of the worst observed job against the bound
                "worst_margin_ms": (None if bound_ms is None
                                    or max_s is None
                                    else bound_ms - max_s * 1e3),
                "negative": (0 if bound_ms is None else sum(
                    1 for r in rts if r * 1e3 > bound_ms + 1e-9)),
            }
            if not bnd[name]["ok"] or bound_ms is None:
                failures.append(f"{mode}:{name} RTA verdict not ok")
            elif not rts:
                failures.append(f"{mode}:{name} recorded no responses")
            elif max_s * 1e3 > bound_ms:
                failures.append(
                    f"{mode}:{name} response {max_s * 1e3:.2f} ms "
                    f"exceeds bound {bound_ms:.2f} ms")
            members[name] = entry
        if ctx["invariant_violations"] or not stats["invariant_ok"]:
            failures.append(
                f"{mode}: {ctx['invariant_violations']} gang-invariant "
                f"violations")
        if ctx["budget_violations"]:
            failures.append(
                f"{mode}: {ctx['budget_violations']} budget-ordering "
                f"violations")
        worsts = [e["worst_margin_ms"] for e in members.values()
                  if e["worst_margin_ms"] is not None]
        row = report["modes"][mode] = {
            "vgangs": [vg.name for vg in policy.vgangs],
            "members": members,
            "rta_margin": {
                "jobs": sum(e["jobs"] for e in members.values()),
                "worst_margin_ms": min(worsts) if worsts else None,
                "negative": sum(e["negative"]
                                for e in members.values()),
            },
            "metrics": stats.get("metrics"),
            "invariant_violations": ctx["invariant_violations"],
            "budget_violations": ctx["budget_violations"],
            "rt_stalls": stats["rt_stalls"],
            "be_quanta": stats["be_quanta"],
            "acquisitions": stats["acquisitions"],
            "preemptions": stats["preemptions"],
            "ipis": stats["ipis"],
            "reclaimed_bytes": stats["reclaimed_bytes"],
        }
        if intervals:
            vgang_of = {m: e["vgang"] for m, e in members.items()}
            row["device_overlap"] = device_overlap(intervals, vgang_of)
            row["device_quanta"] = intervals
        print(f"[{mode:7s}] vgangs={[vg.name for vg in policy.vgangs]} "
              f"inv={ctx['invariant_violations']} "
              f"budget={ctx['budget_violations']} "
              f"stalls={stats['rt_stalls']} "
              f"reclaimed={stats['reclaimed_bytes']:.3g}"
              + (f" device cross-vgang overlaps="
                 f"{row['device_overlap']['cross_pairs']}"
                 if intervals else ""))
        for name, e in members.items():
            print(f"    {name:6s} jobs={e['jobs']:3d} "
                  f"first={e['first_response_ms'] and round(e['first_response_ms'], 2)} ms "
                  f"max={e['max_response_ms'] and round(e['max_response_ms'], 2)} ms "
                  f"bound={e['rta_bound_ms'] and round(e['rta_bound_ms'], 2)} ms")

    report["ok"] = not failures
    report["failures"] = failures
    mode_margins = [m["rta_margin"] for m in report["modes"].values()]
    worsts = [m["worst_margin_ms"] for m in mode_margins
              if m["worst_margin_ms"] is not None]
    report["rta_margin"] = {
        "jobs": sum(m["jobs"] for m in mode_margins),
        "worst_margin_ms": min(worsts) if worsts else None,
        "negative": sum(m["negative"] for m in mode_margins),
    }
    write_bench_json(out_path, report, config=cfg)
    print(f"wrote {out_path}")
    if failures:
        print("FAILURES:")
        for msg in failures:
            print(f"  - {msg}")
        return 1
    print("all modes: 0 violations, every response within its RTA bound")
    return 0


if __name__ == "__main__":
    sys.exit(main())
