"""Perfetto / Chrome-trace JSON export of ``core.tracing.Trace``
timelines (DESIGN.md §12.2) — the reproduction's answer to the paper's
KernelShark figures: open any sim, grid cell or executor bench run in
ui.perfetto.dev (or chrome://tracing).

Format: the stable Chrome "JSON Array"/"traceEvents" flavor —
``{"traceEvents": [...], "displayTimeUnit": "ms"}``. Trace timestamps
are milliseconds of simulated (or wall-clock) time; Chrome trace
``ts``/``dur`` are microseconds, so everything is scaled by 1e3 on the
way out and back.

Track layout:

* pid ``PID_CORES``   — one thread per core ("core 0" ... "core N-1"),
  "X" complete events per segment. ``cat``/``cname`` classify spans:
  gang execution (an ``rt_names`` member), best-effort, throttled
  (``throttled:<task>``), DEM-demoted (``dem:<task>``) and
  watchdog-aborted (``aborted:<key>``) windows color differently.
* pid ``PID_COUNTERS`` — "C" counter events: per-window bandwidth
  budget vs. used per core, donation-pool level under reclaim, and
  cumulative glock hold time (built by ``export_sim`` from the
  regulator's window history and the engines' gang-change log).
* pid ``PID_SPANS`` — "host spans": the ``obs.spans`` recorder's spans,
  one thread a lane ("lane N"; tid N + 1, tid 0 for spans recorded off
  any lane), nested "X" events (an instant has dur 0).

``segments_from_json`` and ``spans_from_json`` invert the core and the
span tracks exactly (the round-trip tests in tests/test_obs.py and
tests/test_torch_perfetto.py rely on them), and ``validate_chrome_trace``
is a dependency-free structural validator used by CI's smoke job.
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.obs.spans import Span

PID_CORES = 1
PID_COUNTERS = 2
PID_SPANS = 3
MS = 1000.0      # trace unit (ms) -> chrome unit (us)

# Perfetto's fixed color-name palette (cname); picked for contrast:
# gangs cycle through strong colors, BE is muted, pathology is loud.
GANG_CNAMES = ("thread_state_running", "rail_response", "rail_animation",
               "thread_state_runnable", "rail_load", "heap_dump_stack_frame")
CNAME_BE = "grey"
CNAME_THROTTLED = "terrible"          # red — the regulator stalled a core
CNAME_DEM = "bad"                     # orange — DEM-demoted execution
CNAME_ABORTED = "black"               # watchdog kill


def _classify(label: str, rt_names: Sequence[str]) -> Tuple[str, str]:
    """(cat, cname) for a segment label."""
    if label.startswith("throttled:"):
        return "throttle", CNAME_THROTTLED
    if label.startswith("dem:"):
        return "dem", CNAME_DEM
    if label.startswith("aborted:"):
        return "aborted", CNAME_ABORTED
    if label in rt_names:
        i = list(rt_names).index(label)
        return "gang", GANG_CNAMES[i % len(GANG_CNAMES)]
    return "be", CNAME_BE


def export_trace(trace, rt_names: Sequence[str] = (),
                 counters: Optional[Dict[str, List[Tuple[float, Dict]]]]
                 = None,
                 title: str = "repro",
                 spans: Sequence[Span] = (),
                 spans_origin: Optional[float] = None) -> Dict:
    """Chrome-trace dict for a ``core.tracing.Trace``.

    ``counters`` maps track name -> [(t_ms, {series: value}), ...];
    each becomes one "C" counter track (Perfetto stacks the series).
    ``spans`` (``obs.spans.Span``, monotonic seconds) become the "host
    spans" group, at ``spans_origin`` (the executor's ``_t0``, where the
    trace's time 0 lies; default: the earliest span's start). Spans that
    start before it are left out.
    """
    trace.finish_view()
    ev: List[Dict] = [
        {"ph": "M", "pid": PID_CORES, "tid": 0, "name": "process_name",
         "args": {"name": f"{title}: cores"}},
        {"ph": "M", "pid": PID_CORES, "tid": 0, "name": "process_sort_index",
         "args": {"sort_index": 0}},
    ]
    for c in range(trace.n_cores):
        ev.append({"ph": "M", "pid": PID_CORES, "tid": c,
                   "name": "thread_name", "args": {"name": f"core {c}"}})
    for s in trace.segments:
        if s.label is None:
            continue
        cat, cname = _classify(s.label, rt_names)
        # args carry the exact ms endpoints: the us-scaled ts/dur lose
        # the last float ulp, and the round-trip (segments_from_json)
        # must reconstruct Trace.segments exactly
        ev.append({"ph": "X", "pid": PID_CORES, "tid": s.core,
                   "name": s.label, "cat": cat, "cname": cname,
                   "ts": s.t0 * MS, "dur": (s.t1 - s.t0) * MS,
                   "args": {"t0_ms": s.t0, "t1_ms": s.t1}})
    if counters:
        ev.append({"ph": "M", "pid": PID_COUNTERS, "tid": 0,
                   "name": "process_name",
                   "args": {"name": f"{title}: counters"}})
        ev.append({"ph": "M", "pid": PID_COUNTERS, "tid": 0,
                   "name": "process_sort_index", "args": {"sort_index": 1}})
        for track in sorted(counters):
            for t, values in counters[track]:
                ev.append({"ph": "C", "pid": PID_COUNTERS, "tid": 0,
                           "name": track, "ts": t * MS,
                           "args": dict(values)})
    if spans:
        ev.extend(_span_events(spans, spans_origin, title))
    return {"traceEvents": ev, "displayTimeUnit": "ms"}


def _span_events(spans: Sequence[Span], origin: Optional[float],
                 title: str) -> List[Dict]:
    if origin is None:
        origin = min(s.t0 for s in spans)
    ev: List[Dict] = [
        {"ph": "M", "pid": PID_SPANS, "tid": 0, "name": "process_name",
         "args": {"name": f"{title}: host spans"}},
        {"ph": "M", "pid": PID_SPANS, "tid": 0, "name": "process_sort_index",
         "args": {"sort_index": 2}}]
    for ln in sorted({s.lane for s in spans},
                     key=lambda x: -1 if x is None else x):
        ev.append({"ph": "M", "pid": PID_SPANS,
                   "tid": 0 if ln is None else ln + 1,
                   "name": "thread_name",
                   "args": {"name": "off lane" if ln is None
                            else f"lane {ln}"}})
    for s in spans:
        if s.t0 < origin:
            continue
        # args carry the exact monotonic endpoints, for spans_from_json
        ev.append({"ph": "X", "pid": PID_SPANS,
                   "tid": 0 if s.lane is None else s.lane + 1,
                   "name": s.name, "cat": s.name.split(".")[0],
                   "ts": (s.t0 - origin) * 1e6, "dur": (s.t1 - s.t0) * 1e6,
                   "args": {"t0_s": s.t0, "t1_s": s.t1, "lane": s.lane,
                            "meta": dict(s.meta)}})
    return ev


# ---- counter-track builders (regulator history + gang-change log) ----

def bandwidth_tracks(history: Iterable[Tuple]) -> Dict[
        str, List[Tuple[float, Dict]]]:
    """Counter tracks from ``BandwidthRegulator.history`` samples.

    ``("window", t_end, core, used, limit)`` samples — one closed
    regulation window per core — become per-core ``bw core N`` tracks
    (used vs. budget, stepped at window ends); ``("draw", t, total)``
    samples become one cumulative ``reclaim drawn`` track.
    """
    out: Dict[str, List[Tuple[float, Dict]]] = {}
    for rec in history:
        if rec[0] == "window":
            _, t_end, core, used, limit = rec
            out.setdefault(f"bw core {core}", []).append(
                (t_end, {"used": used, "budget": limit}))
        elif rec[0] == "draw":
            _, t, total = rec
            out.setdefault("reclaim drawn", []).append(
                (t, {"bytes": total}))
    return out


def glock_track(gang_events: Iterable[Tuple[float, str, Optional[str]]]
                ) -> List[Tuple[float, Dict]]:
    """Cumulative glock-hold-time counter from the engines' gang-change
    log ``(t, event, leader_name)``. Hold time accrues from the acquire
    that made the lock held to the release/preempt that freed it;
    join/leave membership churn does not restart the clock."""
    out: List[Tuple[float, Dict]] = []
    held_ms = 0.0
    t_acq: Optional[float] = None
    for t, event, _leader in gang_events:
        if event == "acquire":
            if t_acq is None:
                t_acq = t
                out.append((t, {"held_ms": held_ms}))
        elif event in ("release", "preempt"):
            if t_acq is not None:
                held_ms += t - t_acq
                t_acq = None
                out.append((t, {"held_ms": held_ms}))
            if event == "preempt":   # successor acquires in the same pick
                t_acq = t
    return out


def export_sim(sim, result, title: str = "sim") -> Dict:
    """Export a finished Simulator run: core tracks from
    ``result.trace`` plus whatever counter history the run recorded
    (``record_counters=True`` at construction)."""
    counters = bandwidth_tracks(getattr(sim.reg, "history", None) or ())
    gl = glock_track(getattr(sim, "gang_events", None) or ())
    if gl:
        counters["glock held"] = gl
    return export_trace(result.trace,
                        rt_names=[t.name for t in sim.rt_tasks],
                        counters=counters, title=title)


# ---- validation / round-trip -----------------------------------------

def validate_chrome_trace(data) -> List[str]:
    """Structural validation of the traceEvents flavor; returns a list
    of problems (empty = valid). Dependency-free on purpose — CI runs
    this without jsonschema."""
    probs: List[str] = []
    per_lane: Dict = {}     # host spans' (t0_s, t1_s, index) by tid
    if not isinstance(data, dict) or "traceEvents" not in data:
        return ["top level must be an object with a traceEvents array"]
    evs = data["traceEvents"]
    if not isinstance(evs, list):
        return ["traceEvents must be an array"]
    for i, e in enumerate(evs):
        where = f"traceEvents[{i}]"
        if not isinstance(e, dict):
            probs.append(f"{where}: not an object")
            continue
        ph = e.get("ph")
        if ph not in ("X", "M", "C"):
            probs.append(f"{where}: unknown ph {ph!r}")
            continue
        if not isinstance(e.get("pid"), int):
            probs.append(f"{where}: pid must be an int")
        if not isinstance(e.get("name"), str) or not e.get("name"):
            probs.append(f"{where}: name must be a non-empty string")
        if ph == "M":
            if e.get("name") not in ("process_name", "thread_name",
                                     "process_sort_index"):
                probs.append(f"{where}: unknown metadata {e.get('name')!r}")
            if not isinstance(e.get("args"), dict):
                probs.append(f"{where}: metadata needs args")
            continue
        ts = e.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            probs.append(f"{where}: ts must be a non-negative number")
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                probs.append(f"{where}: dur must be a non-negative number")
            if not isinstance(e.get("tid"), int):
                probs.append(f"{where}: tid must be an int")
        if ph == "C":
            args = e.get("args")
            if not isinstance(args, dict) or not args or any(
                    not isinstance(v, (int, float))
                    for v in args.values()):
                probs.append(f"{where}: counter args must be a non-empty "
                             f"dict of numbers")
        if ph == "X" and e.get("pid") == PID_SPANS:
            args = e.get("args")
            if not isinstance(args, dict) or not all(
                    isinstance(args.get(k), (int, float))
                    for k in ("t0_s", "t1_s")) \
                    or args["t1_s"] < args["t0_s"]:
                probs.append(f"{where}: a host span needs args t0_s <= "
                             f"t1_s")
            else:
                per_lane.setdefault(e.get("tid"), []).append(
                    (args["t0_s"], args["t1_s"], i))
    for tid, items in per_lane.items():
        # the spans of one lane nest: each starts and ends inside every
        # span open when it starts
        items.sort(key=lambda x: (x[0], -x[1]))
        open_ends: List[float] = []
        for t0, t1, i in items:
            while open_ends and open_ends[-1] <= t0:
                open_ends.pop()
            if open_ends and t1 > open_ends[-1]:
                probs.append(f"traceEvents[{i}]: host span overlaps the "
                             f"span open on its lane (tid {tid})")
            open_ends.append(t1)
    return probs


def segments_from_json(data) -> List[Tuple[int, str, float, float]]:
    """Invert the core tracks: (core, label, t0_ms, t1_ms) tuples in
    (core, t0) order — comparable against ``Trace.segments`` (idle
    segments are never exported, so compare against the labeled
    ones)."""
    out = []
    for e in data["traceEvents"]:
        if e.get("ph") == "X" and e.get("pid") == PID_CORES:
            args = e.get("args") or {}
            if "t0_ms" in args and "t1_ms" in args:
                t0, t1 = args["t0_ms"], args["t1_ms"]
            else:          # foreign trace: fall back to the us scale
                t0 = e["ts"] / MS
                t1 = t0 + e["dur"] / MS
            out.append((e["tid"], e["name"], t0, t1))
    out.sort(key=lambda r: (r[0], r[2]))
    return out


def spans_from_json(data) -> List[Span]:
    """Invert the host-span tracks: ``obs.spans.Span`` tuples in the
    order they were exported."""
    return [Span(e["name"], e["args"]["lane"], e["args"]["t0_s"],
                 e["args"]["t1_s"], e["args"]["meta"])
            for e in data["traceEvents"]
            if e.get("ph") == "X" and e.get("pid") == PID_SPANS]


def write_chrome_trace(path: str, data: Dict) -> None:
    """Validate then write (CI's smoke job goes through this)."""
    probs = validate_chrome_trace(data)
    if probs:
        raise ValueError("invalid chrome trace: " + "; ".join(probs[:5]))
    with open(path, "w") as f:
        json.dump(data, f)
        f.write("\n")
