"""One run of one cell: set-up, the measured window, the metrics, and the
comparison with the plain reference once the program's state is freed."""
from __future__ import annotations

import dataclasses
import gc
import math
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from gangbench.harness import catalog, checks, profile
from gangbench.harness import weights as W
from gangbench.harness.gang import Hog, run_window
from gangbench.harness.model import DTYPES
from gangbench.harness.spans import Spans
from gangbench.harness.stats import percentile


@dataclasses.dataclass
class RunData:
    """What the metric readers read."""
    cell: str
    model: dict               # the configuration's "model" object
    mix: dict                 # the traffic mix
    seconds: float            # the measured window [0, seconds)
    run_s: float              # the executor ran [0, run_s)
    spans: Spans
    response_s: List[float]   # RT job i's response, release i x period
    period_s: float
    requests: List[dict]      # due / admit / first (serving cells)
    leaf_spans: tuple
    token_spans: tuple
    device_kind: str
    trace: Optional[profile.DeviceTrace] = None

    def in_window(self, name: str):
        """Spans of ``name`` that ended inside the window."""
        return [s for s in self.spans.of(name) if s.t1 <= self.seconds]

    def prefills(self):
        """(span, batch, length) of each prefill that ended in the
        window."""
        return [(s, s.meta.get("batch", 1), s.meta["length"])
                for name in ("refill", "prefill")
                for s in self.in_window(name)]

    def decodes(self):
        """(span, positions of its tokens) of each decode step that ended
        in the window."""
        return [(s, s.meta["positions"]) for s in self.in_window("decode")]

    def released(self) -> List[float]:
        """Response times of every RT job released in the window; a job
        that never finished counts until the run's end."""
        n = math.ceil(self.seconds / self.period_s)
        out = list(self.response_s[:n])
        out += [self.run_s - i * self.period_s
                for i in range(len(out), n)]
        return out


def end_to_end(run: RunData, names: List[str], setup_s: float) -> dict:
    W_s = run.seconds
    out: Dict[str, float] = {}
    for name in names:
        if name == "rt_p95_ms":
            out[name] = percentile(run.released(), 95) * 1e3
        elif name == "ttft_p90_ms":
            due = [r for r in run.requests if r["due"] < W_s]
            ttft = [(r["first"] if r["first"] is not None else run.run_s)
                    - r["due"] for r in due]
            out[name] = percentile(ttft, 90) * 1e3
        elif name == "tokens_per_s":
            out[name] = sum(s.meta["tokens"] for n in run.token_spans
                            for s in run.in_window(n)) / W_s
        elif name == "be_gb_per_s":
            out[name] = len(run.in_window("hog")) \
                * run.mix["hog_declared_bytes"] / W_s / 1e9
        elif name == "setup_s":
            out[name] = setup_s
        else:
            raise KeyError(f"no end-to-end metric {name!r}")
    return out


def per_layer(run: RunData, names: List[str], bench_dir: Path) -> dict:
    out = {}
    for name in names:
        value = catalog.load_module("metrics", name, bench_dir).read(run)
        if value is not None:
            out[name] = float(value)
    return out


def run_cell(*, cell: str, config: dict, mix: dict, seed: int,
             seconds: float, trace: bool, device: torch.device,
             t_start: float, e2e: List[dict], layers: List[dict],
             bench_dir: Path = catalog.BENCH_DIR,
             control: bool = False) -> dict:
    """Run ``cell`` once. Returns the result object (without printing it):
    correct, attempted, failed, metrics, device, breakdown (traced), the
    checks, and with ``control`` the fp8 control's reading."""
    m = config["model"]
    ref = catalog.load_module("reference", config["reference"], bench_dir)
    spec = ref.param_spec(m)
    spans = Spans()
    drv = catalog.load_module("drivers", mix["driver"], bench_dir).Driver(
        model=m, mix=mix, seed=seed, seconds=seconds, device=device,
        spans=spans, spec=spec)
    drv.setup()
    hog = Hog(device, int(mix["hog_buffer_bytes"]))
    if hog.declared != int(mix["hog_declared_bytes"]):
        raise ValueError(f"the hog moves {hog.declared} B a quantum, the "
                         f"mix declares {mix['hog_declared_bytes']}")
    hog(0)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    gc.collect()
    gc.freeze()
    prof = profile.start() if trace and device.type == "cuda" else None
    setup_s = time.time() - t_start
    period_s = mix["period_ms"] / 1e3
    run_s = seconds + float(mix["drain_s"])
    out = run_window(device=device, rt_fn=drv.quantum, hog=hog, spans=spans,
                     seconds=seconds, drain_s=float(mix["drain_s"]),
                     period_s=period_s, interval_s=mix["regulation_ms"] / 1e3,
                     profiler=prof)
    gc.unfreeze()
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    run = RunData(
        cell=cell, model=m, mix=mix, seconds=seconds, run_s=run_s,
        spans=spans, response_s=out["stats"]["response_times"]["rt"],
        period_s=period_s, requests=drv.requests(),
        leaf_spans=drv.leaf_spans, token_spans=drv.token_spans,
        device_kind=torch.cuda.get_device_name(device) if cuda else "cpu")
    dev = {"platform": "gpu" if cuda else "cpu", "kind": run.device_kind,
           "count": 1, "memory_peak_bytes": int(peak)}
    result: Dict = {}
    if trace:
        if prof is not None:
            run.trace = profile.read(prof, out["marker_s"])
            dev["busy_s"] = profile.busy_s(run.trace, seconds)
            dev["window_s"] = float(seconds)
            result["breakdown"] = {
                "device_ops": profile.top_ops(run.trace, seconds),
                "idle_gaps": profile.idle_gaps(run.trace, spans.items,
                                               seconds, drv.leaf_spans)}
        values = per_layer(run, [x["name"] for x in layers], bench_dir)
        units = {x["name"]: x["unit"] for x in layers}
        # the same run's end-to-end numbers: against an untraced run's they
        # give the cost of the trace
        result["traced_end_to_end"] = end_to_end(
            run, [x["name"] for x in e2e], setup_s)
    else:
        values = end_to_end(run, [x["name"] for x in e2e], setup_s)
        units = {x["name"]: x["unit"] for x in e2e}
    metrics = {k: {"value": v, "unit": units[k]} for k, v in values.items()}
    attempted = drv.attempted(seconds)
    failed = sum(r["due"] < seconds and r["first"] is None
                 for r in run.requests)

    # the comparison, once the program's state is gone
    guarantee = {
        "be_budget": {"value": checks.budget_ratio(
            spans.items, float(hog.declared), float(hog.declared),
            mix["regulation_ms"] / 1e3), "limit": 1.0},
        "rt_overlap_ms": {"value": checks.rt_overlap_s(spans.items) * 1e3,
                          "limit": 0.0}}
    samples = drv.samples(int(mix["check"]["sample"]))
    drv.release()
    del drv, hog, out, prof
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    served_tokens = sum(len(s[2]) for s in samples)
    stats = checks.gap_stats(np.zeros(0))
    readings = {}
    if samples:
        w = W.draw(spec, seed, device, DTYPES[m["dtype"]])
        seqs = [(ids, n) for ids, n, _ in samples]
        ref_logits = ref.forward(m, w, seqs)
        stats = checks.gap_stats(checks.token_gaps(
            ref_logits, [s[2] for s in samples]))
        if control:
            low = ref.forward(m, w, seqs, precision="fp8")
            readings["control"] = checks.gap_stats(
                checks.control_gaps(ref_logits, low))
        del w, ref_logits
    lim = mix["check"]
    cks = {f"token_gap_{k}": {"value": checks.finite(stats[k]),
                              "limit": lim[f"token_gap_{k}"]}
           for k in ("max", "mean") if f"token_gap_{k}" in lim}
    cks["served_tokens"] = {"value": served_tokens,
                            "limit": lim["min_tokens"], "at_least": True}
    cks.update(guarantee)
    ok = all(checks.passes(c) for c in cks.values())
    if control:
        result["readings"] = dict(readings, program=stats)
    return {"correct": bool(ok), "attempted": int(attempted),
            "failed": int(failed), "metrics": metrics, "device": dev,
            **result, "checks": cks}
