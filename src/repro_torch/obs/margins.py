"""RTA-margin accounting (DESIGN.md §12.3).

Soundness as a *measured* property: every completed job's response time
is compared against its policy's analytic bound (vgang RTA,
RTG-throttle duty-cycle bound, reclaim pricing, enforced-equivalent
WCET — whichever priced the run), the slack ``bound - response`` is
observed into a per-task histogram, and a worst-observed-margin summary
flows into ``SimResult.rta_margins``, the vgang grid rows and the three
BENCH JSON files. A negative margin is an analysis-soundness violation
caught at observation time, not rediscovered at the next grid run.

Quantum-engine callers add their O(dt) discretization slop to the
bounds *before* handing them in (a completion is stamped at the end of
the quantum that drained it, up to one dt late); the event engine's
exact responses take the bounds as-is.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.obs.metrics import MetricsRegistry

# slack-histogram buckets (ms of margin; one negative bucket so a
# soundness violation is visible in the distribution, not only in min)
MARGIN_BOUNDS = (-1e-9, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0,
                 500.0)


def margin_summary(response_times: Dict[str, List[float]],
                   bounds: Dict[str, float],
                   metrics: Optional[MetricsRegistry] = None,
                   eps: float = 1e-9) -> Dict[str, Dict]:
    """Per-task margin summary for every task with a declared bound.

    Returns ``{task: {bound, jobs, worst_margin, mean_margin,
    negative}}`` where margin = bound - measured response (ms).
    ``negative`` counts responses beyond the bound by more than
    ``eps``. Tasks with a bound but no completions report
    ``jobs=0`` with null margins (not an error: a horizon shorter than
    one period is legitimate). When ``metrics`` is given, each margin
    is also observed into the ``rta.margin{gang=...}`` histogram and
    the worst margin into the ``rta.worst_margin{gang=...}`` gauge."""
    out: Dict[str, Dict] = {}
    for name in sorted(bounds):
        bound = bounds[name]
        rs = response_times.get(name) or []
        margins = [bound - r for r in rs]
        hist = None
        if metrics is not None and metrics.enabled:
            hist = metrics.histogram("rta.margin", bounds=MARGIN_BOUNDS,
                                     gang=name)
            for m in margins:
                hist.observe(m)
        worst = min(margins) if margins else None
        if metrics is not None and metrics.enabled and worst is not None:
            g = metrics.gauge("rta.worst_margin", gang=name)
            if g.value == 0.0 or worst < g.value:
                g.set(worst)
        out[name] = {
            "bound": bound,
            "jobs": len(margins),
            "worst_margin": worst,
            "mean_margin": (sum(margins) / len(margins)) if margins
            else None,
            "negative": sum(1 for m in margins if m < -eps),
        }
    return out


def merge_margins(into: Dict[str, Dict],
                  add: Dict[str, Dict]) -> Dict[str, Dict]:
    """Aggregate per-task summaries across runs (the grid merges every
    sim-checked taskset's margins into one per-cell record). Tasks are
    pooled: the merged record keys stay per-task-name, with job counts
    summed and worst margins min-ed."""
    for name, rec in add.items():
        cur = into.get(name)
        if cur is None:
            into[name] = dict(rec)
            continue
        jobs = cur["jobs"] + rec["jobs"]
        worsts = [w for w in (cur["worst_margin"], rec["worst_margin"])
                  if w is not None]
        means = [(cur["mean_margin"], cur["jobs"]),
                 (rec["mean_margin"], rec["jobs"])]
        tot = sum(m * n for m, n in means if m is not None)
        cur.update({
            "jobs": jobs,
            "worst_margin": min(worsts) if worsts else None,
            "mean_margin": (tot / jobs) if jobs else None,
            "negative": cur["negative"] + rec["negative"],
        })
    return into


def overall(summaries: Dict[str, Dict]) -> Dict:
    """Roll one margin-summary dict up to a single record (the BENCH
    files carry both the per-task table and this headline)."""
    worsts = [r["worst_margin"] for r in summaries.values()
              if r["worst_margin"] is not None]
    return {"tasks": len(summaries),
            "jobs": sum(r["jobs"] for r in summaries.values()),
            "worst_margin": min(worsts) if worsts else None,
            "negative": sum(r["negative"] for r in summaries.values())}
