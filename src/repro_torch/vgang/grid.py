"""The virtual-gang acceptance-ratio evaluation grid (arXiv:1912.10959
§VI) on the exact event engine — the headline artifact: RT-Gang vs
virtual-gang acceptance curves.

Grid axes:

* machine size M in {4, 8, 16} cores;
* gang-width distribution: ``light`` (narrow gangs, w <= M/4), ``mixed``
  (w <= M/2), ``heavy`` (M/2 <= w <= M);
* total gang utilization level (the single-core-equivalent sum C_i/P_i
  — note plain RT-Gang can never accept a set above 1.0, while packed
  virtual gangs can, which is the entire point of the follow-up paper);
* policy: ``rtgang`` (singletons = the baseline), the formation
  heuristics ``ffd``, ``bestfit``, ``intfaware`` (formation.py),
  ``rtgT`` — RTG-throttle (arXiv:1912.10959 §IV-C): interference-aware
  formation dispatched with per-member bandwidth regulation (critical
  member unthrottled, siblings capped; sched.py) and priced by the
  duty-cycle RTA bound (rta.accepts_rtg_throttle). Its curve shows the
  cost of intra-gang isolation: it trails ``intfaware`` where sibling
  stalls stretch the gang, and protects the critical member's WCET in
  exchange. ``rtgT+dr`` adds dynamic reclaiming (DESIGN.md §7.5): a
  sibling finishing its job mid-window donates its unspent quota to
  stalled co-siblings, and acceptance is priced by
  min(static, reclaim_wcet) — the exchange gate keeps the static bound
  sound under donation, so this column dominates ``rtgT`` at every
  utilization level while recovering part of the isolation cost.
  ``part`` is strict partitioning (arXiv:2403.10726, DESIGN.md §15):
  gangs bin-packed into static core partitions, priced by
  partition-local uniprocessor RTA with cross-partition inflation —
  a structurally different answer to the same underutilization
  problem, interesting exactly where it crosses ``rtgT+dr``.

Every policy column is a ``PolicyFamily`` from the registry
(vgang/family.py); this module only iterates whatever families the
requested column labels name.

Per (M, dist, util) cell — one batched worker process per cell, like the
per-level batching of launch/sweep.py --schedulability — n random
tasksets are drawn (UUniFast utilizations, per-distribution widths,
random memory intensities feeding ``intensity_interference``), each
heuristic forms virtual gangs, and vgang RTA (rta.py) yields the
acceptance verdict. The first ``sim_check`` tasksets of every cell are
also run through the event engine under VirtualGangPolicy and checked
against the RTA verdict (RTA accept must imply a miss-free simulation —
soundness violations are counted and must be zero).

    PYTHONPATH=src python -m repro_torch.vgang.grid [--smoke] [--seed 0]
        [--cores 4,8,16] [--dists light,mixed,heavy] [--n 50]
        [--utils 0.4,0.8,...] [--heuristics ffd,bestfit,intfaware]
        [--sim-check 2] [--gamma 0.5] [--out results/vgang_torch]
        [--backend numpy|torch] [--device cuda|cpu]

Writes results/vgang_torch/grid_{M}c_{dist}.json per (M, dist) plus a
combined results/vgang_torch/summary.json (the JAX package's grid writes
results/vgang/).

The batched RTA runs on numpy unless ``--backend torch`` (or the config's
``engine.backend``) asks for the float64 torch backend
(analysis/batched_rta.py), which runs on the card, or on the host with
``--device cpu``. A torch run evaluates its cells in this process: a pool
worker forked after the parent touched CUDA cannot use the card, and the
card serves one process's shards in turn anyway.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import os
import random
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.gang import RTTask
from repro_torch.experiment import (ExperimentConfig, GRID_SMOKE_OVERRIDES,
                              add_flags, cli_main, default_grid_config,
                              derive_flags)
from repro_torch.launch.sweep import ROOT, taskset_seed, uunifast
from repro_torch.obs.margins import merge_margins, overall
# re-exported for the pre-registry import sites (the canonical homes of
# the column labels are vgang/family.py and experiment.py)
from repro_torch.vgang.family import (BASELINE_COLUMN, PART_COLUMN,  # noqa: F401
                                RECLAIM_COLUMN, RTG_COLUMN, get_family,
                                grid_columns)
from repro_torch.vgang.formation import intensity_interference

OUT_DEFAULT = os.path.join(ROOT, "results", "vgang_torch")

# gang-width distributions (paper §VI: light/mixed/heavy mixes)
def _width_light(rng: random.Random, m: int) -> int:
    return rng.randint(1, max(1, m // 4))


def _width_mixed(rng: random.Random, m: int) -> int:
    return rng.randint(1, max(1, m // 2))


def _width_heavy(rng: random.Random, m: int) -> int:
    return rng.randint(max(1, m // 2), m)


WIDTH_DISTS = {"light": _width_light, "mixed": _width_mixed,
               "heavy": _width_heavy}

PERIODS = (20.0, 40.0, 80.0)      # small pool -> same-period groups form


def random_vgang_taskset(rng: random.Random, n_cores: int, n_tasks: int,
                         total_util: float, dist: str = "mixed"
                         ) -> List[RTTask]:
    """Random gang taskset for the grid: UUniFast utilizations, widths
    from the named distribution, memory intensity in [0, 1] (drives the
    interference model and the interference-aware heuristic). Releases
    are synchronous (offset 0 = the critical instant) and priorities are
    provisional — formation reassigns them per virtual gang."""
    width_of = WIDTH_DISTS[dist]
    utils = uunifast(rng, n_tasks, total_util)
    tasks = []
    for i in range(n_tasks):
        period = rng.choice(PERIODS)
        width = width_of(rng, n_cores)
        wcet = max(utils[i] * period, 1e-3)
        tasks.append(RTTask(
            name=f"g{i}", wcet=wcet, period=period,
            cores=tuple(range(width)), prio=n_tasks - i,
            mem_intensity=rng.random()))
    return tasks


def n_tasks_for(n_cores: int) -> int:
    """More cores -> more gangs to pack (4 -> 5, 8 -> 7, 16 -> 11)."""
    return 3 + (n_cores + 1) // 2


@dataclasses.dataclass(frozen=True)
class GridCell:
    """One (cores, dist, util) pool-worker payload.  A typed payload —
    not a bare tuple — so a misspelled or stale field fails loudly at
    construction (``TypeError`` naming the unknown keyword) instead of
    silently shifting positional slots."""
    seed: int
    n_cores: int
    dist: str
    util: float
    n_sets: int
    # full ordered column list (family names, vgang/family.py); must
    # include the "rtgang" baseline — use grid_columns() to build it
    columns: Tuple[str, ...]
    sim_check: int
    gamma: float
    cycles: float
    scalar_rta: bool = False
    trace: bool = False
    dt: Optional[float] = None


def _grid_cell(cell: GridCell) -> Dict:
    """Pool worker: one (cores, dist, util) cell — all n tasksets, all
    heuristics, in one process.

    Three phases (DESIGN.md §13.3): (1) draw + form every taskset (the
    per-taskset rng streams are seeded by ``taskset_seed``, so the
    restructure cannot perturb them); (2) one shard-batched RTA call
    per policy column over all n tasksets at once
    (``batched_accepts`` / ``batched_accepts_rtg_throttle``,
    bit-identical to the scalar loop — ``cell.scalar_rta`` keeps the
    old per-taskset loop reachable for benchmarking); (3) the first
    ``sim_check`` tasksets get event-engine sim-checks (default
    ``trace=False`` — their verdicts come from the batched arrays, and
    the SimResult counters are trace-independent)."""
    (seed, n_cores, dist, util, n_sets, columns, sim_check, gamma,
     cycles, scalar_rta) = (
        cell.seed, cell.n_cores, cell.dist, cell.util, cell.n_sets,
        cell.columns, cell.sim_check, cell.gamma, cell.cycles,
        cell.scalar_rta)
    fams = {h: get_family(h) for h in columns}
    sim_accept = {h: 0 for h in columns}
    margins: Dict[str, Dict] = {h: {} for h in columns}
    sim_n = 0
    soundness_violations = 0
    util_gain = 0.0
    t0 = time.time()
    n_tasks = n_tasks_for(n_cores)
    # ---- phase 1: draw + form all n tasksets ------------------------
    drawn: List[Tuple[List[RTTask], object, Dict[str, object]]] = []
    for k in range(n_sets):
        rng = random.Random(taskset_seed(seed, k, util))
        tasks = random_vgang_taskset(rng, n_cores, n_tasks, util, dist)
        intf = intensity_interference(tasks, gamma)
        # form + assign once per distinct form_key: families sharing a
        # formation (rtgT and rtgT+dr both analyze the packed intfaware
        # set) share the *identical* assigned objects, so the rtgT
        # columns' static per-window bounds memoize across the two
        # columns (the cache keys on object identity)
        formed_of_key: Dict[str, object] = {}
        formed: Dict[str, object] = {}
        for h in columns:
            fam = fams[h]
            got = formed_of_key.get(fam.form_key)
            if got is None:
                got = fam.assign(fam.form(tasks, n_cores, intf))
                formed_of_key[fam.form_key] = got
            formed[h] = got
        # formation objective: utilization gain of the best packing vs
        # the singleton baseline (families without a comparable packing
        # objective — partition-kind — are excluded from the min)
        utils = {h: fams[h].utilization(formed[h], intf)
                 for h in columns if fams[h].utilization is not None}
        util_gain += utils["rtgang"] - min(utils.values())
        drawn.append((tasks, intf, formed))
    # ---- phase 2: one shard-batched RTA call per policy column ------
    # one-gang-at-a-time: only same-vgang members ever co-run, so intf
    # only enters through each vgang's inflated WCET (and inflates
    # nothing for the rtgang singleton baseline); the rtgT column
    # prices sibling regulation on top of that, rtgT+dr the reclaiming
    # dispatch (min(static, reclaim)), and part the partition-local
    # uniprocessor RTA with cross-partition inflation
    t_rta = time.time()
    intfs = [d[1] for d in drawn]
    wcet_cache: Dict = {}
    verdicts: Dict[str, List[bool]] = {}
    for h in columns:
        fam = fams[h]
        vsets = [d[2][h] for d in drawn]
        if scalar_rta:
            verdicts[h] = [bool(fam.verdict(v, i))
                           for v, i in zip(vsets, intfs)]
        else:
            verdicts[h] = fam.batched_verdict(vsets, intfs,
                                              wcet_cache=wcet_cache)
    accept = {h: sum(verdicts[h]) for h in columns}
    wall_rta = time.time() - t_rta
    # ---- phase 3: event-engine sim-checks (trace=False) -------------
    for k in range(min(sim_check, n_sets)):
        sim_n += 1
        tasks, intf, formed = drawn[k]
        for h in columns:
            fam = fams[h]
            rta_ok = verdicts[h][k]
            policy = fam.make_policy(formed[h], n_cores, intf)
            horizon = cycles * max(t.period for t in tasks)
            # accepted sets carry per-member analytic bounds into
            # the run: measured response vs bound (DESIGN.md §12.3)
            # rolls up into the per-cell rta_margin record, and a
            # negative margin is a soundness violation caught here
            bounds = policy.member_bounds() if rta_ok else None
            if bounds and any(b is None for b in bounds.values()):
                bounds = None
            sim_kw = {} if cell.dt is None else {"dt": cell.dt}
            r = policy.simulate(horizon, rta_bounds=bounds,
                                trace=cell.trace, **sim_kw)
            sim_ok = sum(r.deadline_misses.values()) == 0
            sim_accept[h] += sim_ok
            if rta_ok and not sim_ok:
                soundness_violations += 1
            if r.rta_margins:
                merge_margins(margins[h], r.rta_margins)
    return {
        "n_cores": n_cores, "dist": dist, "util": util, "n": n_sets,
        "accept": {h: c / n_sets for h, c in accept.items()},
        "sim_accept": ({h: c / sim_n for h, c in sim_accept.items()}
                       if sim_n else None),
        "sim_n": sim_n,
        "rta_margin": ({h: (overall(m) if m else None)
                        for h, m in margins.items()} if sim_n else None),
        "soundness_violations": soundness_violations,
        "mean_util_gain": round(util_gain / n_sets, 4),
        "wall_s": round(time.time() - t0, 3),
        "wall_rta_s": round(wall_rta, 4),
    }


def _skipped_row(cell: GridCell) -> Dict:
    """Placeholder row for a cell that failed/timed out twice: keeps the
    curve files structurally complete; consumers (print_curves, the
    plotting example) filter on the ``skipped`` flag."""
    n_cores, dist, util = cell.n_cores, cell.dist, cell.util
    return {"n_cores": n_cores, "dist": dist, "util": util, "n": 0,
            "accept": None, "sim_accept": None, "sim_n": 0,
            "rta_margin": None, "soundness_violations": 0,
            "mean_util_gain": None, "wall_s": None, "wall_rta_s": None,
            "skipped": True}


def _dispatch(cells: Sequence[GridCell], procs: int,
              cell_timeout: Optional[float],
              worker=_grid_cell) -> Tuple[List[Dict], List[Tuple]]:
    """Run the cell workers with per-cell hardening: a cell that exceeds
    ``cell_timeout`` seconds (or raises) is retried once in a fresh
    pool; a second failure skips the cell (placeholder row + log line)
    instead of hanging or killing the whole grid. ``worker`` is
    injectable for tests. With ``procs <= 1`` (in-process) a timeout
    cannot be enforced preemptively, so only the raise-retry applies."""
    out: Dict[int, Dict] = {}
    todo = list(range(len(cells)))
    pool = None
    try:
        for attempt in (0, 1):
            if not todo:
                break
            failed: List[int] = []
            if procs > 1:
                # the pool is reused across retry rounds; it is only
                # torn down and rebuilt when a cell *timed out* — a
                # timed-out worker is still running and must be reaped
                # (terminate), whereas a raising worker returned
                # normally and its process is fine to reuse
                timed_out = False
                if pool is None:
                    pool = multiprocessing.Pool(min(procs, len(todo)))
                asyncs = [(i, pool.apply_async(worker, (cells[i],)))
                          for i in todo]
                for i, a in asyncs:
                    try:
                        out[i] = a.get(cell_timeout)
                    except Exception as e:
                        is_to = isinstance(e, multiprocessing.TimeoutError)
                        timed_out = timed_out or is_to
                        print(f"grid: cell {cells[i].n_cores}c/"
                              f"{cells[i].dist}/u={cells[i].util} "
                              f"{'timed out' if is_to else f'failed ({e!r})'}"
                              f" (attempt {attempt + 1})",
                              file=sys.stderr)
                        failed.append(i)
                # a cell may have finished while we waited on a later
                # one: harvest before declaring it failed
                for i, a in asyncs:
                    if i in failed and a.ready():
                        try:
                            out[i] = a.get(0)
                            failed.remove(i)
                        except Exception:
                            pass
                if timed_out:
                    pool.terminate()
                    pool.join()
                    pool = None
            else:
                for i in todo:
                    try:
                        out[i] = worker(cells[i])
                    except Exception as e:
                        print(f"grid: cell {cells[i].n_cores}c/"
                              f"{cells[i].dist}/u={cells[i].util} "
                              f"failed ({e!r}) "
                              f"(attempt {attempt + 1})", file=sys.stderr)
                        failed.append(i)
            todo = failed
    finally:
        if pool is not None:
            pool.terminate()
            pool.join()
    skipped = [cells[i] for i in todo]
    for i in todo:
        out[i] = _skipped_row(cells[i])
        print(f"grid: cell {cells[i].n_cores}c/{cells[i].dist}/"
              f"u={cells[i].util} skipped after retry", file=sys.stderr)
    return [out[i] for i in range(len(cells))], skipped


def _margin_headline(results: Sequence[Dict]) -> Dict:
    """Grid-wide RTA-margin rollup for summary.json: jobs checked,
    worst observed margin (ms), and the negative count — which must be
    zero (a negative margin is a bound the measured run broke)."""
    recs = [rec for r in results if r.get("rta_margin")
            for rec in r["rta_margin"].values() if rec]
    worsts = [m["worst_margin"] for m in recs
              if m["worst_margin"] is not None]
    return {"jobs": sum(m["jobs"] for m in recs),
            "worst_margin": min(worsts) if worsts else None,
            "negative": sum(m["negative"] for m in recs)}


def _part_crossover(results: Sequence[Dict]) -> Dict:
    """The headline comparison for the strict-partitioning column:
    per-cell acceptance of ``part`` vs ``rtgT+dr`` — how many cells
    each side wins and the largest gaps either way (summary.json
    ``part_vs_reclaim``)."""
    wins, losses = [], []
    for r in results:
        acc = r.get("accept")
        if not acc or PART_COLUMN not in acc or RECLAIM_COLUMN not in acc:
            continue
        delta = acc[PART_COLUMN] - acc[RECLAIM_COLUMN]
        row = {"n_cores": r["n_cores"], "dist": r["dist"],
               "util": r["util"], PART_COLUMN: acc[PART_COLUMN],
               RECLAIM_COLUMN: acc[RECLAIM_COLUMN],
               "delta": round(delta, 4)}
        if delta > 1e-12:
            wins.append(row)
        elif delta < -1e-12:
            losses.append(row)
    wins.sort(key=lambda r: -r["delta"])
    losses.sort(key=lambda r: r["delta"])
    return {"cells_won": len(wins), "cells_lost": len(losses),
            "top_wins": wins[:3], "top_losses": losses[:3]}


def _grid_config(cores, dists, utils, heuristics, n_per_cell, sim_check,
                 gamma, cycles, seed, processes, out_dir, cell_timeout,
                 scalar_rta, trace, dt) -> ExperimentConfig:
    """The resolved ExperimentConfig a direct ``run_grid(...)`` call
    denotes — so programmatic runs stamp the same provenance digest a
    ``--config`` / legacy-CLI run with equal knobs would."""
    base = default_grid_config()
    return base.merged({
        "taskset": {"cores": list(cores), "dists": list(dists),
                    "utils": list(utils), "n_per_point": n_per_cell,
                    "gamma": gamma, "seed": seed},
        "policy": {"heuristics": list(heuristics)},
        "engine": {"sim_check": sim_check, "cycles": cycles,
                   "processes": processes or 0,
                   "cell_timeout": cell_timeout or 0.0,
                   "scalar_rta": scalar_rta, "trace": trace, "dt": dt},
        "output": {"out": None if out_dir == OUT_DEFAULT else out_dir},
    })


def run_grid(cores: Sequence[int] = (4, 8, 16),
             dists: Sequence[str] = ("light", "mixed", "heavy"),
             utils: Sequence[float] = (0.4, 0.7, 0.9, 1.0, 1.1, 1.2, 1.4,
                                       1.6, 2.0),
             heuristics: Sequence[str] = ("ffd", "bestfit", "intfaware",
                                          RTG_COLUMN, RECLAIM_COLUMN,
                                          PART_COLUMN),
             n_per_cell: int = 50, sim_check: int = 2, gamma: float = 0.5,
             cycles: float = 20.0, seed: int = 0,
             processes: Optional[int] = None,
             out_dir: str = OUT_DEFAULT,
             cell_timeout: Optional[float] = None,
             scalar_rta: bool = False,
             trace: bool = False, dt: Optional[float] = None,
             worker=_grid_cell,
             config: Optional[ExperimentConfig] = None) -> Dict:
    """Run the full grid; one batched worker per (cores, dist, util)
    cell; aggregate and write per-(cores, dist) curve files + summary.

    ``config`` is the resolved ExperimentConfig this run realizes (the
    CLI shell passes it down); when None one is synthesized from the
    arguments, so every summary/curve file carries a ``config_digest``
    regardless of entry point."""
    if config is None:
        config = _grid_config(cores, dists, utils, heuristics, n_per_cell,
                              sim_check, gamma, cycles, seed, processes,
                              out_dir, cell_timeout, scalar_rta, trace, dt)
    digest = config.content_digest()
    # resolve the requested labels against the family registry: the
    # singleton baseline always leads under its curve label "rtgang"
    # (so `--heuristics rtgang,ffd` means what it reads as), plain
    # formation heuristics keep request order, special policy columns
    # (rtgT, rtgT+dr, part) land last in canonical order; unknown
    # labels raise with the registered names
    columns = grid_columns(heuristics)
    cells = [GridCell(seed=seed, n_cores=m, dist=d, util=u,
                      n_sets=n_per_cell, columns=columns,
                      sim_check=sim_check, gamma=gamma, cycles=cycles,
                      scalar_rta=scalar_rta, trace=trace, dt=dt)
             for m in cores for d in dists for u in utils]
    procs = processes or min(multiprocessing.cpu_count(), 16, len(cells))
    procs = max(1, min(procs, len(cells)))
    t0 = time.time()
    results, skipped = _dispatch(cells, procs, cell_timeout, worker)

    summary = {"seed": seed, "gamma": gamma, "cycles": cycles,
               "n_per_cell": n_per_cell, "sim_check": sim_check,
               "heuristics": list(columns),
               "utils": list(utils),
               "config": config.to_dict(),
               "config_digest": digest,
               "soundness_violations": sum(r["soundness_violations"]
                                           for r in results),
               "rta_margin": _margin_headline(results),
               "skipped_cells": len(skipped),
               "wall_s": round(time.time() - t0, 3),
               "files": []}
    if PART_COLUMN in columns and RECLAIM_COLUMN in columns:
        summary["part_vs_reclaim"] = _part_crossover(results)
    os.makedirs(out_dir, exist_ok=True)
    for m in cores:
        for d in dists:
            rows = [r for r in results
                    if r["n_cores"] == m and r["dist"] == d]
            rows.sort(key=lambda r: r["util"])
            path = os.path.join(out_dir, f"grid_{m}c_{d}.json")
            with open(path, "w") as f:
                json.dump({"n_cores": m, "dist": d, "seed": seed,
                           "gamma": gamma, "config_digest": digest,
                           "rows": rows}, f, indent=1)
            summary["files"].append(os.path.relpath(path, ROOT))
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return {"summary": summary, "results": results}


def print_curves(results: List[Dict]) -> None:
    keys = sorted({(r["n_cores"], r["dist"]) for r in results})
    for m, d in keys:
        rows = sorted((r for r in results
                       if r["n_cores"] == m and r["dist"] == d
                       and not r.get("skipped")),
                      key=lambda r: r["util"])
        if not rows:
            continue
        heuristics = list(rows[0]["accept"])
        print(f"\n{m} cores, {d} widths (acceptance ratio per util):")
        header = "  util  " + "".join(f"{h:>10}" for h in heuristics)
        print(header)
        for r in rows:
            line = f"  {r['util']:<5.2f} " + "".join(
                f"{r['accept'][h]:>10.2f}" for h in heuristics)
            print(line)


# config fields this surface exposes as flags (DESIGN.md §14.2); the
# aliases preserve the legacy spellings
GRID_FLAG_PATHS = (
    "smoke", "taskset.cores", "taskset.dists", "taskset.utils",
    "policy.heuristics", "taskset.n_per_point", "engine.sim_check",
    "taskset.gamma", "engine.cycles", "taskset.seed", "engine.processes",
    "engine.cell_timeout", "engine.scalar_rta", "engine.trace",
    "engine.dt", "engine.backend", "output.out")
GRID_FLAG_ALIASES = {"taskset.n_per_point": "--n",
                     "engine.processes": "--procs"}
GRID_FLAG_HELPS = {
    "smoke": "CI cell: 2 utils x 6 policy columns x 4 cores (expands to "
             "explicit fields, then clears itself — a --smoke run and "
             "configs/experiments/grid_smoke.json resolve to the same "
             "axes)",
    "engine.cell_timeout": "per-cell wall-clock timeout in seconds (one "
                           "retry, then the cell is skipped); 0 = none",
    "engine.scalar_rta": "per-taskset scalar RTA loop instead of the "
                         "shard-batched kernel (DESIGN.md §13) — same "
                         "verdicts bit-for-bit, for benchmarking",
    "output.out": "output directory (default results/vgang_torch)",
}


def resolve_grid_config(argv: Optional[Sequence[str]] = None
                        ) -> Tuple[ExperimentConfig, Optional[str]]:
    """base grid config <- --config FILE <- explicit flags, with the
    --smoke sugar expanded into its explicit fields; and the ``--device``
    of the torch backend (None: the card)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="device of the torch RTA backend: cuda (default) "
                         "or cpu")
    base = default_grid_config()
    flags = derive_flags(ExperimentConfig, GRID_FLAG_PATHS,
                         aliases=GRID_FLAG_ALIASES, helps=GRID_FLAG_HELPS)
    add_flags(ap, flags, base)
    cfg = cli_main(ap, flags, base, argv, expected_kind="grid")
    if cfg.smoke:
        cfg = cfg.merged(GRID_SMOKE_OVERRIDES).merged({"smoke": False})
    return cfg, ap.parse_args(argv).device


def main(argv: Optional[Sequence[str]] = None) -> int:
    cfg, device = resolve_grid_config(argv)
    torch_rta = cfg.engine.backend == "torch"
    # in-process workers read the backend and its device from the
    # environment (analysis/batched_rta); restored after the run
    env = {"REPRO_RTA_BACKEND": cfg.engine.backend,
           "REPRO_RTA_DEVICE": device if torch_rta else None}
    saved = {k: os.environ.get(k) for k in env}
    processes = cfg.engine.processes or None
    if torch_rta:
        from repro_torch.device import resolve_device
        device = str(resolve_device(device))   # no card: raise here
        env["REPRO_RTA_DEVICE"] = device
        if processes != 1:
            print(f"grid: the torch RTA backend on {device} runs the cells "
                  f"in this process", file=sys.stderr)
        processes = 1
    try:
        for k, v in env.items():
            if v is None or v == "auto":
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        out_dir = cfg.output.out or OUT_DEFAULT
        out = run_grid(
            cores=cfg.taskset.cores, dists=cfg.taskset.dists,
            utils=cfg.taskset.utils, heuristics=cfg.policy.heuristics,
            n_per_cell=cfg.taskset.n_per_point,
            sim_check=cfg.engine.sim_check, gamma=cfg.taskset.gamma,
            cycles=cfg.engine.cycles, seed=cfg.taskset.seed,
            processes=processes, out_dir=out_dir,
            cell_timeout=cfg.engine.cell_timeout or None,
            scalar_rta=cfg.engine.scalar_rta, trace=cfg.engine.trace,
            dt=cfg.engine.dt, config=cfg)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    print_curves(out["results"])
    s = out["summary"]
    print(f"\nwrote {len(s['files'])} curve files + summary to "
          f"{out_dir} in {s['wall_s']}s "
          f"(soundness violations: {s['soundness_violations']}, "
          f"skipped cells: {s['skipped_cells']}, "
          f"config {s['config_digest'][:12]})")
    return 1 if s["soundness_violations"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
