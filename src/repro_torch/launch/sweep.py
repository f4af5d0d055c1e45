"""Sweep drivers of the port (its counterpart of ``repro.launch.sweep``).

1. Monte-Carlo schedulability sweep: random gang tasksets per utilization
   level, simulated with the exact event-driven engine (Simulator dt=None)
   and cross-checked against RTA, fanned across worker processes — the
   evaluation style of the Virtual-Gang (arXiv:1912.10959) and strict-
   partitioning gang (arXiv:2403.10726) follow-ups.

       python -m repro_torch.launch.sweep --schedulability \\
           [--utils 0.3,0.5,0.7,0.9] [--n 100] [--procs 8] [--cores 4] \\
           [--seed 0] [--out PATH]
       python -m repro_torch.launch.sweep --config \\
           configs/experiments/sweep_smoke.json [--out PATH]

   Writes results/sched_sweep_torch.json unless ``--out`` (or the
   config's ``output.out``) names another path.

   Tasksets are batched into a few contiguous shards per utilization
   level (amortizing worker startup while still using every core);
   per-taskset seeds derive from --seed via ``taskset_seed``, so runs
   are reproducible and sharding-independent. The full virtual-gang
   evaluation grid (formation heuristics x width distributions x
   4/8/16 cores) extends this driver in ``repro_torch.vgang.grid``.

2. The dry-run sweep (the default mode): every (arch x shape) cell on
   the single-pod mesh and the multi-pod mesh through
   ``repro_torch.launch.dryrun``, each cell in a fresh process (a process
   group is process-global), cached as results/dryrun_torch/*.json
   (``OUT``), which the roofline bench reads.

       python -m repro_torch.launch.sweep [--single-pod-only |
           --multi-pod-only] [--force] [--jobs N]

   ``--jobs`` traces that many cells at once (each a process of one
   thread); the printout and the exit are JAX's: one line a cell, then
   ``SWEEP DONE failures=N: [...]``, exit 0.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import random
import subprocess
import time
from typing import Dict, List, Optional, Sequence, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))
OUT = os.path.join(ROOT, "results", "dryrun_torch")
SWEEP_OUT_DEFAULT = os.path.join(ROOT, "results", "sched_sweep_torch.json")



def run_one(arch: str, shape: str, multi_pod: bool, force: bool,
            timeout: float = 3600) -> dict:
    """One dry-run cell, from its cache unless ``force``; a failed cell
    returns its error instead of raising."""
    from repro_torch.launch import dryrun
    path = dryrun.cell_path(arch, shape, multi_pod)
    if os.path.exists(path) and not force:
        with open(path) as f:
            return {"cached": True, **json.load(f)}
    t0 = time.time()
    try:
        return dryrun.run_cell_subprocess(arch, shape, multi_pod, out=path,
                                          timeout=timeout)
    except (RuntimeError, subprocess.TimeoutExpired) as e:
        return {"error": str(e)[-2000:], "arch": arch, "shape": shape,
                "multi_pod": multi_pod, "wall_s": time.time() - t0}


def dryrun_sweep(meshes: Sequence[bool], force: bool = False,
                 jobs: int = 1) -> List[tuple]:
    """Every runnable cell (``valid_cells``) on each mesh (False: 16x16,
    True: pod2x16x16), ``jobs`` cells at a time; writes the skip list
    beside the cells and returns the failed cells."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.configs import valid_cells
    runnable, skipped = valid_cells()
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "skipped.json"), "w") as f:
        json.dump({f"{a}|{s}": r for (a, s), r in skipped.items()}, f,
                  indent=1)
    cells = [(arch, shape, multi_pod) for multi_pod in meshes
             for arch, shape in runnable]

    def one(cell):
        t0 = time.time()
        return cell, run_one(*cell, force), time.time() - t0

    failures = []
    t_sweep = time.time()
    with ThreadPoolExecutor(max(1, jobs)) as pool:
        for (arch, shape, multi_pod), res, wall in pool.map(one, cells):
            tag = "pod2x16x16" if multi_pod else "16x16"
            if "error" in res:
                failures.append((arch, shape, tag))
                print(f"[FAIL] {arch} {shape} {tag}: {res['error'][-400:]}",
                      flush=True)
            else:
                cached = " (cached)" if res.get("cached") else ""
                print(f"[ok] {arch} {shape} {tag} trace={res['lower_s']}s "
                      f"wall={wall:.0f}s{cached}", flush=True)
    print(f"[sweep] {len(cells)} cells in {time.time() - t_sweep:.0f} s "
          f"({jobs} at a time)")
    print(f"\nSWEEP DONE failures={len(failures)}: {failures}")
    return failures


# ---------------------------------------------------------------------
# Monte-Carlo schedulability sweep (event-driven engine, process pool)
# ---------------------------------------------------------------------

def uunifast(rng: random.Random, n: int, total_util: float) -> List[float]:
    """UUniFast: unbiased uniform split of ``total_util`` over ``n`` tasks
    (Bini & Buttazzo). Shared by this sweep and the virtual-gang grid
    (repro_torch.vgang.grid); always driven by an explicit seeded rng so every
    sweep is reproducible."""
    utils: List[float] = []
    remaining = total_util
    for i in range(n - 1):
        nxt = remaining * rng.random() ** (1.0 / (n - 1 - i))
        utils.append(remaining - nxt)
        remaining = nxt
    utils.append(remaining)
    return utils


def random_gang_taskset(rng: random.Random, n_cores: int, n_tasks: int,
                        total_util: float):
    """UUniFast utilizations over ``n_tasks`` gangs, log-uniform periods,
    random gang widths, rate-monotonic priorities (shorter period = higher
    prio; ties broken by index so priorities stay distinct — distinct
    priority per gang is the paper's gang-identity requirement)."""
    from repro_torch.core.gang import RTTask

    utils = uunifast(rng, n_tasks, total_util)

    periods = [rng.choice((10.0, 20.0, 25.0, 40.0, 50.0, 100.0))
               for _ in range(n_tasks)]
    by_rm = sorted(range(n_tasks), key=lambda i: (periods[i], i))
    prio_of = {idx: n_tasks - rank for rank, idx in enumerate(by_rm)}

    tasks = []
    for i in range(n_tasks):
        width = rng.randint(1, n_cores)
        cores = tuple(rng.sample(range(n_cores), width))
        wcet = max(utils[i] * periods[i], 1e-3)
        tasks.append(RTTask(
            name=f"g{i}", wcet=wcet, period=periods[i], cores=cores,
            prio=prio_of[i], release_offset=rng.uniform(0, periods[i])))
    return tasks


def _sched_cell(seed: int, n_cores: int, n_tasks: int, total_util: float,
                cycles: float) -> Dict:
    """One random taskset -> exact-sim verdict + RTA verdict. The taskset
    is rebuilt from the seed, so the cell is reproducible in isolation."""
    from repro_torch.core.rta import schedulable
    from repro_torch.core.sim import Simulator

    rng = random.Random(seed)
    tasks = random_gang_taskset(rng, n_cores, n_tasks, total_util)
    horizon = cycles * max(t.period for t in tasks)
    t0 = time.time()
    r = Simulator(n_cores, tasks, dt=None).run(horizon)
    rta = schedulable(tasks)
    return {
        "seed": seed,
        "util": total_util,
        "sim_ok": sum(r.deadline_misses.values()) == 0,
        "rta_ok": all(v["ok"] for v in rta.values()),
        "events": r.events,
        "wall_s": time.time() - t0,
    }


def taskset_seed(seed: int, k: int, total_util: float) -> int:
    """Per-taskset seed derivation — the reproducibility contract shared
    by this sweep and the virtual-gang grid (repro_torch.vgang.grid): results
    are a pure function of (--seed, taskset index, utilization level),
    independent of how tasksets are batched across workers."""
    return seed + 7919 * k + int(1e6 * total_util)


def _sched_level(args: Tuple) -> List[Dict]:
    """Pool worker: one contiguous shard of a utilization level's
    tasksets in one process (ROADMAP item 4 — interpreter startup and
    import cost amortized over the shard, not paid per taskset).
    Per-taskset seeds use ``taskset_seed`` with the absolute index, so
    results are identical for any sharding. Aggregation stays in the
    parent.

    The shard's RTA verdicts run through the batched kernel
    (``analysis.batched_rta``, DESIGN.md §13) in one call — bit-identical
    to the scalar per-taskset ``schedulable`` loop, which stays
    reachable via the ``scalar_rta`` shard flag (``--scalar-rta``).
    Sims run trace-free: the sweep only reads SimResult counters.

    Optional trailing args extend the payload tuple backwards-
    compatibly: ``scalar_rta``, then ``gamma`` and a ``heuristics``
    tuple of PolicyFamily names (vgang/family.py) — each named family
    forms the shard's tasksets and contributes its own batched
    acceptance bit per taskset (``family_ok``)."""
    from repro_torch.core.rta import schedulable
    from repro_torch.core.sim import Simulator

    seed, n_cores, n_tasks, total_util, cycles, k0, k1, *rest = args
    scalar_rta = bool(rest[0]) if rest else False
    gamma = float(rest[1]) if len(rest) > 1 else 0.5
    heuristics = tuple(rest[2]) if len(rest) > 2 else ()
    seeds = [taskset_seed(seed, k, total_util) for k in range(k0, k1)]
    # each taskset gets its own rng seeded from the absolute index, so
    # drawing the whole shard up front cannot perturb the streams
    tasksets = [random_gang_taskset(random.Random(s), n_cores, n_tasks,
                                    total_util) for s in seeds]
    if scalar_rta:
        rta_bits = [all(v["ok"] for v in schedulable(ts).values())
                    for ts in tasksets]
    else:
        from repro_torch.analysis.batched_rta import batched_accepts
        rta_bits = batched_accepts(tasksets)
    fam_bits: Dict[str, List[bool]] = {}
    if heuristics:
        from repro_torch.vgang.family import get_family
        from repro_torch.vgang.formation import intensity_interference
        intfs = [intensity_interference(ts, gamma) for ts in tasksets]
        for h in heuristics:
            fam = get_family(h)
            formed_sets = [fam.assign(fam.form(ts, n_cores, intf))
                           for ts, intf in zip(tasksets, intfs)]
            if scalar_rta:
                fam_bits[h] = [bool(fam.verdict(f, i))
                               for f, i in zip(formed_sets, intfs)]
            else:
                fam_bits[h] = fam.batched_verdict(formed_sets, intfs)
    out = []
    for j, (s, tasks, rta_ok) in enumerate(zip(seeds, tasksets, rta_bits)):
        horizon = cycles * max(t.period for t in tasks)
        t0 = time.time()
        r = Simulator(n_cores, tasks, dt=None, trace=False).run(horizon)
        row = {
            "seed": s,
            "util": total_util,
            "sim_ok": sum(r.deadline_misses.values()) == 0,
            "rta_ok": rta_ok,
            "events": r.events,
            "wall_s": time.time() - t0,
        }
        if heuristics:
            row["family_ok"] = {h: bool(fam_bits[h][j])
                                for h in heuristics}
        out.append(row)
    return out


def _sweep_config(n_cores, n_tasks, utils, n_per_util, cycles, processes,
                  seed, scalar_rta, out=None, heuristics=(), gamma=0.5):
    """The resolved ExperimentConfig a direct ``schedulability_sweep``
    call denotes (provenance parity with the CLI shell)."""
    from repro_torch.experiment import default_sweep_config
    return default_sweep_config().merged({
        "taskset": {"cores": [n_cores], "n_tasks": n_tasks,
                    "utils": list(utils), "n_per_point": n_per_util,
                    "seed": seed, "gamma": gamma},
        "policy": {"heuristics": list(heuristics)},
        "engine": {"cycles": cycles, "processes": processes or 0,
                   "scalar_rta": scalar_rta},
        "output": {"out": out},
    })


def schedulability_sweep(n_cores: int = 4, n_tasks: int = 4,
                         utils: Sequence[float] = (0.3, 0.5, 0.7, 0.9),
                         n_per_util: int = 100, cycles: float = 20.0,
                         processes: Optional[int] = None,
                         seed: int = 0, scalar_rta: bool = False,
                         heuristics: Sequence[str] = (),
                         gamma: float = 0.5,
                         config=None) -> Dict:
    """Run ``n_per_util`` random tasksets per utilization level in
    batched shard workers (a few shards per level — enough to use every
    core, orders of magnitude fewer process tasks than one per taskset),
    aggregating acceptance ratios (simulated + RTA) in the parent.

    ``heuristics`` names PolicyFamilies (vgang/family.py) to score
    alongside the plain gang RTA: each family forms every taskset and
    contributes a ``family_sched_ratio`` column. Families that require
    window-aligned zero-offset releases (the rtgT pricings) are
    rejected — the sweep draws random release offsets by design.

    ``config`` is the resolved ExperimentConfig this run realizes (the
    CLI shell passes it down; one is synthesized for direct calls), and
    its content digest is stamped into the output dict."""
    heuristics = tuple(heuristics)
    if heuristics:
        from repro_torch.vgang.family import family_names, get_family
        for h in heuristics:
            fam = get_family(h)
            if fam.aligned_releases_only:
                valid = [n for n in family_names()
                         if not get_family(n).aligned_releases_only]
                raise ValueError(
                    f"policy family {h!r} needs window-aligned "
                    f"zero-offset releases, but the sweep draws random "
                    f"release offsets — run it on the grid instead "
                    f"(families valid here: {valid})")
    if config is None:
        config = _sweep_config(n_cores, n_tasks, utils, n_per_util,
                               cycles, processes, seed, scalar_rta,
                               heuristics=heuristics, gamma=gamma)
    procs = max(1, processes or min(multiprocessing.cpu_count(), 16))
    shards_per_level = max(1, -(-procs // max(1, len(utils))))
    shards_per_level = min(shards_per_level, n_per_util)
    step = -(-n_per_util // shards_per_level)
    levels = [(seed, n_cores, n_tasks, u, cycles, k0,
               min(k0 + step, n_per_util), scalar_rta, gamma, heuristics)
              for u in utils for k0 in range(0, n_per_util, step)]
    procs = min(procs, len(levels))
    if procs > 1:
        with multiprocessing.Pool(procs) as pool:
            shards = pool.map(_sched_level, levels, chunksize=1)
    else:
        shards = [_sched_level(lv) for lv in levels]

    by_util: Dict[float, List[Dict]] = {u: [] for u in utils}
    for lv, rs in zip(levels, shards):
        by_util[lv[3]].extend(rs)
    rows = []
    for u in utils:
        rs = by_util[u]
        row = {
            "util": u,
            "n": len(rs),
            "sim_sched_ratio": sum(r["sim_ok"] for r in rs) / len(rs),
            "rta_sched_ratio": sum(r["rta_ok"] for r in rs) / len(rs),
            "events_total": sum(r["events"] for r in rs),
            "wall_s_total": round(sum(r["wall_s"] for r in rs), 3),
        }
        if heuristics:
            row["family_sched_ratio"] = {
                h: sum(r["family_ok"][h] for r in rs) / len(rs)
                for h in heuristics}
        rows.append(row)
    return {"n_cores": n_cores, "n_tasks": n_tasks, "cycles": cycles,
            "processes": procs, "seed": seed,
            "config": config.to_dict(),
            "config_digest": config.content_digest(), "rows": rows}


# config fields the schedulability branch exposes as flags; the aliases
# preserve the legacy spellings (DESIGN.md §14.2)
SWEEP_FLAG_PATHS = (
    "taskset.utils", "taskset.n_per_point", "taskset.n_tasks",
    "taskset.cores", "engine.cycles", "engine.processes", "taskset.seed",
    "engine.scalar_rta", "policy.heuristics", "taskset.gamma",
    "output.out")
SWEEP_FLAG_ALIASES = {"taskset.n_per_point": "--n",
                      "taskset.n_tasks": "--tasks",
                      "engine.processes": "--procs"}
SWEEP_FLAG_HELPS = {
    "engine.scalar_rta": "per-taskset scalar RTA instead of the batched "
                         "kernel (same verdicts, for benchmarking)",
    "output.out": "output JSON path (default "
                  "results/sched_sweep_torch.json)",
}


def run_schedulability(cfg) -> None:
    out = schedulability_sweep(
        n_cores=cfg.taskset.cores[0], n_tasks=cfg.taskset.n_tasks,
        utils=cfg.taskset.utils, n_per_util=cfg.taskset.n_per_point,
        cycles=cfg.engine.cycles,
        processes=cfg.engine.processes or None, seed=cfg.taskset.seed,
        scalar_rta=cfg.engine.scalar_rta,
        heuristics=cfg.policy.heuristics, gamma=cfg.taskset.gamma,
        config=cfg)
    for row in out["rows"]:
        fams = "".join(f" {h}={v:.2f}"
                       for h, v in row.get("family_sched_ratio",
                                           {}).items())
        print(f"util={row['util']:.2f} sim={row['sim_sched_ratio']:.2f} "
              f"rta={row['rta_sched_ratio']:.2f}{fams} n={row['n']} "
              f"({row['events_total']} events in {row['wall_s_total']}s)")
    path = cfg.output.out or SWEEP_OUT_DEFAULT
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path} (config {out['config_digest'][:12]})")


def main(argv: Optional[Sequence[str]] = None) -> None:
    from repro_torch.experiment import (ConfigurationError, ExperimentConfig,
                                        add_flags, default_sweep_config,
                                        derive_flags, resolve_config)
    ap = argparse.ArgumentParser()
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="dry-run mode: cells traced at once")
    ap.add_argument("--schedulability", action="store_true",
                    help="Monte-Carlo gang schedulability sweep instead "
                         "of the dry-run sweep")
    base = default_sweep_config()
    flags = derive_flags(ExperimentConfig, SWEEP_FLAG_PATHS,
                         aliases=SWEEP_FLAG_ALIASES,
                         helps=SWEEP_FLAG_HELPS)
    add_flags(ap, flags, base)
    args = ap.parse_args(argv)

    if args.schedulability or args.config:
        try:
            cfg = resolve_config(base, args, flags, expected_kind="sweep")
        except ConfigurationError as e:
            ap.error(str(e))
        run_schedulability(cfg)
        return
    meshes = [m for m in (False, True)
              if not (m and args.single_pod_only)
              and not (not m and args.multi_pod_only)]
    dryrun_sweep(meshes, args.force, args.jobs)


if __name__ == "__main__":
    main()
