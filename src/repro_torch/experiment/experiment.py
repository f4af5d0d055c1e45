"""The unified experiment description (DESIGN.md §14): one validated
``ExperimentConfig`` consumed by every experiment surface — the vgang
acceptance grid (``repro.vgang.grid``), the Monte-Carlo schedulability
sweep (``repro.launch.sweep --schedulability``), and the three BENCH
drivers — instead of five bespoke argparse stacks.

In the PyTorch port this is a copy; its one surface so far is the
executor vgang bench (``repro_torch.benchmarks.bench_executor_vgang``),
and the batched-RTA backends are ``numpy`` and ``torch``.

Composition (all fields serialize through ``Config``):

* ``TasksetConfig``  — the random-workload knobs shared by grid and
  sweep: seed, machine sizes, width distributions, utilization levels,
  tasksets per point, gangs per taskset, interference gamma.  The
  per-taskset rng streams derive from ``seed`` via
  ``launch.sweep.taskset_seed`` — the reproducibility contract.
* ``PolicyStackConfig`` — which policy columns/modes run and how the
  dispatch is configured (formation heuristics, RTG-throttle, dynamic
  reclaiming, overrun enforcement), with the cross-field rules the
  runtime stack requires (reclaim ⇒ rtg_throttle; a watchdog needs an
  enforcement action).
* ``EngineConfig``   — how verdicts and sims execute: quantum dt (None
  = exact event engine), trace recording, batched-RTA backend, horizon
  in task periods (``cycles``), sim-check count, scalar-RTA fallback,
  worker processes, per-cell timeout.
* ``OutputConfig``   — where results land and which optional sections
  are recorded.

Surfaces that only use a subset of the fields (e.g. ``bench_sim`` has a
fixed workload) simply ignore the rest — the stamped ``content_digest``
still covers every field, so two runs share a digest only if their full
resolved configs match.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.experiment.config import Config, ConfigurationError

# policy-column names the grid understands beyond the formation
# heuristics proper.  The authoritative set is the PolicyFamily registry
# (vgang/family.py) — PolicyStackConfig.validate consults it lazily so a
# registry-added family is accepted here without a parallel edit; this
# static tuple mirrors the built-ins for import-light callers.
RTG_COLUMN = "rtgT"
RECLAIM_COLUMN = "rtgT+dr"
PART_COLUMN = "part"
FORMATION_HEURISTICS = ("ffd", "bestfit", "intfaware")
KNOWN_COLUMNS = ("rtgang",) + FORMATION_HEURISTICS \
    + (RTG_COLUMN, RECLAIM_COLUMN, PART_COLUMN)

WIDTH_DIST_NAMES = ("light", "mixed", "heavy", "uniform")

KINDS = ("grid", "sweep", "bench_sim", "bench_executor", "bench_faults")

ENFORCEMENT_ACTIONS = ("abort", "demote", "degrade")

RTA_BACKENDS = ("auto", "numpy", "torch")


@dataclasses.dataclass
class TasksetConfig(Config):
    """Random-workload axes (UUniFast utilizations; widths per
    distribution for the grid, uniform widths for the sweep)."""

    seed: int = 0
    cores: Tuple[int, ...] = (4, 8, 16)
    dists: Tuple[str, ...] = ("light", "mixed", "heavy")
    utils: Tuple[float, ...] = (0.4, 0.7, 0.9, 1.0, 1.1, 1.2, 1.4,
                                1.6, 2.0)
    n_per_point: int = 50
    # gangs per taskset; None = derived from the machine size
    # (grid.n_tasks_for) — the sweep requires an explicit count
    n_tasks: Optional[int] = None
    gamma: float = 0.5              # intensity_interference strength

    def validate(self):
        if self.seed < 0:
            raise ConfigurationError(
                f"must be >= 0, got {self.seed}", "seed")
        if not self.cores or any(c <= 0 for c in self.cores):
            raise ConfigurationError(
                f"need positive core counts, got {list(self.cores)}",
                "cores")
        for d in self.dists:
            if d not in WIDTH_DIST_NAMES:
                raise ConfigurationError(
                    f"unknown width distribution {d!r}; known: "
                    f"{list(WIDTH_DIST_NAMES)}", "dists")
        if not self.utils or any(u <= 0.0 for u in self.utils):
            raise ConfigurationError(
                f"need positive utilization levels, got "
                f"{list(self.utils)}", "utils")
        if self.n_per_point <= 0:
            raise ConfigurationError(
                f"must be > 0, got {self.n_per_point}", "n_per_point")
        if self.n_tasks is not None and self.n_tasks <= 0:
            raise ConfigurationError(
                f"must be > 0 (or null = derived), got {self.n_tasks}",
                "n_tasks")
        if self.gamma < 0.0:
            raise ConfigurationError(
                f"must be >= 0, got {self.gamma}", "gamma")


@dataclasses.dataclass
class PolicyStackConfig(Config):
    """Which policy columns/modes run, and the dispatch flag bundle."""

    heuristics: Tuple[str, ...] = ("ffd", "bestfit", "intfaware",
                                   RTG_COLUMN, RECLAIM_COLUMN,
                                   PART_COLUMN)
    rtg_throttle: bool = False      # mode surfaces (executor bench)
    reclaim: bool = False           # requires rtg_throttle
    enforcement: Optional[str] = None          # None | abort | demote |
    enforcement_factor: float = 1.2            # degrade (core/faults.py)
    watchdog_factor: Optional[float] = None

    def validate(self):
        # the PolicyFamily registry (vgang/family.py) is the one source
        # of truth for valid columns; imported lazily to keep config
        # loading import-light and cycle-free
        from repro_torch.vgang.family import family_names
        known = family_names()
        for h in self.heuristics:
            if h not in known:
                raise ConfigurationError(
                    f"unknown policy column {h!r}; known: "
                    f"{list(known)}", "heuristics")
        if self.reclaim and not self.rtg_throttle:
            raise ConfigurationError(
                "dynamic reclaiming donates sibling window quota, which "
                "only exists under RTG-throttle — set rtg_throttle=true",
                "reclaim")
        if self.enforcement is not None \
                and self.enforcement not in ENFORCEMENT_ACTIONS:
            raise ConfigurationError(
                f"unknown action {self.enforcement!r}; known: "
                f"{list(ENFORCEMENT_ACTIONS)} (or null)", "enforcement")
        if self.enforcement_factor < 1.0:
            raise ConfigurationError(
                f"must be >= 1.0 (1.0 = declared WCET), got "
                f"{self.enforcement_factor}", "enforcement_factor")
        if self.watchdog_factor is not None:
            if self.enforcement is None:
                raise ConfigurationError(
                    "a watchdog needs an enforcement action to fire — "
                    "set enforcement", "watchdog_factor")
            if self.watchdog_factor <= 0.0:
                raise ConfigurationError(
                    f"must be > 0, got {self.watchdog_factor}",
                    "watchdog_factor")


@dataclasses.dataclass
class EngineConfig(Config):
    """How verdicts and simulations execute."""

    dt: Optional[float] = None      # quantum ms; None = event engine
    trace: bool = False             # timeline recording in sim-checks
    backend: str = "auto"           # batched-RTA backend
    cycles: float = 20.0            # horizon = cycles * max period
    sim_check: int = 2              # tasksets sim-checked per cell
    scalar_rta: bool = False        # per-taskset scalar RTA loop
    processes: int = 0              # worker pool size; 0 = auto
    cell_timeout: float = 0.0       # per-cell seconds; 0 = none

    def validate(self):
        if self.dt is not None and self.dt <= 0.0:
            raise ConfigurationError(
                f"must be > 0 (or null = event engine), got {self.dt}",
                "dt")
        if self.backend not in RTA_BACKENDS:
            raise ConfigurationError(
                f"unknown backend {self.backend!r}; known: "
                f"{list(RTA_BACKENDS)}", "backend")
        if self.cycles <= 0.0:
            raise ConfigurationError(
                f"must be > 0, got {self.cycles}", "cycles")
        if self.sim_check < 0:
            raise ConfigurationError(
                f"must be >= 0, got {self.sim_check}", "sim_check")
        if self.processes < 0:
            raise ConfigurationError(
                f"must be >= 0 (0 = auto), got {self.processes}",
                "processes")
        if self.cell_timeout < 0.0:
            raise ConfigurationError(
                f"must be >= 0 (0 = none), got {self.cell_timeout}",
                "cell_timeout")


@dataclasses.dataclass
class OutputConfig(Config):
    """Result sinks and optional recorded sections."""

    out: Optional[str] = None       # file or directory; None = the
                                    # surface's historical default
    stage: Optional[str] = None     # bench_sim persistent entries label
    profile: bool = False           # bench_sim phase breakdown


@dataclasses.dataclass
class ExperimentConfig(Config):
    """One experiment, fully described.  ``kind`` names the surface that
    runs it; kind-specific cross-field rules live here so an invalid
    combination fails at load time, not at dispatch."""

    kind: str = "grid"
    name: str = ""
    taskset: TasksetConfig = dataclasses.field(
        default_factory=TasksetConfig)
    policy: PolicyStackConfig = dataclasses.field(
        default_factory=PolicyStackConfig)
    engine: EngineConfig = dataclasses.field(default_factory=EngineConfig)
    output: OutputConfig = dataclasses.field(default_factory=OutputConfig)
    smoke: bool = False
    # bench_executor knobs (ignored by the other kinds)
    duration_s: Optional[float] = None    # seconds per mode
    margin: float = 8.0                   # WCET factor over calibration
    jitter_ms: float = 60.0               # dispatch-jitter allowance

    def validate(self):
        if self.kind not in KINDS:
            raise ConfigurationError(
                f"unknown experiment kind {self.kind!r}; known: "
                f"{list(KINDS)}", "kind")
        if self.kind == "sweep":
            if len(self.taskset.cores) != 1:
                raise ConfigurationError(
                    "the schedulability sweep runs one machine size; "
                    f"got {list(self.taskset.cores)}", "taskset.cores")
            if self.taskset.n_tasks is None:
                raise ConfigurationError(
                    "the sweep needs an explicit gang count (the grid "
                    "derives it from the machine size)", "taskset.n_tasks")
        if self.kind == "grid":
            bad = [d for d in self.taskset.dists if d == "uniform"]
            if bad:
                raise ConfigurationError(
                    "the grid draws widths from the named distributions "
                    "light/mixed/heavy; 'uniform' is the sweep's regime",
                    "taskset.dists")
        if self.duration_s is not None and self.duration_s <= 0.0:
            raise ConfigurationError(
                f"must be > 0 (or null = derived), got {self.duration_s}",
                "duration_s")
        if self.margin <= 0.0:
            raise ConfigurationError(
                f"must be > 0, got {self.margin}", "margin")
        if self.jitter_ms < 0.0:
            raise ConfigurationError(
                f"must be >= 0, got {self.jitter_ms}", "jitter_ms")


# ---------------------------------------------------------------------
# Per-surface base configs: each surface's historical CLI defaults,
# spelled once.  CLI resolution overlays --config and explicit flags on
# top of these, so legacy invocations resolve to identical configs (and
# identical digests) as the equivalent config file.
# ---------------------------------------------------------------------

def default_grid_config() -> ExperimentConfig:
    return ExperimentConfig(kind="grid", name="vgang-grid")


GRID_SMOKE_OVERRIDES = {
    "taskset": {"cores": [4], "dists": ["mixed"], "utils": [0.8, 1.6],
                "n_per_point": 10},
    "policy": {"heuristics": ["ffd", "intfaware", RTG_COLUMN,
                              RECLAIM_COLUMN, PART_COLUMN]},
    "engine": {"sim_check": 1},
}


def default_sweep_config() -> ExperimentConfig:
    return ExperimentConfig(
        kind="sweep", name="sched-sweep",
        taskset=TasksetConfig(cores=(4,), dists=("uniform",),
                              utils=(0.3, 0.5, 0.7, 0.9),
                              n_per_point=100, n_tasks=4),
        policy=PolicyStackConfig(heuristics=()),
        engine=EngineConfig(sim_check=0))


def default_bench_sim_config() -> ExperimentConfig:
    return ExperimentConfig(kind="bench_sim", name="bench-sim",
                            policy=PolicyStackConfig(heuristics=()))


def default_bench_executor_config() -> ExperimentConfig:
    return ExperimentConfig(
        kind="bench_executor", name="bench-executor-vgang",
        taskset=TasksetConfig(cores=(4,), dists=("mixed",), utils=(1.0,),
                              n_per_point=1),
        policy=PolicyStackConfig(heuristics=("intfaware",),
                                 rtg_throttle=True))


def default_bench_faults_config() -> ExperimentConfig:
    return ExperimentConfig(
        kind="bench_faults", name="bench-faults",
        taskset=TasksetConfig(cores=(8,), dists=("mixed",), utils=(1.0,),
                              n_per_point=1, seed=42),
        policy=PolicyStackConfig(heuristics=(), enforcement="abort",
                                 enforcement_factor=1.2,
                                 watchdog_factor=2.0))
