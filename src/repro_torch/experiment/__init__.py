"""Composable experiment configs (DESIGN.md §14): a validated
declarative description of every experiment surface, serializable to
the checked-in files under ``configs/experiments/`` and stamped (as a
content digest) into every results artifact."""
from repro_torch.experiment.config import Config, ConfigurationError
from repro_torch.experiment.experiment import (ExperimentConfig, TasksetConfig,
                                               PolicyStackConfig, EngineConfig,
                                               OutputConfig,
                                               GRID_SMOKE_OVERRIDES,
                                               default_grid_config,
                                               default_sweep_config,
                                               default_bench_sim_config,
                                               default_bench_executor_config,
                                               default_bench_faults_config)
from repro_torch.experiment.cli import (Flag, UNSET, derive_flags, add_flags,
                                        resolve_config, cli_main)

__all__ = [
    "Config", "ConfigurationError", "ExperimentConfig", "TasksetConfig",
    "PolicyStackConfig", "EngineConfig", "OutputConfig",
    "GRID_SMOKE_OVERRIDES", "default_grid_config", "default_sweep_config",
    "default_bench_sim_config", "default_bench_executor_config",
    "default_bench_faults_config", "Flag", "UNSET", "derive_flags",
    "add_flags", "resolve_config", "cli_main",
]
