"""Per-(arch x shape) run recipes: dtype/optimizer/remat/parallelism choices
used by the dry-run and launchers. These are the *baseline* settings recorded
in EXPERIMENTS.md; hillclimb variants override fields explicitly."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig, ParallelConfig, ShapeConfig


def parallel_for(cfg: ModelConfig, shape: ShapeConfig,
                 multi_pod: bool = False, **overrides) -> ParallelConfig:
    big = cfg.n_params() > 5e10          # qwen2-72b, kimi-k2
    # training always FSDP-shards weights; inference does too when weights
    # can't fit per-device otherwise (kimi-k2: 2.06 TB bf16 / 16-way EP =
    # 128 GB/device >> 16 GB HBM -> shard d_model over `data` and gather
    # per layer inside the scan)
    infer_needs_fsdp = cfg.n_params() * 2 / 16 > 10e9   # bytes per TP shard
    p = ParallelConfig(
        pod_axis="pod" if multi_pod else None,
        fsdp=shape.kind == "train" or infer_needs_fsdp,
        fsdp_pod=multi_pod,
        tensor_parallel=True,
        expert_parallel=cfg.family == "moe",
        sequence_parallel=True,
        remat="block",
        grad_accum=1,
        optimizer="adafactor" if cfg.n_params() > 2e11 else "adamw",
        opt_state_dtype="bfloat16" if big else "float32",
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        fused_xent=False,
    )
    return dataclasses.replace(p, **overrides)
