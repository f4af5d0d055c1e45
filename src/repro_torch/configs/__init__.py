"""Config registry: ``get_config(arch_id)`` for every assigned architecture."""
from __future__ import annotations

from repro_torch.configs.base import (ModelConfig, MoEConfig, ParallelConfig,
                                RGLRUConfig, SSMConfig, ShapeConfig, SHAPES,
                                reduced)

from repro_torch.configs import (granite_20b, internvl2_1b, kimi_k2_1t,
                           mamba2_1_3b, minitron_4b, olmoe_1b_7b, qwen2_72b,
                           qwen2_7b, recurrentgemma_9b, whisper_base)

_REGISTRY = {
    m.CONFIG.name: m.CONFIG
    for m in (qwen2_72b, minitron_4b, qwen2_7b, granite_20b, mamba2_1_3b,
              internvl2_1b, kimi_k2_1t, olmoe_1b_7b, recurrentgemma_9b,
              whisper_base)
}

ARCH_IDS = tuple(sorted(_REGISTRY))


def get_config(arch_id: str) -> ModelConfig:
    try:
        return _REGISTRY[arch_id]
    except KeyError:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")


def get_shape(shape_id: str) -> ShapeConfig:
    try:
        return SHAPES[shape_id]
    except KeyError:
        raise KeyError(f"unknown shape {shape_id!r}; known: {sorted(SHAPES)}")


def valid_cells():
    """All runnable (arch, shape) cells with skip reasons for the rest.

    Returns (runnable, skipped) where skipped maps (arch, shape) -> reason.
    """
    runnable, skipped = [], {}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES:
            if shape == "long_500k" and not cfg.sub_quadratic:
                skipped[(arch, shape)] = (
                    "long_500k needs sub-quadratic attention; "
                    f"{arch} is full-attention (KV cache at 512k seq is "
                    "O(seq) per layer per sequence — architecture-infeasible, "
                    "not a sharding gap)")
                continue
            runnable.append((arch, shape))
    return runnable, skipped


__all__ = ["ModelConfig", "MoEConfig", "SSMConfig", "RGLRUConfig",
           "ParallelConfig", "ShapeConfig", "SHAPES", "ARCH_IDS",
           "get_config", "get_shape", "reduced", "valid_cells"]
