"""The program's model, built from a configuration file of the benchmark
and loaded with weights the benchmark draws from the seed."""
from __future__ import annotations

from typing import Tuple

import torch

from gangbench.harness import weights as W

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def model_config(m: dict):
    """The port's ``ModelConfig`` of a configuration's ``model`` object."""
    from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig
    kw = {k: v for k, v in m.items() if k not in ("moe", "ssm")}
    if "moe" in m:
        kw["moe"] = MoEConfig(**m["moe"])
    if "ssm" in m:
        kw["ssm"] = SSMConfig(**m["ssm"])
    return ModelConfig(**kw)


def build(m: dict, spec: W.Spec, seed: int, device: torch.device
          ) -> Tuple[object, dict]:
    """The port's ``ModelApi`` on one device (as ``launch.serve`` builds
    it) and its parameters: the spec's weights drawn on ``device`` from
    ``seed`` in the configuration's dtype, handed over by
    ``ModelApi.load``."""
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.model import build_model
    dtype = m["dtype"]
    parallel = ParallelConfig(param_dtype=dtype, compute_dtype=dtype)
    api = build_model(model_config(m), parallel, device,
                      mesh=make_local_mesh(1, 1, device))
    params = api.load(W.draw(spec, seed, device, DTYPES[dtype]))
    return api, params
