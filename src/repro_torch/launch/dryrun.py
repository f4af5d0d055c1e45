"""Dry run of one (arch x shape x mesh) cell of the port: the counterpart
of ``repro.launch.dryrun``, without a compiler.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b \\
        --shape decode_32k [--multi-pod] [--override k=v ...] [--out PATH]

The process joins a ``torch.distributed`` group of the ``"fake"`` backend
(``FakeStore``, world 256 or 512) as rank 0 of the production mesh, and
traces the full config's train step, prefill or decode step once under a
``FakeTensorMode``: every tensor is a DTensor of rank 0's local shard with
no data, every collective returns at once, and no device memory is used.
``roofline.op_analysis`` counts what rank 0 runs: the FLOPs and bytes of
its local ops (the kernels charged their ``roofline.work`` formulas), and
the collectives of the DTensor redistributions and of the parallel paths'
explicit gathers, scatters, all-to-alls and all-reduces, under JAX's kind
names. A process group is process-global, so ``main`` (and
``run_cell_subprocess``) runs each cell in a process of its own.

The cell has ``roofline.report.cell``'s keys and JAX's ``recipe``,
``n_params``, ``n_active_params``, ``chips``, ``dtype``, ``lower_s``.
``memory``: ``argument_size_bytes`` and ``output_size_bytes`` are rank
0's shards of the inputs and outputs; ``temp_size_bytes`` is the peak of
the bytes that the traced ops' outputs hold while they live (the eager
allocations, before the allocator's caching and fragmentation: not XLA's
buffer assignment). Cells go to results/dryrun_torch/
<arch>_<shape>_<mesh>[__<variant>].json.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_shape
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch import inputs as I
from repro_torch.launch.mesh import (_device_mesh, make_production_mesh,
                                     mesh_tag, production_shape)
from repro_torch.launch.recipes import parallel_for
from repro_torch.launch.sweep import OUT
from repro_torch.models import layers as L
from repro_torch.models.model import DTYPES, build_model
from repro_torch.roofline import op_analysis
from repro_torch.roofline.report import SHAPE_TOKENS
from repro_torch.training.optimizer import OptConfig, Optimizer
from repro_torch.training.step import make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))


def cell_path(arch: str, shape: str, multi_pod: bool,
              variant: str = "baseline") -> str:
    suffix = "" if variant == "baseline" else f"__{variant}"
    return os.path.join(OUT, f"{arch}_{shape}_{mesh_tag(multi_pod)}"
                        f"{suffix}.json")


def init_fake_group(world: int) -> None:
    """Join a fake-backend group of ``world`` ranks as rank 0."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized: a "
                           "dry-run cell runs in a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _nbytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_leaves
    return sum((t.to_local() if isinstance(t, DTensor) else t).numel()
               * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _param_specs(api, dtype):
    return L.tree_map(lambda _, d: I.TensorSpec(
        tuple(d.shape), dtype, d.logical,
        api.rules_p.placements(d.logical, d.shape),
        api.rules_p.local_shape(d.logical, d.shape)), api.defs)


def _tokens(shape: ShapeConfig) -> int:
    if shape.name in SHAPE_TOKENS:
        return SHAPE_TOKENS[shape.name]
    return shape.global_batch * (1 if shape.kind == "decode"
                                 else shape.seq_len)


def run_cell(arch: str, shape_id: str, multi_pod: bool,
             overrides: Optional[Dict[str, Any]] = None,
             variant: str = "baseline", *, cfg: Optional[ModelConfig] = None,
             shape: Optional[ShapeConfig] = None,
             mesh: Optional[Dict[str, int]] = None) -> Dict[str, Any]:
    """Trace one cell (see the module docstring). ``cfg``, ``shape`` and
    ``mesh`` ({axis: size}) replace the named config, shape and production
    mesh (the tests' reduced cells). Needs no process group of its own:
    it joins a fake group of the mesh's size, so it runs once a process."""
    cfg = cfg or get_config(arch)
    shape = shape or get_shape(shape_id)
    mshape = mesh or production_shape(multi_pod)
    world = int(torch.Size(mshape.values()).numel())
    init_fake_group(world)
    try:
        dmesh = (make_production_mesh(multi_pod=multi_pod, device_type="cpu")
                 if mesh is None else
                 _device_mesh("cpu", tuple(mshape.values()), tuple(mshape)))
        parallel = parallel_for(cfg, shape, multi_pod, **(overrides or {}))
        api = build_model(cfg, parallel, "cpu", mesh=dmesh)
        return _trace(api, arch, shape_id, shape, mshape, multi_pod,
                      variant, parallel, world)
    finally:
        dist.destroy_process_group()


def _trace(api, arch, shape_id, shape, mshape, multi_pod, variant,
           parallel, world) -> Dict[str, Any]:
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = api.cfg
    cd = "bfloat16" if cfg.dtype == "bfloat16" and \
        parallel.compute_dtype == "bfloat16" else "float32"
    result: Dict[str, Any] = {
        "arch": arch, "shape": shape_id,
        "mesh": "x".join(map(str, mshape.values())) if world not in
        (256, 512) else mesh_tag(multi_pod),
        "variant": variant, "recipe": api.recipe,
        "n_params": api.n_params(),
        "n_active_params": cfg.n_active_params(),
        "chips": world, "tokens": _tokens(shape), "dtype": cd}
    out: list = []
    t0 = time.time()
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = I.materialize(
            _param_specs(api, DTYPES[parallel.param_dtype]), api)
        if shape.kind == "train":
            opt = Optimizer(OptConfig(name=parallel.optimizer,
                                      state_dtype=parallel.opt_state_dtype))
            state = {"params": params, "opt": opt.init(params)}
            batch = I.materialize(I.batch_specs(api, shape), api)
            fn, args = make_train_step(api, opt), (state, batch)
        elif shape.kind == "prefill":
            params = api.load(params)
            batch = I.materialize(I.batch_specs(api, shape), api)
            fn, args = api.prefill_fn, (params, batch)
        else:
            params = api.load(params)
            caches = I.materialize(I.cache_specs(api, shape), api)
            tok, pos = I.materialize(I.decode_token_specs(api, shape), api)
            fn, args = api.decode_fn, (params, caches, tok, pos)
        arg_bytes = _nbytes(args)
        if shape.kind == "train":
            # the step counts are host scalars the optimizer reads: fake
            # tensors that keep their constant value
            state["step"], state["opt"]["count"] = (
                torch.tensor(0, dtype=torch.int32) for _ in range(2))
        ana = op_analysis.analyze(fn, *args, memory=True, result=out)
    result["lower_s"] = round(time.time() - t0, 2)
    result["memory"] = {"argument_size_bytes": arg_bytes,
                        "output_size_bytes": _nbytes(out[0]),
                        "temp_size_bytes": int(ana["peak_bytes"])}
    result["flops_per_device"] = ana["flops"]
    result["bytes_per_device"] = ana["bytes"]
    result["bytes_inner_loops_per_device"] = ana["bytes_inner_loops"]
    result["collectives_per_device"] = {
        "bytes_by_type": ana["collective_bytes"],
        "counts": ana["collective_counts"],
        "total_bytes": ana["collective_total"]}
    result["top_collectives"] = ana["top_collectives"]
    result["top_bytes_ops"] = ana["top_bytes_ops"]
    result["kernels"] = ana["kernels"]
    result["ops"] = ana["ops"]
    return result


def run_cell_subprocess(arch: str, shape: str, multi_pod: bool,
                        overrides=(), variant: str = "baseline",
                        out: Optional[str] = None,
                        timeout: float = 3600) -> Dict[str, Any]:
    """``run_cell`` in a fresh process (``python -m
    repro_torch.launch.dryrun``); writes the cell to ``out`` (default
    ``cell_path``) and returns it. Raises with the child's stderr if it
    fails."""
    out = out or cell_path(arch, shape, multi_pod, variant)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           arch, "--shape", shape, "--out", out, "--variant", variant]
    if multi_pod:
        cmd.append("--multi-pod")
    for ov in overrides:
        cmd += ["--override", ov]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=timeout, cwd=ROOT)
    if proc.returncode != 0:
        raise RuntimeError(f"dry run {arch} {shape} failed:\n"
                           f"{proc.stderr[-3000:]}")
    with open(out) as f:
        return json.load(f)


def parse_overrides(items) -> Dict[str, Any]:
    overrides: Dict[str, Any] = {}
    for ov in items:
        k, v = ov.split("=", 1)
        try:
            overrides[k] = json.loads(v.lower() if v in ("True", "False")
                                      else v)
        except json.JSONDecodeError:
            overrides[k] = v
    return overrides


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--out", default=None,
                    help="default results/dryrun_torch/<cell>.json")
    ap.add_argument("--override", action="append", default=[],
                    help="ParallelConfig overrides, e.g. fused_xent=True")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    res = run_cell(args.arch, args.shape, args.multi_pod,
                   parse_overrides(args.override), args.variant)
    out = args.out or cell_path(args.arch, args.shape, args.multi_pod,
                                args.variant)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps({k: res[k] for k in (
        "arch", "shape", "mesh", "recipe", "flops_per_device",
        "bytes_per_device", "collectives_per_device", "memory",
        "lower_s")}, indent=1))
    return res


if __name__ == "__main__":
    main()
