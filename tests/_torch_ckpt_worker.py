"""One rank of the port's elastic-checkpoint check (tests/
test_torch_checkpoint_mesh.py): a gloo group with a ``file://``
rendezvous; a reduced training state, one step in, saved from a (2, 4)
mesh and restored onto (4, 2) and (8, 1) meshes of the same ranks. Rank 0
puts on the queue the saved state's full arrays and each restore's full
arrays and placements, as numpy (bfloat16 as its int16 bits). Imports
torch and the port only: every spawned rank imports this module."""
import traceback

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

ARCH, OVER = "recurrentgemma-9b", {"n_layers": 5}


def bits(t):
    """A leaf's full array, bfloat16 as its int16 bits."""
    t = (t.full_tensor() if isinstance(t, DTensor) else t).detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().copy()


def tree(fn, t):
    if isinstance(t, dict):
        return {k: tree(fn, v) for k, v in t.items()}
    return fn(t)


def parts():
    """(config, ParallelConfig, optimizer) of the checked state: f32
    masters, bf16 adamw moments."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.training.optimizer import OptConfig, Optimizer
    cfg = reduced(get_config(ARCH), **OVER)
    par = ParallelConfig(param_dtype="float32", compute_dtype="float32",
                         q_block=8, kv_block=8)
    opt = Optimizer(OptConfig(name="adamw", lr=1e-2, warmup=0,
                              state_dtype="bfloat16"))
    return cfg, par, opt


def state_on(mesh, seed):
    """A training state on ``mesh`` (None: one device) after one step."""
    from repro_torch.data.pipeline import (DataConfig, ShardedLoader,
                                           TokenSource)
    from repro_torch.models.model import build_model
    from repro_torch.sharding.partition import batch_axes
    from repro_torch.training.step import make_train_state, make_train_step
    cfg, par, opt = parts()
    api = build_model(cfg, par, "cpu", mesh=mesh)
    state = make_train_state(api, opt, seed)
    data = DataConfig(seq_len=16, global_batch=8, vocab_size=cfg.vocab_size,
                      seed=seed)
    loader = ShardedLoader(TokenSource(data), "cpu",
                           mesh=mesh if api.sharded else None,
                           batch_axes=batch_axes(mesh, par, 8)
                           if mesh is not None else ())
    _, batch = next(loader.iterate(0))
    state, _ = make_train_step(api, opt)(state, batch)
    return state


def run(rank, world, init, ckpt_dir, queue):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.checkpoint.ckpt import CheckpointManager
        names = ("data", "model")
        src = init_device_mesh("cpu", (2, 4), mesh_dim_names=names)
        state = state_on(src, seed=0)
        ckpt = CheckpointManager(ckpt_dir)
        ckpt.save(state, 1, extra={"data_step": 1})
        out = {"saved": tree(bits, state), "restored": {}}
        for shape in ((4, 2), (8, 1)):
            mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
            like = state_on(mesh, seed=5)
            got, extra = ckpt.restore(like)
            out["restored"][shape] = {
                "bits": tree(bits, got), "extra": extra,
                "placements_kept": all(
                    tuple(g.placements) == tuple(w.placements)
                    for g, w in zip(_leaves(got), _leaves(like))
                    if isinstance(w, DTensor)),
                "dtensor_params": all(isinstance(w, DTensor) for w in
                                      _leaves(got["params"]))}
        if rank == 0:
            queue.put(("ok", out))
    except BaseException:
        queue.put(("error", rank, traceback.format_exc()))
        raise
    finally:
        dist.destroy_process_group()


def _leaves(t):
    if isinstance(t, dict):
        return [x for v in t.values() for x in _leaves(v)]
    return [t]
