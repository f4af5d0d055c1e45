"""One rank of the port's multi-device CPU checks (tests/
test_torch_sharding.py, tests/test_torch_sharding_families.py): a gloo
group with a ``file://`` rendezvous, a (data, model) mesh, and per job the
loss and gradients, the prefill and a decode step of a reduced model of
any family whose parameters come from JAX's numpy tree. Rank 0 puts the
gathered (``full_tensor``) results on the queue as numpy arrays. Imports
torch and the port only: every spawned rank imports this module."""
import dataclasses
import traceback

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor


def _full(t):
    t = t.full_tensor() if isinstance(t, DTensor) else t
    return t.detach().numpy()


def _tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def _replicating():
    return DTensor._op_dispatcher._allow_implicit_replication


def _placed(api, logical, a):
    return distribute_tensor(torch.as_tensor(a), api.mesh,
                             api.rules_a.placements(logical, a.shape),
                             src_data_rank=None)


def run_job(job, mesh):
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import MoEConfig, ParallelConfig, ShapeConfig
    from repro_torch.launch import inputs as I
    from repro_torch.convert import params_from_jax_numpy
    from repro_torch.models.model import build_model
    from repro_torch.roofline.op_analysis import analyze
    from repro_torch.training.step import loss_and_grads

    cfg = reduced(get_config(job["arch"]), **job["cfg"])
    if job["moe"]:
        cfg = dataclasses.replace(cfg, moe=MoEConfig(**job["moe"]))
    api = build_model(cfg, ParallelConfig(**job["par"]), "cpu", mesh=mesh)
    # DTensor's implicit replication after each call: on only inside one
    flags = [_replicating()]
    params = params_from_jax_numpy(job["params"], cfg, "cpu", api=api)
    # tokens and labels (B, S); the stub patches / frames (B, n, D)
    batch = {k: _placed(api, ("batch",) + (None,) * (v.ndim - 1), v)
             for k, v in job["batch"].items()}
    loss, metrics, grads = loss_and_grads(api, params, batch)
    flags.append(_replicating())
    out = {"recipe": api.recipe, "loss": float(_full(loss)),
           "metrics": {k: float(_full(v)) for k, v in metrics.items()},
           "grads": _tree(_full, grads),
           "grad_placements": sorted({str(g.placements) for g in
                                      _leaves(grads)})}
    served = api.load(params)
    prefill = analyze(api.prefill_fn, served,
                      {k: v for k, v in batch.items() if k != "labels"},
                      result=(res := []))
    logits, caches = res[0]
    flags.append(_replicating())
    out["prefill_collectives"] = prefill["collective_counts"]
    out["prefill_kernels"] = {k: v["calls"]
                              for k, v in prefill["kernels"].items()}
    out["prefill_logits"] = _full(logits)
    out["prefill_caches"] = _tree(_full, caches)
    B = batch["tokens"].shape[0]
    specs = I.cache_specs(api, ShapeConfig("decode", job["max_seq"], B,
                                           "decode"))
    grown = _grow(api, out["prefill_caches"], specs, job["max_seq"])
    tok = _placed(api, ("batch", None), job["decode_tokens"])
    pos = _placed(api, ("batch",), job["decode_pos"])
    decode = analyze(api.decode_fn, served, grown, tok, pos,
                     result=(res := []))
    logits, caches = res[0]
    flags.append(_replicating())
    out["replication_after_calls"] = flags
    out["decode_collectives"] = decode["collective_counts"]
    out["decode_logits"] = _full(logits)
    out["decode_caches"] = _tree(_full, caches)
    return out


def _grow(api, tree, specs, max_seq):
    """The prefill caches (numpy) as the decode step takes them, copied: each
    "k" / "v" leaf (L, B, S, H, D) zero-padded to ``max_seq`` rows, the
    state leaves as they are, each placed as ``launch.inputs`` lays the
    leaf out."""
    out = {}
    for k, c in tree.items():
        if isinstance(c, dict):
            out[k] = _grow(api, c, specs[k], max_seq)
            continue
        if k in ("k", "v"):
            g = np.zeros(c.shape[:2] + (max_seq,) + c.shape[3:], c.dtype)
            g[:, :, :c.shape[2]] = c
            c = g
        # a copy: the decode step writes its caches in place
        out[k] = _placed(api, specs[k].logical, np.array(c))
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def run(rank, world, init, shape, jobs, queue):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        from repro_torch.launch.mesh import make_local_mesh
        mesh = make_local_mesh(*shape, device="cpu")
        out = {name: run_job(job, mesh) for name, job in jobs.items()}
        if rank == 0:
            queue.put(("ok", out))
    except BaseException:
        queue.put(("error", rank, traceback.format_exc()))
        raise
    finally:
        dist.destroy_process_group()
