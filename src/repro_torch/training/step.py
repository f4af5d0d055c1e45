"""The train step of the port: ``loss_fn`` + ``torch.autograd.grad``,
optional microbatch accumulation, optional int8 error-feedback gradient
compression, then the optimizer update (counterpart of
``repro.training.step``).

The state is {"params": float32 masters, "opt": the optimizer's state,
"step": 0-d int32 on the CPU}, and a step updates it in place where JAX
donates it (``donate_argnums=(0,)``). ``state_pspecs`` gives the
state's partition specs (JAX's), and on a mesh of more than one device
``make_train_state`` places the parameters, and so the state, by them.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models import layers as L
from repro_torch.models.model import DTYPES, ModelApi
from repro_torch.sharding import spmd
from repro_torch.training.optimizer import Optimizer


def make_train_state(api: ModelApi, opt: Optimizer, seed: int = 0):
    """Parameters drawn from ``seed`` on the model's device in
    ``parallel.param_dtype`` (the masters: no cast to the compute dtype,
    ``loss_fn`` casts on every call), the optimizer's state, step 0."""
    params = L.init_params(api.defs, seed=seed,
                           dtype=DTYPES[api.parallel.param_dtype],
                           device=api.device)
    params = L.tree_map(api._place, params)
    return {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32)}


def state_pspecs(api: ModelApi, opt: Optimizer):
    """JAX's ``state_pspecs``: the state tree's ``Rules.spec`` tuples."""
    pspecs = api.param_pspecs()
    return {"params": pspecs,
            "opt": opt.state_pspecs(pspecs, api.param_shapes()),
            "step": ()}


# --------------------------------------------------------------------------
# int8 gradient compression with error feedback: quantize -> dequantize
# around the (implicit) cross-pod reduction, keeping the quantization
# residual in an error-feedback buffer (JAX's ``compress_grads``).
# --------------------------------------------------------------------------
def compress_grads(grads, ef_buf):
    """Returns (dequantized grads in each leaf's dtype, new residuals)."""
    def one(path, g):
        e = ef_buf
        for k in path:
            e = e[k]
        g32 = g.float() + e
        scale = torch.clamp(g32.abs().max(), min=1e-12) / 127.0
        q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
        deq = q.float() * scale
        return deq.to(g.dtype), g32 - deq

    out = L.tree_map(one, grads)
    return (L.tree_map(lambda _, t: t[0], out),
            L.tree_map(lambda _, t: t[1], out))


def loss_and_grads(api: ModelApi, params, batch):
    """(loss, metrics, grads) of ``api.loss_fn`` at ``params``, all
    detached, the grads a tree like ``params``: the masters are detached
    (no copy) into leaves that require grad, so autograd's graph never
    reaches the state."""
    leaves = L.tree_map(lambda _, p: p.detach().requires_grad_(), params)
    with torch.enable_grad(), spmd.implicit_replication(api.sharded):
        loss, metrics = api.loss_fn(leaves, batch)
        flat = L.tree_leaves(leaves)
        gs = torch.autograd.grad(loss, flat, allow_unused=True,
                                 materialize_grads=True)
    it = iter(gs)
    # on a mesh, each gradient in its parameter's placements (a replicated
    # leaf's comes back as a partial sum over the batch axes)
    grads = L.tree_map(lambda _, p: _like(next(it), p), params)
    metrics = {k: v.detach() if torch.is_tensor(v) else v
               for k, v in metrics.items()}
    return loss.detach(), metrics, grads


def _like(g, p):
    if isinstance(p, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(api: ModelApi, opt: Optimizer):
    """``train_step(state, batch) -> (state, metrics)``. ``grad_accum`` >
    1 splits the batch into that many microbatches along its first axis
    and averages their gradients in f32 (the metrics are the last
    microbatch's, the loss the mean); ``grad_compress`` "int8_ef" keeps
    its residuals in ``state["opt"]["ef"]``, as JAX does."""
    accum = api.parallel.grad_accum
    use_compress = api.parallel.grad_compress == "int8_ef"

    def accumulate(params, batch):
        B = next(iter(batch.values())).shape[0]
        mb = B // accum
        gacc = L.tree_map(
            lambda _, p: torch.zeros_like(p, dtype=torch.float32), params)
        lsum = 0.0
        for i in range(accum):
            loss, metrics, grads = loss_and_grads(
                api, params, {k: v[i * mb:(i + 1) * mb]
                              for k, v in batch.items()})
            for a, g in zip(L.tree_leaves(gacc), L.tree_leaves(grads)):
                a.add_(g.float())
            lsum = lsum + loss
        for a in L.tree_leaves(gacc):
            a.div_(accum)
        return lsum / accum, metrics, gacc

    def train_step(state, batch):
        with spmd.implicit_replication(api.sharded):
            return step(state, batch)

    def step(state, batch):
        if accum > 1:
            loss, metrics, grads = accumulate(state["params"], batch)
        else:
            loss, metrics, grads = loss_and_grads(api, state["params"],
                                                  batch)
        opt_state = state["opt"]
        if use_compress:
            ef = opt_state.pop("ef", None)
            if ef is None:
                ef = L.tree_map(
                    lambda _, p: torch.zeros_like(p, dtype=torch.float32),
                    state["params"])
            grads, ef = compress_grads(grads, ef)
            opt.update(grads, opt_state, state["params"])
            opt_state["ef"] = ef
        else:
            opt.update(grads, opt_state, state["params"])
        state["step"] += 1
        metrics = dict(metrics)
        metrics["loss"] = loss
        return state, metrics

    return train_step
