"""Mixture-of-Experts layer of the port (olmoe, kimi-k2), counterpart of
``repro.models.moe``, on one device or with expert parallelism on a mesh.

* One device (no mesh, or a model axis of size 1): every JAX path falls
  back to ``_moe_dense_fallback``, every expert computed locally through a
  capacity buffer, with its capacity formula at prefill and decode alike.
* Train / prefill on a mesh (``_moe_sp``): the residual is sequence-
  sharded over model; each device routes its tokens and exchanges them
  with the expert-owning devices by a capacity-bounded all-to-all over
  model (``_moe_local_a2a``), computes its ``E / n`` experts and reverses
  the exchange.
* Decode on a mesh (``_moe_replicated``): tokens replicated over model;
  each device computes its experts' share and one all-reduce over model
  sums them, with JAX's two capacity formulas (``moe_decode_cap_mult`` 4.0
  against the tight one). ``_moe_weight_stationary`` (the hillclimb
  lever) keeps the experts' d_ff sharded over the batch axes and moves the
  activations instead: an all-gather over the batch axes and one
  all-reduce over model and batch axes.

The load-balance and router-z losses are those of all tokens on every
path: a mesh body returns its partial sums (``Partial`` DTensors), where
JAX's bodies keep each device's own values.

Routing is sorts, gathers and scatters, as in JAX, and stays on the device:
no host read on the dispatch and combine path, and the expert capacity is
a Python int computed from the token count (a shape). The per-expert
products are the hand-written ``moe_gmm`` kernel on the card
(``repro_torch.kernels.moe_gmm``), three launches per layer, which reads
the per-expert row counts from device memory; on the CPU the kernel's
wrapper takes its plain version. In train mode they are JAX's einsums
(``_expert_ffn_einsum``), under autograd.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.moe_gmm.ops import grouped_matmul
from repro_torch.models import layers as L
from repro_torch.models.transformer import Ctx, _norm, attn_apply, attn_defs
from repro_torch.sharding import spmd
from repro_torch.sharding.partition import constrain


def moe_mlp_defs(cfg: ModelConfig,
                 weight_stationary: bool = False) -> Dict[str, L.ParamDef]:
    """Weight-stationary (inference): the per-expert d_ff over the batch
    axes ("expert_mlp") instead of FSDP over d_model, as in JAX."""
    assert cfg.moe is not None
    D, F, E = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    d_lg = None if weight_stationary else "embed"
    f_lg = "expert_mlp" if weight_stationary else None
    return {
        "ln": L.ParamDef((D,), ("embed",), "ones"),
        "router": L.ParamDef((D, E), (None, None)),
        "wg": L.ParamDef((E, D, F), ("experts", d_lg, f_lg)),
        "wu": L.ParamDef((E, D, F), ("experts", d_lg, f_lg)),
        "wd": L.ParamDef((E, F, D), ("experts", f_lg, d_lg)),
    }


def moe_block_defs(cfg: ModelConfig, weight_stationary: bool = False
                   ) -> Dict[str, Any]:
    return {"attn": attn_defs(cfg),
            "moe": moe_mlp_defs(cfg, weight_stationary)}


# --------------------------------------------------------------------------
# Routing helpers
# --------------------------------------------------------------------------
def _topk_route(x, w_router, top_k: int):
    """x: (T, D) -> (weights (T,k) f32, experts (T,k) int64, probs (T,E)
    f32). Expert ids are torch's index type, int64."""
    logits = x.float() @ w_router.float()
    probs = torch.softmax(logits, dim=-1)
    topw, tope = torch.topk(probs, top_k, dim=-1, sorted=True)
    topw = topw / topw.sum(-1, keepdim=True).clamp_min(1e-9)
    return topw, tope, probs


def _positions_in_expert(flat_e, n_experts: int):
    """Rank of each (token,k) pair within its expert (by stable sort)."""
    tk = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    run_start = torch.searchsorted(sorted_e, sorted_e, side="left")
    ranks_sorted = torch.arange(tk, device=flat_e.device) - run_start
    return torch.empty_like(ranks_sorted).scatter_(0, order, ranks_sorted)


def aux_losses(probs, tope, n_experts: int) -> Dict[str, torch.Tensor]:
    """Switch-style load-balancing loss + router z-loss."""
    T = probs.shape[0]
    k = tope.shape[-1]
    flat = tope.reshape(-1)
    counts = torch.zeros((n_experts,), dtype=torch.float32,
                         device=probs.device).index_add_(
        0, flat, torch.ones(flat.shape, dtype=torch.float32,
                            device=probs.device))
    frac_tokens = counts / max(T * k, 1)
    frac_probs = probs.mean(dim=0)
    lb = n_experts * torch.sum(frac_tokens * frac_probs)
    z = torch.mean(torch.square(torch.logsumexp(
        torch.log(probs.clamp_min(1e-20)), dim=-1)))
    return {"load_balance": lb, "router_z": z}


def _expert_ffn(wg, wu, wd, xs, counts):
    """xs: (E, C, D) -> (E, C, D); SwiGLU per expert on the grouped-matmul
    kernel. Rows >= counts[e] of xs are zero and come out zero."""
    g = grouped_matmul(xs, wg, counts)
    u = grouped_matmul(xs, wu, counts)
    h = L.swiglu(g, u)
    return grouped_matmul(h, wd, counts)


def _expert_ffn_einsum(wg, wu, wd, xs):
    """JAX's ``_expert_ffn``: the same SwiGLU per expert as einsums over
    the whole capacity buffer, which autograd differentiates (the kernel
    has no backward). The train path."""
    g = torch.einsum("ecd,edf->ecf", xs, wg)
    u = torch.einsum("ecd,edf->ecf", xs, wu)
    h = L.swiglu(g, u)
    return torch.einsum("ecf,efd->ecd", h, wd)


def _capacity(T: int, top_k: int, n_experts: int,
              capacity_factor: float) -> int:
    """JAX's ``_moe_dense_fallback`` capacity: the fair share times the
    capacity factor, padded to a multiple of 8 (at least 8)."""
    cap = int(np.ceil(T * top_k / n_experts * capacity_factor))
    return max(8, int(np.ceil(cap / 8) * 8))


# --------------------------------------------------------------------------
# Single-device path
# --------------------------------------------------------------------------
def _moe_dense_fallback(cfg: ModelConfig, p, x, with_aux: bool = True,
                        train: bool = False):
    """No-mesh path: every expert computed locally via a capacity buffer.
    Pairs ranked at or past the capacity are dropped, as in JAX. Returns
    (y, load_balance, router_z); the losses are None unless ``with_aux``.
    ``train`` computes the experts with ``_expert_ffn_einsum``."""
    moe = cfg.moe
    E, k = moe.n_experts, moe.top_k
    B, S, D = x.shape
    T = B * S
    dev = x.device
    xt = x.reshape(T, D)
    topw, tope, probs = _topk_route(xt, p["router"], k)
    flat_e = tope.reshape(-1)
    flat_w = topw.reshape(-1)
    flat_t = torch.arange(T, device=dev)[:, None].expand(T, k).reshape(-1)
    ranks = _positions_in_expert(flat_e, E)
    cap = _capacity(T, k, E, moe.capacity_factor)
    valid = ranks < cap
    slot = flat_e * cap + torch.where(valid, ranks, 0)
    buf = torch.zeros((E * cap, D), dtype=xt.dtype, device=dev).index_add_(
        0, slot, torch.where(valid[:, None], xt[flat_t], 0))
    # rows in use per expert, bincount(flat_e[valid]) without the host read
    # that a boolean mask or bincount's size check would make
    counts = torch.zeros((E,), dtype=torch.int32, device=dev).scatter_add_(
        0, flat_e, valid.to(torch.int32))
    xs = buf.reshape(E, cap, D)
    out = (_expert_ffn_einsum(p["wg"], p["wu"], p["wd"], xs) if train else
           _expert_ffn(p["wg"], p["wu"], p["wd"], xs, counts))
    out = out.reshape(E * cap, D)
    gathered = out[slot] * torch.where(valid, flat_w, 0.0)[:, None].to(
        out.dtype)
    # JAX's .at[flat_t].add: flat_t is each token repeated k times, so the
    # scatter is a sum over k (deterministic, unlike an atomic index_add_)
    y = gathered.view(T, k, D).sum(1)
    if not with_aux:
        return y.reshape(B, S, D), None, None
    aux = aux_losses(probs, tope, E)
    return y.reshape(B, S, D), aux["load_balance"], aux["router_z"]


def _aux_partials(probs, tope, n_experts: int):
    """The sums the aux losses are made of, over this device's tokens:
    expert picks (E,), router probabilities (E,), router-z terms ()."""
    flat = tope.reshape(-1)
    counts = torch.zeros((n_experts,), dtype=torch.float32,
                         device=probs.device).index_add_(
        0, flat, torch.ones(flat.shape, dtype=torch.float32,
                            device=probs.device))
    z = torch.square(torch.logsumexp(torch.log(probs.clamp_min(1e-20)),
                                     dim=-1)).sum()
    return counts, probs.sum(dim=0), z


def _aux_from_partials(counts, psum, zsum, T: int, k: int, E: int):
    """``aux_losses`` of T tokens from the sums of ``_aux_partials``."""
    lb = E * torch.sum((counts / max(T * k, 1)) * (psum / T))
    return {"load_balance": lb, "router_z": zsum / T}


def _route_local(cfg: ModelConfig, xt, w_router, e0: int, e_loc: int,
                 cap_of):
    """Route tokens xt (T, D) and keep the pairs of experts [e0, e0 +
    e_loc): returns (flat_t, slot, valid, weight, cap) of the capacity
    buffer (e_loc * cap, D) and (topw, tope, probs); ``cap_of(T)`` is the
    capacity formula."""
    moe = cfg.moe
    k = moe.top_k
    T = xt.shape[0]
    topw, tope, probs = _topk_route(xt, w_router, k)
    local_e = tope - e0
    mine = (local_e >= 0) & (local_e < e_loc)
    flat_e = torch.where(mine, local_e, 0).reshape(-1)
    flat_w = torch.where(mine, topw, 0.0).reshape(-1)
    flat_m = mine.reshape(-1)
    flat_t = torch.arange(T, device=xt.device)[:, None].expand(T, k) \
        .reshape(-1)
    ranks = _positions_in_expert(torch.where(flat_m, flat_e, e_loc),
                                 e_loc + 1)
    cap = cap_of(T)
    valid = flat_m & (ranks < cap)
    slot = flat_e * cap + torch.where(valid, ranks, 0)
    return (flat_t, slot, valid, torch.where(valid, flat_w, 0.0), cap,
            (topw, tope, probs))


def _dispatch(xt, flat_t, slot, valid, rows: int):
    return torch.zeros((rows, xt.shape[1]), dtype=xt.dtype,
                       device=xt.device).index_add_(
        0, slot, torch.where(valid[:, None], xt[flat_t], 0))


def _combine(out, slot, weight, T: int, k: int):
    """Each token's weighted sum of its pairs' rows of ``out`` (the sum
    over k, deterministic, as in ``_moe_dense_fallback``)."""
    gathered = out[slot] * weight[:, None].to(out.dtype)
    return gathered.view(T, k, out.shape[1]).sum(1)


def _ffn(train: bool, wg, wu, wd, xs):
    """The experts' SwiGLU on a capacity buffer (e, C, D): the moe_gmm
    kernel with every row counted (rows of unused slots are zero and give
    zero), or JAX's einsums under autograd."""
    if train:
        return _expert_ffn_einsum(wg, wu, wd, xs)
    counts = torch.full((xs.shape[0],), xs.shape[1], dtype=torch.int32,
                        device=xs.device)
    return _expert_ffn(wg, wu, wd, xs, counts)


def _moe_local_a2a(ctx: Ctx, x_loc, w_router, wg, wu, wd):
    """Per-device body of ``_moe_sp``. x_loc: (B_loc, S_loc, D); wg, wu,
    wd: this device's e_loc = E / n experts. Returns (y, pick counts,
    probability sums, router-z sum) of this device's tokens."""
    cfg = ctx.cfg
    moe = cfg.moe
    E, k = moe.n_experts, moe.top_k
    n = ctx.model_axis_size
    axis = ctx.parallel.model_axis
    e_loc = E // n
    B, S, D = x_loc.shape
    T = B * S
    xt = x_loc.reshape(T, D)
    flat_t, slot, valid, weight, cap, (topw, tope, probs) = _route_local(
        cfg, xt, w_router, 0, E,
        lambda T: _capacity(T, k, E, moe.capacity_factor))
    buf = _dispatch(xt, flat_t, slot, valid, E * cap)
    # the exchange: block i of the send buffer holds device i's experts;
    # after it, block i holds what device i sent for this device's experts
    recv = spmd.all_to_all(buf.reshape(n, e_loc * cap, D), ctx.mesh, axis)
    recv = recv.reshape(n, e_loc, cap, D).transpose(0, 1) \
        .reshape(e_loc, n * cap, D)
    out = _ffn(ctx.mode == "train", wg, wu, wd, recv)
    out = out.reshape(e_loc, n, cap, D).transpose(0, 1) \
        .reshape(n, e_loc * cap, D)
    back = spmd.all_to_all(out, ctx.mesh, axis).reshape(E * cap, D)
    y = _combine(back, slot, weight, T, k).reshape(B, S, D)
    return (y,) + _aux_partials(probs, tope, E)


def _moe_sp(ctx: Ctx, p, x):
    """x: (B, S, D) with batch over the batch axes and S over model."""
    cfg = ctx.cfg
    if not ctx.sharded:
        y, lb, rz = _moe_dense_fallback(cfg, p, x, train=ctx.mode == "train")
        return y, {"load_balance": lb, "router_z": rz}
    x_spec = ctx.place(batch=0, model=1)
    e_spec = ctx.place(model=0)
    partial = spmd.placements(
        ctx.mesh, **{a: "partial" for a in ctx.mesh.mesh_dim_names})
    y, counts, psum, zsum = spmd.shard_map(
        lambda *a: _moe_local_a2a(ctx, *a), ctx.mesh,
        (x_spec, ctx.place(), e_spec, e_spec, e_spec),
        (x_spec, partial, partial, partial))(
        x, p["router"], p["wg"], p["wu"], p["wd"])
    T = x.shape[0] * x.shape[1]
    return y, _aux_from_partials(counts, psum, zsum, T, cfg.moe.top_k,
                                 cfg.moe.n_experts)


def _decode_capacity(cap_mult: float, T: int, k: int, E: int) -> int:
    """JAX's decode capacities: the baseline formula at ``cap_mult`` 4.0,
    the tight one (the hillclimb's) otherwise."""
    if cap_mult == 4.0:
        cap = int(np.ceil(T * k / max(E, 1) * 4)) + 8
        return int(np.ceil(cap / 8) * 8)
    return max(8, int(np.ceil(np.ceil(T * k / max(E, 1) * cap_mult) / 8)
                      * 8))


def _moe_replicated(ctx: Ctx, p, x):
    """Decode path: x replicated over model; each device computes its
    local experts' share and one all-reduce over model sums them.
    x: (B, S=1, D)."""
    cfg = ctx.cfg
    moe = cfg.moe
    n = ctx.model_axis_size
    if not ctx.sharded:
        y, _, _ = _moe_dense_fallback(cfg, p, x, with_aux=False)
        return y
    axis = ctx.parallel.model_axis
    E, k = moe.n_experts, moe.top_k
    e_loc = E // n
    cap_mult = ctx.parallel.moe_decode_cap_mult

    def body(x_loc, w_router, wg, wu, wd):
        B, S, D = x_loc.shape
        T = B * S
        xt = x_loc.reshape(T, D)
        e0 = spmd.axis_index(ctx.mesh, axis) * e_loc
        flat_t, slot, valid, weight, cap, _ = _route_local(
            cfg, xt, w_router, e0, e_loc,
            lambda T: _decode_capacity(cap_mult, T, k, E))
        buf = _dispatch(xt, flat_t, slot, valid, e_loc * cap)
        out = _ffn(False, wg, wu, wd, buf.reshape(e_loc, cap, D))
        y = _combine(out.reshape(e_loc * cap, D), slot, weight, T, k)
        return spmd.psum(y, ctx.mesh, axis).reshape(B, S, D)

    x_spec = ctx.place(batch=0)
    e_spec = ctx.place(model=0)
    return spmd.shard_map(body, ctx.mesh,
                          (x_spec, ctx.place(), e_spec, e_spec, e_spec),
                          x_spec)(x, p["router"], p["wg"], p["wu"], p["wd"])


def _moe_weight_stationary(ctx: Ctx, p, x):
    """Decode MoE without moving weights: expert d_ff sharded over the
    batch axes, experts over model; the (tiny) decode activations are
    all-gathered over the batch axes, every device computes its expert x
    d_ff-slice partials, and one all-reduce over model and batch axes
    combines them."""
    cfg = ctx.cfg
    moe = cfg.moe
    n = ctx.model_axis_size
    baxes = ctx.batch_axes()
    if not ctx.sharded or not baxes:
        y, _, _ = _moe_dense_fallback(cfg, p, x, with_aux=False)
        return y
    axis = ctx.parallel.model_axis
    E, k = moe.n_experts, moe.top_k
    e_loc = E // n
    cap_mult = ctx.parallel.moe_decode_cap_mult

    def body(x_loc, w_router, wg, wu, wd):
        B_loc, S, D = x_loc.shape
        x_all = spmd.all_gather(x_loc, ctx.mesh, baxes, dim=0)
        T = x_all.shape[0] * S
        xt = x_all.reshape(T, D)
        e0 = spmd.axis_index(ctx.mesh, axis) * e_loc
        flat_t, slot, valid, weight, cap, _ = _route_local(
            cfg, xt, w_router, e0, e_loc,
            lambda T: max(8, int(np.ceil(np.ceil(
                T * k / max(E, 1) * cap_mult) / 8) * 8)))
        buf = _dispatch(xt, flat_t, slot, valid, e_loc * cap)
        out = _ffn(False, wg, wu, wd, buf.reshape(e_loc, cap, D))
        y = _combine(out.reshape(e_loc * cap, D), slot, weight, T, k)
        y = spmd.psum(y, ctx.mesh, (axis,) + baxes)
        d = spmd.axis_index(ctx.mesh, baxes)
        return y.reshape(-1, S, D)[d * B_loc:(d + 1) * B_loc]

    x_spec = ctx.place(batch=0)
    w_spec = ctx.place(model=0, batch=2)
    wd_spec = ctx.place(model=0, batch=1)
    return spmd.shard_map(body, ctx.mesh,
                          (x_spec, ctx.place(), w_spec, w_spec, wd_spec),
                          x_spec)(x, p["router"], p["wg"], p["wu"], p["wd"])


def moe_mlp_apply(ctx: Ctx, p, x):
    """Returns (x + moe(x), aux). At decode the aux losses, which JAX
    computes and drops, are not computed (aux is {})."""
    h = _norm(ctx.cfg, p, x)
    if ctx.mode == "decode":
        ws = ctx.parallel is not None and ctx.parallel.moe_weight_stationary
        y = (_moe_weight_stationary if ws else _moe_replicated)(ctx, p, h)
        aux = {}
    else:
        h = constrain(h, ctx.rules, ("batch", "seq", None))
        y, aux = _moe_sp(ctx, p, h)
    y = constrain(y, ctx.rules, ("batch", "seq", None))
    return x + y, aux


def moe_block_apply(ctx: Ctx, p, x, cache=None):
    x, new_cache = attn_apply(ctx, p["attn"], x, cache)
    x, aux = moe_mlp_apply(ctx, p["moe"], x)
    return x, new_cache, aux
