"""Mixture-of-Experts layer of the port (olmoe, kimi-k2) on one device.

Counterpart of ``repro.models.moe`` where it has no mesh: every JAX path
(``_moe_sp`` at prefill, ``_moe_replicated`` and ``_moe_weight_stationary``
at decode) falls back to ``_moe_dense_fallback`` when there is no mesh or
the model axis has size 1, so that is the path ported here, with its
capacity formula at prefill and decode alike. The ``shard_map`` bodies
(all-to-all, replicated, weight-stationary) wait for the mesh port.

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


def moe_mlp_defs(cfg: ModelConfig) -> Dict[str, L.ParamDef]:
    assert cfg.moe is not None
    D, F, E = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    return {
        "ln": L.ParamDef((D,), ("embed",), "ones"),
        "router": L.ParamDef((D, E), (None, None)),
        "wg": L.ParamDef((E, D, F), ("experts", "embed", None)),
        "wu": L.ParamDef((E, D, F), ("experts", "embed", None)),
        "wd": L.ParamDef((E, F, D), ("experts", None, "embed")),
    }


def moe_block_defs(cfg: ModelConfig) -> Dict[str, Any]:
    return {"attn": attn_defs(cfg), "moe": moe_mlp_defs(cfg)}


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


def moe_mlp_apply(ctx: Ctx, p, x):
    """Returns (x + moe(x), aux). At decode the aux losses, which JAX
    computes and drops, are not computed (aux is {})."""
    h = _norm(ctx.cfg, p, x)
    with_aux = ctx.mode != "decode"
    y, lb, rz = _moe_dense_fallback(ctx.cfg, p, h, with_aux=with_aux,
                                    train=ctx.mode == "train")
    aux = {"load_balance": lb, "router_z": rz} if with_aux else {}
    return x + y, aux


def moe_block_apply(ctx: Ctx, p, x, cache=None):
    x, new_cache = attn_apply(ctx, p["attn"], x, cache)
    x, aux = moe_mlp_apply(ctx, p["moe"], x)
    return x, new_cache, aux
