"""RG-LRU recurrent block + hybrid blocks of the port (RecurrentGemma /
Griffin). [arXiv:2402.19427]

Counterpart of ``repro.models.rglru``, on one device or on a mesh.
The Griffin residual block is a temporal mixer (the RG-LRU recurrence or
local MQA attention) and an MLP. RG-LRU per channel c:

    r_t = sigmoid(W_a x_t)            (recurrence gate, block-diagonal W)
    i_t = sigmoid(W_x x_t)            (input gate, block-diagonal W)
    log a_t = -c_exp * softplus(Lambda) * r_t
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Prefill runs the recurrence through ``kernels.rglru_scan.ops.rglru_scan``
where JAX calls ``_rglru_scan`` (an associative scan of the same function,
with the same contract): on the card the hand-written CUDA kernel, on the
CPU its plain version ``_rglru_scan`` (defined here, a per-step loop).
Train mode calls ``_rglru_assoc_scan``, JAX's ``associative_scan`` in
torch ops (log depth, the same order of sums), under autograd, on either
device. Decode is the O(1) update in f32 torch ops; it updates the cache
leaves ``conv`` and ``h`` in place, as the port's Mamba2 block does. The
dtype order is JAX's: gate, x-branch and conv in the compute dtype; r, i,
log_a and the gated input in f32; y cast to x's dtype before the gate.

On a mesh every product is ``layers.dense``; the lru channels are over
the model axis and the gates' ``n_heads`` blocks with them, so a device
holds whole blocks and the block-diagonal product is local
(``_block_diag``); the scan runs under ``spmd.shard_map``, the batch over
the batch axes and the channels over model, with no collective.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rglru_scan.ops import rglru_scan
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.mamba2 import _causal_conv, write_state
from repro_torch.sharding import spmd
from repro_torch.sharding.partition import constrain


def _n_blocks(cfg: ModelConfig) -> int:
    return max(cfg.n_heads, 1)


def rglru_mixer_defs(cfg: ModelConfig) -> Dict[str, L.ParamDef]:
    assert cfg.rglru is not None
    g = cfg.rglru
    D = cfg.d_model
    Wd = g.lru_width or D
    nb = _n_blocks(cfg)
    bw = Wd // nb
    return {
        "ln": L.ParamDef((D,), ("embed",), "ones"),
        "w_gate_branch": L.ParamDef((D, Wd), ("embed", "lru")),
        "w_x_branch": L.ParamDef((D, Wd), ("embed", "lru")),
        "conv": L.ParamDef((g.conv_width, Wd), (None, "lru"), "normal", 0.5),
        # block-diagonal gates: (nb, bw, bw)
        "w_a": L.ParamDef((nb, bw, bw), ("lru_blocks", None, None)),
        "b_a": L.ParamDef((nb, bw), ("lru_blocks", None), "zeros"),
        "w_i": L.ParamDef((nb, bw, bw), ("lru_blocks", None, None)),
        "b_i": L.ParamDef((nb, bw), ("lru_blocks", None), "zeros"),
        "lam": L.ParamDef((Wd,), ("lru",), "ones"),
        "w_out": L.ParamDef((Wd, D), ("lru", "embed")),
    }


def rec_block_defs(cfg: ModelConfig) -> Dict[str, Any]:
    return {"mix": rglru_mixer_defs(cfg), "mlp": T.mlp_defs(cfg)}


def _block_diag_apply(x, w, b, nb):
    """x: (B,S,Wd) -> (B,S,Wd) with block-diagonal weight (nb,bw,bw)."""
    B, S, Wd = x.shape
    bw = Wd // nb
    xb = x.reshape(B, S, nb, bw)
    y = torch.einsum("bsnw,nwv->bsnv", xb, w) + b[None, None]
    return y.reshape(B, S, Wd)


def _block_diag(ctx, x, w, b, nb):
    """``_block_diag_apply``; on a mesh on each device's shard: its lru
    channels are whole blocks when the blocks are over the model axis (JAX
    aligns them), else x is gathered over model."""
    if not isinstance(x, DTensor):
        return _block_diag_apply(x, w, b, nb)
    axis = ctx.parallel.model_axis
    on_model = isinstance(
        w.placements[ctx.mesh.mesh_dim_names.index(axis)], Shard)
    xpl = ctx.place(batch=0, model=2 if on_model else None)
    wpl = ctx.place(model=0 if on_model else None)
    return spmd.shard_map(
        lambda xl, wl, bl: _block_diag_apply(xl, wl, bl, wl.shape[0]),
        ctx.mesh, (xpl, wpl, wpl), xpl)(x, w, b)


def _rglru_scan(log_a, gx, h0=None):
    """The linear recurrence h_t = exp(log_a_t) h_{t-1} + gx_t per channel,
    as a sequential loop (the kernel's plain version). log_a, gx: (B, S,
    C); h0: (B, C) or None, folded into the first step as JAX folds it.
    Returns (h_all (B, S, C) in log_a's dtype, h_last (B, C) f32); all
    arithmetic in f32."""
    a = torch.exp(log_a.float())
    b = gx.float()
    if h0 is not None:
        b = b.clone()
        b[:, 0] += a[:, 0] * h0.float()
    h = torch.zeros_like(b[:, 0])
    hs = []
    for t in range(b.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1).to(log_a.dtype), h


def _interleave(even, odd):
    """Rows of ``even`` at the even positions of dim 1 and of ``odd`` at
    the odd ones (``even`` as long as ``odd`` or one longer)."""
    B, n_odd = odd.shape[0], odd.shape[1]
    pairs = torch.stack([even[:, :n_odd], odd], dim=2).reshape(
        B, 2 * n_odd, *odd.shape[2:])
    return pairs if even.shape[1] == n_odd else \
        torch.cat([pairs, even[:, n_odd:]], dim=1)


def _assoc_scan(a, b):
    """JAX's ``associative_scan`` of (a1, b1) . (a2, b2) = (a1 a2,
    a2 b1 + b2) along dim 1: pairs combined, the half-length scan
    recursively, the even positions fixed up. Depth log2(S), work O(S)."""
    n = a.shape[1]
    if n < 2:
        return a, b
    a0, b0, a1, b1 = a[:, 0:n - 1:2], b[:, 0:n - 1:2], a[:, 1::2], b[:, 1::2]
    odd_a, odd_b = _assoc_scan(a0 * a1, a1 * b0 + b1)
    if n % 2 == 0:
        pa, pb = odd_a[:, :-1], odd_b[:, :-1]
    else:
        pa, pb = odd_a, odd_b
    a2, b2 = a[:, 2::2], b[:, 2::2]
    even_a = torch.cat([a[:, :1], pa * a2], dim=1)
    even_b = torch.cat([b[:, :1], a2 * pb + b2], dim=1)
    return _interleave(even_a, odd_a), _interleave(even_b, odd_b)


def _rglru_assoc_scan(log_a, gx, h0=None):
    """``_rglru_scan``'s function as JAX's model computes it
    (``jax.lax.associative_scan``, the same order of sums), in torch ops
    that autograd differentiates: the train-mode recurrence. Returns
    (h_all in log_a's dtype, h_last f32)."""
    a = torch.exp(log_a.float())
    b = gx.float()
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0.float()[:, None], b[:, 1:]],
                      dim=1)
    _, h = _assoc_scan(a, b)
    return h.to(log_a.dtype), h[:, -1]


def _scan_on_mesh(ctx, scan, log_a, gx, h0):
    """``scan`` on each device's shard: the batch over the batch axes and
    the lru channels over model (the recurrence is per channel: no
    collective). Returns (h_all, h_last) laid out alike."""
    if not ctx.sharded:
        return scan(log_a, gx, h0)
    B, S, C = log_a.shape
    pl = ctx.rules.placements(("batch", None, "lru"), log_a.shape)
    ph = ctx.rules.placements(("batch", "lru"), (B, C))
    if h0 is None:
        return spmd.shard_map(lambda a, b: scan(a, b), ctx.mesh, (pl, pl),
                              (pl, ph))(log_a, gx)
    return spmd.shard_map(scan, ctx.mesh, (pl, pl, ph),
                          (pl, ph))(log_a, gx, h0)


def rglru_mixer_apply(ctx, p, x, cache: Optional[dict] = None):
    """x: (B,S,D). Returns (x + mixer(x), cache).

    prefill: the returned cache is {"conv": (B, W-1, Wd) in x's dtype,
    "h": (B, Wd) f32}.
    decode: ``cache`` holds this layer's views of those leaves; they are
    updated in place and the same dict is returned."""
    cfg = ctx.cfg
    g = cfg.rglru
    nb = _n_blocks(cfg)
    S = x.shape[1]

    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    if ctx.mode != "decode":
        # the tp recipe's constraint, on a mesh under either recipe (as
        # mamba2's block): no product meets two shardings
        h = constrain(h, ctx.rules, ("batch", None, None))
    gate = L.gelu(L.dense(h, p["w_gate_branch"]))
    xb = L.dense(h, p["w_x_branch"])
    conv_state = cache.get("conv") if cache else None
    xb, conv_new = _causal_conv(xb, p["conv"], conv_state)
    xb = constrain(xb, ctx.rules, ("batch", None, "lru"))

    r = torch.sigmoid(_block_diag(ctx, xb, p["w_a"], p["b_a"], nb).float())
    i = torch.sigmoid(_block_diag(ctx, xb, p["w_i"], p["b_i"], nb).float())
    lam = F.softplus(p["lam"].float())
    log_a = -g.c_exponent * lam[None, None, :] * r
    gated_x = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                     min=1e-12)) * (i * xb.float())

    if ctx.mode == "decode":
        assert cache is not None and S == 1
        h_new = torch.exp(log_a[:, 0]) * cache["h"] + gated_x[:, 0]
        write_state(cache["h"], h_new)
        write_state(cache["conv"], conv_new)
        y = h_new[:, None]
        new_cache = cache
    else:
        h0 = cache["h"].float() if cache else None
        scan = _rglru_assoc_scan if ctx.mode == "train" else rglru_scan
        y, h_last = _scan_on_mesh(ctx, scan, log_a, gated_x, h0)
        new_cache = ({"conv": conv_new, "h": h_last}
                     if ctx.mode == "prefill" else None)

    y = L.dense(y.to(x.dtype) * gate, p["w_out"])
    y = constrain(y, ctx.rules, ("batch", "seq", None))
    return x + y, new_cache


def rec_block_apply(ctx, p, x, cache=None):
    x, new_cache = rglru_mixer_apply(ctx, p["mix"], x, cache)
    x = T.mlp_apply(ctx, p["mlp"], x)
    return x, new_cache


def attn_block_defs_rg(cfg: ModelConfig) -> Dict[str, Any]:
    return {"attn": T.attn_defs(cfg), "mlp": T.mlp_defs(cfg)}


def attn_block_apply_rg(ctx, p, x, cache=None):
    """Local MQA attention (window ``cfg.window``) + MLP. The prefill
    attention is the flash kernel; decode writes this layer's k/v views in
    place (``transformer.attn_apply``)."""
    x, new_cache = T.attn_apply(ctx, p["attn"], x, cache)
    x = T.mlp_apply(ctx, p["mlp"], x)
    return x, new_cache
