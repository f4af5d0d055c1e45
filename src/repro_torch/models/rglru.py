"""RG-LRU recurrent block + hybrid blocks of the port (RecurrentGemma /
Griffin). [arXiv:2402.19427]

Counterpart of ``repro.models.rglru`` on one device (no ``constrain``).
The Griffin residual block is a temporal mixer (the RG-LRU recurrence or
local MQA attention) and an MLP. RG-LRU per channel c:

    r_t = sigmoid(W_a x_t)            (recurrence gate, block-diagonal W)
    i_t = sigmoid(W_x x_t)            (input gate, block-diagonal W)
    log a_t = -c_exp * softplus(Lambda) * r_t
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Prefill runs the recurrence through ``kernels.rglru_scan.ops.rglru_scan``
where JAX calls ``_rglru_scan`` (an associative scan of the same function,
with the same contract): on the card the hand-written CUDA kernel, on the
CPU its plain version ``_rglru_scan`` (defined here). Train mode calls
``_rglru_scan`` itself, under autograd, on either device.
Decode is the O(1) update in f32 torch ops; it updates the cache leaves
``conv`` and ``h`` in place, as the port's Mamba2 block does. The dtype
order is JAX's: gate, x-branch and conv in the compute dtype; r, i,
log_a and the gated input in f32; y cast to x's dtype before the gate.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rglru_scan.ops import rglru_scan
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.mamba2 import _causal_conv
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


def _rglru_scan(log_a, gx, h0=None):
    """The linear recurrence h_t = exp(log_a_t) h_{t-1} + gx_t per channel
    (JAX's ``_rglru_scan``, as a sequential loop that autograd
    differentiates). log_a, gx: (B, S, C); h0: (B, C) or None, folded into
    the first step as JAX folds it. Returns (h_all (B, S, C) in log_a's
    dtype, h_last (B, C) f32); all arithmetic in f32."""
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
    if ctx.recipe == "tp" and ctx.mode != "decode":
        h = constrain(h, ctx.rules, ("batch", None, None))
    gate = L.gelu(h @ p["w_gate_branch"])
    xb = h @ p["w_x_branch"]
    conv_state = cache.get("conv") if cache else None
    xb, conv_new = _causal_conv(xb, p["conv"], conv_state)
    xb = constrain(xb, ctx.rules, ("batch", None, "lru"))

    r = torch.sigmoid(_block_diag_apply(xb, p["w_a"], p["b_a"], nb).float())
    i = torch.sigmoid(_block_diag_apply(xb, p["w_i"], p["b_i"], nb).float())
    lam = F.softplus(p["lam"].float())
    log_a = -g.c_exponent * lam[None, None, :] * r
    gated_x = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                     min=1e-12)) * (i * xb.float())

    if ctx.mode == "decode":
        assert cache is not None and S == 1
        h_new = torch.exp(log_a[:, 0]) * cache["h"] + gated_x[:, 0]
        cache["h"].copy_(h_new)
        cache["conv"].copy_(conv_new)
        y = h_new[:, None]
        new_cache = cache
    else:
        h0 = cache["h"].float() if cache else None
        scan = _rglru_scan if ctx.mode == "train" else rglru_scan
        y, h_last = scan(log_a, gated_x, h0)
        new_cache = ({"conv": conv_new, "h": h_last}
                     if ctx.mode == "prefill" else None)

    y = (y.to(x.dtype) * gate) @ p["w_out"]
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
