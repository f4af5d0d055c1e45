"""Mamba2 / SSD (state-space duality) blocks of the port. [arXiv:2405.21060]

Counterpart of ``repro.models.mamba2`` on one device (no ``constrain``).
Per head h (H = d_inner/P heads, state size N):
    h_t = exp(A * dt_t) * h_{t-1} + dt_t * B_t (x) x_t        (N x P outer)
    y_t = C_t . h_t + D * x_t
with scalar A<0 per head, B_t/C_t shared across heads (n_groups=1), gated
RMSNorm on the output and a causal depthwise conv on (x, B, C) inputs.

Prefill runs the chunked SSD scan through ``kernels.ssd_scan.ops.ssd_scan``:
on the card the hand-written CUDA kernel, on the CPU its plain version
(JAX's ``_ssd_chunked``). Its inputs are f32, as ``_ssd_chunked`` casts
them, so y stays f32 up to the ``D_skip`` term in a bf16 model too. Decode
is the O(1) recurrent update in torch ops (the JAX package has no Pallas
kernel for it). JAX promotes bf16 x f32 to f32 inside its einsums; torch
does not mix dtypes, so the casts to f32 are written out.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.models import layers as L

CACHE_NAMES = ("conv_x", "conv_B", "conv_C", "h")


def ssm_block_defs(cfg: ModelConfig) -> Dict[str, L.ParamDef]:
    assert cfg.ssm is not None
    s = cfg.ssm
    D = cfg.d_model
    di = s.d_inner(D)
    H = s.n_heads(D)
    N, W = s.state_dim, s.conv_width
    return {
        "ln": L.ParamDef((D,), ("embed",), "ones"),
        "in_x": L.ParamDef((D, di), ("embed", "ssm_inner")),
        "in_z": L.ParamDef((D, di), ("embed", "ssm_inner")),
        "in_B": L.ParamDef((D, N), ("embed", None)),
        "in_C": L.ParamDef((D, N), ("embed", None)),
        "in_dt": L.ParamDef((D, H), ("embed", "ssm_heads")),
        "conv_x": L.ParamDef((W, di), (None, "ssm_inner"), "normal", 0.5),
        "conv_B": L.ParamDef((W, N), (None, None), "normal", 0.5),
        "conv_C": L.ParamDef((W, N), (None, None), "normal", 0.5),
        "dt_bias": L.ParamDef((H,), ("ssm_heads",), "zeros"),
        "A_log": L.ParamDef((H,), ("ssm_heads",), "zeros"),
        "D_skip": L.ParamDef((H,), ("ssm_heads",), "ones"),
        "gn": L.ParamDef((di,), ("ssm_inner",), "ones"),
        "out": L.ParamDef((di, D), ("ssm_inner", "embed")),
    }


def _causal_conv(x, w, state=None):
    """Depthwise causal conv. x: (B,S,C), w: (W,C). state: (B,W-1,C) tail of
    previous tokens (decode). Returns (y, new_state)."""
    W = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    S = x.shape[1]
    y = sum(xp[:, i:i + S, :] * w[i][None, None, :] for i in range(W))
    new_state = xp[:, -(W - 1):, :] if W > 1 else None
    return y, new_state


def ssm_block_apply(ctx, p, x, cache: Optional[dict] = None):
    """x: (B,S,D). Returns (x_out, cache).

    prefill: the returned cache is {"conv_x", "conv_B", "conv_C"} (B, W-1,
    C) in x's dtype and {"h"} (B, H, P, N) f32.
    decode: ``cache`` holds this layer's views of those leaves; they are
    updated in place and the same dict is returned."""
    cfg = ctx.cfg
    s = cfg.ssm
    D = cfg.d_model
    di = s.d_inner(D)
    H = s.n_heads(D)
    P = s.head_dim
    Bsz, S, _ = x.shape

    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    z = h @ p["in_z"]
    xin = h @ p["in_x"]
    Bm = h @ p["in_B"]
    Cm = h @ p["in_C"]
    dt = h @ p["in_dt"]

    conv_cache = cache if cache is not None else {}
    xin, cx = _causal_conv(xin, p["conv_x"], conv_cache.get("conv_x"))
    Bm, cB = _causal_conv(Bm, p["conv_B"], conv_cache.get("conv_B"))
    Cm, cC = _causal_conv(Cm, p["conv_C"], conv_cache.get("conv_C"))
    xin = F.silu(xin.float()).to(xin.dtype)
    Bm = F.silu(Bm.float()).to(Bm.dtype)
    Cm = F.silu(Cm.float()).to(Cm.dtype)

    dt = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())

    xh = xin.reshape(Bsz, S, H, P)

    if ctx.mode == "decode":
        assert cache is not None and S == 1
        hs = cache["h"]                                      # (B,H,P,N) f32
        da = torch.exp(dt[:, 0] * A[None, :])                # (B,H)
        upd = torch.einsum("bh,bn,bhp->bhpn", dt[:, 0], Bm[:, 0].float(),
                           xh[:, 0].float())
        hs.mul_(da[:, :, None, None]).add_(upd)
        y = torch.einsum("bn,bhpn->bhp", Cm[:, 0].float(), hs)[:, None]
        for name, new in (("conv_x", cx), ("conv_B", cB), ("conv_C", cC)):
            cache[name].copy_(new)
        new_cache = cache
    else:
        y, h_fin = ssd_scan(xh.float(), dt, Bm.float(), Cm.float(), A,
                            chunk=min(s.chunk, S))
        new_cache = None
        if ctx.mode == "prefill":
            new_cache = {"conv_x": cx, "conv_B": cB, "conv_C": cC,
                         "h": h_fin}

    y = y + p["D_skip"].float()[None, None, :, None] * xh.float()
    y = y.reshape(Bsz, S, di)
    # gated RMSNorm (mamba2): norm(y * silu(z))
    y = y * F.silu(z.float())
    y = L.rms_norm(y.to(x.dtype), p["gn"], cfg.norm_eps)
    out = y @ p["out"]
    return x + out, new_cache
