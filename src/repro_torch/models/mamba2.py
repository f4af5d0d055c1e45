"""Mamba2 / SSD (state-space duality) blocks of the port. [arXiv:2405.21060]

Counterpart of ``repro.models.mamba2`` on one device (no ``constrain``).
Per head h (H = d_inner/P heads, state size N):
    h_t = exp(A * dt_t) * h_{t-1} + dt_t * B_t (x) x_t        (N x P outer)
    y_t = C_t . h_t + D * x_t
with scalar A<0 per head, B_t/C_t shared across heads (n_groups=1), gated
RMSNorm on the output and a causal depthwise conv on (x, B, C) inputs.

Prefill runs the chunked SSD scan through ``kernels.ssd_scan.ops.ssd_scan``:
on the card the hand-written CUDA kernel, on the CPU its plain version
``_ssd_chunked`` (JAX's ``_ssd_chunked``, defined here). Train mode
calls ``_ssd_chunked`` itself, under autograd, on either device. The
scan's inputs are f32, as ``_ssd_chunked`` casts them, so y stays f32 up
to the ``D_skip`` term in a bf16 model too. Decode
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


def _ssd_chunked(xh, dt, Bm, Cm, A, h0=None, chunk: int = 256):
    """Chunked SSD scan.

    xh: (B,S,H,P); dt: (B,S,H) (post-softplus); Bm, Cm: (B,S,N); A: (H,)
    < 0. h0: optional (B,H,P,N) initial state.
    Returns y: (B,S,H,P), h_final: (B,H,P,N). All math f32, y too.
    """
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    S_orig = S
    if S % Q:
        # pad with dt=0 tokens: decay exp(0)=1 and zero input contribution,
        # so state and earlier outputs are unaffected.
        pad = Q - S % Q
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        S = S + pad
    nc = S // Q
    xh, dt, Bm, Cm, A = (t.float() for t in (xh, dt, Bm, Cm, A))

    xb = xh.reshape(Bsz, nc, Q, H, P)
    db = dt.reshape(Bsz, nc, Q, H)
    Bb = Bm.reshape(Bsz, nc, Q, N)
    Cb = Cm.reshape(Bsz, nc, Q, N)

    # log-decay within chunk: L[t] = sum_{u<=t} A*dt_u   (B,nc,Q,H)
    logd = db * A[None, None, None, :]
    Lc = torch.cumsum(logd, dim=2)
    Ltot = Lc[:, :, -1, :]                                   # (B,nc,H)

    # intra-chunk quadratic form
    CB = torch.einsum("bcqn,bckn->bcqk", Cb, Bb)             # (B,nc,Q,Q)
    # decay(i,j) = exp(L_i - L_j) for j<=i
    diff = Lc[:, :, :, None, :] - Lc[:, :, None, :, :]       # (B,nc,Q,Q,H)
    iq = torch.arange(Q, device=xh.device)
    causal = (iq[:, None] >= iq[None, :])[None, None, :, :, None]
    M = torch.where(causal, torch.exp(diff), 0.0)
    M = M * CB[..., None] * db[:, :, None, :, :]             # j-index dt
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", M, xb)

    # per-chunk end-state contribution: sum_j exp(Ltot - L_j) dt_j B_j x_j
    decay_end = torch.exp(Ltot[:, :, None, :] - Lc)         # (B,nc,Q,H)
    S_chunk = torch.einsum("bcqh,bcqn,bcqhp->bchpn",
                           decay_end * db, Bb, xb)           # (B,nc,H,P,N)

    # inter-chunk scan
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=xh.device)
         if h0 is None else h0.float())
    y_inter = []
    for c in range(nc):
        # y_inter[i] = C_i . (exp(L_i) * h)
        y_inter.append(torch.einsum("bqn,bqh,bhpn->bqhp", Cb[:, c],
                                    torch.exp(Lc[:, c]), h))
        h = torch.exp(Ltot[:, c])[:, :, None, None] * h + S_chunk[:, c]
    y_inter = torch.stack(y_inter, dim=1)                    # (B,nc,Q,H,P)

    y = (y_intra + y_inter).reshape(Bsz, S, H, P)
    return y[:, :S_orig], h


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
        scan = _ssd_chunked if ctx.mode == "train" else ssd_scan
        y, h_fin = scan(xh.float(), dt, Bm.float(), Cm.float(), A,
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
