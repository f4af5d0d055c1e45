"""Mamba2 / SSD (state-space duality) blocks of the port. [arXiv:2405.21060]

Counterpart of ``repro.models.mamba2``, on one device or on a mesh.
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
to the ``D_skip`` term in a bf16 model too. At prefill the elementwise
glue on each side of the scan (the causal convs with SiLU and softplus
before it; the D skip, the gate and the gated RMSNorm after it) is one
kernel each on the card (``kernels.ssm_glue.ops``), and their plain
versions ``_conv_act`` / ``_gate_norm`` on the CPU; decode, train and the
mesh run those plain versions. Decode
is the O(1) recurrent update in torch ops (the JAX package has no Pallas
kernel for it). JAX promotes bf16 x f32 to f32 inside its einsums; torch
does not mix dtypes, so the casts to f32 are written out.

On a mesh (the tensors are DTensors) every product is ``layers.dense``,
d_inner and the heads are over the model axis and B / C replicated over
it (JAX's rules). The scan runs under ``spmd.shard_map``
(``_scan_on_mesh``): the batch over the batch axes, x, dt and A over the
heads, B and C whole, so each device's kernel launch takes its local
(B/d, S, H/m, P). The causal conv runs on the local shards with its state
in the placements of the x it extends (``_causal_conv``), and the decode
step updates the state cache's local shards in place, on the cache's
placements (``_decode_step``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssm_glue.ops import ssm_conv_act, ssm_gate_norm
from repro_torch.models import layers as L
from repro_torch.sharding import spmd
from repro_torch.sharding.partition import constrain

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
    previous tokens (decode). Returns (y, new_state). A DTensor x (its
    sequence whole) is convolved on its local shards: the state comes in
    x's placements, w in those of x's channels, y and the new state go
    out in x's placements."""
    if isinstance(x, DTensor):
        pl = tuple(x.placements)
        wpl = spmd.follow(pl, {2: 1})
        if state is None:
            return spmd.shard_map(_causal_conv, x.device_mesh, (pl, wpl),
                                  (pl, pl))(x, w)
        return spmd.shard_map(_causal_conv, x.device_mesh, (pl, wpl, pl),
                              (pl, pl))(x, w, state)
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


def _scan_on_mesh(ctx, scan, xh, dt, Bm, Cm, A, chunk: int):
    """``scan`` (the kernel's wrapper, or ``_ssd_chunked`` at train) on
    each device's shard: the batch over the batch axes, xh, dt and A over
    the heads, Bm and Cm whole over the model axis (shared by the heads).
    Returns y sharded as xh and h as (batch, heads)."""
    if not ctx.sharded:
        return scan(xh, dt, Bm, Cm, A, chunk=chunk)
    r = ctx.rules
    B, S, H, P = xh.shape
    px = r.placements(("batch", None, "ssm_heads", None), xh.shape)
    pd = r.placements(("batch", None, "ssm_heads"), dt.shape)
    pb = r.placements(("batch", None, None), Bm.shape)
    pa = r.placements(("ssm_heads",), A.shape)
    ph = r.placements(("batch", "ssm_heads", None, None),
                      (B, H, P, Bm.shape[-1]))
    return spmd.shard_map(lambda *a: scan(*a, chunk=chunk), ctx.mesh,
                          (px, pd, pb, pb, pa), (px, ph))(xh, dt, Bm, Cm, A)


def _ssd_step(hs, dt, Bm, Cm, xh, A):
    """One decode step, in place: hs (B,H,P,N) f32 <- exp(dt A) hs +
    dt B (x) x. dt (B,1,H), Bm = Cm (B,1,N), xh (B,1,H,P). Returns y
    (B,1,H,P) f32."""
    da = torch.exp(dt[:, 0] * A[None, :])                    # (B,H)
    upd = torch.einsum("bh,bn,bhp->bhpn", dt[:, 0], Bm[:, 0].float(),
                       xh[:, 0].float())
    hs.mul_(da[:, :, None, None]).add_(upd)
    return torch.einsum("bn,bhpn->bhp", Cm[:, 0].float(), hs)[:, None]


def _decode_step(ctx, hs, dt, Bm, Cm, xh, A):
    """``_ssd_step`` on the cache ``hs``; on a mesh on its local shard,
    in place (never redistributed: a copy would lose the write), the other
    operands laid out on the cache's placements."""
    if not isinstance(hs, DTensor):
        return _ssd_step(hs, dt, Bm, Cm, xh, A)
    pl = tuple(hs.placements)
    heads = spmd.follow(pl, {0: 0, 1: 2})       # dt (B,1,H), xh (B,1,H,P)
    rows = spmd.follow(pl, {0: 0})              # Bm, Cm (B,1,N)
    return spmd.shard_map(
        lambda *a: _ssd_step(hs.to_local(), *a), ctx.mesh,
        (heads, rows, rows, heads, spmd.follow(pl, {1: 0})),
        heads)(dt, Bm, Cm, xh, A)


def write_state(leaf, new):
    """Copy ``new`` into the cache ``leaf`` in place; on a mesh into the
    leaf's local shard, ``new`` laid out on the leaf's placements first."""
    if isinstance(leaf, DTensor):
        if tuple(new.placements) != tuple(leaf.placements):
            new = new.redistribute(leaf.device_mesh, leaf.placements)
        leaf.to_local().copy_(new.to_local())
    else:
        leaf.copy_(new)


def _conv_act(xin, Bm, Cm, dt, conv_x, conv_B, conv_C, dt_bias,
              state: Optional[dict] = None):
    """The glue before the scan, in torch ops (``ssm_conv_act``'s plain
    version): the causal convs of x, B and C (from the conv states in
    ``state``, a decode step's cache, or from zeros), SiLU in f32 rounded
    back to each one's dtype, and softplus(dt + dt_bias) in f32. Returns
    (x, B, C, dt', (the new conv states of x, B and C))."""
    state = state if state is not None else {}
    xin, cx = _causal_conv(xin, conv_x, state.get("conv_x"))
    Bm, cB = _causal_conv(Bm, conv_B, state.get("conv_B"))
    Cm, cC = _causal_conv(Cm, conv_C, state.get("conv_C"))
    xin = F.silu(xin.float()).to(xin.dtype)
    Bm = F.silu(Bm.float()).to(Bm.dtype)
    Cm = F.silu(Cm.float()).to(Cm.dtype)
    dt = F.softplus(dt.float() + dt_bias.float())
    return xin, Bm, Cm, dt, (cx, cB, cC)


def _gate_norm(y, xh, z, D_skip, gn, eps: float):
    """The glue after the scan, in torch ops (``ssm_gate_norm``'s plain
    version): y (B,S,H,P) f32 plus the D skip of xh (B,S,H,P), gated by
    silu(z) (B,S,H*P) in f32, rounded to z's dtype, then RMSNorm with
    weight ``gn`` (mamba2's gated norm: norm(y * silu(z)))."""
    y = y + D_skip.float()[None, None, :, None] * xh.float()
    y = y.reshape(z.shape)
    y = y * F.silu(z.float())
    return L.rms_norm(y.to(z.dtype), gn, eps)


def ssm_block_apply(ctx, p, x, cache: Optional[dict] = None):
    """x: (B,S,D). Returns (x_out, cache).

    prefill: the returned cache is {"conv_x", "conv_B", "conv_C"} (B, W-1,
    C) in x's dtype and {"h"} (B, H, P, N) f32.
    decode: ``cache`` holds this layer's views of those leaves; they are
    updated in place and the same dict is returned."""
    cfg = ctx.cfg
    s = cfg.ssm
    H = s.n_heads(cfg.d_model)
    P = s.head_dim
    Bsz, S, _ = x.shape

    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    if ctx.mode != "decode":
        # JAX constrains h under the tp recipe and leaves mamba2's (cp: no
        # attention heads) to GSPMD; here both gather the sequence, so
        # that no product meets two shardings (as mlp_apply does)
        h = constrain(h, ctx.rules, ("batch", None, None))
    z = L.dense(h, p["in_z"])
    xin = L.dense(h, p["in_x"])
    Bm = L.dense(h, p["in_B"])
    Cm = L.dense(h, p["in_C"])
    dt = L.dense(h, p["in_dt"])

    A = -torch.exp(p["A_log"].float())
    if ctx.mode == "prefill" and cache is None and \
            not isinstance(xin, DTensor):
        # the glue on each side of the scan in one kernel each on the card
        # (their plain versions on the CPU); on a mesh the plain ops below
        xh, Bm, Cm, dt, (cx, cB, cC) = ssm_conv_act(
            xin, Bm, Cm, dt, p["conv_x"], p["conv_B"], p["conv_C"],
            p["dt_bias"])
        y, h_fin = ssd_scan(xh, dt, Bm, Cm, A, chunk=min(s.chunk, S))
        y = ssm_gate_norm(y, xh, z, p["D_skip"], p["gn"], cfg.norm_eps)
        new_cache = {"conv_x": cx, "conv_B": cB, "conv_C": cC, "h": h_fin}
    else:
        xin, Bm, Cm, dt, (cx, cB, cC) = _conv_act(
            xin, Bm, Cm, dt, p["conv_x"], p["conv_B"], p["conv_C"],
            p["dt_bias"], cache)
        xh = constrain(xin.reshape(Bsz, S, H, P), ctx.rules,
                       ("batch", None, "ssm_heads", None))
        if ctx.mode == "decode":
            assert cache is not None and S == 1
            y = _decode_step(ctx, cache["h"], dt, Bm, Cm, xh, A)
            for name, new in (("conv_x", cx), ("conv_B", cB),
                              ("conv_C", cC)):
                write_state(cache[name], new)
            new_cache = cache
        else:
            scan = _ssd_chunked if ctx.mode == "train" else ssd_scan
            y, h_fin = _scan_on_mesh(ctx, scan, xh.float(), dt, Bm.float(),
                                     Cm.float(), A, min(s.chunk, S))
            new_cache = None
            if ctx.mode == "prefill":
                new_cache = {"conv_x": cx, "conv_B": cB, "conv_C": cC,
                             "h": h_fin}
        y = _gate_norm(y, xh, z, p["D_skip"], p["gn"], cfg.norm_eps)
    out = constrain(L.dense(y, p["out"]), ctx.rules, ("batch", "seq", None))
    return x + out, new_cache
