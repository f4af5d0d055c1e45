"""Plain float32 reference of Mamba2 (arXiv:2405.21060) as the port serves
mamba2-1.3b, written from the equations.

Per layer, h = RMSNorm(x): z = h Wz, u = h Wx, B = h WB, C = h WC (one
group), dt = softplus(h Wdt + dt_bias); u, B and C each pass a causal
depthwise conv of width W and a SiLU; per head (P channels of u) with
A = -exp(A_log):

    s_t = exp(A dt_t) s_{t-1} + dt_t B_t (x) u_t,   y_t = C_t . s_t + D u_t

then x += Wout . RMSNorm(y * silu(z)) (the gated norm). Logits:
RMSNorm(x) @ E^T (tied embeddings).

The scan is computed in chunks of 128 tokens: inside a chunk as the
masked quadratic form, across chunks through the carried state; all in
float32. It runs layer by layer over a list of sequences; the state and
the convolutions' history are worked out again from the tokens.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gangbench.reference.common import exact_f32, lin, rms

CHUNK = 128


def param_spec(m: dict):
    """The weight tree the port's SSM family takes (paths, shapes), with
    the benchmark's initial scales: projections of std 1/sqrt(fan in) (dt's
    a tenth of that), A and dt drawn as Mamba2 initialises them (A in
    [1, 16], dt in [0.001, 0.1], both log-uniform), norm weights around
    1, the tied embedding of std 1/sqrt(d_model)."""
    L, D, V = m["n_layers"], m["d_model"], m["vocab_size"]
    s = m["ssm"]
    di = s["expand"] * D
    H = di // s["head_dim"]
    N, W = s["state_dim"], s["conv_width"]
    r = 1.0 / math.sqrt(D)
    b = ("blocks",)
    return [
        (("final_ln",), (D,), "normal1", 0.1),
        (("embed",), (V, D), "normal", r),
        (b + ("ln",), (L, D), "normal1", 0.1),
        (b + ("in_x",), (L, D, di), "normal", r),
        (b + ("in_z",), (L, D, di), "normal", r),
        (b + ("in_B",), (L, D, N), "normal", r),
        (b + ("in_C",), (L, D, N), "normal", r),
        (b + ("in_dt",), (L, D, H), "normal", 0.1 * r),
        (b + ("conv_x",), (L, W, di), "normal", 0.5),
        (b + ("conv_B",), (L, W, N), "normal", 0.5),
        (b + ("conv_C",), (L, W, N), "normal", 0.5),
        (b + ("dt_bias",), (L, H), "softplus_inv_loguniform", (1e-3, 1e-1)),
        (b + ("A_log",), (L, H), "log_loguniform", (1.0, 16.0)),
        (b + ("D_skip",), (L, H), "normal1", 0.1),
        (b + ("gn",), (L, di), "normal1", 0.1),
        (b + ("out",), (L, di, D), "normal", 1 / math.sqrt(di)),
    ]


def _conv(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv: y_t = sum_i w[i] u_{t - (W - 1) + i}, zeros
    before the first token. u (S, C), w (W, C)."""
    W = w.shape[0]
    up = torch.cat([u.new_zeros(W - 1, u.shape[1]), u])
    S = u.shape[0]
    return sum(up[i:i + S] * w[i] for i in range(W))


def ssd(u: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """y_t = C_t . s_t with s_t = exp(A dt_t) s_{t-1} + dt_t B_t (x) u_t.
    u (S, H, P), dt (S, H), B and C (S, N), A (H,). Returns y (S, H, P)."""
    S, H, P = u.shape
    N = B.shape[1]
    pad = (-S) % CHUNK
    if pad:   # dt = 0: no decay and no input, so nothing earlier changes
        u = F.pad(u, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    nc = u.shape[0] // CHUNK
    u = u.view(nc, CHUNK, H, P)
    dt = dt.view(nc, CHUNK, H)
    B = B.view(nc, CHUNK, N)
    C = C.view(nc, CHUNK, N)
    cum = torch.cumsum(dt * A, dim=1)                        # (nc, Q, H)
    i = torch.arange(CHUNK, device=u.device)
    causal = (i[:, None] >= i[None, :])[None, :, :, None]
    diff = cum[:, :, None, :] - cum[:, None, :, :]           # (nc, Q, Q, H)
    decay = torch.exp(torch.where(causal, diff, float("-inf")))
    cb = C @ B.transpose(1, 2)                               # (nc, Q, Q)
    w = decay * cb[..., None] * dt[:, None, :, :]
    y = torch.einsum("cqkh,ckhp->cqhp", w, u)
    to_end = torch.exp(cum[:, -1:, :] - cum) * dt            # (nc, Q, H)
    add = torch.einsum("cqh,cqn,cqhp->chpn", to_end, B, u)   # (nc,H,P,N)
    s = u.new_zeros(H, P, N)
    for c in range(nc):
        y[c] += torch.einsum("qn,qh,hpn->qhp", C[c], torch.exp(cum[c]), s)
        s = torch.exp(cum[c, -1])[:, None, None] * s + add[c]
    return y.reshape(nc * CHUNK, H, P)[:S]


def forward(m: dict, weights: Dict, seqs: Sequence[Tuple[np.ndarray, int]],
            precision: str = "f32") -> List[torch.Tensor]:
    """For each (ids, n_prompt) of ``seqs`` (ids the prompt followed by
    every served token but the last), the float32 logits at positions
    n_prompt - 1 .. len(ids) - 1: those that chose each served token."""
    dev = weights["embed"].device
    eps = m["norm_eps"]
    s = m["ssm"]
    P = s["head_dim"]
    blocks = weights["blocks"]
    with torch.no_grad(), exact_f32():
        xs = [weights["embed"][torch.as_tensor(np.asarray(t), device=dev)
                               .long()].float() for t, _ in seqs]
        for li in range(m["n_layers"]):
            p = {n: blocks[n][li] for n in blocks}
            A = -torch.exp(p["A_log"].float())
            for i, x in enumerate(xs):
                S = x.shape[0]
                h = rms(x, p["ln"].float(), eps)
                z = lin(h, p["in_z"], precision)
                u = F.silu(_conv(lin(h, p["in_x"], precision),
                                 p["conv_x"].float()))
                B = F.silu(_conv(lin(h, p["in_B"], precision),
                                 p["conv_B"].float()))
                C = F.silu(_conv(lin(h, p["in_C"], precision),
                                 p["conv_C"].float()))
                dt = F.softplus(lin(h, p["in_dt"], precision)
                                + p["dt_bias"].float())
                uh = u.view(S, -1, P)
                y = ssd(uh, dt, B, C, A) \
                    + p["D_skip"].float()[None, :, None] * uh
                y = y.reshape(S, -1) * F.silu(z)
                xs[i] = x + lin(rms(y, p["gn"].float(), eps), p["out"],
                                precision)
        out = []
        for (_, n_prompt), x in zip(seqs, xs):
            h = rms(x[n_prompt - 1:], weights["final_ln"].float(), eps)
            out.append(lin(h, weights["embed"].T, precision))
        return out
