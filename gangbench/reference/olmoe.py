"""Plain float32 reference of a mixture-of-experts decoder as the port
serves OLMoE-1B-7B (arXiv:2409.02060), written from the equations.

Per layer: x += Wo . attention(RoPE(Wq h), RoPE(Wk h), Wv h), h =
RMSNorm(x), causal, heads of ``head_dim``, RoPE with split halves; then
x += sum over the top-k experts e of w_e . Wd_e (silu(Wg_e h) * Wu_e h),
h = RMSNorm(x), the router a softmax over ``h Wr`` whose top-k
probabilities are renormalised to sum to 1. Logits: RMSNorm(x) @ W_head.

Departures of the port from the published model, which this reference
follows: no QK-norm; expert capacity. A prefill of T tokens gives each
expert ``max(8, ceil8(ceil(T k / E x capacity_factor)))`` rows, filled in
token order (token t's picks in their top-k order), and a pair past them
is dropped. Decoded tokens are routed with every pair kept: the capacity
of a decode step (8 rows an expert over the engine's 16 slots) binds only
when more than 8 of the step's tokens pick one expert, and which of them
it drops depends on the other slots' tokens, which this reference does
not see.

It runs layer by layer over a list of sequences, casting one layer's
weights to float32 at a time, so that it fits beside the bfloat16
weights; every cache and routing decision is worked out again here.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from gangbench.reference.common import exact_f32, lin, rms


def param_spec(m: dict):
    """The weight tree the port's MoE family takes (paths, shapes), with
    the benchmark's initial scales: normal weights of std 1/sqrt(fan in),
    norm weights around 1, embeddings of std 1."""
    L, D, V = m["n_layers"], m["d_model"], m["vocab_size"]
    Q = m["n_heads"] * m["head_dim"]
    KV = m["n_kv_heads"] * m["head_dim"]
    E, F = m["moe"]["n_experts"], m["d_ff"]
    s = 1.0 / math.sqrt(D)
    return [
        (("final_ln",), (D,), "normal1", 0.1),
        (("embed",), (V, D), "normal", 1.0),
        (("lm_head",), (D, V), "normal", s),
        (("blocks", "attn", "ln"), (L, D), "normal1", 0.1),
        (("blocks", "attn", "wq"), (L, D, Q), "normal", s),
        (("blocks", "attn", "wk"), (L, D, KV), "normal", s),
        (("blocks", "attn", "wv"), (L, D, KV), "normal", s),
        (("blocks", "attn", "wo"), (L, Q, D), "normal", 1 / math.sqrt(Q)),
        (("blocks", "moe", "ln"), (L, D), "normal1", 0.1),
        (("blocks", "moe", "router"), (L, D, E), "normal", s),
        (("blocks", "moe", "wg"), (L, E, D, F), "normal", s),
        (("blocks", "moe", "wu"), (L, E, D, F), "normal", s),
        (("blocks", "moe", "wd"), (L, E, F, D), "normal", 1 / math.sqrt(F)),
    ]


def capacity(T: int, k: int, E: int, factor: float) -> int:
    cap = math.ceil(T * k / E * factor)
    return max(8, math.ceil(cap / 8) * 8)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, Dh), positions 0..S-1, split halves."""
    S, _, Dh = x.shape
    half = Dh // 2
    freq = 1.0 / (theta ** (torch.arange(half, dtype=torch.float64,
                                         device=x.device) / half))
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] \
        * freq
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v, heads_at_once: int = 4) -> torch.Tensor:
    """Causal softmax attention, q (S, Hq, Dh), k and v (S, Hkv, Dh)."""
    S, Hq, Dh = q.shape
    G = Hq // k.shape[1]
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    out = torch.empty_like(q)
    for h0 in range(0, Hq, heads_at_once):
        hs = range(h0, min(h0 + heads_at_once, Hq))
        qh = q[:, hs].transpose(0, 1)                        # (h, S, Dh)
        kh = k[:, [h // G for h in hs]].transpose(0, 1)
        vh = v[:, [h // G for h in hs]].transpose(0, 1)
        s = (qh @ kh.transpose(1, 2)) / math.sqrt(Dh)
        s = s.masked_fill(~mask, float("-inf"))
        out[:, hs] = (torch.softmax(s, dim=-1) @ vh).transpose(0, 1)
    return out


def _route(h: torch.Tensor, wr: torch.Tensor, k: int, n_prompt: int,
           factor: float, precision: str):
    """Top-k experts and weights of each token of one sequence, and
    whether each pair is kept: the prefill's first ``n_prompt`` tokens
    under their capacity, the decoded ones all kept."""
    E = wr.shape[-1]
    probs = torch.softmax(lin(h, wr, precision), dim=-1)
    topw, tope = torch.topk(probs, k, dim=-1, sorted=True)
    topw = topw / topw.sum(-1, keepdim=True)
    keep = torch.ones_like(tope, dtype=torch.bool)
    cap = capacity(n_prompt, k, E, factor)
    flat = tope[:n_prompt].reshape(-1).cpu().numpy()
    # rank of each pair among its expert's pairs, in token order
    order = np.argsort(flat, kind="stable")
    first = np.searchsorted(flat[order], flat[order], side="left")
    rank = np.empty(len(flat), np.int64)
    rank[order] = np.arange(len(flat)) - first
    keep[:n_prompt] = torch.as_tensor((rank < cap).reshape(n_prompt, k),
                                      device=h.device)
    return tope, topw, keep


def forward(m: dict, weights: Dict, seqs: Sequence[Tuple[np.ndarray, int]],
            precision: str = "f32") -> List[torch.Tensor]:
    """For each (ids, n_prompt) of ``seqs`` (ids the prompt followed by
    every served token but the last), the float32 logits at positions
    n_prompt - 1 .. len(ids) - 1: those that chose each served token."""
    dev = weights["embed"].device
    eps = m["norm_eps"]
    H, Hkv, Dh = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    moe = m["moe"]
    k, E = moe["top_k"], moe["n_experts"]
    blocks = weights["blocks"]
    with torch.no_grad(), exact_f32():
        ids = [torch.as_tensor(np.asarray(s), device=dev).long()
               for s, _ in seqs]
        xs = [weights["embed"][t].float() for t in ids]
        for li in range(m["n_layers"]):
            a = {n: blocks["attn"][n][li] for n in blocks["attn"]}
            for i, x in enumerate(xs):
                S = x.shape[0]
                h = rms(x, a["ln"].float(), eps)
                q = _rope(lin(h, a["wq"], precision).view(S, H, Dh),
                          m["rope_theta"])
                kk = _rope(lin(h, a["wk"], precision).view(S, Hkv, Dh),
                           m["rope_theta"])
                v = lin(h, a["wv"], precision).view(S, Hkv, Dh)
                o = _attention(q, kk, v).reshape(S, H * Dh)
                xs[i] = x + lin(o, a["wo"], precision)
            p = {n: blocks["moe"][n][li] for n in blocks["moe"]}
            hs, routes = [], []
            for (_, n_prompt), x in zip(seqs, xs):
                h = rms(x, p["ln"].float(), eps)
                hs.append(h)
                routes.append(_route(h, p["router"], k, n_prompt,
                                     moe["capacity_factor"], precision))
            h = torch.cat(hs)
            tope = torch.cat([r[0] for r in routes])
            topw = torch.cat([r[1] for r in routes])
            keep = torch.cat([r[2] for r in routes])
            y = torch.zeros_like(h)
            for e in range(E):
                tok, slot = torch.nonzero((tope == e) & keep, as_tuple=True)
                if not len(tok):
                    continue
                he = h[tok]
                g = lin(he, p["wg"][e], precision)
                u = lin(he, p["wu"][e], precision)
                out = lin(torch.nn.functional.silu(g) * u, p["wd"][e],
                          precision)
                y.index_add_(0, tok, out * topw[tok, slot][:, None])
            offs = np.cumsum([0] + [x.shape[0] for x in xs])
            xs = [x + y[offs[i]:offs[i + 1]] for i, x in enumerate(xs)]
        out = []
        for (_, n_prompt), x in zip(seqs, xs):
            h = rms(x[n_prompt - 1:], weights["final_ln"].float(), eps)
            out.append(lin(h, weights["lm_head"], precision))
        return out
