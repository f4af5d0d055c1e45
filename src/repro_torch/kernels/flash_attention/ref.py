"""Plain PyTorch versions of the flash-attention kernel.

``naive_attention`` is a port of the JAX package's oracle (materialized
scores, f32 softmax). The wrapper in ``ops.py`` takes it for tensors on the
CPU; on the card it is what the CUDA kernel is held against.

``tiled_attention`` computes with the bf16 tensor-core kernel's rounding
points, so that the CPU tests can show what they cost against the oracle.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30
LOG2E = 1.4426950408889634


def naive_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D) -> (B, Sq, Hq, D)."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    kr = k.repeat_interleave(G, dim=2).float()
    vr = v.repeat_interleave(G, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) * (D ** -0.5)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vr)
    return out.to(q.dtype)


def tiled_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    block_k: int = 64):
    """The bf16 kernel's arithmetic, plainly: an online softmax over kv
    tiles of ``block_k`` rows with f32 scores, running max and sum (the
    scale folded into exp2 with log2 e); P rounded to q's dtype before
    P V; f32 accumulation; acc / max(l, 1e-20) in q's dtype.
    q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D) -> (B, Sq, Hq, D)."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    sl2 = D ** -0.5 * LOG2E
    qf = q.float().transpose(1, 2)                       # (B, Hq, Sq, D)
    kf = k.repeat_interleave(G, dim=2).float().transpose(1, 2)
    vr = v.repeat_interleave(G, dim=2).transpose(1, 2)   # q's dtype
    qpos = torch.arange(Sq, device=q.device)[:, None]
    m = torch.full((B, Hq, Sq, 1), -torch.inf, device=q.device)
    l = torch.zeros((B, Hq, Sq, 1), device=q.device)
    acc = torch.zeros((B, Hq, Sq, D), device=q.device)
    for k0 in range(0, Sk, block_k):
        s = qf @ kf[:, :, k0:k0 + block_k].transpose(-1, -2)
        kpos = torch.arange(k0, k0 + s.shape[-1], device=q.device)[None, :]
        mask = torch.ones_like(s[0, 0], dtype=torch.bool)
        if causal:
            mask &= kpos <= qpos
        if window > 0:
            mask &= kpos > qpos - window
        s = torch.where(mask, s, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        base = torch.where(m_new == -torch.inf, 0.0, m_new * sl2)
        corr = torch.exp2(m * sl2 - base)
        p = torch.exp2(s * sl2 - base)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p.to(q.dtype).float() @ \
            vr[:, :, k0:k0 + block_k].float()
        m = m_new
    out = acc / l.clamp_min(1e-20)
    return out.transpose(1, 2).to(q.dtype)
