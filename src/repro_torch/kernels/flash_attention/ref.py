"""Plain PyTorch version of the flash-attention kernel: a port of the JAX
package's ``naive_attention`` oracle (materialized scores, f32 softmax).

The wrapper in ``ops.py`` takes it for tensors on the CPU; on the card it
is what the CUDA kernel is held against.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


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
