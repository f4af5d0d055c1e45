"""Plain PyTorch versions of the flash-attention kernel.

``naive_attention`` is a port of the JAX package's oracle (materialized
scores, f32 softmax). The wrapper in ``ops.py`` takes it for tensors on the
CPU; on the card it is what the CUDA kernel is held against.

``tiled_attention`` computes with the bf16 kernels' rounding points, so
that the CPU tests can show what they cost against the oracle: ``block_k``
is the kernel's kv tile, 64 rows on the tc path (D 16, 32) and on the
wgmma path at D 128 and 256, 128 rows on the wgmma path at D 64.

``tf32x3_attention`` is the f32 kernel's arithmetic at D 64, 128 and 256
(the "tf32x3" path): both products in split TF32 (each operand hi + lo,
hi hi + hi lo + lo hi), at that path's kv tile, the same online softmax.
The CPU tests hold it against the JAX package's kernel and oracle.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.tf32 import tf32_split

NEG_INF = -1e30
LOG2E = 1.4426950408889634


def naive_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, softcap: float = 0.0):
    """q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D) -> (B, Sq, Hq, D); query
    row i sits at key position ``q_offset + i``; ``softcap`` > 0 caps the
    scaled f32 scores at softcap * tanh(s / softcap) before the mask (JAX's
    ``masked_attention``)."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    kr = k.repeat_interleave(G, dim=2).float()
    vr = v.repeat_interleave(G, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) * (D ** -0.5)
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    qpos = q_offset + torch.arange(Sq, device=q.device)[:, None]
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
                    block_k: int = 64, softcap: float = 0.0):
    """The bf16 kernel's arithmetic, plainly: an online softmax over kv
    tiles of ``block_k`` rows with f32 scores, running max and sum (the
    scale folded into exp2 with log2 e; under ``softcap`` the scores are
    capped as softcap * tanh(s * (scale / softcap)), the max is tracked in
    capped units and log2 e alone is the factor); P rounded to q's dtype
    before P V; f32 accumulation; acc / max(l, 1e-20) in q's dtype.
    q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D) -> (B, Sq, Hq, D)."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    sl2 = LOG2E if softcap > 0 else D ** -0.5 * LOG2E
    qf = q.float().transpose(1, 2)                       # (B, Hq, Sq, D)
    kf = k.repeat_interleave(G, dim=2).float().transpose(1, 2)
    vr = v.repeat_interleave(G, dim=2).transpose(1, 2)   # q's dtype
    qpos = torch.arange(Sq, device=q.device)[:, None]
    m = torch.full((B, Hq, Sq, 1), -torch.inf, device=q.device)
    l = torch.zeros((B, Hq, Sq, 1), device=q.device)
    acc = torch.zeros((B, Hq, Sq, D), device=q.device)
    for k0 in range(0, Sk, block_k):
        s = qf @ kf[:, :, k0:k0 + block_k].transpose(-1, -2)
        if softcap > 0:
            s = softcap * torch.tanh(s * (D ** -0.5 / softcap))
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


def tf32x3_attention(q, k, v, *, causal: bool = True, window: int = 0,
                     q_offset: int = 0, softcap: float = 0.0):
    """The f32 kernel's arithmetic on the tf32x3 path, plainly: kv tiles of
    4096 / D rows (the kernel's: 4096 values a K or V tile); S = Q K^T of
    the unscaled Q as Qh Kh + Qh Kl + Ql Kh, each operand split a = hi + lo
    with ``cvt.rna``'s rounding; under ``softcap`` S becomes softcap *
    tanh(S * (scale / softcap)); masked scores -inf; the online softmax in
    exp2 with the scale (scale * log2 e, in f32; log2 e alone under a cap)
    folded into the exponent and a row that has seen no unmasked key on
    base 0; P = exp2(S - m) split as P's hi + lo and O += Ph Vh + Ph Vl +
    Pl Vh in f32; out = O / max(l, 1e-20). q: (B, Sq, Hq, D); k, v: (B, Sk,
    Hkv, D), f32; query row i sits at key position q_offset + i. Returns
    (B, Sq, Hq, D) f32."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    block_k = 4096 // D
    f32 = torch.float32
    scale = torch.tensor(D ** -0.5, dtype=f32)
    log2e = torch.tensor(LOG2E, dtype=f32)
    sl2 = log2e if softcap > 0 else scale * log2e     # the kernel's f32 math
    c_in = scale / torch.tensor(softcap, dtype=f32) if softcap > 0 else None
    qh, ql = tf32_split(q.transpose(1, 2))                  # (B, Hq, Sq, D)
    kf = k.repeat_interleave(G, dim=2).float().transpose(1, 2)
    vf = v.repeat_interleave(G, dim=2).float().transpose(1, 2)
    qpos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    m = torch.full((B, Hq, Sq, 1), -torch.inf, device=q.device)
    l = torch.zeros((B, Hq, Sq, 1), device=q.device)
    acc = torch.zeros((B, Hq, Sq, D), device=q.device)
    for k0 in range(0, Sk, block_k):
        kh, kl = tf32_split(kf[:, :, k0:k0 + block_k].transpose(-1, -2))
        s = qh @ kh + qh @ kl + ql @ kh
        if softcap > 0:
            s = softcap * torch.tanh(s * c_in)
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
        ph, pl = tf32_split(p)
        vh, vl = tf32_split(vf[:, :, k0:k0 + block_k])
        acc = acc * corr + ph @ vh + ph @ vl + pl @ vh
        m = m_new
    out = acc / l.clamp_min(1e-20)
    return out.transpose(1, 2).contiguous()
