"""Split TF32 in plain PyTorch: the arithmetic of the CUDA kernels that
take f32 products on the tensor cores (``csrc/ssd_scan.cu``, the
"tf32x3" path of ``csrc/flash_attention.cu``).

wgmma's tf32 form reads an f32 and drops its low 13 mantissa bits. The
kernels write each operand a = hi + lo, hi = tf32(a), lo = tf32(a - hi),
both rounded as ``cvt.rna.tf32.f32`` rounds, and take a b as hi hi + hi lo
+ lo hi in f32 accumulators (each product of two tf32 values is exact in
f32): within about 2^-21 of |a b|.
"""
from __future__ import annotations

import torch


def tf32_round(a):
    """``a`` (f32) rounded to tf32: half an ulp of a 10-bit mantissa added to
    the magnitude, the low 13 bits cut; infinities and NaNs kept."""
    u = a.contiguous().view(torch.int32)
    keep = (u & 0x7F800000) == 0x7F800000
    return torch.where(keep, u, (u + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(a):
    """a (f32) -> (hi, lo): hi = tf32(a), lo = tf32(a - hi)."""
    a = a.float()
    hi = tf32_round(a)
    return hi, tf32_round(a - hi)


def mm3(a, b):
    """a @ b in split TF32: hi hi + hi lo + lo hi."""
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    return ah @ bh + ah @ bl + al @ bh
