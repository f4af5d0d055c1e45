"""Pieces the plain references share: float32 arithmetic with TF32 off,
RMSNorm, and the linear layer in float32 or, for the control, with both
operands rounded to fp8 (e4m3, scaled per row of the activations and
per output column of the weights)."""
from __future__ import annotations

import contextlib
from typing import Iterator

import torch

FP8_MAX = 448.0


@contextlib.contextmanager
def exact_f32() -> Iterator[None]:
    """Float32 products with TF32 off, restored afterwards."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.backends.cudnn.allow_tf32 = prev[1]
        torch.set_float32_matmul_precision(prev[2])


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to e4m3, scaled so that the largest magnitude along
    ``dim`` maps to e4m3's largest."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def lin(a: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ w`` in float32; "fp8" rounds a's rows and w's columns to fp8
    first. ``w`` may be stored in any float type."""
    w = w.float()
    if precision == "fp8":
        return fp8(a, -1) @ fp8(w, -2)
    if precision != "f32":
        raise ValueError(f"unknown precision {precision!r}")
    return a @ w
