"""Plain PyTorch version of the grouped-matmul kernel: a port of the JAX
package's ``gmm_reference`` oracle (an f32 batched product, rows >=
``counts[e]`` zeroed, cast to x's dtype).

The wrapper in ``ops.py`` takes it for tensors on the CPU; on the card it
is what the CUDA kernel is held against. ``gmm_split_reference`` sums the
product as the kernel's swap path does with its D split over ``splits``
blocks: an f32 partial a block, added in rank order, rounded once.
``gmm_tf32x3_reference`` is the arithmetic of the f32 "tf32x3" path: each
D tile of 32 a product in split TF32 (``kernels/tf32.py``), the tiles of
a block summed in order, the blocks' partials in rank order.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.moe_gmm.tiling import TF32_DEPTH, split_bounds
from repro_torch.kernels.tf32 import tf32_split


def gmm_reference(x, w, counts):
    """x: (E, C, D); w: (E, D, F); counts: (E,) -> (E, C, F) with rows >=
    counts[e] zeroed."""
    out = torch.einsum("ecd,edf->ecf", x.float(), w.float())
    rows = torch.arange(x.shape[1], device=x.device)[None, :, None]
    valid = rows < counts.to(x.device)[:, None, None]
    return torch.where(valid, out, 0.0).to(x.dtype)


def gmm_split_reference(x, w, counts, splits: int):
    """``gmm_reference`` with the sum over D taken as ``splits`` f32
    partials over ``split_bounds``, added in rank order and rounded once."""
    acc = None
    for lo, hi in split_bounds(x.shape[2], splits):
        part = torch.einsum("ecd,edf->ecf", x[:, :, lo:hi].float(),
                            w[:, lo:hi].float())
        acc = part if acc is None else acc + part
    rows = torch.arange(x.shape[1], device=x.device)[None, :, None]
    valid = rows < counts.to(x.device)[:, None, None]
    return torch.where(valid, acc, 0.0).to(x.dtype)


def gmm_tf32x3_reference(x, w, counts, splits: int = 1):
    """``gmm_reference`` in f32 as the tf32x3 path computes it: x and w
    split into tf32 hi + lo, each D tile of 32 taken as hi hi + hi lo + lo
    hi and added in order into a block's f32 partial (the D tiles of
    ``split_bounds(D, splits, 32)``), the ``splits`` partials added in rank
    order."""
    xh, xl = tf32_split(x)
    wh, wl = tf32_split(w)
    acc = None
    for lo, hi in split_bounds(x.shape[2], splits, TF32_DEPTH):
        part = None
        for d in range(lo, hi, TF32_DEPTH):
            k = slice(d, min(hi, d + TF32_DEPTH))
            tile = (torch.einsum("ecd,edf->ecf", xh[:, :, k], wh[:, k])
                    + torch.einsum("ecd,edf->ecf", xl[:, :, k], wh[:, k])
                    + torch.einsum("ecd,edf->ecf", xh[:, :, k], wl[:, k]))
            part = tile if part is None else part + tile
        if part is None:   # a block with no D tile contributes zeros
            part = torch.zeros((x.shape[0], x.shape[1], w.shape[2]),
                               device=x.device)
        acc = part if acc is None else acc + part
    rows = torch.arange(x.shape[1], device=x.device)[None, :, None]
    valid = rows < counts.to(x.device)[:, None, None]
    return torch.where(valid, acc, 0.0)
