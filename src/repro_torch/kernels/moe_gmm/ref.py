"""Plain PyTorch version of the grouped-matmul kernel: a port of the JAX
package's ``gmm_reference`` oracle (an f32 batched product, rows >=
``counts[e]`` zeroed, cast to x's dtype).

The wrapper in ``ops.py`` takes it for tensors on the CPU; on the card it
is what the CUDA kernel is held against. ``gmm_split_reference`` sums the
product as the kernel's swap path does with its D split over ``splits``
blocks: an f32 partial a block, added in rank order, rounded once.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.moe_gmm.tiling import split_bounds


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
