"""Plain PyTorch version of the grouped-matmul kernel: a port of the JAX
package's ``gmm_reference`` oracle (an f32 batched product, rows >=
``counts[e]`` zeroed, cast to x's dtype).

The wrapper in ``ops.py`` takes it for tensors on the CPU; on the card it
is what the CUDA kernel is held against.
"""
from __future__ import annotations

import torch


def gmm_reference(x, w, counts):
    """x: (E, C, D); w: (E, D, F); counts: (E,) -> (E, C, F) with rows >=
    counts[e] zeroed."""
    out = torch.einsum("ecd,edf->ecf", x.float(), w.float())
    rows = torch.arange(x.shape[1], device=x.device)[None, :, None]
    valid = rows < counts.to(x.device)[:, None, None]
    return torch.where(valid, out, 0.0).to(x.dtype)
