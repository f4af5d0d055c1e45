"""Plain PyTorch versions of the RG-LRU scan kernel.

* ``rglru_reference`` — a port of the JAX package's oracle
  (``repro.kernels.rglru_scan.ref.rglru_reference``): the literal per-step
  recurrence h_t = exp(log_a_t) h_{t-1} + b_t in f32 from h = 0, returned
  in log_a's dtype. A test oracle.
* ``rglru_scan_reference`` — the same loop with the contract of the JAX
  model's ``repro.models.rglru._rglru_scan``: an optional initial state
  ``h0`` folded into the first step (``gx[:, 0] += a[:, 0] * h0``, as
  rglru.py:74-75 does), and the last state returned beside every state.
  The wrapper in ``ops.py`` takes it for tensors on the CPU; on the card it
  is what the CUDA kernel is held against. JAX's associative scan combines
  the same products in another order, so the two agree to f32 rounding,
  not bit for bit.
"""
from __future__ import annotations

import torch


def rglru_scan_reference(log_a, gx, h0=None):
    """log_a, gx: (B, S, C); h0: (B, C) or None. Returns (h_all (B, S, C)
    in log_a's dtype, h_last (B, C) f32); all arithmetic in f32."""
    a = torch.exp(log_a.float())
    b = gx.float()
    if h0 is not None:
        b = b.clone()
        b[:, 0] += a[:, 0] * h0.float()
    h = torch.zeros_like(b[:, 0])
    out = torch.empty_like(b)
    for t in range(b.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out.to(log_a.dtype), h


def rglru_reference(log_a, b):
    """log_a, b: (B, S, C) -> h_all (B, S, C) in log_a's dtype; h_0 = 0."""
    return rglru_scan_reference(log_a, b)[0]
