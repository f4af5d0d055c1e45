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
* ``rglru_chunked_reference`` — the CUDA kernel's chunk-parallel algorithm
  in f32: chunks of L steps, each scanned locally from 0 with the running
  product of its decays, a carry pass over the chunks, then the fix-up
  h_t = h_local_t + P_t h_start. Used by neither the wrapper nor the model:
  it lets the CPU show that the kernel's algorithm computes the function.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


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


def rglru_chunked_reference(log_a, gx, h0=None, L: int = 8):
    """log_a, gx: (B, S, C); h0: (B, C) or None; L: steps a chunk. Steps
    past S count as log_a = 0, gx = 0. Returns (h_all (B, S, C) in log_a's
    dtype, h_last (B, C) f32); all arithmetic in f32. Never exp of a
    difference of cumulative log-decays: under strong decay that
    overflows, while the running product only underflows, to 0."""
    B, S, C = log_a.shape
    n = -(-S // L)
    pad = n * L - S
    a = torch.exp(F.pad(log_a.float(), (0, 0, 0, pad))).reshape(B, n, L, C)
    b = F.pad(gx.float(), (0, 0, 0, pad)).reshape(B, n, L, C)
    # 1. local recurrences from 0, every chunk at once, and running products
    prod = torch.ones_like(a[:, :, 0])
    hl = torch.zeros_like(b[:, :, 0])
    p_t, hl_t = torch.empty_like(a), torch.empty_like(b)
    for t in range(L):
        hl = a[:, :, t] * hl + b[:, :, t]
        prod = prod * a[:, :, t]
        p_t[:, :, t], hl_t[:, :, t] = prod, hl
    # 2. carry: h_start(k) = P_end(k-1) h_start(k-1) + h_local_end(k-1)
    hs = (torch.zeros_like(b[:, 0, 0]) if h0 is None
          else h0.float().clone())
    starts = []
    for k in range(n):
        starts.append(hs)
        hs = p_t[:, k, -1] * hs + hl_t[:, k, -1]
    # 3. fix-up
    h = hl_t + p_t * torch.stack(starts, dim=1)[:, :, None]
    return h.reshape(B, n * L, C)[:, :S].to(log_a.dtype), hs
