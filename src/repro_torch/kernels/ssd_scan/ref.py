"""Plain PyTorch versions of the SSD chunked-scan kernel.

* ``ssd_reference`` — a port of the JAX package's sequential-scan oracle
  (``repro.kernels.ssd_scan.ref.ssd_reference``): the literal per-token
  recurrence in f32, in the kernel layout. A test oracle only.
* ``ssd_chunked_reference`` — ``repro_torch.models.mamba2._ssd_chunked``,
  the port of ``repro.models.mamba2._ssd_chunked`` in the model layout
  (defined once, beside the model that trains through it): the chunked
  SSD algorithm in f32, a sequence that is not a chunk multiple padded
  with dt = 0 tokens. The wrapper in ``ops.py`` takes it for tensors on
  the CPU, so on the CPU the port computes exactly what the JAX model
  computes; on the card it is what the CUDA kernel is held against.
* ``ssd_state_passing_reference`` — the CUDA kernel's decomposition in f32:
  (i) C B^T once per (b, chunk); (ii) per (b, h, chunk), independently,
  the intra-chunk output and the chunk's own state; (iii) the state passed
  from chunk to chunk; (iv) the inter-chunk output from the state before
  each chunk. Used by neither the wrapper nor the model: it lets the CPU
  show that the kernel's algorithm computes the function.
* ``tf32_split`` — an f32 tensor as hi + lo, both rounded to tf32 the way
  ``cvt.rna.tf32.f32`` rounds (to nearest, ties away from zero, on the
  f32 bits); ``repro_torch.kernels.tf32``'s, shared with flash's plain
  version of its f32 path.
* ``ssd_tf32x3_reference`` — the CUDA kernel's numerics: the same
  decomposition, in 64-row tiles, with each of its four products taken as
  hi hi + hi lo + lo hi of the split operands (split TF32), as the tensor
  cores take them; decays, states and sums in f32. It shows on the CPU
  that three TF32 products keep f32's tolerance.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.tf32 import mm3, tf32_split  # noqa: F401
from repro_torch.models.mamba2 import _ssd_chunked as ssd_chunked_reference


def ssd_reference(x, dt, Bm, Cm, A):
    """x: (BH, S, P); dt: (BH, S, 1); Bm, Cm: (BH, S, N); A: (BH, 1).
    Returns (y: (BH, S, P) in x's dtype, h_final: (BH, P, N) f32)."""
    BH, S, P = x.shape
    N = Bm.shape[-1]
    xf, dtf, bf, cf = (t.float() for t in (x, dt, Bm, Cm))
    a = A.float()[:, 0]
    h = torch.zeros((BH, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        da = torch.exp(dtf[:, t, 0] * a)                        # (BH,)
        h = da[:, None, None] * h + dtf[:, t, 0, None, None] * (
            xf[:, t, :, None] * bf[:, t, None, :])
        ys.append(torch.einsum("bpn,bn->bp", h, cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), h


def ssd_state_passing_reference(xh, dt, Bm, Cm, A, chunk: int = 256):
    """The chunk-parallel SSD decomposition of ``csrc/ssd_scan.cu``.

    xh: (B,S,H,P); dt: (B,S,H) (post-softplus); Bm, Cm: (B,S,N); A: (H,)
    < 0. Tokens past S in the last chunk count as dt = 0, x = B = C = 0.
    Returns y: (B,S,H,P), h_final: (B,H,P,N), all f32.
    """
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    x = F.pad(xh.float(), (0, 0, 0, 0, 0, pad)).reshape(Bsz, nc, Q, H, P)
    d = F.pad(dt.float(), (0, 0, 0, pad)).reshape(Bsz, nc, Q, H)
    Bc = F.pad(Bm.float(), (0, 0, 0, pad)).reshape(Bsz, nc, Q, N)
    Cc = F.pad(Cm.float(), (0, 0, 0, pad)).reshape(Bsz, nc, Q, N)
    lc = torch.cumsum(d * A.float(), dim=2)                  # (B,nc,Q,H)
    ltot = lc[:, :, -1]                                      # (B,nc,H)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=xh.device).tril()

    # (i) C B^T once per (b, chunk), its lower triangle (i query, j key)
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc).masked_fill(~tri, 0.0)
    # (ii) per (b, h, chunk): exp only of Lc_i - Lc_j with j <= i (<= 0)
    diff = (lc[:, :, :, None, :] - lc[:, :, None, :, :]).masked_fill(
        ~tri[..., None], float("-inf"))                      # (B,nc,i,j,H)
    m = cb[..., None] * torch.exp(diff) * d[:, :, None, :, :]
    y = torch.einsum("bcijh,bcjhp->bcihp", m, x)
    w = torch.exp(ltot[:, :, None, :] - lc) * d              # (B,nc,Q,H)
    s = torch.einsum("bcjh,bcjhp,bcjn->bchpn", w, x, Bc)     # (B,nc,H,P,N)
    # (iii) h_c = exp(Ltot_c) h_{c-1} + s_c, keeping the state before each
    h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=xh.device)
    before = []
    for c in range(nc):
        before.append(h)
        h = torch.exp(ltot[:, c])[:, :, None, None] * h + s[:, c]
    # (iv) y_i += exp(Lc_i) h_{c-1} C_i
    y = y + torch.exp(lc)[..., None] * torch.einsum(
        "bcin,bchpn->bcihp", Cc, torch.stack(before, dim=1))
    return y.reshape(Bsz, nc * Q, H, P)[:, :S], h


TILE = 64   # rows of the kernel's query and key tiles


def ssd_tf32x3_reference(xh, dt, Bm, Cm, A, chunk: int = 256):
    """``ssd_state_passing_reference`` with the CUDA kernel's products.

    Per chunk: (i) CB = C B^T; (ii) M = CB exp(Lc_i - Lc_j) dt_j, j <= i,
    factored off the diagonal tiles as exp(Lc_i - Lc_i0) exp(Lc_i0 - Lc_j)
    dt_j (i0 the query tile's first row), y = M x; (iii) s = (w x)^T B,
    w_j = exp(Ltot - Lc_j) dt_j, h_c = exp(Ltot) h_{c-1} + s_c; (iv) y_i +=
    exp(Lc_i) (C h_{c-1}^T)[i]. Each product in split TF32. Same
    arguments and results as ``ssd_state_passing_reference``.
    """
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    x = F.pad(xh.float(), (0, 0, 0, 0, 0, pad)).reshape(Bsz, nc, Q, H, P)
    d = F.pad(dt.float(), (0, 0, 0, pad)).reshape(Bsz, nc, Q, H)
    Bc = F.pad(Bm.float(), (0, 0, 0, pad)).reshape(Bsz, nc, Q, N)
    Cc = F.pad(Cm.float(), (0, 0, 0, pad)).reshape(Bsz, nc, Q, N)
    lc = torch.cumsum(d * A.float(), dim=2)                  # (B,nc,Q,H)
    ltot = lc[:, :, -1]
    idx = torch.arange(Q, device=xh.device)
    i0 = idx // TILE * TILE                                  # a row's tile
    tri = idx[:, None] >= idx[None, :]
    same = i0[:, None] == i0[None, :]

    cb = mm3(Cc, Bc.transpose(-1, -2))                      # (B,nc,i,j)
    li = lc.permute(0, 1, 3, 2)                              # (B,nc,H,Q)
    dj = d.permute(0, 1, 3, 2)
    diff = li[..., :, None] - li[..., None, :]               # (B,nc,H,i,j)
    diag = torch.exp(diff.clamp(max=0.0)) * cb[:, :, None] * dj[..., None, :]
    u = torch.exp(li - li[..., i0])                          # (B,nc,H,i)
    v = torch.exp((li[..., i0][..., :, None] - li[..., None, :])
                  .clamp(max=0.0)) * dj[..., None, :]        # (B,nc,H,i,j)
    off = cb[:, :, None] * (u[..., None] * v)
    m = torch.where(same, diag, off).masked_fill(~tri, 0.0)
    xp = x.permute(0, 1, 3, 2, 4)                            # (B,nc,H,Q,P)
    y = mm3(m, xp)                                          # (B,nc,H,i,p)
    w = torch.exp(ltot[:, :, None, :] - lc) * d              # (B,nc,Q,H)
    wx = w.permute(0, 1, 3, 2)[..., None] * xp               # (B,nc,H,j,p)
    s = mm3(wx.transpose(-1, -2), Bc[:, :, None])           # (B,nc,H,p,n)
    h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=xh.device)
    for c in range(nc):
        inter = mm3(Cc[:, c, None], h.transpose(-1, -2))   # (B,H,i,p)
        y[:, c] = y[:, c] + torch.exp(li[:, c])[..., None] * inter
        h = torch.exp(ltot[:, c])[:, :, None, None] * h + s[:, c]
    y = y.permute(0, 1, 3, 2, 4).reshape(Bsz, nc * Q, H, P)[:, :S]
    return y, h
