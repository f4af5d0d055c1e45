"""Plain PyTorch versions of the SSD chunked-scan kernel.

* ``ssd_reference`` — a port of the JAX package's sequential-scan oracle
  (``repro.kernels.ssd_scan.ref.ssd_reference``): the literal per-token
  recurrence in f32, in the kernel layout. A test oracle only.
* ``ssd_chunked_reference`` — a port of ``repro.models.mamba2._ssd_chunked``
  in the model layout: the chunked SSD algorithm in f32, a sequence that
  is not a chunk multiple padded with dt = 0 tokens. The wrapper in
  ``ops.py`` takes it for tensors on the CPU, so on the CPU the port
  computes exactly what the JAX model computes; on the card it is what the
  CUDA kernel is held against.
* ``ssd_state_passing_reference`` — the CUDA kernel's decomposition in f32:
  (i) C B^T once per (b, chunk); (ii) per (b, h, chunk), independently,
  the intra-chunk output and the chunk's own state; (iii) the state passed
  from chunk to chunk; (iv) the inter-chunk output from the state before
  each chunk. Used by neither the wrapper nor the model: it lets the CPU
  show that the kernel's algorithm computes the function.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


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


def ssd_chunked_reference(xh, dt, Bm, Cm, A, h0=None, chunk: int = 256):
    """Chunked SSD scan.

    xh: (B,S,H,P); dt: (B,S,H) (post-softplus); Bm, Cm: (B,S,N); A: (H,)
    < 0. h0: optional (B,H,P,N) initial state.
    Returns y: (B,S,H,P), h_final: (B,H,P,N). All math f32, y too.
    """
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    S_orig = S
    if S % Q:
        # pad with dt=0 tokens: decay exp(0)=1 and zero input contribution,
        # so state and earlier outputs are unaffected.
        pad = Q - S % Q
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        S = S + pad
    nc = S // Q
    xh, dt, Bm, Cm, A = (t.float() for t in (xh, dt, Bm, Cm, A))

    xb = xh.reshape(Bsz, nc, Q, H, P)
    db = dt.reshape(Bsz, nc, Q, H)
    Bb = Bm.reshape(Bsz, nc, Q, N)
    Cb = Cm.reshape(Bsz, nc, Q, N)

    # log-decay within chunk: L[t] = sum_{u<=t} A*dt_u   (B,nc,Q,H)
    logd = db * A[None, None, None, :]
    Lc = torch.cumsum(logd, dim=2)
    Ltot = Lc[:, :, -1, :]                                   # (B,nc,H)

    # intra-chunk quadratic form
    CB = torch.einsum("bcqn,bckn->bcqk", Cb, Bb)             # (B,nc,Q,Q)
    # decay(i,j) = exp(L_i - L_j) for j<=i
    diff = Lc[:, :, :, None, :] - Lc[:, :, None, :, :]       # (B,nc,Q,Q,H)
    iq = torch.arange(Q, device=xh.device)
    causal = (iq[:, None] >= iq[None, :])[None, None, :, :, None]
    M = torch.where(causal, torch.exp(diff), 0.0)
    M = M * CB[..., None] * db[:, :, None, :, :]             # j-index dt
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", M, xb)

    # per-chunk end-state contribution: sum_j exp(Ltot - L_j) dt_j B_j x_j
    decay_end = torch.exp(Ltot[:, :, None, :] - Lc)         # (B,nc,Q,H)
    S_chunk = torch.einsum("bcqh,bcqn,bcqhp->bchpn",
                           decay_end * db, Bb, xb)           # (B,nc,H,P,N)

    # inter-chunk scan
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=xh.device)
         if h0 is None else h0.float())
    y_inter = []
    for c in range(nc):
        # y_inter[i] = C_i . (exp(L_i) * h)
        y_inter.append(torch.einsum("bqn,bqh,bhpn->bqhp", Cb[:, c],
                                    torch.exp(Lc[:, c]), h))
        h = torch.exp(Ltot[:, c])[:, :, None, None] * h + S_chunk[:, c]
    y_inter = torch.stack(y_inter, dim=1)                    # (B,nc,Q,H,P)

    y = (y_intra + y_inter).reshape(Bsz, S, H, P)
    return y[:, :S_orig], h


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
