"""Wrapper of the CUDA SSD chunked-scan kernel (``csrc/ssd_scan.cu``).

``ssd_scan(xh, dt, Bm, Cm, A, chunk=...)`` has the JAX wrapper's interface
(``repro.kernels.ssd_scan.ops.ssd_scan``, without ``interpret``) and takes
the model layout as it is: B and C stay shared across heads, so C B^T is
computed once per (b, chunk) instead of per head from a copy broadcast
over heads. A call makes two device launches on PyTorch's current stream
(C B^T, then the chunk-parallel scan, which starts while the first runs;
``csrc/ssd_scan.cu``), both with their products on the tensor cores in
split TF32 and their operands brought by TMA, into a scratch tensor the
wrapper allocates, and counts as one launch. TMA reads x, B and C in
place: they must start on 16-byte boundaries, with rows (H P and N
elements) of a multiple of 16 bytes. A CPU tensor goes
to the plain version (``models.mamba2._ssd_chunked``, imported at the
call: the model module imports this one); a CUDA tensor goes
to the kernel, or the call raises. The kernel is built at its first launch
(``repro_torch.kernels.build``).
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.distributed.tensor import DTensor

from repro_torch.roofline.work import charged, ssd_work

SOURCES = ("ssd_scan.cu",)
MAX_STATE = 128      # N: the state tile's 128 columns (two warpgroups')
MAX_CHUNK = 256      # Q: four query tiles of 64 rows a block
KERNELS = ("ssd_chunk", "ssd_cb")   # repro_ssd_scan_smem's numbering
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset (plain-version calls do not count)
launches = 0

_built = None
_build_lock = threading.Lock()


def reset_launches() -> None:
    global launches
    launches = 0


def build():
    """Build (or load) the kernel library; returns the ``Built`` record."""
    global _built
    with _build_lock:
        if _built is None:
            from repro_torch.kernels.build import build as nvcc_build
            built = nvcc_build("ssd_scan", SOURCES)
            fn = built.lib.repro_ssd_scan
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + \
                [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            ws = built.lib.repro_ssd_scan_workspace
            ws.argtypes = [ctypes.c_int] * 6
            ws.restype = ctypes.c_longlong
            built.lib.repro_ssd_scan_smem.argtypes = [ctypes.c_int]
            built.lib.repro_ssd_scan_smem.restype = ctypes.c_int
            _built = built
    return _built


def smem_bytes(kernel: str = "ssd_chunk") -> int:
    """Dynamic shared memory of a block of ``kernel`` (``KERNELS``): the
    chunk-parallel scan or C B^T."""
    return build().lib.repro_ssd_scan_smem(KERNELS.index(kernel))


@functools.lru_cache(maxsize=256)
def _workspace_bytes(B: int, S: int, H: int, P: int, N: int, Q: int) -> int:
    """Scratch bytes of a call at these extents (the C entry point's
    layout: the ticket, the flags, C B^T per (b, chunk), the states)."""
    return build().lib.repro_ssd_scan_workspace(B, S, H, P, N, Q)


def _check(xh, dt, Bm, Cm, A, h0, chunk: int) -> None:
    """Raise on what the kernel does not take."""
    if h0 is not None:
        raise ValueError("the CUDA ssd_scan kernel takes no initial state "
                         "h0 (the Pallas kernel has none either)")
    if xh.dtype not in _DTYPES or any(t.dtype != xh.dtype
                                      for t in (dt, Bm, Cm)):
        raise TypeError(f"ssd_scan takes float32 or bfloat16 xh, dt, Bm, Cm "
                        f"of one dtype, got {xh.dtype}/{dt.dtype}/"
                        f"{Bm.dtype}/{Cm.dtype}")
    if A.dtype != torch.float32:
        raise TypeError(f"A must be float32, got {A.dtype}")
    if xh.dim() != 4 or dt.dim() != 3 or Bm.dim() != 3 or \
            Bm.shape != Cm.shape or A.dim() != 1 or \
            tuple(dt.shape) != tuple(xh.shape[:3]) or \
            tuple(Bm.shape[:2]) != tuple(xh.shape[:2]) or \
            A.shape[0] != xh.shape[2]:
        raise ValueError(f"expected xh (B,S,H,P), dt (B,S,H), Bm = Cm "
                         f"(B,S,N), A (H,); got {tuple(xh.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)}, {tuple(A.shape)}")
    B, S, H, P = xh.shape
    N = Bm.shape[2]
    if min(B, S, H, P, N) == 0 or N > MAX_STATE or chunk < 1 or \
            min(chunk, S) > MAX_CHUNK:
        raise ValueError(f"unsupported extent B={B}, S={S}, H={H}, P={P}, "
                         f"N={N} (at most {MAX_STATE}), chunk={chunk} "
                         f"(min(chunk, S) at most {MAX_CHUNK})")
    if not all(t.is_contiguous() for t in (xh, dt, Bm, Cm, A)):
        raise ValueError("ssd_scan needs contiguous tensors")
    es = xh.element_size()
    if (H * P * es) % 16 or (N * es) % 16 or \
            any(t.data_ptr() % 16 for t in (xh, Bm, Cm)):
        raise ValueError(f"ssd_scan's TMA loads need xh, Bm, Cm starting on "
                         f"16-byte boundaries and rows of a multiple of 16 "
                         f"bytes: H*P={H * P} and N={N} elements of "
                         f"{es} bytes")
    if not (xh.is_cuda and all(t.device == xh.device
                               for t in (dt, Bm, Cm, A))):
        raise ValueError("xh, dt, Bm, Cm, A must lie on one CUDA device")


def _no_dtensor(*ts) -> None:
    """Raise on a DTensor: the kernel takes one device's shard, which
    ``spmd.shard_map`` hands it (``models.mamba2._scan_on_mesh``)."""
    if any(isinstance(t, DTensor) for t in ts):
        raise TypeError("ssd_scan got a DTensor: call it under "
                        "spmd.shard_map on the local shards "
                        "(models.mamba2._scan_on_mesh)")


def _work(xh, dt, Bm, Cm, A, *, chunk: int = 128, h0=None):
    B, S, H, P = xh.shape
    return ssd_work(B, S, H, P, Bm.shape[2], chunk, xh.dtype)


@charged("ssd_scan", _work)
def ssd_scan(xh, dt, Bm, Cm, A, *, chunk: int = 128, h0=None):
    """xh: (B, S, H, P); dt: (B, S, H) (post-softplus); Bm, Cm: (B, S, N)
    (shared across heads); A: (H,) < 0; chunk: the chunk length, cut to S.
    Returns (y: (B, S, H, P) in xh's dtype, h: (B, H, P, N) f32), all
    arithmetic in f32. Any S: a sequence that is not a chunk multiple is
    padded with dt = 0 tokens, as the JAX model pads it. ``h0`` (an initial
    state) is taken by the plain version only."""
    global launches
    _no_dtensor(xh, dt, Bm, Cm, A, h0)
    if is_fake(xh):             # the dry run: no data, nothing launched
        B, S, H, P = xh.shape
        return torch.empty_like(xh), xh.new_empty(
            (B, H, P, Bm.shape[2]), dtype=torch.float32)
    if xh.device.type == "cpu":
        from repro_torch.models.mamba2 import _ssd_chunked
        y, h = _ssd_chunked(xh, dt, Bm, Cm, A, h0=h0, chunk=chunk)
        return y.to(xh.dtype), h
    _check(xh, dt, Bm, Cm, A, h0, chunk)
    B, S, H, P = xh.shape
    N = Bm.shape[2]
    Q = min(chunk, S)
    lib = build().lib
    y = torch.empty_like(xh)
    h = torch.empty((B, H, P, N), dtype=torch.float32, device=xh.device)
    # C B^T per (b, chunk), the chunks' published states, their flags and
    # the block ticket; the first launch zeroes the flags and the ticket
    ws = torch.empty(_workspace_bytes(B, S, H, P, N, Q), dtype=torch.uint8,
                     device=xh.device)
    stream = torch.cuda.current_stream(xh.device).cuda_stream
    with torch.cuda.device(xh.device):
        err = lib.repro_ssd_scan(xh.data_ptr(), dt.data_ptr(), Bm.data_ptr(),
                                 Cm.data_ptr(), A.data_ptr(), y.data_ptr(),
                                 h.data_ptr(), ws.data_ptr(),
                                 _DTYPES[xh.dtype], B, S, H, P, N, Q, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: cudaError {err}")
    launches += 1
    return y, h
