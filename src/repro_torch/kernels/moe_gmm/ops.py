"""Wrapper of the CUDA grouped-matmul kernel (``csrc/moe_gmm.cu``).

``grouped_matmul(x, w, counts)`` has the JAX wrapper's interface
(``repro.kernels.moe_gmm.ops.grouped_matmul``, without its block sizes)
and launches on PyTorch's current stream. A CPU tensor goes to the plain
version (``ref.gmm_reference``); a CUDA tensor goes to the kernel, or the
call raises. The kernel is built at its first launch
(``repro_torch.kernels.build``). bf16 runs on the tensor cores, f32 on
the FMA kernel (full-f32 products); neither falls back to the other.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels.moe_gmm.ref import gmm_reference

SOURCES = ("moe_gmm.cu",)
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
            built = nvcc_build("moe_gmm", SOURCES)
            fn = built.lib.repro_moe_gmm
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + \
                [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            built.lib.repro_moe_gmm_smem.argtypes = [ctypes.c_int] * 2
            built.lib.repro_moe_gmm_smem.restype = ctypes.c_int
            _built = built
    return _built


def smem_bytes(dtype, C: int) -> int:
    """Dynamic shared memory a block takes at (dtype, C); 0 where the
    kernel's is static."""
    return build().lib.repro_moe_gmm_smem(_DTYPES[dtype], C)


def _check(x, w, counts) -> None:
    """Raise on what the kernel does not take."""
    if not (x.is_cuda and w.device == x.device and counts.device == x.device):
        raise ValueError("x, w, counts must lie on one CUDA device")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"moe_gmm takes float32 or bfloat16 x and w of one "
                        f"dtype, got {x.dtype}/{w.dtype}")
    if counts.dtype != torch.int32:
        raise TypeError(f"counts must be int32, got {counts.dtype}")
    if x.dim() != 3 or w.dim() != 3 or counts.dim() != 1 or \
            w.shape[0] != x.shape[0] or w.shape[1] != x.shape[2] or \
            counts.shape[0] != x.shape[0]:
        raise ValueError(f"expected x (E,C,D), w (E,D,F), counts (E,); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(counts.shape)}")
    E, C, D = x.shape
    F = w.shape[2]
    if min(E, C, D, F) == 0 or E > 65535:
        raise ValueError(f"unsupported extent E={E}, C={C}, D={D}, F={F}")
    if not (x.is_contiguous() and w.is_contiguous() and
            counts.is_contiguous()):
        raise ValueError("moe_gmm needs contiguous tensors")


def grouped_matmul(x, w, counts):
    """x: (E, C, D); w: (E, D, F); counts: (E,) int32 -> (E, C, F) in x's
    dtype: out[e] = x[e] @ w[e] with f32 accumulation, rows >= counts[e]
    zeroed."""
    global launches
    if x.device.type == "cpu":
        return gmm_reference(x, w, counts)
    _check(x, w, counts)
    E, C, D = x.shape
    F = w.shape[2]
    lib = build().lib
    out = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.repro_moe_gmm(x.data_ptr(), w.data_ptr(), counts.data_ptr(),
                                out.data_ptr(), _DTYPES[x.dtype], E, C, D, F,
                                stream)
    if err != 0:
        raise RuntimeError(f"moe_gmm kernel launch failed: cudaError {err}")
    launches += 1
    return out
