"""Wrapper of the CUDA flash-attention kernel (``csrc/flash_attention.cu``).

``flash_attention`` takes the model layout (B, S, H, D) and launches on
PyTorch's current stream. bf16 runs on the tensor-core kernel, which reads
and writes that layout in place; f32 runs on the FMA kernel (full-f32
products), which takes the (B*H, S, D) layout the JAX wrapper reorders
to, so the f32 call makes those copies; neither falls back to the other.
``flash_attention_bhsd`` launches either on the (B*H, S, D) layout. A
CPU tensor goes to the plain version (``ref.naive_attention``); a CUDA
tensor goes to the kernel, or the call raises. The kernel is built at its
first launch (``repro_torch.kernels.build``).
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels.flash_attention.ref import naive_attention

SOURCES = ("flash_attention.cu",)
HEAD_DIMS = (16, 32, 64, 128, 256)
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
            built = nvcc_build("flash_attention", SOURCES)
            fn = built.lib.repro_flash_attention_fwd
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + \
                [ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fn = built.lib.repro_flash_attention_fwd_bshd
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + \
                [ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            built.lib.repro_flash_attention_smem.argtypes = [ctypes.c_int] * 2
            built.lib.repro_flash_attention_smem.restype = ctypes.c_int
            _built = built
    return _built


def smem_bytes(dtype, head_dim: int) -> int:
    """Dynamic shared memory a block takes at (dtype, head_dim)."""
    return build().lib.repro_flash_attention_smem(_DTYPES[dtype], head_dim)


def _check(q, k, v, window: int) -> None:
    """Raise on what either layout's kernel does not take."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("q, k, v must lie on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v "
                        f"of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.shape[-1] not in HEAD_DIMS or k.shape[-1] != q.shape[-1]:
        raise ValueError(f"head_dim {q.shape[-1]} (k: {k.shape[-1]}) not in "
                         f"{HEAD_DIMS}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention needs contiguous tensors")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in (q, k, v)):
        raise ValueError("the bf16 kernel copies 16-byte chunks: q, k, v "
                         "must start on 16-byte boundaries")


def _launched(err: int) -> None:
    global launches
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    launches += 1


def flash_attention_bhsd(q, k, v, *, causal: bool = True, window: int = 0,
                         group: int = 1):
    """Kernel launch on the (B*H, S, D) layout. q: (B*Hq, Sq, D);
    k, v: (B*Hkv, Sk, D), all contiguous on one CUDA device; the kv row of
    q row bh is bh // group. Returns (B*Hq, Sq, D) in q's dtype."""
    _check(q, k, v, window)
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"expected q (B*Hq,Sq,D), k = v (B*Hkv,Sk,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    BHq, Sq, D = q.shape
    BHkv, Sk, _ = k.shape
    if group < 1 or BHq != BHkv * group:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, group {group}")
    if min(BHq, Sq, Sk) == 0 or BHq > 65535:
        raise ValueError(f"unsupported extent B*Hq={BHq}, Sq={Sq}, Sk={Sk}")
    lib = build().lib
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.repro_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            _DTYPES[q.dtype], BHq, group, Sq, Sk, D, int(causal),
            int(window), float(D ** -0.5), stream)
    _launched(err)
    return o


def _flash_bshd(q, k, v, causal: bool, window: int):
    """bf16 kernel launch on the model layout, read and written in place."""
    _check(q, k, v, window)
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    if min(B, Sq, Sk) == 0 or B * Hq > 65535:
        raise ValueError(f"unsupported extent B={B}, Hq={Hq}, Sq={Sq}, "
                         f"Sk={Sk}")
    lib = build().lib
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.repro_flash_attention_fwd_bshd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Hq,
            Hkv, Sq, Sk, D, int(causal), int(window), float(D ** -0.5),
            stream)
    _launched(err)
    return o


def _aligned(t):
    """``t`` contiguous, copied where its data does not start on a 16-byte
    boundary (a view into a larger buffer may not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D) -> (B, Sq, Hq, D)."""
    if q.device.type == "cpu":
        return naive_attention(q, k, v, causal=causal, window=window)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or \
            k.shape[0] != q.shape[0] or k.shape[2] == 0 or \
            q.shape[2] % k.shape[2]:
        raise ValueError(f"expected q (B,Sq,Hq,D), k = v (B,Sk,Hkv,D) with "
                         f"Hkv dividing Hq; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype == torch.bfloat16:
        return _flash_bshd(_aligned(q), _aligned(k), _aligned(v), causal,
                           window)
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    qt = q.transpose(1, 2).reshape(B * Hq, Sq, D).contiguous()
    kt = k.transpose(1, 2).reshape(B * Hkv, Sk, D).contiguous()
    vt = v.transpose(1, 2).reshape(B * Hkv, Sk, D).contiguous()
    out = flash_attention_bhsd(qt, kt, vt, causal=causal, window=window,
                               group=Hq // Hkv)
    return out.reshape(B, Hq, Sq, D).transpose(1, 2)
