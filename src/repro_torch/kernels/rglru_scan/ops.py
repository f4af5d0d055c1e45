"""Wrapper of the CUDA RG-LRU scan kernel (``csrc/rglru_scan.cu``).

``rglru_scan(log_a, gx, h0=None)`` has the contract of the JAX model's
``repro.models.rglru._rglru_scan``: h_t = exp(log_a_t) h_{t-1} + gx_t per
channel from h0 (0 when absent), returning every h_t and the last one. The
kernel (``csrc/rglru_scan.cu``) is chunk-parallel: one thread a (channel,
chunk of 8 steps), local recurrences with running decay products, a carry
pass over the chunks in shared memory, then the fix-up; ``ref.
rglru_chunked_reference`` is the same algorithm in plain PyTorch. One
device launch a call, on PyTorch's current stream. A CPU tensor goes to
the plain version (``models.rglru._rglru_scan``, imported at the call:
the model module imports this one); a CUDA tensor goes to
the kernel, or the call raises. The kernel is built at its first launch
(``repro_torch.kernels.build``).
"""
from __future__ import annotations

import ctypes
import threading

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.distributed.tensor import DTensor

from repro_torch.roofline.work import charged, rglru_work

SOURCES = ("rglru_scan.cu",)
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
            built = nvcc_build("rglru_scan", SOURCES)
            fn = built.lib.repro_rglru_scan
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + \
                [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _built = built
    return _built


def _check(log_a, gx, h0) -> None:
    """Raise on what the kernel does not take."""
    if log_a.dtype not in _DTYPES or gx.dtype != log_a.dtype:
        raise TypeError(f"rglru_scan takes float32 or bfloat16 log_a and gx "
                        f"of one dtype, got {log_a.dtype}/{gx.dtype}")
    if log_a.dim() != 3 or gx.shape != log_a.shape:
        raise ValueError(f"expected log_a = gx (B,S,C); got "
                         f"{tuple(log_a.shape)}, {tuple(gx.shape)}")
    B, S, C = log_a.shape
    if h0 is not None and (h0.dtype != torch.float32 or
                           tuple(h0.shape) != (B, C)):
        raise ValueError(f"h0 must be float32 (B,C) = {(B, C)}, got "
                         f"{h0.dtype} {tuple(h0.shape)}")
    if min(B, S, C) == 0 or B > 65535:
        raise ValueError(f"unsupported extent B={B}, S={S}, C={C}")
    ts = (log_a, gx) if h0 is None else (log_a, gx, h0)
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("rglru_scan needs contiguous tensors")
    if not (log_a.is_cuda and all(t.device == log_a.device for t in ts)):
        raise ValueError("log_a, gx (and h0) must lie on one CUDA device")


def _no_dtensor(*ts) -> None:
    """Raise on a DTensor: the kernel takes one device's shard, which
    ``spmd.shard_map`` hands it (``models.rglru._scan_on_mesh``)."""
    if any(isinstance(t, DTensor) for t in ts):
        raise TypeError("rglru_scan got a DTensor: call it under "
                        "spmd.shard_map on the local shards "
                        "(models.rglru._scan_on_mesh)")


def _work(log_a, gx, h0=None):
    B, S, C = log_a.shape
    return rglru_work(B, S, C, h0 is not None, log_a.dtype)


@charged("rglru_scan", _work)
def rglru_scan(log_a, gx, h0=None):
    """log_a, gx: (B, S, C); h0: (B, C) f32 or None. Returns (h_all
    (B, S, C) in log_a's dtype, h_last (B, C) f32), all arithmetic in f32.
    Any S and C."""
    global launches
    _no_dtensor(log_a, gx, h0)
    if is_fake(log_a):          # the dry run: no data, nothing launched
        return torch.empty_like(log_a), log_a.new_empty(
            (log_a.shape[0], log_a.shape[2]), dtype=torch.float32)
    if log_a.device.type == "cpu":
        from repro_torch.models.rglru import _rglru_scan
        return _rglru_scan(log_a, gx, h0)
    _check(log_a, gx, h0)
    B, S, C = log_a.shape
    lib = build().lib
    y = torch.empty_like(log_a)
    h_last = torch.empty((B, C), dtype=torch.float32, device=log_a.device)
    stream = torch.cuda.current_stream(log_a.device).cuda_stream
    with torch.cuda.device(log_a.device):
        err = lib.repro_rglru_scan(
            log_a.data_ptr(), gx.data_ptr(),
            None if h0 is None else h0.data_ptr(), y.data_ptr(),
            h_last.data_ptr(), _DTYPES[log_a.dtype], B, S, C, stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: cudaError {err}")
    launches += 1
    return y, h_last
