"""Wrapper of the CUDA grouped-matmul kernel (``csrc/moe_gmm.cu``).

``grouped_matmul(x, w, counts)`` has the JAX wrapper's interface
(``repro.kernels.moe_gmm.ops.grouped_matmul``, without its block sizes)
and launches on PyTorch's current stream. A CPU tensor goes to the plain
version (``ref.gmm_reference``); a CUDA tensor goes to the kernel, or the
call raises. The kernel is built at its first launch
(``repro_torch.kernels.build``). ``gmm_path`` picks the kernel's path
from the call's dtype, shape and alignment alone, and ``gmm_splits`` the
split over D of the swap path and of the tf32x3 path at C <= 16 from the
shape and the card's SM count; no path falls back to another.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.kernels.moe_gmm.ref import gmm_reference
from repro_torch.kernels.moe_gmm.tiling import (MAX_SPLITS, SWAP_COLS,
                                               SWAP_DEPTH, TF32_COLS,
                                               TF32_DEPTH)
from repro_torch.roofline.work import charged, gmm_work

SOURCES = ("moe_gmm.cu",)
_DTYPES = (torch.float32, torch.bfloat16)
# the kernel's paths, numbered as csrc/moe_gmm.cu's entry point takes them:
# "fma" f32 where TMA cannot address the tensors (FMA products), "swap"
# bf16 C <= 16 through TMA (wgmma with the operands swapped, split over
# D), "wgmma" bf16 C > 16 through TMA, "fill" bf16 where TMA cannot
# address the tensors (mma.sync, 8- or 16-row tiles filled element by
# element), "tf32x3" f32 through TMA (wgmma in split TF32, the operands
# swapped, split over D at C <= 16)
PATHS = ("fma", "swap", "wgmma", "fill", "tf32x3")

# kernel launches since the last reset (plain-version calls do not count),
# in all and by path
launches = 0
launches_by_path = dict.fromkeys(PATHS, 0)

_built = None
_build_lock = threading.Lock()


def reset_launches() -> None:
    global launches
    launches = 0
    for p in PATHS:
        launches_by_path[p] = 0


def gmm_path(dtype, C: int, D: int, F: int, aligned: bool) -> str:
    """The kernel path of a call: f32 where TMA can address x, w and out
    (D and F multiples of 4: 16-byte row strides; ``aligned``: every base
    16-byte aligned) -> "tf32x3", other f32 calls -> "fma"; bf16 where
    TMA can address them (D and F multiples of 8) -> "swap" for C <= 16,
    "wgmma" above; other bf16 calls -> "fill"."""
    if dtype == torch.float32:
        return "tf32x3" if aligned and D % 4 == 0 and F % 4 == 0 else "fma"
    if dtype != torch.bfloat16:
        raise TypeError(f"moe_gmm has no path for {dtype}")
    if not (aligned and D % 8 == 0 and F % 8 == 0):
        return "fill"
    return "swap" if C <= 16 else "wgmma"


def gmm_splits(E: int, C: int, D: int, F: int, sms: int) -> int:
    """Blocks (a cluster) that split the D sum of each (expert, 128-column
    tile) on the swap path and on the tf32x3 path at C <= 16: the largest
    of 1, 2, 4, 8 that keeps every block on an SM of its own (E x tiles x
    splits <= ``sms``) and at least 64 of D a block (one bf16 D tile, two
    f32 ones); 1 for C > 16 (no path splits there)."""
    if C > 16:
        return 1
    blocks = E * -(-F // SWAP_COLS)
    splits = 1
    while (splits < MAX_SPLITS and 2 * splits * blocks <= sms
           and 2 * splits * SWAP_DEPTH <= D):
        splits *= 2
    return splits


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _sm_count(device) -> int:
    """The card's SM count, read once a device."""
    device = torch.device(device)
    return _sms(torch.cuda.current_device() if device.index is None
                else device.index)


def build():
    """Build (or load) the kernel library; returns the ``Built`` record."""
    global _built
    with _build_lock:
        if _built is None:
            from repro_torch.kernels.build import build as nvcc_build
            built = nvcc_build("moe_gmm", SOURCES)
            fn = built.lib.repro_moe_gmm
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + \
                [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            built.lib.repro_moe_gmm_smem.argtypes = [ctypes.c_int] * 2
            built.lib.repro_moe_gmm_smem.restype = ctypes.c_int
            tiling = built.lib.repro_moe_gmm_tiling
            tiling.argtypes, tiling.restype = [ctypes.c_int], ctypes.c_int
            got = tuple(tiling(i) for i in range(5))
            want = (SWAP_COLS, SWAP_DEPTH, MAX_SPLITS, TF32_COLS, TF32_DEPTH)
            if got != want:
                raise RuntimeError(
                    f"moe_gmm.cu tiles the swap and tf32x3 paths as {got} "
                    f"(swap columns, depth, cluster, tf32x3 columns, "
                    f"depth), tiling.py as {want}")
            _built = built
    return _built


def smem_bytes(path: str, C: int) -> int:
    """Dynamic shared memory a block of ``path`` takes at C rows; 0 where
    the kernel's is static."""
    return build().lib.repro_moe_gmm_smem(PATHS.index(path), C)


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


def _work(x, w, counts):
    E, C, D = x.shape
    return gmm_work(E, C, D, w.shape[2], counts, x.dtype)


@charged("moe_gmm", _work)
def grouped_matmul(x, w, counts):
    """x: (E, C, D); w: (E, D, F); counts: (E,) int32 -> (E, C, F) in x's
    dtype: out[e] = x[e] @ w[e] with f32 accumulation, rows >= counts[e]
    zeroed."""
    global launches
    if is_fake(x):              # the dry run: no data, nothing launched
        return x.new_empty((x.shape[0], x.shape[1], w.shape[2]))
    if x.device.type == "cpu":
        return gmm_reference(x, w, counts)
    _check(x, w, counts)
    E, C, D = x.shape
    F = w.shape[2]
    lib = build().lib
    out = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    path = gmm_path(x.dtype, C, D, F, all(
        t.data_ptr() % 16 == 0 for t in (x, w, out)))
    splits = gmm_splits(E, C, D, F, _sm_count(x.device)) \
        if path in ("swap", "tf32x3") else 1
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.repro_moe_gmm(x.data_ptr(), w.data_ptr(), counts.data_ptr(),
                                out.data_ptr(), PATHS.index(path), splits, E,
                                C, D, F, stream)
    if err != 0:
        raise RuntimeError(f"moe_gmm kernel launch failed ({path} path): "
                           f"cudaError {err}")
    launches += 1
    launches_by_path[path] += 1
    return out
