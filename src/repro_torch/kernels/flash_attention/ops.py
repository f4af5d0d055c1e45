"""Wrapper of the CUDA flash-attention kernel (``csrc/flash_attention.cu``).

``flash_attention`` takes the model layout (B, S, H, D) and launches on
PyTorch's current stream. ``flash_path`` picks the kernel's path from the
dtype and head dim before the launch: bf16 at D 64, 128 and 256 (every
shipped config) runs on ``flash_fwd_wgmma`` (Hopper's wgmma fed by TMA),
bf16 at D 16 and 32 on ``flash_fwd_tc`` (mma.sync), f32 at D 64, 128 and
256 on ``flash_fwd_tf32x3`` (wgmma in split TF32, fed by TMA); the three
read and write that layout in place. f32 at D 16 and 32 (test shapes)
runs on the FMA kernel, which takes the (B*H, S, D) layout the JAX
wrapper reorders to, so that call makes those copies. No path falls back
to another.
``flash_attention_bhsd`` launches any path on the (B*H, S, D) layout. A
CPU tensor goes to the plain version (``ref.naive_attention``); a CUDA
tensor goes to the kernel, or the call raises. The kernel is built at its
first launch (``repro_torch.kernels.build``).

``softcap`` (>= 0) caps each scaled score s at ``softcap * tanh(s /
softcap)`` before the mask, as JAX's ``layers.attention`` does; 0 leaves
the scores as they are. Both kernels compute it.

``q_offset`` (>= 0) places query row i at key position ``q_offset + i``:
the causal mask keeps k <= q_offset + i and the window k > q_offset + i -
window. Context parallelism calls the kernel on a rank's query rows
against the gathered keys with its rank's offset. Under a
``FakeTensorMode`` (the dry run) a wrapper launches nothing and returns
an empty output of the right shape; the analysis charges its work.
"""
from __future__ import annotations

import ctypes
import threading

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.kernels.flash_attention.ref import naive_attention
from repro_torch.roofline.work import charged, flash_work

SOURCES = ("flash_attention.cu",)
HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPES = (torch.float32, torch.bfloat16)
# the kernel's paths, numbered as csrc/flash_attention.cu's entry points
# take them: "fma" f32 at D 16 and 32 (FMA), "tc" bf16 at D 16 and 32
# (mma.sync), "wgmma" bf16 at D 64, 128 and 256 (wgmma + TMA), "tf32x3" f32
# at D 64, 128 and 256 (wgmma in split TF32 + TMA)
PATHS = ("fma", "tc", "wgmma", "tf32x3")

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


def flash_path(dtype, D: int, aligned: bool) -> str:
    """The kernel path of a call: f32 with D in {16, 32} -> "fma"; f32 with
    D in {64, 128, 256} -> "tf32x3"; bf16 with D in {16, 32} -> "tc"; bf16
    with D in {64, 128, 256} -> "wgmma". Every path but "fma" copies
    16-byte chunks (cp.async, TMA): ``aligned`` (q, k, v and the output
    start on 16-byte boundaries) must hold there, or the call raises."""
    if dtype not in _DTYPES:
        raise TypeError(f"flash_attention has no path for {dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if dtype == torch.float32 and D <= 32:
        return "fma"
    if not aligned:
        raise ValueError("the tensor-core kernels copy 16-byte chunks: q, "
                         "k, v must start on 16-byte boundaries")
    if dtype == torch.float32:
        return "tf32x3"
    return "tc" if D <= 32 else "wgmma"


def build():
    """Build (or load) the kernel library; returns the ``Built`` record."""
    global _built
    with _build_lock:
        if _built is None:
            from repro_torch.kernels.build import build as nvcc_build
            built = nvcc_build("flash_attention", SOURCES)
            # q, k, v, o; the path and 8 (bshd: 9) ints; scale, softcap;
            # the stream
            for fn, n_int in ((built.lib.repro_flash_attention_fwd, 9),
                              (built.lib.repro_flash_attention_fwd_bshd, 10)):
                fn.argtypes = [ctypes.c_void_p] * 4 + \
                    [ctypes.c_int] * n_int + [ctypes.c_float] * 2 + \
                    [ctypes.c_void_p]
                fn.restype = ctypes.c_int
            built.lib.repro_flash_attention_smem.argtypes = [ctypes.c_int] * 2
            built.lib.repro_flash_attention_smem.restype = ctypes.c_int
            _built = built
    return _built


def smem_bytes(path: str, head_dim: int) -> int:
    """Dynamic shared memory a block of ``path`` takes at ``head_dim``; -1
    where the path does not take the head dim."""
    return build().lib.repro_flash_attention_smem(PATHS.index(path),
                                                  head_dim)


def _check_softcap(softcap: float) -> None:
    if not 0.0 <= softcap < float("inf"):
        raise ValueError(f"softcap must be finite and >= 0, got {softcap}")


def _check(q, k, v, window: int, q_offset: int, softcap: float) -> None:
    """Raise on what either layout's kernel does not take."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("q, k, v must lie on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v "
                        f"of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.shape[-1] not in HEAD_DIMS or k.shape[-1] != q.shape[-1]:
        raise ValueError(f"head_dim {q.shape[-1]} (k: {k.shape[-1]}) not in "
                         f"{HEAD_DIMS}")
    if window < 0 or q_offset < 0:
        raise ValueError(f"window and q_offset must be >= 0, got {window}, "
                         f"{q_offset}")
    _check_softcap(softcap)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention needs contiguous tensors")


def _path(q, k, v, o) -> str:
    return flash_path(q.dtype, q.shape[-1],
                      all(t.data_ptr() % 16 == 0 for t in (q, k, v, o)))


def _launched(err: int, path: str) -> None:
    global launches
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed ({path} "
                           f"path): cudaError {err}")
    launches += 1
    launches_by_path[path] += 1


def _bhsd_work(q, k, v, *, causal: bool = True, window: int = 0,
               group: int = 1, q_offset: int = 0, softcap: float = 0.0):
    BHq, Sq, D = q.shape
    return flash_work((1, Sq, k.shape[1], BHq, k.shape[0], D, causal,
                       window, q.dtype), q_offset)


def _work(q, k, v, *, causal: bool = True, window: int = 0,
          q_offset: int = 0, softcap: float = 0.0):
    B, Sq, Hq, D = q.shape
    return flash_work((B, Sq, k.shape[1], Hq, k.shape[2], D, causal, window,
                       q.dtype), q_offset)


@charged("flash_attention", _bhsd_work)
def flash_attention_bhsd(q, k, v, *, causal: bool = True, window: int = 0,
                         group: int = 1, q_offset: int = 0,
                         softcap: float = 0.0):
    """Kernel launch on the (B*H, S, D) layout. q: (B*Hq, Sq, D);
    k, v: (B*Hkv, Sk, D), all contiguous on one CUDA device; the kv row of
    q row bh is bh // group. Returns (B*Hq, Sq, D) in q's dtype."""
    if is_fake(q):
        return torch.empty_like(q)
    _check(q, k, v, window, q_offset, softcap)
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
    path = _path(q, k, v, o)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.repro_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            PATHS.index(path), BHq, group, Sq, Sk, D, int(causal),
            int(window), int(q_offset), float(D ** -0.5), float(softcap),
            stream)
    _launched(err, path)
    return o


def _flash_bshd(q, k, v, causal: bool, window: int, q_offset: int,
                softcap: float):
    """Kernel launch on the model layout, read and written in place (the
    tc, wgmma or tf32x3 path)."""
    _check(q, k, v, window, q_offset, softcap)
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    if min(B, Sq, Sk) == 0 or B * Hq > 65535:
        raise ValueError(f"unsupported extent B={B}, Hq={Hq}, Sq={Sq}, "
                         f"Sk={Sk}")
    lib = build().lib
    o = torch.empty_like(q)
    path = _path(q, k, v, o)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.repro_flash_attention_fwd_bshd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            PATHS.index(path), B, Hq, Hkv, Sq, Sk, D, int(causal),
            int(window), int(q_offset), float(D ** -0.5), float(softcap),
            stream)
    _launched(err, path)
    return o


def _aligned(t):
    """``t`` contiguous, copied where its data does not start on a 16-byte
    boundary (a view into a larger buffer may not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


@charged("flash_attention", _work)
def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, softcap: float = 0.0):
    """q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D) -> (B, Sq, Hq, D)."""
    if is_fake(q):
        return torch.empty_like(q)
    _check_softcap(softcap)
    if q.device.type == "cpu":
        return naive_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset, softcap=softcap)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or \
            k.shape[0] != q.shape[0] or k.shape[2] == 0 or \
            q.shape[2] % k.shape[2]:
        raise ValueError(f"expected q (B,Sq,Hq,D), k = v (B,Sk,Hkv,D) with "
                         f"Hkv dividing Hq; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype != torch.float32 or q.shape[-1] > 32:   # all but "fma"
        return _flash_bshd(_aligned(q), _aligned(k), _aligned(v), causal,
                           window, q_offset, softcap)
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    qt = q.transpose(1, 2).reshape(B * Hq, Sq, D).contiguous()
    kt = k.transpose(1, 2).reshape(B * Hkv, Sk, D).contiguous()
    vt = v.transpose(1, 2).reshape(B * Hkv, Sk, D).contiguous()
    out = flash_attention_bhsd(qt, kt, vt, causal=causal, window=window,
                               group=Hq // Hkv, q_offset=q_offset,
                               softcap=softcap)
    return out.reshape(B, Hq, Sq, D).transpose(1, 2)
