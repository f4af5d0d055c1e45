"""Wrappers of the CUDA kernels of Mamba2's prefill glue
(``csrc/ssm_glue.cu``), one on each side of ``ssd_scan``.

``ssm_conv_act(xin, Bm, Cm, dt, conv_x, conv_B, conv_C, dt_bias)``: the
causal convs of x, B and C with SiLU, softplus(dt + dt_bias), and the conv
state; x, B and C come out in f32 (``ssd_scan``'s operands), x as (B, S,
H, P). ``ssm_gate_norm(y, xh, z, D_skip, gn, eps)``: (y + D xh) silu(z)
and the gated RMSNorm, in z's dtype. Each call is one device launch on
PyTorch's current stream and counts one in ``launches``. A CPU tensor
goes to the plain version (``models.mamba2._conv_act`` / ``_gate_norm``,
imported at the call: the model module imports this one); a CUDA tensor
goes to the kernel, or the call raises. The kernels are built at their
first launch (``repro_torch.kernels.build``), as a library of their own.
"""
from __future__ import annotations

import ctypes
import threading

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.distributed.tensor import DTensor

from repro_torch.roofline.work import (charged, ssm_conv_act_work,
                                       ssm_gate_norm_work)

SOURCES = ("ssm_glue.cu",)
VEC = 8              # channels a thread moves: 16-byte loads of bf16
WIDTH = 4            # the conv's width, mamba2's (csrc W)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset, both kernels (plain-version calls
# do not count)
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
            built = nvcc_build("ssm_glue", SOURCES)
            conv = built.lib.repro_ssm_conv_act
            conv.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 6 + \
                [ctypes.c_void_p]
            conv.restype = ctypes.c_int
            norm = built.lib.repro_ssm_gate_norm
            norm.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_float] + \
                [ctypes.c_int] * 5 + [ctypes.c_void_p]
            norm.restype = ctypes.c_int
            built.lib.repro_ssm_glue_max_inner.restype = ctypes.c_int
            _built = built
    return _built


def _no_dtensor(*ts) -> None:
    """Raise on a DTensor: the model keeps the plain version on a mesh."""
    if any(isinstance(t, DTensor) for t in ts):
        raise TypeError("the ssm_glue kernels take plain tensors; "
                        "models.mamba2 runs the plain version on a mesh")


def _common(ts: dict, dtypes: dict, aligned: tuple) -> None:
    """Dtypes (``dtypes``: name -> allowed), contiguity, 16-byte bases of
    ``aligned`` and one CUDA device, checked in that order."""
    for name, t in ts.items():
        if t.dtype not in dtypes[name]:
            raise TypeError(f"{name} must be {dtypes[name]}, got {t.dtype}")
    bad = [n for n, t in ts.items() if not t.is_contiguous()]
    if bad:
        raise ValueError(f"the ssm_glue kernels need contiguous tensors: "
                         f"{bad} are not")
    bad = [n for n in aligned if ts[n].data_ptr() % 16]
    if bad:
        raise ValueError(f"the ssm_glue kernels' 16-byte loads need {bad} "
                         f"starting on 16-byte boundaries")
    first = next(iter(ts.values()))
    if not (first.is_cuda and all(t.device == first.device
                                  for t in ts.values())):
        raise ValueError("the ssm_glue kernels' operands must lie on one "
                         "CUDA device")


def _check_conv(xin, Bm, Cm, dt, conv_x, conv_B, conv_C, dt_bias) -> None:
    """Raise on what ``ssm_conv_act``'s kernel does not take."""
    if xin.dtype not in _DTYPES:
        raise TypeError(f"ssm_conv_act takes float32 or bfloat16, got "
                        f"{xin.dtype}")
    one = (xin.dtype,)
    ts = dict(xin=xin, Bm=Bm, Cm=Cm, dt=dt, conv_x=conv_x, conv_B=conv_B,
              conv_C=conv_C, dt_bias=dt_bias)
    ok = xin.dim() == 3 and Bm.dim() == 3 and dt.dim() == 3 and \
        conv_x.dim() == 2
    if ok:
        B, S, DI = xin.shape
        N, H, W = Bm.shape[2], dt.shape[2], conv_x.shape[0]
        want = dict(xin=(B, S, DI), Bm=(B, S, N), Cm=(B, S, N),
                    dt=(B, S, H), conv_x=(W, DI), conv_B=(W, N),
                    conv_C=(W, N), dt_bias=(H,))
        ok = all(tuple(t.shape) == want[n] for n, t in ts.items())
    if not ok:
        raise ValueError(f"expected xin (B,S,DI), Bm = Cm (B,S,N), dt "
                         f"(B,S,H), conv_x (W,DI), conv_B = conv_C (W,N), "
                         f"dt_bias (H,); got {_shapes(ts)}")
    if min(B, S, DI, N, H) == 0 or DI % VEC or N % VEC or H % VEC or \
            W != WIDTH:
        raise ValueError(f"unsupported extent B={B}, S={S}, DI={DI}, N={N}, "
                         f"H={H} (multiples of {VEC}), W={W} (only "
                         f"{WIDTH})")
    _common(ts, {n: one for n in ts}, tuple(ts))


def _check_norm(y, xh, z, D_skip, gn) -> None:
    """Raise on what ``ssm_gate_norm``'s kernel does not take."""
    if z.dtype not in _DTYPES:
        raise TypeError(f"ssm_gate_norm takes float32 or bfloat16 z, got "
                        f"{z.dtype}")
    one, f32 = (z.dtype,), (torch.float32,)
    ts = dict(y=y, xh=xh, z=z, D_skip=D_skip, gn=gn)
    ok = y.dim() == 4
    if ok:
        B, S, H, P = y.shape
        DI = H * P
        want = dict(y=(B, S, H, P), xh=(B, S, H, P), z=(B, S, DI),
                    D_skip=(H,), gn=(DI,))
        ok = all(tuple(t.shape) == want[n] for n, t in ts.items())
    if not ok:
        raise ValueError(f"expected y = xh (B,S,H,P), z (B,S,H*P), D_skip "
                         f"(H,), gn (H*P,); got {_shapes(ts)}")
    if min(B, S, H) == 0 or P % VEC or P == 0:
        raise ValueError(f"unsupported extent B={B}, S={S}, H={H}, P={P} "
                         f"(a multiple of {VEC})")
    _common(ts, dict(y=f32, xh=f32, z=one, D_skip=one, gn=one),
            ("y", "xh", "z", "gn"))


def _shapes(ts: dict) -> str:
    return ", ".join(f"{n} {tuple(t.shape)}" for n, t in ts.items())


def conv_act_plain(xin, Bm, Cm, dt, conv_x, conv_B, conv_C, dt_bias):
    """``ssm_conv_act`` by its plain version (``models.mamba2._conv_act``),
    in the wrapper's form: x, B and C widened to f32, x as (B, S, H, P)."""
    from repro_torch.models.mamba2 import _conv_act
    B, S, DI = xin.shape
    H = dt.shape[2]
    x, b, c, d, state = _conv_act(xin, Bm, Cm, dt, conv_x, conv_B, conv_C,
                                  dt_bias)
    return (x.float().reshape(B, S, H, DI // H), b.float(), c.float(), d,
            state)


def _conv_work(xin, Bm, Cm, dt, conv_x, *rest):
    B, S, DI = xin.shape
    return ssm_conv_act_work(B, S, DI, Bm.shape[2], dt.shape[2],
                             conv_x.shape[0], xin.dtype)


@charged("ssm_conv_act", _conv_work)
def ssm_conv_act(xin, Bm, Cm, dt, conv_x, conv_B, conv_C, dt_bias):
    """xin (B, S, DI), Bm and Cm (B, S, N), dt (B, S, H): the in
    projections; conv_x (W, DI), conv_B and conv_C (W, N), dt_bias (H,).
    Returns (xh (B, S, H, P) f32, Bm f32, Cm f32, dt' (B, S, H) f32, (conv
    states of x, B and C, (B, W-1, C) in xin's dtype)): silu of each causal
    conv rounded to xin's dtype, softplus(dt + dt_bias)."""
    global launches
    _no_dtensor(xin, Bm, Cm, dt, conv_x, conv_B, conv_C, dt_bias)
    if is_fake(xin) or xin.device.type == "cpu":
        B, S, DI = xin.shape
        H, W = dt.shape[2], conv_x.shape[0]
        if is_fake(xin):        # the dry run: no data, nothing launched
            f32 = dict(dtype=torch.float32)
            return (xin.new_empty((B, S, H, DI // H), **f32),
                    Bm.new_empty(Bm.shape, **f32),
                    Cm.new_empty(Cm.shape, **f32),
                    dt.new_empty(dt.shape, **f32),
                    tuple(t.new_empty((B, W - 1, t.shape[2]))
                          for t in (xin, Bm, Cm)))
        return conv_act_plain(xin, Bm, Cm, dt, conv_x, conv_B, conv_C,
                              dt_bias)
    _check_conv(xin, Bm, Cm, dt, conv_x, conv_B, conv_C, dt_bias)
    B, S, DI = xin.shape
    N, H, W = Bm.shape[2], dt.shape[2], conv_x.shape[0]
    dev = xin.device
    f32 = dict(dtype=torch.float32, device=dev)
    xo = torch.empty((B, S, H, DI // H), **f32)
    bo, co = torch.empty((B, S, N), **f32), torch.empty((B, S, N), **f32)
    dto = torch.empty((B, S, H), **f32)
    state = tuple(torch.empty((B, W - 1, C), dtype=xin.dtype, device=dev)
                  for C in (DI, N, N))
    lib = build().lib
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.repro_ssm_conv_act(
            *(t.data_ptr() for t in (xin, Bm, Cm, dt, conv_x, conv_B,
                                     conv_C, dt_bias, xo, bo, co, dto,
                                     *state)),
            _DTYPES[xin.dtype], B, S, DI, N, H, stream)
    if err != 0:
        raise RuntimeError(f"ssm_conv_act kernel launch failed: cudaError "
                           f"{err}")
    launches += 1
    return xo, bo, co, dto, state


def _norm_work(y, xh, z, *rest, **kw):
    B, S, H, P = y.shape
    return ssm_gate_norm_work(B, S, H * P, H, z.dtype)


@charged("ssm_gate_norm", _norm_work)
def ssm_gate_norm(y, xh, z, D_skip, gn, eps: float):
    """y (B, S, H, P) f32 (the scan's output), xh (B, S, H, P) (its x),
    z (B, S, H P), D_skip (H,), gn (H P,). Returns rms_norm(((y + D_skip
    xh) silu(z)) in z's dtype, gn, eps) (B, S, H P) in z's dtype, the
    arithmetic in f32."""
    global launches
    _no_dtensor(y, xh, z, D_skip, gn)
    if is_fake(z):              # the dry run: no data, nothing launched
        return torch.empty_like(z)
    if z.device.type == "cpu":
        from repro_torch.models.mamba2 import _gate_norm
        return _gate_norm(y, xh, z, D_skip, gn, eps)
    _check_norm(y, xh, z, D_skip, gn)
    B, S, H, P = y.shape
    lib = build().lib
    if H * P > lib.repro_ssm_glue_max_inner():
        raise ValueError(f"ssm_gate_norm holds a row of at most "
                         f"{lib.repro_ssm_glue_max_inner()} channels in "
                         f"registers, got H*P={H * P}")
    out = torch.empty_like(z)
    stream = torch.cuda.current_stream(z.device).cuda_stream
    with torch.cuda.device(z.device):
        err = lib.repro_ssm_gate_norm(
            *(t.data_ptr() for t in (y, xh, z, D_skip, gn, out)),
            float(eps), _DTYPES[z.dtype], B, S, H * P, P, stream)
    if err != 0:
        raise RuntimeError(f"ssm_gate_norm kernel launch failed: cudaError "
                           f"{err}")
    launches += 1
    return out
