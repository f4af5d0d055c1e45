"""The work of one call of each hand-written kernel, from its shapes: the
operations its algorithm needs and the bytes it must move, each input
read once and each output written once. Where the work depends on the
data (moe_gmm's rows in use), the count is that of the call's data.

One count serves two readers: the card check's bounds (``chip_smoke.py``)
and the cost analysis (``op_analysis``). A kernel launched through
``ctypes`` is invisible to PyTorch's dispatcher, so each kernel wrapper
reports its calls to the analysis running in its thread through
``charged``; with none running, that costs one attribute read a call.
"""
from __future__ import annotations

import functools
import threading
from typing import Callable, Optional, Tuple

import numpy as np
from torch._subclasses.fake_tensor import is_fake

_local = threading.local()


def unmasked_pairs(Sq: int, Sk: int, causal: bool, window: int,
                   q_offset: int = 0) -> int:
    """(q, k) pairs of an Sq x Sk attention that the mask keeps: k <= q
    when ``causal``, k > q - window when ``window`` > 0, with key
    positions from 0 and query row i at position ``q_offset + i``."""
    i = q_offset + np.arange(Sq)
    hi = np.minimum(i, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros(Sq, int)
    return int(np.maximum(hi - lo + 1, 0).sum())


def visible_keys(Sq: int, Sk: int, causal: bool, window: int,
                 q_offset: int = 0) -> int:
    """Keys that at least one query row of the call may see: the mask keeps
    a contiguous run of keys, from the first row's window start to the
    last row's causal end."""
    lo = max(q_offset - window + 1, 0) if window > 0 else 0
    hi = min(q_offset + Sq, Sk) if causal else Sk
    return max(hi - lo, 0)


def flash_work(case, q_offset: int = 0) -> Tuple[int, int]:
    """Operations (4 x Hq x D per unmasked (q, k) pair of the Sq x Sk) and
    bytes (q read and o written once, and of k and v only the keys some
    row may see); ``case`` is (B, Sq, Sk, Hq, Hkv, D, causal, window,
    dtype). A logit softcap adds nothing: its tanh, like the softmax's
    exp, runs on the special-function units beside the tensor-core
    products the count holds, so a capped call is charged as an uncapped
    one."""
    B, Sq, Sk, Hq, Hkv, D, causal, window, dt = case
    ops = 4 * B * Hq * D * unmasked_pairs(Sq, Sk, causal, window, q_offset)
    keys = visible_keys(Sq, Sk, causal, window, q_offset)
    return ops, dt.itemsize * (2 * B * Sq * Hq * D + 2 * B * keys * Hkv * D)


def gmm_work(E, C, D, F, counts, dt) -> Tuple[int, int]:
    """Operations, 2 x (rows in use) x D x F, and the bytes a call must
    move: the rows in use of x, the weights of the experts in use, the
    whole output, the counts. Counts without data (a fake tensor of the
    dry run) count every row of every expert."""
    if is_fake(counts):
        rows, used = E * C, E
    else:
        rows = int(counts.sum())
        used = int((counts > 0).sum())
    return (2 * rows * D * F,
            dt.itemsize * (rows * D + used * D * F + E * C * F) + 4 * E)


def ssd_work(B, S, H, P, N, chunk, dt) -> Tuple[int, int]:
    """Operations: per chunk of q tokens inside the sequence, only the
    q (q + 1) / 2 pairs j <= i of the causal triangle, C B^T once per
    (b, chunk) (B and C are shared across heads, 2 pairs N) and per head
    the intra-chunk product (2 pairs P), the inter-chunk term and the state
    update (2 q N P each). Bytes: x, dt, B, C and A read once, y and the
    final state written once."""
    Q = min(chunk, S)
    ops = 0
    for c0 in range(0, S, Q):
        q = min(Q, S - c0)
        pairs = unmasked_pairs(q, q, True, 0)
        ops += 2 * B * (pairs * N + H * (pairs * P + 2 * q * N * P))
    nbytes = dt.itemsize * (2 * B * S * H * P + B * S * H + 2 * B * S * N) \
        + 4 * H + 4 * B * H * P * N
    return ops, nbytes


def rglru_work(B, S, C, with_h0, dt) -> Tuple[int, int]:
    """Operations, an exp and an FMA (3) per element, and bytes: log_a and
    gx read once, h written once in the input type, h0 read and the last h
    written in f32."""
    return (3 * B * S * C,
            dt.itemsize * 3 * B * S * C + 4 * B * C * (2 if with_h0 else 1))


def ssm_conv_act_work(B, S, DI, N, H, W, dt) -> Tuple[int, int]:
    """Mamba2's glue before the scan (``ssm_conv_act``). Operations: none
    counted, as the analysis counts none for the plain version's
    elementwise ops (``op_analysis._flops``). Bytes: x, B, C and dt read
    once in ``dt`` and written once in f32, the conv weights and dt_bias
    read, the conv state (the last W - 1 rows of x, B and C) written."""
    C = DI + 2 * N
    return 0, (B * S * (C + H) * (dt.itemsize + 4)
               + dt.itemsize * (W * C + H + B * (W - 1) * C))


def ssm_gate_norm_work(B, S, DI, H, dt) -> Tuple[int, int]:
    """Mamba2's glue after the scan (``ssm_gate_norm``). Operations: none
    counted (as ``ssm_conv_act_work``). Bytes: y and x read once in f32, z
    read and the output written once in ``dt``, D and the norm's weight
    read."""
    return 0, B * S * DI * (8 + 2 * dt.itemsize) + dt.itemsize * (H + DI)


def current():
    """The analysis running in this thread, or None."""
    return getattr(_local, "analysis", None)


def set_current(analysis) -> Optional[object]:
    """Make ``analysis`` (or None) this thread's; returns the previous."""
    prev = current()
    _local.analysis = analysis
    return prev


def charged(name: str, work: Callable[..., Tuple[int, int]]):
    """Decorator of a kernel wrapper. With an analysis running in this
    thread, a call charges it ``work(*args, **kw)`` = (operations, bytes)
    under ``name``, and the ops the call dispatches are the kernel's own;
    with none, the call runs as it is and ``work`` is never called."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            analysis = current()
            if analysis is None:
                return fn(*args, **kw)
            with analysis.kernel(name, lambda: work(*args, **kw)):
                return fn(*args, **kw)
        return call
    return wrap
