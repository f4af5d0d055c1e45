#!/usr/bin/env python3
"""Times of the port's flash-attention kernel on one NVIDIA card: the
prefill shapes ``chip_smoke.py`` (c) times, and the context-parallel
ranks of its phase (s).

    PYTHONPATH=<checkout>/src python3 scripts/torch_flash_times.py [--tag T]

Each call is timed two ways: 20 wrapper calls back to back between CUDA
events (``chip_smoke.py``'s ``ms``: a call that short is timed by its
wrapper's host dispatch), and the same 20 calls captured in a CUDA graph
and replayed (device time only); beside them, the largest absolute
difference from the plain version (``ref.naive_attention``), the kernel
path the call took (where the checkout counts launches by path), the
share of the bound (``roofline.work.flash_work`` over the H100's peaks:
bf16 at 989 TFLOP/s; f32 at the split-TF32 rate, three TF32 products at
495 TFLOP/s, and at the FMA rate, 67 TFLOP/s) that the graph time
reaches, and for each case of (c) and each rank of (s) SDPA
(``scaled_dot_product_attention`` with the same mask and ``enable_gqa``;
f32 with TF32 off) in a CUDA graph too and the kernel / SDPA ratio of the
two graph times. The shapes are (c)'s timed cases (``TIMED``), (c5)'s
softcap cases (``SOFTCAP_CASES``, each also without its cap, for the
cap's cost) and (s)'s splits (``CP_CASES``), all from
``scripts/torch_flash_cases.py``, which ``chip_smoke.py`` imports too:
for a split, rank r's S / n query rows against the full K/V at
``q_offset`` r S / n, and the unsplit call.
A checkout whose kernel takes no ``softcap`` skips (c5)'s cases, one
whose kernel takes no ``q_offset`` (s)'s too. ``--ptxas`` first prints
each kernel's registers and spills from the build's ptxas report and the
nvcc time. The kernel comes from whichever
checkout's ``src`` is first on ``PYTHONPATH`` (each builds into its own
``build/``), so one copy of this script times two commits' kernels in
one call. Prints one line a case with the card's name and power limit.
Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import inspect
import subprocess
import sys

import torch
import torch.nn.functional as F
from torch_flash_cases import CP_CASES, SOFTCAP_CASES, TIMED

from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention.ref import naive_attention
from repro_torch.roofline import report as RR
from repro_torch.roofline.work import flash_work

DT_NAME = {torch.float32: "f32", torch.bfloat16: "bf16"}


def label(case) -> str:
    B, Sq, Sk, Hq, Hkv, D, causal, window, dt = case
    mask = ("causal" if causal else "full") + \
        (f" window {window}" if window else "")
    return f"B={B} Sq={Sq} Sk={Sk} Hq={Hq} Hkv={Hkv} D={D} {mask}"


def eager_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of one call over ``iters`` calls back to back."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Mean device time of one call: ``iters`` calls in a CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def sdpa_call(q, k, v, causal: bool, window: int, q_offset: int = 0):
    """SDPA on the same inputs and mask, heads first (views: no copy in
    the timed call); with a q_offset over the first q_offset + Sq keys,
    the bottom-right causal mask."""
    if q_offset:
        k, v = k[:, :q_offset + q.shape[1]], v[:, :q_offset + q.shape[1]]
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    if window or q_offset:
        i = q_offset + torch.arange(q.shape[1], device=q.device)
        j = torch.arange(k.shape[1], device=q.device)
        mask = (j[None] > i[:, None] - window if window else True) & \
            ((j[None] <= i[:, None]) if causal else True)
        return lambda: F.scaled_dot_product_attention(  # noqa: E731
            qh, kh, vh, attn_mask=mask, enable_gqa=True)
    return lambda: F.scaled_dot_product_attention(  # noqa: E731
        qh, kh, vh, is_causal=causal, enable_gqa=True)


# f32 products at f32's accuracy on the tensor cores: three TF32 products
# (split TF32) at the card's dense TF32 rate
SPLIT_TF32_OPS_PER_S = 495e12 / 3


def bound_ms(case, q_offset: int = 0, fma: bool = False) -> float:
    """The least time for the case: operations over the peak rate of its
    type against bytes over the memory rate. f32 at the split-TF32 rate,
    or with ``fma`` at the FMA rate (the bound of the FMA kernel)."""
    ops, nbytes = flash_work(case, q_offset)
    rate = RR.PEAK_FLOPS[str(case[-1]).removeprefix("torch.")]
    if case[-1] == torch.float32 and not fma:
        rate = SPLIT_TF32_OPS_PER_S
    return max(ops / rate, nbytes / RR.HBM_BW) * 1e3


def bound_text(case, g_ms: float, q_offset: int = 0) -> str:
    """The bound (f32: both) and the share of it a graph time reaches."""
    b_ms = bound_ms(case, q_offset)
    text = f"bound {b_ms:.4f} ms, {100 * b_ms / g_ms:.1f}% of it"
    if case[-1] == torch.float32:
        f_ms = bound_ms(case, q_offset, fma=True)
        text = (f"split-TF32 {text}; FMA-rate bound {f_ms:.4f} ms, "
                f"{100 * f_ms / g_ms:.1f}% of it")
    return text


def traced_path(call) -> str:
    """The kernel path one call took, where the checkout counts them."""
    by_path = getattr(fa, "launches_by_path", None)
    if by_path is None:
        return "-"
    before = dict(by_path)
    call()
    torch.cuda.synchronize()
    return ",".join(p for p, n in by_path.items() if n != before[p])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", default="", help="label printed on each line")
    ap.add_argument("--ptxas", action="store_true",
                    help="print the build's registers and spills first")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_flash_times: needs an NVIDIA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False   # SDPA's f32 in f32
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    if args.ptxas:   # a checkout whose build module parses the report
        from repro_torch.kernels.build import ptxas_report
        built = fa.build()
        print(f"[{args.tag}] nvcc {built.seconds:.1f} s", flush=True)
        for k in ptxas_report(built.log):
            print(f"[{args.tag}] {k['kernel']}: {k['registers']} registers, "
                  f"spills {k['spill_stores']} / {k['spill_loads']} B",
                  flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def qkv(B, Sq, Sk, Hq, Hkv, D, dt):
        return (torch.randn((B, Sq, Hq, D), generator=gen, device=dev).to(dt),
                torch.randn((B, Sk, Hkv, D), generator=gen, device=dev).to(dt),
                torch.randn((B, Sk, Hkv, D), generator=gen, device=dev).to(dt))

    for case in TIMED:
        B, Sq, Sk, Hq, Hkv, D, causal, window, dt = case
        q, k, v = qkv(B, Sq, Sk, Hq, Hkv, D, dt)
        call = lambda: fa.flash_attention(  # noqa: E731
            q, k, v, causal=causal, window=window)
        err = (call().float() - naive_attention(
            q, k, v, causal=causal, window=window).float()).abs().max()
        g_ms = graph_ms(call)
        lib_ms = graph_ms(sdpa_call(q, k, v, causal, window))
        lib = (f", SDPA graph {lib_ms:.4f} ms, kernel / SDPA "
               f"{g_ms / lib_ms:.3f}, {bound_text(case, g_ms)}")
        print(f"[{args.tag}] {label(case)} {DT_NAME[dt]}: path "
              f"{traced_path(call)}, max_abs_err {float(err):.6g}, calls "
              f"back to back {eager_ms(call):.4f} ms, CUDA graph "
              f"{g_ms:.4f} ms{lib} [{smi}]", flush=True)
    params = inspect.signature(fa.flash_attention).parameters
    for case, off, cap in SOFTCAP_CASES if "softcap" in params else ():
        B, Sq, Sk, Hq, Hkv, D, causal, window, dt = case
        q, k, v = qkv(B, Sq, Sk, Hq, Hkv, D, dt)
        for c in (cap, 0.0):
            call = lambda: fa.flash_attention(  # noqa: E731
                q, k, v, causal=causal, window=window, q_offset=off,
                softcap=c)
            err = (call().float() - naive_attention(
                q, k, v, causal=causal, window=window, q_offset=off,
                softcap=c).float()).abs().max()
            g_ms = graph_ms(call)
            print(f"[{args.tag}] softcap {c} {label(case)} q_offset {off} "
                  f"{DT_NAME[dt]}: max_abs_err {float(err):.6g}, calls back "
                  f"to back {eager_ms(call):.4f} ms, CUDA graph "
                  f"{g_ms:.4f} ms, {bound_text(case, g_ms, off)} [{smi}]",
                  flush=True)
    if "q_offset" not in params:
        return 0
    for dt, name in DT_NAME.items():
        for arch, Hq, Hkv, D, S, n, window in CP_CASES:
            q, k, v = qkv(1, S, S, Hq, Hkv, D, dt)
            s = S // n
            for r in [None] + list(range(n)):
                part = q if r is None else q[:, r * s:(r + 1) * s].contiguous()
                off = 0 if r is None else r * s
                call = lambda: fa.flash_attention(  # noqa: E731
                    part, k, v, causal=True, window=window, q_offset=off)
                what = "unsplit" if r is None else f"rank {r} of {n}"
                g_ms = graph_ms(call)
                lib_ms = graph_ms(sdpa_call(part, k, v, True, window, off))
                case = (1, part.shape[1], S, Hq, Hkv, D, True, window, dt)
                print(f"[{args.tag}] cp {arch} S={S} {what} {name}: calls "
                      f"back to back {eager_ms(call):.4f} ms, CUDA graph "
                      f"{g_ms:.4f} ms, SDPA graph {lib_ms:.4f} ms, kernel / "
                      f"SDPA {g_ms / lib_ms:.3f}, "
                      f"{bound_text(case, g_ms, off)} [{smi}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
