#!/usr/bin/env python3
"""Times of the port's two scan kernels at their serve shapes, on one
NVIDIA card.

    PYTHONPATH=<checkout>/src python3 scripts/torch_scan_times.py [--tag T]

Times ``ssd_scan`` at mamba2-1.3b's prefill shapes (B=1, H 64, P 64, N 128,
chunk 256) and ``rglru_scan`` at recurrentgemma-9b's (B=1, C 4096), S 32,
200, 300 and 1024, f32 and bf16, inputs drawn from seed 0 at the models'
scale as ``chip_smoke.py`` draws them. Each kernel is timed two ways: 20
wrapper calls back to back between CUDA events (``chip_smoke.py``'s
``ms``: a short kernel's time is then its wrapper's host dispatch), and
the same 20 calls captured in a CUDA graph and replayed (device time
only). The kernels come from whichever checkout's ``src`` is first on
``PYTHONPATH`` (each builds into its own ``build/``), so one copy of this
script times two commits' kernels in one call. Prints one line per shape
with the card's name and power limit. Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import math
import subprocess
import sys

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru_scan import ops as rg
from repro_torch.kernels.ssd_scan import ops as ssd

SEQS = (32, 200, 300, 1024)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


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


def ssd_inputs(S, dt, gen, dev, B=1, H=64, P=64, N=128):
    """As chip_smoke.ssd_inputs: silu of N(0, 0.5^2) for x, B, C; dt =
    softplus(N(0, 1)); A = -exp(U[0, log 16])."""
    def act(shape):
        return F.silu(0.5 * torch.randn(shape, generator=gen, device=dev))
    x = act((B, S, H, P)).to(dt)
    dtv = F.softplus(torch.randn((B, S, H), generator=gen,
                                 device=dev)).to(dt)
    Bm, Cm = act((B, S, N)).to(dt), act((B, S, N)).to(dt)
    A = -torch.exp(torch.rand((H,), generator=gen, device=dev)
                   * math.log(16.0))
    return x, dtv, Bm, Cm, A


def rglru_inputs(S, dt, gen, dev, B=1, C=4096):
    """As chip_smoke.rglru_inputs at the model's scale, no h0."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    log_a = -8.0 * float(F.softplus(torch.tensor(1.0))) * torch.sigmoid(
        randn(B, S, C))
    gx = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                min=1e-12)) * torch.sigmoid(
        randn(B, S, C)) * randn(B, S, C)
    return log_a.to(dt), gx.to(dt)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", default="", help="label printed on each line")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_scan_times: needs an NVIDIA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for name, dt in DTYPES.items():
        for S in SEQS:
            a = ssd_inputs(S, dt, gen, dev)
            call = lambda: ssd.ssd_scan(*a, chunk=256)  # noqa: E731
            print(f"[{args.tag}] ssd_scan S={S} {name}: calls back to back "
                  f"{eager_ms(call):.4f} ms, CUDA graph "
                  f"{graph_ms(call):.4f} ms [{smi}]", flush=True)
    for name, dt in DTYPES.items():
        for S in SEQS:
            la, gx = rglru_inputs(S, dt, gen, dev)
            call = lambda: rg.rglru_scan(la, gx)  # noqa: E731
            print(f"[{args.tag}] rglru_scan S={S} {name}: calls back to back "
                  f"{eager_ms(call):.4f} ms, CUDA graph "
                  f"{graph_ms(call):.4f} ms [{smi}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
