#!/usr/bin/env python3
"""Times of Mamba2's prefill glue kernels and of the prefill around them,
on one NVIDIA card.

    PYTHONPATH=src python3 scripts/torch_ssm_glue_times.py [--seqs 1024 2048 4096]
        [--batch 8] [--tag T] [--out PATH]

At mamba2-1.3b's widths (d_inner 4096, N 128, 64 heads, conv width 4),
bf16, batch ``--batch``, for each S of ``--seqs``:

* each kernel of ``kernels/ssm_glue`` (``ssm_conv_act``, ``ssm_gate_norm``)
  and its plain version (the torch ops of ``models.mamba2._conv_act`` /
  ``_gate_norm``): 10 calls captured in a CUDA graph and replayed (device
  time only), beside the kernel's bytes bound at 3.35 TB/s
  (``roofline.work``: each input read once, each output written once)
  and its share of it;
* the whole mamba2-1.3b prefill (``ModelApi.prefill_fn``, 48 layers,
  weights drawn from seed 0) with the kernels and with the plain path
  (the model's two glue calls swapped for their plain versions): device
  time (one prefill in a CUDA graph, replayed) and wall time (host clock
  around an eager prefill and a synchronize, median of 5), and the glue
  launches a prefill.

Prints one line a row with the card's name and power limit, and one JSON
line at the end (also written to ``--out``). Inputs are drawn at the
model's scale from seed 0. Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ParallelConfig
from repro_torch.kernels.ssm_glue import ops
from repro_torch.models import mamba2
from repro_torch.models.model import build_model
from repro_torch.roofline.work import ssm_conv_act_work, ssm_gate_norm_work

ARCH = "mamba2-1.3b"
HBM = 3.35e12


def graph_ms(fn, iters: int = 10, replays: int = 5) -> float:
    """Mean device time of one call: ``iters`` calls in a CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
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
    del graph
    torch.cuda.empty_cache()
    return start.elapsed_time(end) / (iters * replays)


def wall_ms(fn, reps: int = 5) -> float:
    """Median host time of ``fn()`` and a synchronize, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def glue_rows(cfg, B: int, S: int, dev) -> list:
    s = cfg.ssm
    DI, N, H, P, W = (s.d_inner(cfg.d_model), s.state_dim,
                      s.n_heads(cfg.d_model), s.head_dim, s.conv_width)
    g = torch.Generator(device=dev).manual_seed(0)

    def r(*shape, scale=1.0, shift=0.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=dev) * scale
                + shift).to(dtype)
    conv = (r(B, S, DI), r(B, S, N), r(B, S, N), r(B, S, H, scale=0.1),
            r(W, DI, scale=0.5), r(W, N, scale=0.5), r(W, N, scale=0.5),
            r(H, shift=-4.0))
    norm = (r(B, S, H, P, dtype=torch.float32),
            r(B, S, H, P, dtype=torch.float32), r(B, S, DI),
            r(H, scale=0.1, shift=1.0), r(DI, scale=0.1, shift=1.0))
    rows = []
    for name, fn, plain, args, nbytes in (
            ("ssm_conv_act", ops.ssm_conv_act, ops.conv_act_plain, conv,
             ssm_conv_act_work(B, S, DI, N, H, W, torch.bfloat16)[1]),
            ("ssm_gate_norm", lambda *a: ops.ssm_gate_norm(*a, 1e-5),
             lambda *a: mamba2._gate_norm(*a, 1e-5), norm,
             ssm_gate_norm_work(B, S, DI, H, torch.bfloat16)[1])):
        kernel = graph_ms(lambda: fn(*args))
        plain_ms = graph_ms(lambda: plain(*args))
        bound = 1e3 * nbytes / HBM
        rows.append({"kernel": name, "B": B, "S": S, "graph_ms": kernel,
                     "plain_graph_ms": plain_ms, "bytes": nbytes,
                     "bound_ms": bound, "share_pct": 100 * bound / kernel})
    return rows


def prefill_rows(api, params, B: int, S: int, dev) -> list:
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        1, api.cfg.vocab_size, size=(B, S)), device=dev)

    def prefill():
        return api.prefill_fn(params, {"tokens": tokens})
    rows = []
    saved = mamba2.ssm_conv_act, mamba2.ssm_gate_norm
    for path in ("kernels", "plain"):
        if path == "plain":
            mamba2.ssm_conv_act = ops.conv_act_plain
            mamba2.ssm_gate_norm = mamba2._gate_norm
        try:
            ops.reset_launches()
            prefill()
            torch.cuda.synchronize()
            launches = ops.launches
            wall = wall_ms(prefill)
            try:
                device = graph_ms(prefill, iters=1, replays=3)
            except RuntimeError as e:     # a prefill that cannot be captured
                device = None
                print(f"[prefill] {path} S={S}: no CUDA graph: {e}",
                      file=sys.stderr)
        finally:
            mamba2.ssm_conv_act, mamba2.ssm_gate_norm = saved
        rows.append({"prefill": path, "B": B, "S": S, "device_ms": device,
                     "wall_ms": wall,
                     "wall_ms_per_ktok": wall / (B * S / 1e3),
                     "glue_launches": launches})
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seqs", type=int, nargs="+", default=[1024, 2048, 4096])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: these times are the card's", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    card = smi[0] if smi else torch.cuda.get_device_name(0)
    cfg = get_config(ARCH)
    built = ops.build()
    print(f"[build] ssm_glue {built.seconds:.1f} s")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line or "entry" in line:
            print(f"[ptxas] {line.strip()}")
    rows = []
    for S in args.seqs:
        for row in glue_rows(cfg, args.batch, S, dev):
            rows.append(row)
            print(f"[glue] {args.tag} {row['kernel']} B={row['B']} "
                  f"S={S}: graph {row['graph_ms']:.4f} ms (plain "
                  f"{row['plain_graph_ms']:.4f}), bound "
                  f"{row['bound_ms']:.4f} ms ({row['bytes']} B at 3.35 "
                  f"TB/s): {row['share_pct']:.1f}%; {card}")
    api = build_model(cfg, ParallelConfig(param_dtype="bfloat16",
                                          compute_dtype="bfloat16"), dev)
    params = api.init(seed=0)
    for S in args.seqs:
        for row in prefill_rows(api, params, args.batch, S, dev):
            rows.append(row)
            dev_ms = ("n/a" if row["device_ms"] is None
                      else f"{row['device_ms']:.2f}")
            print(f"[prefill] {args.tag} {row['prefill']} B={row['B']} "
                  f"S={S}: device {dev_ms} ms, wall {row['wall_ms']:.2f} ms "
                  f"({row['wall_ms_per_ktok']:.2f} ms/ktok), glue launches "
                  f"{row['glue_launches']}; {card}")
    out = {"tag": args.tag, "card": card, "rows": rows}
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
