#!/usr/bin/env python3
"""Serve-path times of the port on one NVIDIA card: what
``chip_smoke.py``'s phase (d) reads, for one model at full width.

    PYTHONPATH=<checkout>/src python3 scripts/torch_serve_times.py \\
        [--tag T] [--arch qwen2-7b] [--steps 200]

Draws the model's bf16 weights from seed 0 and serves (d)'s six prompts
(32, 200, 1024, 77, 512 and 300 tokens, 16 new tokens each, 4 slots,
2048 cache rows) under the gang executor for 6 s (``launch.serve.run``):
the decode quanta's response times and the busy quanta (refill + decode)
come from that run. Then the engine alone, with no executor and the
cyclic garbage collector paused: ``--steps`` decode steps over 4 busy
slots and 6 prefills of 1024 tokens, each between two synchronizes on
the host clock (the first two steps and the first prefill left out of
the medians and the 10th percentile). The model is built on
``launch.mesh.make_local_mesh(1, 1)`` where the checkout has it, as
``launch.serve`` builds it, and without a mesh where it has none. The
port comes from whichever checkout's ``src`` is first on ``PYTHONPATH``,
so one copy of this script times two commits in one call. Prints one
JSON line with the card's name and power limit. Exits non-zero without
a card.
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ParallelConfig
from repro_torch.launch import serve
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Request, ServingEngine

PROMPTS = (32, 200, 1024, 77, 512, 300)
MAX_NEW = 16
MAX_SEQ = 2048
DURATION = 6.0


def host_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", default="", help="label of the JSON line")
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--steps", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_serve_times: needs an NVIDIA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    cfg = get_config(args.arch)
    parallel = ParallelConfig(param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    try:
        from repro_torch.launch.mesh import make_local_mesh
        mesh = {"mesh": make_local_mesh(1, 1, dev)}
    except ImportError:
        mesh = {}
    api = build_model(cfg, parallel, dev, **mesh)
    params = api.init(seed=0)
    res = serve.run(cfg, parallel, device=dev, n_requests=len(PROMPTS),
                    max_new=MAX_NEW, prompt_lens=PROMPTS, max_batch=4,
                    max_seq=MAX_SEQ, duration=DURATION, api=api,
                    params=params, log=lambda line: None)
    lat, busy = np.asarray(res["latency_ms"]), res["busy_quantum_ms"]
    engine = ServingEngine(api, params, max_batch=4, max_seq=MAX_SEQ)
    rng = np.random.default_rng(5)
    for i in range(4):
        engine.add_request(Request(rid=i, max_new=10**6, prompt=rng.integers(
            0, cfg.vocab_size, size=(32,)).astype(np.int32)))
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, 1024)),
                             device=dev)
    gc.collect()
    gc.disable()
    try:
        steps = [host_ms(engine.decode_step) for _ in range(args.steps)]
        pre = [host_ms(lambda: api.prefill_fn(params, {"tokens": tokens}))
               for _ in range(6)]
    finally:
        gc.enable()
    print(json.dumps({
        "tag": args.tag, "arch": args.arch, "layers": cfg.n_layers,
        "mesh": bool(mesh), "card": smi,
        "decode_quantum_p50_ms": float(np.percentile(lat, 50)),
        "decode_quantum_p99_ms": float(np.percentile(lat, 99)),
        "decode_quanta": int(len(lat)),
        "busy_quantum_p50_ms": float(np.percentile(busy, 50)),
        "busy_quantum_p99_ms": float(np.percentile(busy, 99)),
        "busy_quanta": int(len(busy)),
        "engine_decode_step_median_ms": float(np.median(steps[2:])),
        "engine_decode_step_p10_ms": float(np.percentile(steps[2:], 10)),
        "engine_decode_step_min_ms": float(np.min(steps[2:])),
        "engine_prefill_1024_median_ms": float(np.median(pre[1:])),
        "requests_done": sum(r.done for r in res["requests"])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
