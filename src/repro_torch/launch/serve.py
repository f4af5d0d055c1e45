"""Serving launcher: gang-scheduled serving of a latency-critical model with
best-effort background work — the paper's deployment story end to end, on
the GPU (PyTorch port of ``repro.launch.serve``).

``python -m repro_torch.launch.serve --arch qwen2-7b --requests 6``
serves the reduced config of ``--arch`` (``olmoe-1b-7b`` for the MoE
model); add ``--device cpu`` to run without a card. ``run()`` serves any
config of a family the engine serves, at full size too.

The decode step of the served model is the RT gang (priority 10); a
background batch job (synthetic compute) is best-effort, throttled by the
gang's byte budget. Compare p99 decode latency with --no-gang. Every
quantum runs on its lane's CUDA stream and ends when that stream has
drained (``repro_torch.device.Lanes``).
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core.executor import BEJob, GangExecutor, RTJob
from repro_torch.device import Lanes, resolve_device
from repro_torch.models.model import ModelApi, build_model
from repro_torch.serving.engine import Request, ServingEngine


def run(cfg: ModelConfig, parallel: ParallelConfig, *,
        device: Optional[str | torch.device] = None,
        n_requests: int = 6, max_new: int = 16,
        prompt_lens: Sequence[int] = (32,), max_batch: int = 4,
        max_seq: int = 256, duration: float = 6.0, no_gang: bool = False,
        seed: int = 0, api: Optional[ModelApi] = None, params=None,
        log: Callable[[str], None] = print) -> dict:
    """Serve ``n_requests`` random prompts (request i has length
    ``prompt_lens[i % len(prompt_lens)]``) under the gang executor for
    ``duration`` seconds. Parameters are drawn from ``seed`` on the
    device unless ``params`` (for ``api``) are given. Returns the
    requests, the engine, the executor stats, the decode-quantum response
    times (release to finish) and the wall time of the quanta that had
    requests to refill or decode, in ms."""
    dev = resolve_device(device)
    if api is None:
        api = build_model(cfg, parallel, dev)
    if params is None:
        params = api.init(seed)
    engine = ServingEngine(api, params, max_batch=max_batch, max_seq=max_seq)
    engine.warmup(prompt_len=prompt_lens[0])

    rng = np.random.default_rng(seed)
    reqs = [Request(rid=i,
                    prompt=rng.integers(
                        0, cfg.vocab_size,
                        size=(prompt_lens[i % len(prompt_lens)],))
                    .astype(np.int32),
                    max_new=max_new)
            for i in range(n_requests)]
    pending = list(reqs)
    busy_ms = []        # wall time of the quanta that had work to do

    def decode_quantum(lane, idx):
        t0 = time.perf_counter()
        work = bool(pending) or engine.active.any()
        while pending and engine.add_request(pending[0]):
            pending.pop(0)
        engine.decode_step()
        if work:
            busy_ms.append((time.perf_counter() - t0) * 1e3)

    stats = run_gang(decode_quantum, dev, duration, no_gang=no_gang)
    lat = np.array(stats["response_times"].get("decode", [0.0])) * 1e3
    done = sum(r.done for r in reqs)
    log(f"[serve] gang={'off' if no_gang else 'on'} "
        f"requests done {done}/{len(reqs)} decode_steps={engine.decode_steps}")
    if len(lat):
        log(f"[serve] decode quantum latency ms: "
            f"p50={np.percentile(lat, 50):.2f} "
            f"p99={np.percentile(lat, 99):.2f} max={lat.max():.2f}")
    log(f"[serve] best-effort quanta: {stats['be_quanta']}")
    return {"requests": reqs, "engine": engine, "stats": stats,
            "latency_ms": lat, "busy_quantum_ms": np.array(busy_ms),
            "api": api, "params": params}


def run_gang(rt_quantum: Callable, device: torch.device, duration: float,
             no_gang: bool = False) -> dict:
    """Run ``rt_quantum(lane, idx)`` as the RT gang (job "decode": priority
    10, a 10 ms period, lane 0, a 2 MB byte budget) beside the best-effort
    background job (memory-heavy 512² f32 matmul batches, 1 MB a quantum)
    on lanes 0 and 1, for ``duration`` seconds. Every quantum runs on its
    lane's stream and ends when that stream has drained. Returns the
    executor's stats; an exception in a quantum, which would end only the
    lane's worker thread, is kept and raised after the run."""
    bg_arr = torch.ones((512, 512), dtype=torch.float32, device=device)

    def bg(lane):
        return float((bg_arr @ bg_arr.T).sum())

    ex = GangExecutor(n_lanes=2, enabled=not no_gang,
                      regulation_interval_s=0.02)
    lanes = Lanes(device, ex.n_lanes)
    errors = []
    ex.submit_rt(RTJob(name="decode", fn=lanes.quantum(rt_quantum, errors),
                       lanes=(0,), prio=10, period_s=0.01, budget_bytes=2e6,
                       n_jobs=int(duration / 0.01)))
    ex.submit_be(BEJob(name="bg-batch", fn=lanes.quantum(bg, errors),
                       lanes=(0, 1), bytes_per_quantum=1e6))
    stats = ex.run(duration)
    if errors:
        raise errors[0]
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--no-gang", action="store_true")
    ap.add_argument("--duration", type=float, default=6.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = reduced(get_config(args.arch))
    parallel = ParallelConfig(param_dtype="float32", compute_dtype="float32",
                              q_block=64, kv_block=64)
    return run(cfg, parallel, device=args.device, n_requests=args.requests,
               max_new=args.max_new, duration=args.duration,
               no_gang=args.no_gang)


if __name__ == "__main__":
    main()
