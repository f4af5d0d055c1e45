"""Fleet scenario: latency-critical serving (the RT gang) sharing the card
with a best-effort training job, under RT-Gang admission throttling. The
serving decode step is the paper's 'DNN control task'; training is the
memory hog: each of its microsteps streams the parameters, gradients and
optimizer state through device memory (counterpart of
``examples/serve_with_background_training.py``).

    python -m repro_torch.examples.serve_with_background_training
        [--device cpu] [--duration 6] [--no-gang]

The JAX example's scenario as it is: the RT gang ``serve-decode`` (prio
10, a 20 ms period, a 5e5 B budget, lane 0, 200 jobs) refills the slot
engine (max_batch 2, max_seq 128; 8 requests of 16-token prompts, 12 new
tokens) and decodes one step a quantum; the BE job ``train-be`` runs one
AdamW microstep (4 x 64 tokens) a quantum on lane 1, declared at 1e6 B a
quantum (a declared cost: the cost estimate is not ported); 20 ms
regulation, 6 s. That declared quantum is twice the gang's budget a
window, so under RT-Gang the admission regulator turns the training job
away for as long as the gang's regime holds (from its first acquire to
the end of the run): JAX's example too runs only its warm-up (compile)
microstep there; Co-Sched trains. ``run(train_bytes=...)`` declares
another cost: one within the budget lets RT-Gang admit microsteps beside
the gang. By default reduced qwen2-7b serves and
reduced olmoe-1b-7b trains, in f32. Every quantum runs on its lane's CUDA
stream and ends when that stream has drained (``device.Lanes.quantum``);
on the card each quantum also records CUDA events on its stream, so that
a caller can see how the lanes' device work overlapped. ``build()`` and
``run()`` take any configs of the served and trained families, at full
width too.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core.executor import BEJob, GangExecutor, RTJob
from repro_torch.data.pipeline import DataConfig, TokenSource
from repro_torch.device import Lanes, resolve_device, synchronize
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.training.optimizer import OptConfig, Optimizer
from repro_torch.training.step import make_train_state, make_train_step

TRAIN_BYTES = 1e6        # the training job's declared bytes a quantum
F32 = ParallelConfig(param_dtype="float32", compute_dtype="float32",
                     q_block=8, kv_block=8)


def build(serve_cfg: ModelConfig, train_cfg: ModelConfig, *,
          device=None, serve_parallel: ParallelConfig = F32,
          train_parallel: ParallelConfig = F32, seed: int = 0) -> dict:
    """The served model's parameters (drawn from ``seed``, cast once for
    serving) and the trained model's state (float32 masters from
    ``seed + 1``, AdamW at lr 1e-3), on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    sapi = build_model(serve_cfg, serve_parallel, dev)
    tapi = build_model(train_cfg, train_parallel, dev)
    opt = Optimizer(OptConfig(lr=1e-3))
    models = {"device": dev, "serve_api": sapi,
              "serve_params": sapi.init(seed), "train_api": tapi,
              "opt": opt, "train_state": make_train_state(tapi, opt,
                                                          seed + 1)}
    synchronize(dev)
    return models


def run(models: dict, *, enabled: bool = True, duration: float = 6.0,
        train_bytes: float = TRAIN_BYTES,
        log: Callable[[str], None] = print) -> dict:
    """Serve 8 requests under the gang executor beside the training job
    for ``duration`` seconds (RT-Gang, or Co-Sched when ``enabled`` is
    False), the training job declared at ``train_bytes`` a quantum
    against the gang's 5e5 B budget. The training state in ``models`` goes on from where an
    earlier run left it. Returns the requests, the executor's stats, the
    decode quanta's run times (ms, the executor's trace), the host times
    of those that had requests to refill or decode (ms; the others return
    at once) and response times (release to finish, ms), the prefills,
    the microsteps' host times (ms) and losses (the warm-up microstep's
    apart), and on the card each quantum's CUDA-event interval on its
    lane's stream ({"name", "start_ms", "end_ms"} against one reference
    event)."""
    dev = models["device"]
    sapi, tapi = models["serve_api"], models["train_api"]
    engine = ServingEngine(sapi, models["serve_params"], max_batch=2,
                           max_seq=128)
    engine.warmup(prompt_len=16)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(
        1, sapi.cfg.vocab_size, size=(16,)).astype(np.int32), max_new=12)
        for i in range(8)]
    pending = list(reqs)

    tstep = make_train_step(tapi, models["opt"])
    src = TokenSource(DataConfig(seq_len=64, global_batch=4,
                                 vocab_size=tapi.cfg.vocab_size))
    state = models["train_state"]
    train = {"ms": [], "losses": [], "prefills": 1}   # 1: the warm-up's
    busy_ms = []        # host time of the decode quanta that had work
    timeline: Optional[list] = [] if dev.type == "cuda" else None
    ref = None

    def timed(name, body):
        """``body`` between two CUDA events on the current (lane) stream."""
        if timeline is None:
            return body()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = body()
        end.record()
        timeline.append((name, start, end))
        return out

    def train_quantum(lane):
        t0 = time.perf_counter()
        b = src.train_batch(int(state["step"]))
        batch = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        _, metrics = timed("train-be", lambda: tstep(state, batch))
        train["losses"].append(float(metrics["loss"]))
        train["ms"].append((time.perf_counter() - t0) * 1e3)

    def decode_quantum(lane, idx):
        def body():
            while pending and engine.add_request(pending[0]):
                pending.pop(0)
                train["prefills"] += 1
            engine.decode_step()
        t0 = time.perf_counter()
        work = bool(pending) or engine.active.any()
        timed("serve-decode", body)
        if work:
            busy_ms.append((time.perf_counter() - t0) * 1e3)

    lanes = Lanes(dev, 2)
    errors: List[BaseException] = []
    tq = lanes.quantum(train_quantum, errors)
    tq(1)                                   # warm-up microstep, untimed
    train["ms"].clear()
    warmup_loss = train["losses"].pop()
    if timeline is not None:
        synchronize(dev)
        ref = torch.cuda.Event(enable_timing=True)
        ref.record()
        timeline.clear()
    ex = GangExecutor(n_lanes=2, enabled=enabled, regulation_interval_s=0.02)
    ex.submit_rt(RTJob("serve-decode", lanes.quantum(decode_quantum, errors),
                       lanes=(0,), prio=10, period_s=0.02, budget_bytes=5e5,
                       n_jobs=200))
    ex.submit_be(BEJob("train-be", tq, lanes=(1,), bytes_per_quantum=train_bytes))
    stats = ex.run(duration)
    if errors:
        raise errors[0]
    intervals = []
    if timeline is not None:
        synchronize(dev)
        intervals = [{"name": n, "start_ms": ref.elapsed_time(a),
                      "end_ms": ref.elapsed_time(b)} for n, a, b in timeline]
    lat = np.array([s.t1 - s.t0 for s in ex.trace.segments
                    if s.label == "serve-decode"])              # ms
    done = sum(r.done for r in reqs)
    mode = "RT-Gang" if enabled else "Co-Sched"
    if len(lat):
        log(f"[{mode}] serve: decode p50={np.percentile(lat, 50):.2f}ms "
            f"p99={np.percentile(lat, 99):.2f}ms over {len(lat)} quanta; "
            f"requests done {done}/{len(reqs)}")
    log(f"[{mode}] train: {len(train['ms'])} best-effort microsteps "
        f"completed (throttled to the gang's budget) after the warm-up's")
    return {"requests": reqs, "stats": stats, "decode_ms": lat,
            "busy_ms": np.array(busy_ms),
            "response_ms": np.array(
                stats["response_times"]["serve-decode"]) * 1e3,
            "prefills": train["prefills"], "train_ms": np.array(train["ms"]),
            "warmup_loss": warmup_loss, "losses": train["losses"],
            "intervals": intervals, "engine": engine}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--duration", type=float, default=6.0)
    ap.add_argument("--no-gang", action="store_true")
    args = ap.parse_args(argv)
    models = build(reduced(get_config("qwen2-7b")),
                   reduced(get_config("olmoe-1b-7b")), device=args.device)
    return run(models, enabled=not args.no_gang, duration=args.duration)


if __name__ == "__main__":
    main()
