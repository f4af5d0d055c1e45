"""Calibrate a cell's period and rate on the card, in one process.

    python3 gangbench/tools/sweep.py --workload <cell> --seed <n> \
        [--rates 1.0 2.0 ...] [--seconds 20] [--out FILE]

1. The decode step alone (no executor, no best-effort job), with every
   slot or sequence busy: the median of 30 steps. The cell's period is the
   smallest multiple of 10 ms at or above twice it.
2. Prefill alone at the mix's shortest, middle and longest prompt.
3. For an open-loop mix, a window at each rate of ``--rates`` at the
   cell's period beside the hog: time to first token (p50, p90), the RT
   response p95, tokens/s, and whether the queue grew (requests due in
   the first half of the window admitted later than those of the second
   half would be by then).

Prints one JSON line per measurement and writes them to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if not __package__:     # run as a script from the checkout's root
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from gangbench.harness import catalog  # noqa: E402
from gangbench.harness.gang import Hog, run_window  # noqa: E402
from gangbench.harness.spans import Spans  # noqa: E402
from gangbench.harness.stats import percentile  # noqa: E402


def emit(rows, row):
    rows.append(row)
    print(json.dumps(row), flush=True)


def timed(fn, n):
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--rates", type=float, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--period-ms", type=float, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    bench = catalog.load_benchmark()
    cell = catalog.workload(bench, args.workload)
    config = catalog.read_data(ROOT / catalog.config_of(
        bench, cell["config"])["file"])
    mix = catalog.load_data("traffic", cell["traffic"])
    m = config["model"]
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    ref = catalog.load_module("reference", config["reference"])
    spans = Spans()
    mod = catalog.load_module("drivers", mix["driver"])
    rows = []
    t0 = time.perf_counter()
    drv = mod.Driver(model=m, mix=mix, seed=args.seed, seconds=args.seconds,
                     device=dev, spans=spans, spec=ref.param_spec(m))
    drv.setup()
    emit(rows, {"what": "setup", "seconds": time.perf_counter() - t0,
                "kind": kind})
    lo, hi = int(mix["prompt"]["lo"]), int(mix["prompt"]["hi"])
    lengths = (lo, int(round((lo * hi) ** 0.5)), hi)
    if mix["driver"] == "serve":
        from repro_torch.serving.engine import Request, ServingEngine
        eng = ServingEngine(drv.api, drv.params, max_batch=int(mix["slots"]),
                            max_seq=int(mix["max_seq"]))
        rng = np.random.default_rng(args.seed)
        for n in lengths:
            eng2 = ServingEngine(drv.api, drv.params, max_batch=1,
                                 max_seq=int(mix["max_seq"]))
            ts = timed(lambda: (eng2.add_request(Request(
                rid=0, prompt=rng.integers(0, m["vocab_size"], n)
                .astype(np.int32), max_new=2)), eng2._reset()), 5)
            emit(rows, {"what": "prefill_alone", "length": n,
                        "ms": [1e3 * t for t in ts]})
            del eng2
        for i in range(int(mix["slots"])):
            eng.add_request(Request(rid=i, prompt=rng.integers(
                0, m["vocab_size"], (lo + hi) // 2).astype(np.int32),
                max_new=10**6))
        ts = timed(eng.decode_step, 30)
        del eng
    else:
        B = int(mix["batch"])
        api, params = drv.api, drv.params
        for n in lengths:
            tok = torch.randint(0, m["vocab_size"], (B, n), device=dev)
            ts = timed(lambda: api.prefill_fn(params, {"tokens": tok})[0]
                       .argmax(-1).cpu(), 3)
            emit(rows, {"what": "prefill_alone", "length": n, "batch": B,
                        "ms": [1e3 * t for t in ts]})
        tok = torch.randint(0, m["vocab_size"], (B, (lo + hi) // 2),
                            device=dev)
        logits, caches = api.prefill_fn(params, {"tokens": tok})
        nxt = logits[:, -1].argmax(-1)[:, None]
        pos = torch.full((B,), tok.shape[1], device=dev)
        ts = timed(lambda: api.decode_fn(params, caches, nxt, pos)[0]
                   .argmax(-1).cpu(), 30)
        del logits, caches
    med = float(np.median(ts)) * 1e3
    period = 10 * int(np.ceil(2 * med / 10))
    emit(rows, {"what": "decode_alone", "median_ms": med,
                "ms": [1e3 * t for t in ts], "period_ms": period})
    period_ms = args.period_ms or period
    hog = Hog(dev, int(mix["hog_buffer_bytes"]))
    for rate in args.rates:
        mix_r = dict(mix, rate_per_s=rate, period_ms=period_ms)
        drv.release()
        drv = mod.Driver(model=m, mix=mix_r, seed=args.seed,
                         seconds=args.seconds, device=dev, spans=spans,
                         spec=ref.param_spec(m))
        drv.setup()
        run_s = args.seconds + float(mix["drain_s"])
        out = run_window(device=dev, rt_fn=drv.quantum, hog=hog, spans=spans,
                         seconds=args.seconds, drain_s=float(mix["drain_s"]),
                         period_s=period_ms / 1e3,
                         interval_s=mix["regulation_ms"] / 1e3)
        reqs = [r for r in drv.requests() if r["due"] < args.seconds]
        ttft = [(r["first"] if r["first"] is not None else run_s) - r["due"]
                for r in reqs]
        half = len(ttft) // 2
        resp = out["stats"]["response_times"]["rt"]
        n_rel = int(np.ceil(args.seconds / (period_ms / 1e3)))
        toks = sum(s.meta["tokens"] for name in drv.token_spans
                   for s in spans.of(name) if s.t1 <= args.seconds)
        emit(rows, {"what": "rate", "rate_per_s": rate,
                    "period_ms": period_ms, "requests": len(reqs),
                    "ttft_p50_ms": 1e3 * percentile(ttft, 50),
                    "ttft_p90_ms": 1e3 * percentile(ttft, 90),
                    "ttft_first_half_mean_ms": 1e3 * float(np.mean(
                        ttft[:half])),
                    "ttft_second_half_mean_ms": 1e3 * float(np.mean(
                        ttft[half:])),
                    "never_admitted": sum(r["first"] is None for r in reqs),
                    "rt_p95_ms": 1e3 * percentile(resp[:n_rel], 95),
                    "rt_released": n_rel, "rt_finished": len(resp),
                    "tokens_per_s": toks / args.seconds,
                    "be_quanta": out["stats"]["be_quanta"]})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n"
                                          for r in rows))


if __name__ == "__main__":
    main()
