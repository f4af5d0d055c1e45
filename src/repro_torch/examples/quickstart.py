"""Quickstart: train a small LM end to end with the port's substrate
(resumable data, AdamW, async checkpointing), then serve it for a few
tokens through the port's slot engine (counterpart of
``examples/quickstart.py``).

    python -m repro_torch.examples.quickstart [--device cpu]
        [--ckpt-dir DIR]

Without ``--device cpu`` it runs on the card and raises where there is
none.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ParallelConfig
from repro_torch.data.pipeline import DataConfig
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.training.optimizer import OptConfig, Optimizer
from repro_torch.training.runner import RunnerConfig, TrainRunner


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "quickstart_ckpt"))
    args = ap.parse_args(argv)

    cfg = reduced(get_config("qwen2-7b"))      # tiny same-family config
    parallel = ParallelConfig(param_dtype="float32", compute_dtype="float32",
                              q_block=64, kv_block=64)
    api = build_model(cfg, parallel, args.device)
    print(f"model: {cfg.name}  params={api.n_params():,}")

    opt = Optimizer(OptConfig(name="adamw", lr=3e-3, warmup=10,
                              decay_steps=100))
    data = DataConfig(seq_len=128, global_batch=8, vocab_size=cfg.vocab_size)
    runner = TrainRunner(api, opt, data,
                         RunnerConfig(total_steps=100, ckpt_every=25,
                                      ckpt_dir=args.ckpt_dir))
    state = runner.run()
    losses = [m["loss"] for m in runner.metrics_log]
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} over "
          f"{len(losses)} steps")
    if not losses[-1] < losses[0]:
        raise RuntimeError("loss should decrease")

    engine = ServingEngine(api, api.load(state["params"]), max_batch=2,
                           max_seq=256)
    engine.warmup(prompt_len=16)
    rng = np.random.default_rng(0)
    req = Request(rid=0, prompt=rng.integers(
        1, cfg.vocab_size, size=(16,)).astype(np.int32), max_new=8)
    engine.run_until_done([req])
    print("generated tokens:", req.out)
    return {"losses": losses, "request": req}


if __name__ == "__main__":
    main()
