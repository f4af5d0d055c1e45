"""Training launcher of the port: ``python -m repro_torch.launch.train
--arch <id> [...]`` (counterpart of ``repro.launch.train``, with
``--device``).

Trains the reduced (or, with --full-size, the full) config of ``--arch``
on one device through the runner: data resumable by step,
checkpoint/restart (``--fail-at-step`` injects a failure, then a second
runner resumes from the latest checkpoint, as the JAX launcher does). The
card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ParallelConfig
from repro_torch.data.pipeline import DataConfig
from repro_torch.models.model import build_model
from repro_torch.training.optimizer import OptConfig, Optimizer
from repro_torch.training.runner import (RunnerConfig, SimulatedFailure,
                                         TrainRunner)


def main(argv=None) -> TrainRunner:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--full-size", action="store_true",
                    help="use the full config (default: reduced smoke size)")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--fail-at-step", type=int, default=None)
    ap.add_argument("--data", default=None, help="memmapped token file")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full_size:
        cfg = reduced(cfg)
    parallel = ParallelConfig(param_dtype="float32", compute_dtype="float32",
                              q_block=64, kv_block=64)
    api = build_model(cfg, parallel, args.device)
    opt = Optimizer(OptConfig(name="adamw", lr=args.lr, warmup=10,
                              decay_steps=max(args.steps, 20)))
    data_cfg = DataConfig(
        seq_len=args.seq, global_batch=args.batch,
        vocab_size=cfg.vocab_size, path=args.data,
        n_vision_tokens=cfg.n_vision_tokens, d_model=cfg.d_model,
        n_frames=cfg.n_encoder_frames if cfg.family == "audio" else 0)
    rc = RunnerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                      ckpt_dir=args.ckpt_dir, fail_at_step=args.fail_at_step)
    runner = TrainRunner(api, opt, data_cfg, rc)
    try:
        runner.run()
    except SimulatedFailure as e:
        print(f"[ft] {e}; restarting from latest checkpoint...")
        runner2 = TrainRunner(api, opt, data_cfg,
                              RunnerConfig(total_steps=args.steps,
                                           ckpt_every=args.ckpt_every,
                                           ckpt_dir=args.ckpt_dir))
        runner2.run()
        runner.metrics_log.extend(runner2.metrics_log)
    first = runner.metrics_log[0]["loss"] if runner.metrics_log else None
    last = runner.metrics_log[-1]["loss"] if runner.metrics_log else None
    print(f"[train] {args.arch}: steps={len(runner.metrics_log)} "
          f"loss {first:.4f} -> {last:.4f}")
    return runner


if __name__ == "__main__":
    main()
