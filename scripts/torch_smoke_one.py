#!/usr/bin/env python3
"""Quick smoke of the PyTorch port: one train step, a prefill and a decode
step of a family's reduced config.

    python3 scripts/torch_smoke_one.py [ARCH ...] [--device cpu]

The counterpart of ``scripts/smoke_one.py``. For each arch named
(qwen2-7b when none) it builds the reduced config in f32 (remat "block",
attention blocks of 8), takes one AdamW step of the port's train step on
B=2, S=32 all-ones tokens and labels, then runs ``prefill_fn`` on the
updated parameters and one ``decode_fn`` step at position S-1 on the
prefill's caches. A vlm batch carries patches (B, n_vision_tokens,
d_model) of 0.01, an audio batch frames (B, n_encoder_frames, d_model) of
0.01, as in ``smoke_one.py``. Fails unless the loss and every logit are
finite. Runs on the card (where prefill reaches the CUDA kernels) unless
``--device cpu``; prints ``<arch>: OK loss=... params=...`` per arch.
"""
from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.training.optimizer import OptConfig, Optimizer  # noqa: E402
from repro_torch.training.step import (make_train_state,  # noqa: E402
                                       make_train_step)

B, S = 2, 32


def smoke(arch: str, device) -> dict:
    """One train step, a prefill and a decode step of reduced ``arch``;
    raises unless everything is finite. Returns the loss and the shapes."""
    cfg = reduced(get_config(arch))
    api = build_model(cfg, ParallelConfig(
        param_dtype="float32", compute_dtype="float32", remat="block",
        q_block=8, kv_block=8), device)
    ones = torch.ones((B, S), dtype=torch.int32, device=api.device)
    batch = {"tokens": ones, "labels": ones}
    if cfg.family == "vlm":
        batch["patches"] = torch.full((B, cfg.n_vision_tokens, cfg.d_model),
                                      0.01, device=api.device)
    if cfg.family == "audio":
        batch["frames"] = torch.full((B, cfg.n_encoder_frames, cfg.d_model),
                                     0.01, device=api.device)
    opt = Optimizer(OptConfig(name="adamw"))
    state, metrics = make_train_step(api, opt)(
        make_train_state(api, opt, seed=0), batch)
    loss = float(metrics["loss"])
    if not math.isfinite(loss):
        raise RuntimeError(f"{arch}: train loss {loss}")

    params = api.load(state["params"])
    logits, caches = api.prefill_fn(
        params, {k: v for k, v in batch.items() if k != "labels"})
    if not bool(torch.isfinite(logits).all()):
        raise RuntimeError(f"{arch}: prefill logits not finite")
    logits2, _ = api.decode_fn(
        params, caches, ones[:, :1],
        torch.full((B,), S - 1, dtype=torch.long, device=api.device))
    if not bool(torch.isfinite(logits2).all()):
        raise RuntimeError(f"{arch}: decode logits not finite")
    print(f"{arch}: OK loss={loss:.4f} params={api.n_params()}")
    return {"arch": arch, "family": cfg.family, "loss": loss,
            "n_params": api.n_params(),
            "prefill_logits": tuple(logits.shape),
            "decode_logits": tuple(logits2.shape)}


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("archs", nargs="*", default=["qwen2-7b"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return [smoke(arch, args.device) for arch in args.archs]


if __name__ == "__main__":
    main()
