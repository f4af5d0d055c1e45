"""Fault-tolerant training runner of the port: checkpoint/restart,
deterministic data resume, simulated failures, straggler accounting,
async checkpointing (counterpart of ``repro.training.runner``).

Failure recovery = process restart + ``resume_or_init()`` from the latest
complete checkpoint, whose ``extra["data_step"]`` says where the data
stream resumes.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Optional

from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.data.pipeline import DataConfig, ShardedLoader, TokenSource
from repro_torch.models.model import ModelApi
from repro_torch.training.optimizer import Optimizer
from repro_torch.training.step import make_train_state, make_train_step


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class RunnerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    keep: int = 3
    fail_at_step: Optional[int] = None     # simulate a node failure
    straggler_factor: float = 3.0


class TrainRunner:
    def __init__(self, api: ModelApi, opt: Optimizer, data_cfg: DataConfig,
                 run_cfg: RunnerConfig):
        self.api = api
        self.opt = opt
        self.run_cfg = run_cfg
        self.ckpt = CheckpointManager(run_cfg.ckpt_dir, keep=run_cfg.keep)
        self.loader = ShardedLoader(TokenSource(data_cfg), api.device)
        self.step_fn = make_train_step(api, opt)
        self.metrics_log: list = []
        self.straggler_steps: list = []
        self._ema_dur: Optional[float] = None

    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0):
        return make_train_state(self.api, self.opt, seed)

    def resume_or_init(self, seed: int = 0):
        latest = self.ckpt.latest_step()
        if latest is None:
            return self.init_state(seed), 0
        state = self.init_state(seed)  # structure donor
        state, extra = self.ckpt.restore(state)
        return state, int(extra.get("data_step", latest))

    # ------------------------------------------------------------------
    def run(self, state=None, start_step: Optional[int] = None):
        """Train from ``state`` (default: the latest checkpoint, or a new
        state) to ``total_steps``. A step's ``dur_s`` is host time from
        the call to the loss read back, which waits for the device."""
        rc = self.run_cfg
        if state is None:
            state, start_step = self.resume_or_init()
        if start_step is None:
            start_step = int(state["step"])
        for step, batch in self.loader.iterate(start_step):
            if step >= rc.total_steps:
                break
            if rc.fail_at_step is not None and step == rc.fail_at_step:
                raise SimulatedFailure(f"injected failure at {step}")
            t0 = time.monotonic()
            state, metrics = self.step_fn(state, batch)
            loss = float(metrics["loss"])
            dur = time.monotonic() - t0
            if self._ema_dur is not None and \
                    dur > rc.straggler_factor * self._ema_dur:
                self.straggler_steps.append((step, dur))
            self._ema_dur = dur if self._ema_dur is None else \
                0.9 * self._ema_dur + 0.1 * dur
            self.metrics_log.append({"step": step, "loss": loss,
                                     "dur_s": dur})
            if (step + 1) % rc.ckpt_every == 0:
                self.ckpt.save(state, step + 1,
                               extra={"data_step": step + 1})
        self.ckpt.wait()
        return state
