"""Training launcher of the port: ``python -m repro_torch.launch.train
--arch <id> [...]`` (counterpart of ``repro.launch.train``, with
``--device`` and ``--ranks``).

Trains the reduced (or, with --full-size, the full) config of ``--arch``
on a (data, 1) mesh through the runner, data the number of ranks:
``--ranks N`` spawns N processes, each a rank of a group (gloo on the
CPU, NCCL on cards, one card a rank) with a ``file://`` rendezvous under
the checkpoint directory; without it, the ranks of a group the caller
initialized, or 1. Data resumable by step, checkpoint/restart
(``--fail-at-step`` injects a failure on every rank, then a second
runner resumes from the latest checkpoint, as the JAX launcher does); a
checkpoint written by N ranks resumes in a run of M. The card unless
``--device cpu``.

    python -m repro_torch.launch.train --device cpu --ranks 2 \
        --fail-at-step 25 --ckpt-dir DIR
"""
from __future__ import annotations

import argparse
import os
import tempfile
import types
import uuid

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ParallelConfig
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.model import build_model
from repro_torch.training.optimizer import OptConfig, Optimizer
from repro_torch.training.runner import (RunnerConfig, SimulatedFailure,
                                         TrainRunner)


def _parser() -> argparse.ArgumentParser:
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
    ap.add_argument("--ranks", type=int, default=1,
                    help="spawn this many ranks (a (ranks, 1) mesh)")
    return ap


def _rank(rank: int, world: int, init: str, argv, queue) -> None:
    """One spawned rank: join the group, train, hand rank 0's log back."""
    torch.set_num_threads(1)
    cuda = torch.device(_parser().parse_args(argv).device).type == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if cuda else "gloo", init_method=init,
                            rank=rank, world_size=world)
    try:
        runner = main(argv)
        if rank == 0:
            queue.put(("ok", runner.metrics_log))
    except BaseException as e:
        queue.put(("error", rank, repr(e)))
        raise
    finally:
        dist.destroy_process_group()


def _spawn(args, argv):
    """``--ranks N``: N processes, each running ``main`` (without
    ``--ranks``) as a rank of one group; returns rank 0's metrics log."""
    import multiprocessing as mp
    os.makedirs(args.ckpt_dir, exist_ok=True)
    init = "file://" + os.path.join(
        os.path.abspath(args.ckpt_dir), f".rdzv_{uuid.uuid4().hex}")
    rest, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a == "--ranks":
            skip = True
        elif not a.startswith("--ranks="):
            rest.append(a)
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_rank,
                         args=(r, args.ranks, init, rest, queue))
             for r in range(args.ranks)]
    for p in procs:
        p.start()
    try:
        msg = queue.get()
    finally:
        for p in procs:
            p.join()
        try:
            os.remove(init[len("file://"):])
        except OSError:
            pass
    if msg[0] != "ok" or any(p.exitcode for p in procs):
        raise RuntimeError(f"a rank failed: {msg[1:]}")
    return types.SimpleNamespace(metrics_log=msg[1])


def main(argv=None):
    """Train (see the module docstring). Returns this process's
    ``TrainRunner``; with ``--ranks`` > 1, an object whose
    ``metrics_log`` is rank 0's."""
    import sys
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parser().parse_args(argv)
    if args.ranks > 1:
        if dist.is_initialized():
            raise ValueError("--ranks spawns its own group; the caller "
                             "initialized one")
        return _spawn(args, argv)

    cfg = get_config(args.arch)
    if not args.full_size:
        cfg = reduced(cfg)
    parallel = ParallelConfig(param_dtype="float32", compute_dtype="float32",
                              q_block=64, kv_block=64)
    data = dist.get_world_size() if dist.is_initialized() else 1
    api = build_model(cfg, parallel, args.device,
                      mesh=make_local_mesh(data, 1, args.device))
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
        if not dist.is_initialized() or dist.get_rank() == 0:
            print(f"[ft] {e}; restarting from latest checkpoint...")
        runner2 = TrainRunner(api, opt, data_cfg,
                              RunnerConfig(total_steps=args.steps,
                                           ckpt_every=args.ckpt_every,
                                           ckpt_dir=args.ckpt_dir))
        runner2.run()
        runner.metrics_log.extend(runner2.metrics_log)
    first = runner.metrics_log[0]["loss"] if runner.metrics_log else None
    last = runner.metrics_log[-1]["loss"] if runner.metrics_log else None
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(f"[train] {args.arch}: steps={len(runner.metrics_log)} "
              f"loss {first:.4f} -> {last:.4f} ranks={data}")
    return runner


if __name__ == "__main__":
    main()
