"""The port's training entry points on the CPU: TrainRunner's restart
after a simulated failure, the train launcher, the quickstart and the
serve-beside-training example (reduced configs, f32). The restart is
held to the uninterrupted run's losses exactly: on the CPU both runs
compute the same ops on the same bits (the checkpoint stores them). No
timing bound: these run on a shared host."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.examples import quickstart  # noqa: E402
from repro_torch.examples import serve_with_background_training as swbt  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.training.optimizer import OptConfig, Optimizer  # noqa: E402
from repro_torch.training.runner import (RunnerConfig,  # noqa: E402
                                         SimulatedFailure, TrainRunner)


def _runner(ckpt_dir, fail_at_step=None):
    cfg = reduced(get_config("qwen2-7b"))
    api = build_model(cfg, ParallelConfig(param_dtype="float32",
                                          compute_dtype="float32",
                                          q_block=64, kv_block=64),
                      device="cpu")
    opt = Optimizer(OptConfig(lr=3e-3, warmup=2, decay_steps=20))
    data = DataConfig(seq_len=32, global_batch=4, vocab_size=cfg.vocab_size)
    return TrainRunner(api, opt, data, RunnerConfig(
        total_steps=12, ckpt_every=4, ckpt_dir=str(ckpt_dir),
        fail_at_step=fail_at_step))


def test_restart_after_failure_gives_the_uninterrupted_losses(tmp_path):
    clean = _runner(tmp_path / "clean")
    clean.run()
    want = {m["step"]: m["loss"] for m in clean.metrics_log}
    assert sorted(want) == list(range(12))
    assert clean.ckpt.all_steps() == [4, 8, 12]

    first = _runner(tmp_path / "ft", fail_at_step=10)
    with pytest.raises(SimulatedFailure, match="at 10"):
        first.run()
    assert [m["step"] for m in first.metrics_log] == list(range(10))
    second = _runner(tmp_path / "ft")
    state, start = second.resume_or_init()
    assert start == 8 and int(state["step"]) == 8
    second.run()
    assert [m["step"] for m in second.metrics_log] == [8, 9, 10, 11]
    for m in first.metrics_log + second.metrics_log:
        assert m["loss"] == want[m["step"]], m["step"]
    assert want[11] < want[0]
    assert all(m["dur_s"] > 0 for m in second.metrics_log)


def test_a_failure_waits_for_the_checkpoint_being_written(tmp_path,
                                                          monkeypatch):
    """The step-8 checkpoint's write is still running when the failure at
    step 8 raises: ``run`` finishes that write before it raises, so a
    runner resuming in the same process starts from step 8, not 4."""
    import time
    from repro_torch.checkpoint import ckpt
    real = ckpt.CheckpointManager._save_sync

    def slow(self, leaves, step, extra):
        time.sleep(0.5)
        real(self, leaves, step, extra)
    monkeypatch.setattr(ckpt.CheckpointManager, "_save_sync", slow)
    first = _runner(tmp_path, fail_at_step=8)
    with pytest.raises(SimulatedFailure, match="at 8"):
        first.run()
    assert first.ckpt.all_steps() == [4, 8]
    _, start = _runner(tmp_path).resume_or_init()
    assert start == 8


def test_train_launcher_restarts_on_the_cpu(tmp_path, capsys):
    runner = launch_train.main([
        "--device", "cpu", "--steps", "12", "--batch", "4", "--seq", "32",
        "--ckpt-every", "5", "--fail-at-step", "7",
        "--ckpt-dir", str(tmp_path)])
    steps = [m["step"] for m in runner.metrics_log]
    assert steps == list(range(7)) + list(range(5, 12))
    out = capsys.readouterr().out
    assert "[ft] injected failure at 7" in out
    assert "[train] qwen2-7b: steps=14" in out


def test_quickstart_trains_then_serves_on_the_cpu(tmp_path):
    out = quickstart.main(["--device", "cpu", "--ckpt-dir", str(tmp_path)])
    losses = out["losses"]
    assert len(losses) == 100 and losses[-1] < losses[0]
    assert out["request"].done and len(out["request"].out) == 8


def test_serve_beside_training_on_the_cpu():
    models = swbt.build(reduced(get_config("qwen2-7b")),
                        reduced(get_config("olmoe-1b-7b")), device="cpu")
    first = float(models["train_state"]["params"]["final_ln"].sum())
    runs = {enabled: swbt.run(models, enabled=enabled, duration=1.5)
            for enabled in (True, False)}
    for enabled, res in runs.items():
        assert len(res["decode_ms"]) >= 1, enabled
        assert math.isfinite(res["warmup_loss"])
        assert all(math.isfinite(x) for x in res["losses"])
        assert res["intervals"] == []              # CUDA events: card only
    cosched = runs[False]
    assert len(cosched["losses"]) >= 1
    assert cosched["stats"]["be_quanta"]["train-be"] == len(cosched["losses"])
    # the microsteps moved the shared training state
    assert float(models["train_state"]["params"]["final_ln"].sum()) != first
    assert int(models["train_state"]["step"]) == 2 + sum(
        len(r["losses"]) for r in runs.values())


def test_rt_gang_admits_training_declared_within_the_budget():
    # the example declares 1e6 B a microstep, twice the gang's 5e5 B
    # budget; at half the budget RT-Gang's regulator admits microsteps
    models = swbt.build(reduced(get_config("qwen2-7b")),
                        reduced(get_config("olmoe-1b-7b")), device="cpu")
    res = swbt.run(models, enabled=True, duration=1.5, train_bytes=2.5e5)
    assert len(res["decode_ms"]) >= 1
    assert len(res["losses"]) >= 1
    assert res["stats"]["be_quanta"]["train-be"] == len(res["losses"])
    assert all(math.isfinite(x) for x in res["losses"])


def test_serve_beside_training_main_on_the_cpu():
    res = swbt.main(["--device", "cpu", "--duration", "1", "--no-gang"])
    assert len(res["decode_ms"]) >= 1 and len(res["losses"]) >= 1
    losses = [res["warmup_loss"]] + res["losses"]
    assert np.isfinite(losses).all()


@pytest.mark.parametrize("main", [launch_train.main, quickstart.main,
                                  swbt.main],
                         ids=["train", "quickstart", "serve_with_training"])
def test_entry_points_default_to_the_card(main):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        main([])
