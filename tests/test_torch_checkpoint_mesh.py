"""Elastic checkpoints of sharded state and multi-rank training, on the
CPU (gloo).

* A reduced recurrentgemma-9b training state (f32 masters, bf16 adamw
  moments, one step in) saved from a (2, 4) mesh of 8 ranks
  (``tests/_torch_ckpt_worker.py``) restores onto (4, 2), onto (8, 1) and
  onto one device: every leaf equal to the saved full array bit for bit,
  in the placements of the tree it was restored like. The save writes
  one ``.done`` marker, from rank 0.
* ``launch.train --ranks 2 --fail-at-step`` restarts both ranks from
  their checkpoint, and its losses equal a 1-rank run's at
  ``tests/test_torch_train.py``'s loss tolerance (rtol 1e-5: the ranks
  reduce the gradients in another order than one device sums them); the
  2-rank run's checkpoint resumes in a 1-rank run, the same losses again.
"""
import json
import multiprocessing as mp
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(__file__))
import _torch_ckpt_worker as W  # noqa: E402
from _torch_jax_models import LOSS_RTOL, leaves  # noqa: E402

from repro_torch.checkpoint.ckpt import CheckpointManager  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402

JOIN_S = 600
TRAIN = ["--device", "cpu", "--batch", "4", "--seq", "32", "--ckpt-every",
         "5"]


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    ckpt_dir = str(tmp_path_factory.mktemp("mesh_ckpt"))
    init = "file://" + str(tmp_path_factory.mktemp("rdzv") / "store")
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=W.run, args=(r, 8, init, ckpt_dir, queue))
             for r in range(8)]
    for p in procs:
        p.start()
    try:
        msg = queue.get(timeout=JOIN_S)
    finally:
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.terminate()
    assert msg[0] == "ok", msg[2]
    return ckpt_dir, msg[1]


def _equal_bits(got, want):
    got, want = dict(leaves(got)), dict(leaves(want))
    assert set(got) == set(want)
    for path, w in want.items():
        assert got[path].dtype == w.dtype, path
        assert np.array_equal(got[path], w), path


@pytest.mark.parametrize("shape", [(4, 2), (8, 1)], ids=["4x2", "8x1"])
def test_mesh_checkpoint_restores_onto_another_mesh(saved, shape):
    _, out = saved
    r = out["restored"][shape]
    assert r["dtensor_params"] and r["placements_kept"]
    assert r["extra"] == {"data_step": 1}
    _equal_bits(r["bits"], out["saved"])


def test_mesh_checkpoint_restores_onto_one_device(saved):
    ckpt_dir, out = saved
    like = W.state_on(None, seed=5)
    got, extra = CheckpointManager(ckpt_dir).restore(like)
    assert extra == {"data_step": 1}
    assert all(t.device.type == "cpu" and type(t) is torch.Tensor
               for _, t in leaves(got))
    _equal_bits(W.tree(W.bits, got), out["saved"])


def test_mesh_checkpoint_is_one_set_of_files(saved):
    ckpt_dir, _ = saved
    assert sorted(os.listdir(ckpt_dir)) == ["step_1", "step_1.done"]
    with open(os.path.join(ckpt_dir, "step_1", "manifest.json")) as f:
        manifest = json.load(f)
    dtypes = {e["dtype"] for e in manifest["leaves"]}
    assert {"float32", "bfloat16", "int32"} <= dtypes
    # full logical arrays, as one device writes them
    like = dict(leaves(W.state_on(None, seed=5)))
    for e in manifest["leaves"]:
        assert tuple(e["shape"]) == tuple(like[e["path"]].shape), e["path"]


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    runner = launch_train.main(TRAIN + [
        "--steps", "14", "--ckpt-dir", str(tmp_path_factory.mktemp("one"))])
    return {m["step"]: m["loss"] for m in runner.metrics_log}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    ckpt_dir = str(tmp_path_factory.mktemp("two"))
    log = launch_train.main(TRAIN + [
        "--ranks", "2", "--steps", "12", "--fail-at-step", "7",
        "--ckpt-dir", ckpt_dir]).metrics_log
    return ckpt_dir, log


def test_two_rank_training_restarts_and_matches_one_rank(two_ranks,
                                                         one_rank):
    ckpt_dir, log = two_ranks
    assert [m["step"] for m in log] == list(range(7)) + list(range(5, 12))
    for m in log:
        np.testing.assert_allclose(m["loss"], one_rank[m["step"]],
                                   rtol=LOSS_RTOL, err_msg=str(m["step"]))
    assert one_rank[11] < one_rank[0]
    assert CheckpointManager(ckpt_dir).all_steps() == [5, 10]


def test_two_rank_checkpoint_resumes_in_one_rank(two_ranks, one_rank):
    ckpt_dir, _ = two_ranks
    runner = launch_train.main(TRAIN + ["--steps", "14",
                                        "--ckpt-dir", ckpt_dir])
    assert [m["step"] for m in runner.metrics_log] == [10, 11, 12, 13]
    for m in runner.metrics_log:
        np.testing.assert_allclose(m["loss"], one_rank[m["step"]],
                                   rtol=LOSS_RTOL, err_msg=str(m["step"]))
