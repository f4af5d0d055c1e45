"""The port's CheckpointManager against the JAX package's: the same
on-disk format (manifest paths, files, shapes, dtypes), a checkpoint
written by either restoring in the other bit for bit, bf16 leaves
round-tripping without ml_dtypes, async saves isolated from later
in-place updates, retention. On the CPU; no tolerance: equality."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.ckpt import CheckpointManager as JaxCkpt  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.configs.base import ParallelConfig as JaxParallelConfig  # noqa: E402
from repro.launch.mesh import make_local_mesh  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402

from repro_torch.checkpoint.ckpt import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training.step import make_train_state  # noqa: E402

F32 = dict(param_dtype="float32", compute_dtype="float32")


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return {p: a for k in sorted(tree)
                for p, a in _flat(tree[k], path + (k,)).items()}
    return {"/".join(path): tree}


def _bits(x):
    """The raw bytes of a leaf of either package, with its dtype name."""
    if isinstance(x, torch.Tensor):
        name = str(x.dtype).removeprefix("torch.")
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return name, x.numpy().tobytes(), tuple(x.shape)
    a = np.asarray(x)
    return str(a.dtype), a.tobytes(), a.shape


def _assert_same(torch_tree, jax_tree):
    t, j = _flat(torch_tree), _flat(jax_tree)
    assert set(t) == set(j)
    for k in j:
        assert _bits(t[k]) == _bits(j[k]), k


def _port_state(seed=0):
    api = build_model(reduced(get_config("qwen2-7b")), ParallelConfig(**F32),
                      device="cpu")
    opt = topt.Optimizer(topt.OptConfig())
    state = make_train_state(api, opt, seed=seed)
    rng = np.random.default_rng(seed)
    for leaf in _flat(state["opt"]).values():    # non-trivial moments
        if leaf.is_floating_point():
            leaf.copy_(torch.as_tensor(rng.normal(size=leaf.shape)))
    state["opt"]["count"].fill_(7)
    state["step"].fill_(7)
    return state


def _jax_state(seed=1):
    japi = jax_build_model(jax_reduced(jax_get_config("qwen2-7b")),
                           JaxParallelConfig(**F32), make_local_mesh(1, 1))
    params = japi.init(jax.random.key(seed))
    opt = jopt.Optimizer(jopt.OptConfig()).init(params)
    rng = np.random.default_rng(seed)
    opt = jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape),
                                             a.dtype)
                       if jnp.issubdtype(a.dtype, jnp.floating) else a, opt)
    opt["count"] = jnp.int32(5)
    return {"params": params, "opt": opt, "step": jnp.int32(5)}


def test_port_checkpoint_restores_in_jax(tmp_path):
    state = _port_state()
    CheckpointManager(str(tmp_path)).save(state, 7, extra={"data_step": 7},
                                          blocking=True)
    restored, extra = JaxCkpt(str(tmp_path)).restore(_jax_state())
    assert extra == {"data_step": 7}
    _assert_same(state, restored)


def test_jax_checkpoint_restores_in_port(tmp_path):
    state = _jax_state()
    JaxCkpt(str(tmp_path)).save(state, 5, extra={"data_step": 5},
                                blocking=True)
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 5
    restored, extra = mgr.restore(_port_state())
    assert extra == {"data_step": 5}
    _assert_same(restored, state)


def test_both_packages_write_the_same_manifest(tmp_path):
    pstate, jstate = _port_state(), _jax_state()
    CheckpointManager(str(tmp_path / "port")).save(pstate, 3, blocking=True)
    JaxCkpt(str(tmp_path / "jax")).save(jstate, 3, blocking=True)
    mans = [json.loads((tmp_path / d / "step_3" / "manifest.json")
                       .read_text()) for d in ("port", "jax")]
    assert mans[0]["leaves"] == mans[1]["leaves"]
    for d in ("port", "jax"):
        names = sorted(os.listdir(tmp_path / d))
        assert names == ["step_3", "step_3.done"]


def test_bf16_leaves_round_trip_bit_for_bit(tmp_path):
    rng = np.random.default_rng(2)
    vals = rng.normal(size=(3, 5)).astype(np.float32)
    tree = {"w": torch.as_tensor(vals).to(torch.bfloat16),
            "b": torch.as_tensor(vals[0])}
    mgr = CheckpointManager(str(tmp_path / "port"))
    mgr.save(tree, 1, blocking=True)
    back, _ = mgr.restore(tree)
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"].view(torch.int16),
                       tree["w"].view(torch.int16))
    assert torch.equal(back["b"], tree["b"])
    # a bf16 leaf that JAX wrote (through ml_dtypes) restores too
    jtree = {"w": jnp.asarray(vals, jnp.bfloat16), "b": jnp.asarray(vals[0])}
    JaxCkpt(str(tmp_path / "jax")).save(jtree, 1, blocking=True)
    back, _ = CheckpointManager(str(tmp_path / "jax")).restore(tree)
    _assert_same(back, jtree)


def test_async_save_snapshots_before_later_updates(tmp_path):
    tree = {"p": torch.arange(6, dtype=torch.float32)}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(tree, 1)
    tree["p"].add_(100.0)                         # the next step, in place
    mgr.wait()
    back, _ = mgr.restore(tree)
    assert torch.equal(back["p"], torch.arange(6, dtype=torch.float32))


def test_retention_and_errors(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "c"), keep=2)
    with pytest.raises(FileNotFoundError):
        mgr.restore({"p": torch.zeros(2)})
    for step in (1, 2, 3, 4):
        mgr.save({"p": torch.full((2,), float(step))}, step)
    mgr.wait()
    assert mgr.all_steps() == [3, 4] and mgr.save_count == 4
    assert sorted(os.listdir(tmp_path / "c")) == [
        "step_3", "step_3.done", "step_4", "step_4.done"]
    back, _ = mgr.restore({"p": torch.zeros(2)}, step=3)
    assert back["p"].tolist() == [3.0, 3.0]
    with pytest.raises(ValueError, match="shape mismatch at p"):
        mgr.restore({"p": torch.zeros(3)})
