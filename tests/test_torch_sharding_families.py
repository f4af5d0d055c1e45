"""The ssm, hybrid, audio and vlm families on a (2, 4) mesh of 8 CPU ranks
(gloo), against the single-device port and the JAX package on one
device.

One spawn of 8 processes (``tests/_torch_dist_worker.py``, as
``tests/test_torch_sharding.py`` runs it) takes every variant, in f32,
with ``sequence_parallel`` on (the dry run's recipes set it): reduced
mamba2-1.3b with no attention heads (the cp recipe of the full config),
whose scan runs under ``shard_map`` over its 8 heads; reduced
recurrentgemma-9b with 5 layers (one (rec, rec, attn) group and a
2-layer recurrent tail) and a window of 8 that binds at S = 32, its
4 gate blocks and lru channels over the 4-way model axis; reduced
whisper-base with 2 heads over model 4 (as 8 heads over 16: the cp
recipe) and 16 encoder frames; reduced internvl2-1b with 6 heads (as 14
over 16: cp) and 4 patch positions. From the same JAX parameters, each
variant's loss, gradients (gathered), prefill logits and every cache
leaf, and one decode step's logits and caches must equal the
single-device port's and JAX's at ``tests/test_torch_train.py``'s
tolerances (loss rtol 1e-5; each gradient leaf within 1e-4 of its
largest |g|, whisper's key biases, zero in exact arithmetic, within 1e-6
of the tree's; logits and caches atol / rtol 1e-4). The prefill calls
each scan once a recurrent layer on local shards. The scan wrappers raise
``TypeError`` on a DTensor.
"""
import multiprocessing as mp
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
import _torch_dist_worker  # noqa: E402
from _torch_jax_models import (GRAD_TOL, LOSS_RTOL, TOL,  # noqa: E402
                               assert_grads_close, grow_kv, leaves,
                               lm_batch, perturb, stub_inputs)

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.configs.base import ParallelConfig as JaxParallelConfig  # noqa: E402
from repro.launch.mesh import make_local_mesh as jax_local_mesh  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.convert import params_from_jax_numpy  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.training.step import loss_and_grads  # noqa: E402

MESH = (2, 4)
B, S, MAX_SEQ = 4, 32, 40
# name: (arch, config overrides, the recipe the (2, 4) mesh gives,
#        {kernel wrapper: calls a prefill})
VARIANTS = {
    "mamba2": ("mamba2-1.3b", {"n_heads": 0, "vocab_size": 250}, "cp",
               {"ssd_scan": 2}),
    "hybrid": ("recurrentgemma-9b", {"n_layers": 5}, "tp",
               {"rglru_scan": 4, "flash_attention": 1}),
    "whisper": ("whisper-base", {"n_heads": 2, "n_kv_heads": 2,
                                 "n_encoder_frames": 6}, "cp",
                {"flash_attention": 6}),
    "vlm": ("internvl2-1b", {"n_heads": 6, "vocab_size": 250}, "cp",
            {"flash_attention": 2}),
}
# gradients zero in exact arithmetic (no RoPE: softmax ignores a shift
# that all keys share)
ZERO = {"whisper": ("bk",)}
JOIN_S = 600


def _par():
    return dict(param_dtype="float32", compute_dtype="float32", q_block=8,
                kv_block=8, sequence_parallel=True)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_ref(arch, over):
    """JAX on one device: its parameters as numpy, the batch, the loss,
    gradients, prefill and one decode step."""
    cfg = jax_reduced(jax_get_config(arch), **over)
    japi = jax_build_model(cfg, JaxParallelConfig(**_par()),
                           jax_local_mesh(1, 1))
    jparams = perturb(japi.init(jax.random.key(0)),
                      np.random.default_rng(0))
    batch = dict(lm_batch(5, B, S, cfg.vocab_size), **stub_inputs(cfg, B, 7))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        japi.loss_fn, has_aux=True))(jparams, jb)
    pb = {k: v for k, v in jb.items() if k != "labels"}
    logits, caches = jax.jit(japi.prefill_fn)(jparams, pb)
    rng = np.random.default_rng(6)
    tok = rng.integers(0, cfg.vocab_size, size=(B, 1)).astype(np.int32)
    pos = np.full((B,), S, np.int32)
    dlogits, dcaches = jax.jit(japi.decode_fn)(
        jparams, grow_kv(caches, MAX_SEQ, jnp), jnp.asarray(tok),
        jnp.asarray(pos))
    return {"params": _np(jparams), "batch": batch, "tok": tok, "pos": pos,
            "loss": float(loss),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": _np(grads), "prefill_logits": np.asarray(logits),
            "prefill_caches": _np(caches),
            "decode_logits": np.asarray(dlogits),
            "decode_caches": _np(dcaches)}


def _single(arch, over, ref):
    """The port on one device from the same parameters."""
    cfg = reduced(get_config(arch), **over)
    api = build_model(cfg, ParallelConfig(**_par()), "cpu")
    params = params_from_jax_numpy(ref["params"], cfg, "cpu")
    batch = {k: torch.as_tensor(v) for k, v in ref["batch"].items()}
    loss, metrics, grads = loss_and_grads(api, params, batch)
    served = api.load(params)
    logits, caches = api.prefill_fn(
        served, {k: v for k, v in batch.items() if k != "labels"})
    t = lambda x: x.detach().numpy()  # noqa: E731
    # copies: the decode step writes the state leaves in place
    pre = _tree(lambda x: t(x).copy(), caches)
    dlogits, dcaches = api.decode_fn(served, grow_kv(caches, MAX_SEQ, torch),
                                     torch.as_tensor(ref["tok"]),
                                     torch.as_tensor(ref["pos"]))
    return {"loss": float(loss),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": _tree(t, grads), "prefill_logits": t(logits),
            "prefill_caches": pre, "decode_logits": t(dlogits),
            "decode_caches": _tree(t, dcaches)}


def _tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    return fn(tree)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    refs, jobs = {}, {}
    for name, (arch, over, _, _) in VARIANTS.items():
        refs[name] = _jax_ref(arch, over)
        jobs[name] = {"arch": arch, "cfg": over, "moe": None, "par": _par(),
                      "params": refs[name]["params"],
                      "batch": refs[name]["batch"], "max_seq": MAX_SEQ,
                      "decode_tokens": refs[name]["tok"],
                      "decode_pos": refs[name]["pos"]}
    singles = {name: _single(arch, over, refs[name])
               for name, (arch, over, _, _) in VARIANTS.items()}
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    world = MESH[0] * MESH[1]
    init = "file://" + str(tmp_path_factory.mktemp("rdzv") / "store")
    procs = [ctx.Process(target=_torch_dist_worker.run,
                         args=(r, world, init, MESH, jobs, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        msg = queue.get(timeout=JOIN_S)   # rank 0's results or an error
    finally:
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.terminate()
    assert msg[0] == "ok", msg[2]
    return refs, singles, msg[1]


def _trees_close(got, want, what):
    got, want = dict(leaves(got)), dict(leaves(want))
    assert set(got) == set(want), what
    for path, w in want.items():
        np.testing.assert_allclose(got[path], np.asarray(w),
                                   err_msg=f"{what} {path}", **TOL)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_recipe_collectives_and_local_kernels(runs, name):
    _, _, dist_out = runs
    d = dist_out[name]
    assert d["recipe"] == VARIANTS[name][2]
    assert any("Shard" in p for p in d["grad_placements"])
    assert sum(d["prefill_collectives"].values()) > 0
    assert sum(d["decode_collectives"].values()) > 0
    # each wrapper took local shards (a DTensor raises), once a layer
    assert d["prefill_kernels"] == VARIANTS[name][3]
    assert d["replication_after_calls"] == [False] * 4


@pytest.mark.parametrize("name", list(VARIANTS))
def test_loss_matches_single_device_and_jax(runs, name):
    refs, singles, dist_out = runs
    d, s, j = dist_out[name], singles[name], refs[name]
    np.testing.assert_allclose(d["loss"], s["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(d["loss"], j["loss"], rtol=LOSS_RTOL)
    assert set(d["metrics"]) == set(j["metrics"])
    for k in j["metrics"]:
        np.testing.assert_allclose(d["metrics"][k], j["metrics"][k],
                                   rtol=LOSS_RTOL, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_grads_match_single_device_and_jax(runs, name):
    refs, singles, dist_out = runs
    got = _tree(torch.as_tensor, dist_out[name]["grads"])
    zero = ZERO.get(name, ())
    assert_grads_close(got, refs[name]["grads"], tol=GRAD_TOL, zero=zero)
    assert_grads_close(got, singles[name]["grads"], tol=GRAD_TOL, zero=zero)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_prefill_matches_single_device_and_jax(runs, name):
    refs, singles, dist_out = runs
    d = dist_out[name]
    for who, want in (("port", singles[name]), ("jax", refs[name])):
        np.testing.assert_allclose(d["prefill_logits"],
                                   want["prefill_logits"],
                                   err_msg=f"{who} logits", **TOL)
        _trees_close(d["prefill_caches"], want["prefill_caches"], who)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_decode_step_matches_single_device_and_jax(runs, name):
    refs, singles, dist_out = runs
    d = dist_out[name]
    for who, want in (("port", singles[name]), ("jax", refs[name])):
        np.testing.assert_allclose(d["decode_logits"], want["decode_logits"],
                                   err_msg=f"{who} decode logits", **TOL)
        _trees_close(d["decode_caches"], want["decode_caches"], who)


@pytest.mark.parametrize("which", ["ssd_scan", "rglru_scan"])
def test_scan_wrappers_raise_on_a_dtensor(tmp_path, which):
    """A DTensor never reaches the kernel or its plain version: the
    wrapper names the ``shard_map`` that should have been around it."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.kernels.rglru_scan.ops import rglru_scan
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.launch.mesh import make_local_mesh
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_local_mesh(1, 1, "cpu")
        g = torch.Generator().manual_seed(0)

        def d(*shape):
            return distribute_tensor(torch.randn(shape, generator=g), mesh,
                                     src_data_rank=None)
        with pytest.raises(TypeError, match="shard_map"):
            if which == "ssd_scan":
                ssd_scan(d(1, 8, 2, 4), d(1, 8, 2).abs(), d(1, 8, 4),
                         d(1, 8, 4), -d(2).abs(), chunk=4)
            else:
                rglru_scan(-d(1, 8, 4).abs(), d(1, 8, 4))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", list(VARIANTS))
def test_one_rank_mesh_runs_the_parallel_paths(tmp_path, name):
    """``build_model(..., sharded=True)`` on a one-rank DeviceMesh (the
    card's check, chip_smoke.py (v), on the CPU): every leaf a DTensor,
    each kernel wrapper called once a layer on local tensors, no
    collective, and the prefill equal to the same prefill without a mesh:
    the logits within 1e-6 (the same ops), every cache leaf at TOL."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import layers as L
    from repro_torch.roofline.op_analysis import analyze
    arch, over, _, calls = VARIANTS[name]
    cfg = reduced(get_config(arch), **over)
    plain = build_model(cfg, ParallelConfig(**_par()), "cpu")
    with pytest.raises(ValueError, match="DeviceMesh"):
        build_model(cfg, ParallelConfig(**_par()), "cpu",
                    mesh=make_local_mesh(1, 1, "cpu"), sharded=True)
    params = plain.init(seed=3)
    batch = dict(lm_batch(4, 2, 24, cfg.vocab_size), **stub_inputs(cfg, 2, 5))
    batch = {k: torch.as_tensor(v) for k, v in batch.items()
             if k != "labels"}
    want_logits, want = plain.prefill_fn(params, batch)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        api = build_model(cfg, ParallelConfig(**_par()), "cpu",
                          mesh=make_local_mesh(1, 1, "cpu"), sharded=True)
        placed = api.load(params)
        assert all(isinstance(a, DTensor) for a in L.tree_leaves(placed))
        r = analyze(api.prefill_fn, placed, batch, result=(res := []))
        logits, caches = res[0]
        assert {k: v["calls"] for k, v in r["kernels"].items()} == calls
        assert sum(r["collective_counts"].values()) == 0
        np.testing.assert_allclose(logits.full_tensor().numpy(),
                                   want_logits.numpy(), atol=1e-6, rtol=0)
        _trees_close(_tree(lambda t: t.full_tensor().numpy(), caches),
                     _tree(lambda t: t.numpy(), want), name)
    finally:
        dist.destroy_process_group()
