"""The port's parallel paths on a (2, 4) mesh of 8 CPU ranks (gloo),
against the single-device port and the JAX package on one device.

One spawn of 8 processes (``tests/_torch_dist_worker.py``, a ``file://``
rendezvous under the test's temp dir, one intra-op thread a rank) runs
every variant, in f32, on JAX's test configs: reduced qwen2-7b (4 heads:
the tp recipe on the 4-way model axis), reduced qwen2-7b with 6 heads
(the cp recipe), reduced olmoe-1b-7b with 8 experts top-2 at capacity
factor 8 (no dropped pair: the all-to-all path equals the single-device
buffer), each also with ``sequence_parallel`` and ``explicit_rs``, and
olmoe's decode with ``moe_weight_stationary``. From the same JAX
parameters, each variant's loss, gradients (gathered), prefill logits and
caches, and one decode step's logits and caches must equal the
single-device port's and JAX's at ``tests/test_torch_train.py``'s
tolerances (loss rtol 1e-5; each gradient leaf within 1e-4 of its
largest |g|; logits and caches atol / rtol 1e-4).
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
                               assert_grads_close, lm_batch, perturb)

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.configs.base import MoEConfig as JaxMoEConfig  # noqa: E402
from repro.configs.base import ParallelConfig as JaxParallelConfig  # noqa: E402
from repro.launch.mesh import make_local_mesh as jax_local_mesh  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import MoEConfig, ParallelConfig  # noqa: E402
from repro_torch.convert import params_from_jax_numpy  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.training.step import loss_and_grads  # noqa: E402

MESH = (2, 4)
B, S, MAX_SEQ = 4, 32, 40
MOE = dict(n_experts=8, top_k=2, capacity_factor=8.0)
SP = dict(sequence_parallel=True, explicit_rs=True)
# name: (arch, config overrides, MoE config, ParallelConfig levers,
#        the recipe the (2, 4) mesh gives)
VARIANTS = {
    "tp": ("qwen2-7b", {}, None, {}, "tp"),
    "tp_sp_rs": ("qwen2-7b", {}, None, SP, "tp"),
    "cp": ("qwen2-7b", {"n_heads": 6}, None, {}, "cp"),
    "cp_sp": ("qwen2-7b", {"n_heads": 6}, None,
              {"sequence_parallel": True}, "cp"),
    "moe": ("olmoe-1b-7b", {}, MOE, {}, "tp"),
    "moe_sp_rs": ("olmoe-1b-7b", {}, MOE, SP, "tp"),
    "moe_ws": ("olmoe-1b-7b", {}, MOE, {"moe_weight_stationary": True},
               "tp"),
}
JOIN_S = 600


def _par(levers):
    return dict(param_dtype="float32", compute_dtype="float32", q_block=8,
                kv_block=8, **levers)


def _jax_ref(arch, over, moe, levers):
    """JAX on one device: (jparams as numpy, loss, metrics, grads, prefill
    logits and caches, decode logits and caches) and the decode inputs."""
    cfg = jax_reduced(jax_get_config(arch), **over)
    if moe:
        import dataclasses
        cfg = dataclasses.replace(cfg, moe=JaxMoEConfig(**moe))
    japi = jax_build_model(cfg, JaxParallelConfig(**_par(levers)),
                           jax_local_mesh(1, 1))
    jparams = perturb(japi.init(jax.random.key(0)),
                      np.random.default_rng(0))
    batch = lm_batch(5, B, S, cfg.vocab_size)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        japi.loss_fn, has_aux=True))(jparams, jb)
    logits, caches = jax.jit(japi.prefill_fn)(jparams,
                                              {"tokens": jb["tokens"]})
    rng = np.random.default_rng(6)
    tok = rng.integers(0, cfg.vocab_size, size=(B, 1)).astype(np.int32)
    pos = np.full((B,), S, np.int32)
    grown = {k: jnp.zeros(c.shape[:2] + (MAX_SEQ,) + c.shape[3:], c.dtype)
             .at[:, :, :S].set(c) for k, c in caches.items()}
    dlogits, dcaches = jax.jit(japi.decode_fn)(jparams, grown,
                                               jnp.asarray(tok),
                                               jnp.asarray(pos))
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return {"params": to_np(jparams), "batch": batch, "tok": tok, "pos": pos,
            "loss": float(loss),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": to_np(grads), "prefill_logits": np.asarray(logits),
            "prefill_caches": to_np(caches),
            "decode_logits": np.asarray(dlogits),
            "decode_caches": to_np(dcaches)}


def _single(arch, over, moe, levers, ref):
    """The port on one device from the same parameters."""
    import dataclasses
    cfg = reduced(get_config(arch), **over)
    if moe:
        cfg = dataclasses.replace(cfg, moe=MoEConfig(**moe))
    api = build_model(cfg, ParallelConfig(**_par(levers)), "cpu")
    params = params_from_jax_numpy(ref["params"], cfg, "cpu")
    batch = {k: torch.as_tensor(v) for k, v in ref["batch"].items()}
    loss, metrics, grads = loss_and_grads(api, params, batch)
    served = api.load(params)
    logits, caches = api.prefill_fn(served, {"tokens": batch["tokens"]})
    grown = {k: torch.zeros(c.shape[:2] + (MAX_SEQ,) + c.shape[3:])
             for k, c in caches.items()}
    for k in grown:
        grown[k][:, :, :S] = caches[k]
    dlogits, dcaches = api.decode_fn(served, grown,
                                     torch.as_tensor(ref["tok"]),
                                     torch.as_tensor(ref["pos"]))
    t = lambda x: x.detach().numpy()  # noqa: E731
    return {"loss": float(loss),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": grads, "prefill_logits": t(logits),
            "prefill_caches": {k: t(v) for k, v in caches.items()},
            "decode_logits": t(dlogits),
            "decode_caches": {k: t(v) for k, v in dcaches.items()}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    refs, jobs = {}, {}
    for name, (arch, over, moe, levers, _) in VARIANTS.items():
        refs[name] = _jax_ref(arch, over, moe, levers)
        jobs[name] = {"arch": arch, "cfg": over, "moe": moe,
                      "par": _par(levers), "params": refs[name]["params"],
                      "batch": refs[name]["batch"], "max_seq": MAX_SEQ,
                      "decode_tokens": refs[name]["tok"],
                      "decode_pos": refs[name]["pos"]}
    singles = {name: _single(*VARIANTS[name][:4], refs[name])
               for name in VARIANTS}
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
    dist_out = msg[1]
    return refs, singles, dist_out


def _close(got, want, what):
    np.testing.assert_allclose(got, want, err_msg=what, **TOL)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_recipe_and_sharded_run(runs, name):
    _, _, dist_out = runs
    d = dist_out[name]
    assert d["recipe"] == VARIANTS[name][4]
    # the gradients came back as DTensors laid out over the mesh
    assert any("Shard" in p for p in d["grad_placements"])
    assert sum(d["prefill_collectives"].values()) > 0
    assert sum(d["decode_collectives"].values()) > 0
    if VARIANTS[name][2]:          # MoE: the all-to-all exchange at prefill
        assert d["prefill_collectives"]["all-to-all"] > 0


@pytest.mark.parametrize("name", list(VARIANTS))
def test_implicit_replication_ends_with_each_call(runs, name):
    """Plain tensors enter DTensor ops as replicated only inside the
    model's calls: not after ``build_model``, the loss and gradients, the
    prefill or the decode step."""
    _, _, dist_out = runs
    assert dist_out[name]["replication_after_calls"] == [False] * 4


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
    got = _to_torch(dist_out[name]["grads"])
    assert_grads_close(got, refs[name]["grads"], tol=GRAD_TOL)
    assert_grads_close(got, _to_np(singles[name]["grads"]), tol=GRAD_TOL)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_prefill_matches_single_device_and_jax(runs, name):
    refs, singles, dist_out = runs
    d = dist_out[name]
    for want in (singles[name], refs[name]):
        _close(d["prefill_logits"], want["prefill_logits"], "logits")
        assert set(d["prefill_caches"]) == set(want["prefill_caches"])
        for k in want["prefill_caches"]:
            _close(d["prefill_caches"][k], want["prefill_caches"][k], k)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_decode_step_matches_single_device_and_jax(runs, name):
    refs, singles, dist_out = runs
    d = dist_out[name]
    for want in (singles[name], refs[name]):
        _close(d["decode_logits"], want["decode_logits"], "decode logits")
        for k in want["decode_caches"]:
            _close(d["decode_caches"][k], want["decode_caches"][k], k)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.as_tensor(tree)


def _to_np(tree):
    if isinstance(tree, dict):
        return {k: _to_np(v) for k, v in tree.items()}
    return tree.detach().numpy()
