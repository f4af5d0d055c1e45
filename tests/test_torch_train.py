"""PyTorch port vs the JAX package: the train mode of the four ported
families (reduced qwen2-7b, olmoe-1b-7b, mamba2-1.3b, recurrentgemma-9b)
on the CPU, in f32, with JAX's parameters carried over by
``repro_torch.convert`` and JAX on a 1x1 mesh
(``jax.value_and_grad(api.loss_fn)``).

Tolerances (f32; the same math with sums taken in another order): the
loss within rtol 1e-5, the MoE aux metrics within atol 1e-6, every
gradient leaf within 1e-4 of that leaf's largest |g| in JAX. The remat
policies recompute the same ops, so their gradients agree within 1e-6 of
a leaf's largest |g|.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.configs.base import ParallelConfig as JaxParallelConfig  # noqa: E402
from repro.launch.mesh import make_local_mesh  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402

from _torch_jax_models import (GRAD_TOL, LOSS_RTOL,  # noqa: E402
                               assert_grads_close, lm_batch, pair, to_jax,
                               to_torch)

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.moe_gmm import ops as gmm_ops  # noqa: E402
from repro_torch.kernels.rglru_scan import ops as rg_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import mamba2, moe, rglru  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.training.optimizer import OptConfig, Optimizer  # noqa: E402
from repro_torch.training.step import (loss_and_grads,  # noqa: E402
                                       make_train_state, make_train_step)

FAMILIES = {"dense": "qwen2-7b", "moe": "olmoe-1b-7b", "ssm": "mamba2-1.3b",
            "hybrid": "recurrentgemma-9b"}
# the hybrid with one group and a 2-layer recurrent tail, its window
# binding inside the sequence
OVERRIDES = {"hybrid": dict(n_layers=5, window=8)}
REMAT_TOL = 1e-6


def _models(family, **par):
    return pair(FAMILIES[family], OVERRIDES.get(family, {}), **par)


def _jax_loss_grads(japi, jparams, batch):
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        japi.loss_fn, has_aux=True))(jparams, to_jax(batch))
    return float(loss), {k: float(v) for k, v in metrics.items()}, grads


def _port_loss_grads(api, params, batch):
    loss, metrics, grads = loss_and_grads(api, params, to_torch(batch))
    return float(loss), {k: float(v) for k, v in metrics.items()}, grads


@pytest.mark.parametrize("fused", [False, True], ids=["xent", "fused_xent"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_and_grads_match_jax(family, fused):
    japi, jparams, api, params = _models(family, fused_xent=fused)
    batch = lm_batch(1, 2, 16, api.cfg.vocab_size)
    jl, jm, jg = _jax_loss_grads(japi, jparams, batch)
    tl, tm, tg = _port_loss_grads(api, params, batch)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=LOSS_RTOL, atol=1e-6)
    if family == "moe":
        assert {"load_balance", "router_z"} <= set(tm)
    assert_grads_close(tg, jg, GRAD_TOL)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_remat_policies_give_the_same_grads(family):
    _, _, api, params = _models(family)
    batch = lm_batch(2, 2, 16, api.cfg.vocab_size)
    base = _port_loss_grads(api, params, batch)   # remat "block"
    for policy in ("none", "dots"):
        other = build_model(api.cfg, ParallelConfig(
            param_dtype="float32", compute_dtype="float32", q_block=8,
            kv_block=8, remat=policy), device="cpu")
        loss, _, grads = _port_loss_grads(other, params, batch)
        assert loss == pytest.approx(base[0], rel=1e-6)
        assert_grads_close(grads, base[2], REMAT_TOL)


def test_dense_long_sequence_trains_through_the_blocked_attention():
    """S = 640 > 512 with q_block = kv_block = 128: JAX's dispatch takes
    its blocked ``flash_attention_jnp``; the port its blocked twin."""
    japi, jparams, api, params = _models("dense", q_block=128, kv_block=128)
    batch = lm_batch(3, 1, 640, api.cfg.vocab_size)
    jl, _, jg = _jax_loss_grads(japi, jparams, batch)
    tl, _, tg = _port_loss_grads(api, params, batch)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert_grads_close(tg, jg, GRAD_TOL)


@pytest.mark.parametrize("case", [
    dict(S=640, q_block=128, kv_block=64),                # blocked, causal
    dict(S=640, q_block=128, kv_block=128, window=100),   # blocks skipped
    dict(S=640, q_block=64, kv_block=128, softcap=5.0),
    dict(S=96, q_block=32, kv_block=32, window=10),       # materialized
], ids=["blocked", "window", "softcap", "masked"])
def test_train_attention_matches_jax(case):
    case = dict(case)
    S = case.pop("S")
    rng = np.random.default_rng(4)
    B, Hq, Hkv, D = 1, 4, 2, 8
    q, k, v, ct = (rng.normal(size=shape).astype(np.float32) for shape in (
        (B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D), (B, S, Hq, D)))
    jout, vjp = jax.vjp(lambda q, k, v: jL.attention(q, k, v, causal=True,
                                                     **case), q, k, v)
    jgrads = vjp(jnp.asarray(ct))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    tout = L.train_attention(tq, tk, tv, causal=True, **case)
    tgrads = torch.autograd.grad(tout, (tq, tk, tv), torch.as_tensor(ct))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               atol=1e-5, rtol=1e-5)
    for t, j in zip(tgrads, jgrads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_xent_losses_match_jax(tied):
    """xent_loss and fused_xent_loss (4 chunks of 6) against JAX's, value
    and gradients, with masked labels."""
    rng = np.random.default_rng(5)
    B, S, D, V = 2, 24, 16, 40
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    table = rng.normal(size=(V, D) if tied else (D, V)).astype(np.float32)
    labels = rng.integers(0, V, size=(B, S)).astype(np.int32)
    labels[1, 5:9] = -100
    rules = jax_build_model(jax_reduced(jax_get_config("qwen2-7b")),
                            JaxParallelConfig(), make_local_mesh(1, 1)).rules_a

    def jfused(x, t):
        return jmodel.fused_xent_loss(x, t, jnp.asarray(labels), rules, tied,
                                      chunk=6)[0]

    def jplain(x, t):
        logits = jnp.einsum("bsd,vd->bsv" if tied else "bsd,dv->bsv", x, t)
        return jmodel.xent_loss(logits, jnp.asarray(labels), rules)[0]

    tl = torch.as_tensor(labels)
    for jfn, tfn in (
            (jfused, lambda x, t: tmodel.fused_xent_loss(x, t, tl, tied,
                                                         chunk=6)[0]),
            (jplain, lambda x, t: tmodel.xent_loss(
                x @ (t.T if tied else t), tl)[0])):
        jv, jg = jax.value_and_grad(jfn, argnums=(0, 1))(x, table)
        tx, tt = (torch.tensor(a, requires_grad=True) for a in (x, table))
        tv = tfn(tx, tt)
        tg = torch.autograd.grad(tv, (tx, tt))
        np.testing.assert_allclose(float(tv), float(jv), rtol=1e-6)
        for t, j in zip(tg, jg):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6,
                                       rtol=1e-5)
    n = tmodel.xent_loss(torch.zeros((B, S, V)), tl)[1]["tokens"]
    assert int(n) == B * S - 4


def test_no_kernel_wrapper_is_called_on_the_train_path(monkeypatch):
    """A train step of every family runs with the four kernel wrappers
    replaced by functions that raise, and moves no launch counter; the
    same patch makes prefill raise (it reaches the wrappers)."""
    def boom(*args, **kwargs):
        raise AssertionError("a kernel wrapper was called")
    monkeypatch.setattr(L, "flash_attention", boom)
    monkeypatch.setattr(moe, "grouped_matmul", boom)
    monkeypatch.setattr(mamba2, "ssd_scan", boom)
    monkeypatch.setattr(rglru, "rglru_scan", boom)
    kernels = (fa_ops, gmm_ops, ssd_ops, rg_ops)
    for m in kernels:
        m.reset_launches()
    for family in FAMILIES:
        cfg = reduced(get_config(FAMILIES[family]),
                      **OVERRIDES.get(family, {}))
        api = build_model(cfg, ParallelConfig(param_dtype="float32",
                                              compute_dtype="float32"),
                          device="cpu")
        opt = Optimizer(OptConfig())
        state = make_train_state(api, opt, seed=0)
        batch = to_torch(lm_batch(6, 2, 16, cfg.vocab_size))
        state, metrics = make_train_step(api, opt)(state, batch)
        assert np.isfinite(float(metrics["loss"])), family
        with pytest.raises(AssertionError, match="kernel wrapper"):
            api.prefill_fn(api.load(state["params"]), batch)
    assert [m.launches for m in kernels] == [0, 0, 0, 0]
