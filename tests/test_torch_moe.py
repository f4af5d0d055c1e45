"""PyTorch port vs the JAX package: the MoE layer and the MoE LM (reduced
olmoe-1b-7b: 4 experts, top-2, GQA group 2, 2 layers) on the CPU, with
JAX's parameters carried over by ``repro_torch.convert``. The JAX side runs
on a 1x1 mesh, where every JAX MoE path is ``_moe_dense_fallback``.

Tolerances (f32): routing ids and ranks equal, weights and losses 1e-6;
the MoE layer atol = rtol = 1e-5; logits and caches 1e-4 (both run the
same f32 math, with sums taken in another order); greedy token ids equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.configs.base import MoEConfig as JaxMoEConfig  # noqa: E402
from repro.configs.base import ParallelConfig as JaxParallelConfig  # noqa: E402
from repro.launch.mesh import make_local_mesh  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JaxServingEngine  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import MoEConfig, ParallelConfig  # noqa: E402
from repro_torch.convert import params_from_jax_numpy  # noqa: E402
from repro_torch.kernels.moe_gmm import ops as gmm_ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from test_torch_model import _perturb  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "olmoe-1b-7b"


def jax_and_port_moe_lm():
    """Reduced olmoe-1b-7b in both packages on identical parameters."""
    jcfg = jax_reduced(jax_get_config(ARCH))
    japi = jax_build_model(
        jcfg, JaxParallelConfig(param_dtype="float32",
                                compute_dtype="float32",
                                q_block=8, kv_block=8), make_local_mesh(1, 1))
    jparams = _perturb(japi.init(jax.random.key(0)),
                       np.random.default_rng(0))
    cfg = reduced(get_config(ARCH))
    api = build_model(cfg, ParallelConfig(param_dtype="float32",
                                          compute_dtype="float32"),
                      device="cpu")
    params = api.load(params_from_jax_numpy(
        jax.tree.map(np.asarray, jparams), cfg, device="cpu"))
    return japi, jparams, api, params


@pytest.fixture(scope="module")
def lm():
    return jax_and_port_moe_lm()


# --------------------------------------------------------------------------
# Routing and the MoE layer
# --------------------------------------------------------------------------
def _layer_inputs(seed, T, D, E, F):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, D)).astype(np.float32)
    p = {"router": rng.normal(size=(D, E)).astype(np.float32) / D ** 0.5,
         "wg": rng.normal(size=(E, D, F)).astype(np.float32) / D ** 0.5,
         "wu": rng.normal(size=(E, D, F)).astype(np.float32) / D ** 0.5,
         "wd": rng.normal(size=(E, F, D)).astype(np.float32) / F ** 0.5}
    return x, p


def test_routing_pieces_match_jax():
    T, D, E, k = 64, 32, 8, 2
    x, p = _layer_inputs(0, T, D, E, 16)
    jw, je, jp = jmoe._topk_route(jnp.asarray(x), jnp.asarray(p["router"]), k)
    tw, te, tp = moe._topk_route(torch.as_tensor(x),
                                 torch.as_tensor(p["router"]), k)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6)
    flat = np.array(je).reshape(-1)
    jranks = jmoe._positions_in_expert(jnp.asarray(flat), E)
    tranks = moe._positions_in_expert(torch.as_tensor(flat).long(), E)
    np.testing.assert_array_equal(tranks.numpy(), np.asarray(jranks))
    jaux = jmoe.aux_losses(jp, je, E)
    taux = moe.aux_losses(tp, te, E)
    for name in ("load_balance", "router_z"):
        np.testing.assert_allclose(taux[name].item(), float(jaux[name]),
                                   atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("drop", [False, True])
def test_dense_fallback_matches_jax(drop):
    """The single-device MoE layer, with and without dropped pairs. The
    dropping case biases the router so that every token picks expert 0
    first: 64 pairs against a capacity of 24."""
    cfg = reduced(get_config(ARCH), d_model=32, d_ff=16,
                  moe=MoEConfig(n_experts=8, top_k=2, capacity_factor=1.25))
    jcfg = jax_reduced(jax_get_config(ARCH), d_model=32, d_ff=16,
                       moe=JaxMoEConfig(n_experts=8, top_k=2,
                                        capacity_factor=1.25))
    T, E, k = 64, 8, 2
    x, p = _layer_inputs(1, T, 32, E, 16)
    if drop:
        x[:, 0] = 4.0
        p["router"][0, 0] = 3.0
    te = moe._topk_route(torch.as_tensor(x), torch.as_tensor(p["router"]),
                         k)[1]
    ranks = moe._positions_in_expert(te.reshape(-1), E)
    cap = moe._capacity(T, k, E, 1.25)
    assert cap == 24
    assert bool((ranks >= cap).any()) == drop
    jy, jlb, jrz = jmoe._moe_dense_fallback(
        jcfg, {n: jnp.asarray(a) for n, a in p.items()},
        jnp.asarray(x)[None])
    ty, tlb, trz = moe._moe_dense_fallback(
        cfg, {n: torch.as_tensor(a) for n, a in p.items()},
        torch.as_tensor(x)[None])
    assert ty.shape == (1, T, 32)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tlb.item(), float(jlb), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(trz.item(), float(jrz), atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------------------
# The MoE LM
# --------------------------------------------------------------------------
def test_prefill_logits_and_cache_match_jax(lm):
    japi, jparams, api, params = lm
    tokens = np.random.default_rng(1).integers(1, 256, size=(2, 12))
    jl, jc = jax.jit(japi.prefill_fn)(
        jparams, {"tokens": jnp.asarray(tokens, jnp.int32)})
    before = gmm_ops.launches
    tl, tc = api.prefill_fn(params, {"tokens": torch.as_tensor(tokens)})
    assert gmm_ops.launches == before
    assert tl.shape == (2, 1, 256) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name in ("k", "v"):
        assert tc[name].shape == (2, 2, 12, 2, 16)
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **TOL)


def test_decode_at_per_slot_positions_matches_jax(lm):
    """Prefill two sequences of 12 tokens into a 32-slot cache, then decode
    3 steps with the slots at different positions (12 and 7: slot 1
    overwrites its cache from position 7 on)."""
    japi, jparams, api, params = lm
    B, S_p, S = 2, 12, 32
    tokens = np.random.default_rng(2).integers(1, 256, size=(B, S_p))
    _, jc = jax.jit(japi.prefill_fn)(
        jparams, {"tokens": jnp.asarray(tokens, jnp.int32)})
    _, tc = api.prefill_fn(params, {"tokens": torch.as_tensor(tokens)})
    jcache = {n: jnp.zeros(jc[n].shape[:2] + (S,) + jc[n].shape[3:],
                           jnp.float32).at[:, :, :S_p].set(jc[n])
              for n in ("k", "v")}
    tcache = {n: torch.zeros(tc[n].shape[:2] + (S,) + tc[n].shape[3:])
              for n in ("k", "v")}
    for n in ("k", "v"):
        tcache[n][:, :, :S_p] = tc[n]
    jdecode = jax.jit(japi.decode_fn)
    nxt = np.array([[5], [17]])
    for step in range(3):
        pos = np.array([S_p + step, 7 + step])
        jl, jcache = jdecode(jparams, jcache, jnp.asarray(nxt, jnp.int32),
                             jnp.asarray(pos, jnp.int32))
        tl, tcache = api.decode_fn(params, tcache, torch.as_tensor(nxt),
                                   torch.as_tensor(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None]
        np.testing.assert_array_equal(tl[:, -1].argmax(-1).numpy(), nxt[:, 0])
    for n in ("k", "v"):
        np.testing.assert_allclose(tcache[n].numpy(),
                                   np.asarray(jcache[n]), **TOL)


def test_engine_matches_jax_engine(lm):
    """3 requests (prompts of 16, 9 and 23 tokens, 6 new tokens each) on 2
    slots: the port's engine gives the JAX engine's token ids."""
    japi, jparams, api, params = lm
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, api.cfg.vocab_size, size=(n,))
               .astype(np.int32) for n in (16, 9, 23)]
    jeng = JaxServingEngine(japi, jparams, max_batch=2, max_seq=64)
    jreqs = [JaxRequest(rid=i, prompt=p, max_new=6)
             for i, p in enumerate(prompts)]
    jeng.run_until_done(jreqs, max_steps=100)
    engine = ServingEngine(api, params, max_batch=2, max_seq=64)
    reqs = [Request(rid=i, prompt=p, max_new=6)
            for i, p in enumerate(prompts)]
    engine.run_until_done(reqs, max_steps=100)
    assert all(r.done and len(r.out) == 6 for r in reqs)
    assert [r.out for r in reqs] == [r.out for r in jreqs]


def test_convert_carries_a_jax_moe_tree():
    cfg = reduced(get_config(ARCH))
    japi = jax_build_model(jax_reduced(jax_get_config(ARCH)),
                           JaxParallelConfig(param_dtype="float32"),
                           make_local_mesh(1, 1))
    tree = jax.tree.map(np.asarray, japi.init(jax.random.key(4)))
    params = params_from_jax_numpy(tree, cfg, device="cpu")
    for name in ("ln", "router", "wg", "wu", "wd"):
        a = tree["blocks"]["moe"][name]
        t = params["blocks"]["moe"][name]
        assert t.dtype == torch.float32 and tuple(t.shape) == a.shape
        np.testing.assert_array_equal(t.numpy(), a)
    assert params["blocks"]["moe"]["wg"].shape == (2, 4, 64, 64)
    blocks = dict(tree["blocks"], moe={k: v for k, v in
                                       tree["blocks"]["moe"].items()
                                       if k != "router"})
    with pytest.raises(ValueError, match="moe"):
        params_from_jax_numpy(dict(tree, blocks=blocks), cfg, device="cpu")


def test_serve_main_olmoe_on_cpu_finishes_requests():
    # 6 requests of 16 tokens on 4 slots take 30 decode quanta of the
    # 10 ms period (0.35 s on an idle CPU); 2 s leaves room for a busy one
    res = serve.main(["--arch", ARCH, "--device", "cpu", "--duration",
                      "2.0"])
    assert res["api"].cfg.family == "moe"
    assert all(r.done and len(r.out) == 16 for r in res["requests"])
