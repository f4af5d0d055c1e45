"""PyTorch port vs the JAX package: the dense LM (reduced qwen2-7b) on the
CPU, with JAX's parameters carried over by ``repro_torch.convert``.

Tolerance: f32, atol = rtol = 1e-4 — both run the same f32 math, but the
sums are taken in another order. Greedy token ids must be equal.
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
from repro.models.model import build_model as jax_build_model  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.convert import params_from_jax_numpy  # noqa: E402
from repro_torch.models.layers import count_params  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
# leaves that JAX initializes to ones/zeros: perturbed so that the biases
# and norm weights are exercised too
PERTURB = ("ln", "bq", "bk", "bv", "final_ln")


def _perturb(tree, rng, keys=PERTURB):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng, keys)
        elif k in keys:
            out[k] = v + jnp.asarray(0.1 * rng.normal(size=v.shape), v.dtype)
        else:
            out[k] = v
    return out


def jax_and_port_lm():
    """Reduced qwen2-7b in both packages on identical parameters."""
    jcfg = jax_reduced(jax_get_config("qwen2-7b"))
    japi = jax_build_model(
        jcfg, JaxParallelConfig(param_dtype="float32",
                                compute_dtype="float32",
                                q_block=8, kv_block=8), make_local_mesh(1, 1))
    jparams = _perturb(japi.init(jax.random.key(0)),
                       np.random.default_rng(0))
    cfg = reduced(get_config("qwen2-7b"))
    api = build_model(cfg, ParallelConfig(param_dtype="float32",
                                          compute_dtype="float32"),
                      device="cpu")
    params = api.load(params_from_jax_numpy(
        jax.tree.map(np.asarray, jparams), cfg, device="cpu"))
    return japi, jparams, api, params


@pytest.fixture(scope="module")
def lm():
    return jax_and_port_lm()


def test_prefill_logits_and_cache_match_jax(lm):
    japi, jparams, api, params = lm
    tokens = np.random.default_rng(1).integers(1, 256, size=(2, 12))
    jl, jc = jax.jit(japi.prefill_fn)(
        jparams, {"tokens": jnp.asarray(tokens, jnp.int32)})
    tl, tc = api.prefill_fn(params, {"tokens": torch.as_tensor(tokens)})
    assert tl.shape == (2, 1, 256) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name in ("k", "v"):
        assert tc[name].shape == (2, 2, 12, 2, 16)
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **TOL)


def test_decode_steps_match_jax(lm):
    """Prefill, then 4 greedy decode steps against a 32-slot cache: the
    logits agree at every step and the greedy ids are equal."""
    japi, jparams, api, params = lm
    B, S_p, S = 2, 9, 32
    tokens = np.random.default_rng(2).integers(1, 256, size=(B, S_p))
    jl, jc = jax.jit(japi.prefill_fn)(
        jparams, {"tokens": jnp.asarray(tokens, jnp.int32)})
    tl, tc = api.prefill_fn(params, {"tokens": torch.as_tensor(tokens)})
    jcache = {n: jnp.zeros(jc[n].shape[:2] + (S,) + jc[n].shape[3:],
                           jnp.float32).at[:, :, :S_p].set(jc[n])
              for n in ("k", "v")}
    tcache = {n: torch.zeros(tc[n].shape[:2] + (S,) + tc[n].shape[3:])
              for n in ("k", "v")}
    for n in ("k", "v"):
        tcache[n][:, :, :S_p] = tc[n]
    jdecode = jax.jit(japi.decode_fn)
    jnext = np.asarray(jnp.argmax(jl[:, -1], -1))
    tnext = tl[:, -1].argmax(-1).numpy()
    np.testing.assert_array_equal(tnext, jnext)
    for step in range(4):
        pos = np.full((B,), S_p + step)
        jl, jcache = jdecode(jparams, jcache,
                             jnp.asarray(jnext[:, None], jnp.int32),
                             jnp.asarray(pos, jnp.int32))
        tl, tcache = api.decode_fn(params, tcache,
                                   torch.as_tensor(tnext[:, None]),
                                   torch.as_tensor(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        jnext = np.asarray(jnp.argmax(jl[:, -1], -1))
        tnext = tl[:, -1].argmax(-1).numpy()
        np.testing.assert_array_equal(tnext, jnext)
    for n in ("k", "v"):
        np.testing.assert_allclose(tcache[n].numpy(),
                                   np.asarray(jcache[n]), **TOL)


def test_init_draws_jax_scale_on_device_from_seed():
    cfg = reduced(get_config("qwen2-7b"))
    api = build_model(cfg, ParallelConfig(param_dtype="float32",
                                          compute_dtype="float32"),
                      device="cpu")
    a, b = api.init(seed=3), api.init(seed=3)
    wq = a["blocks"]["attn"]["wq"]
    assert wq.shape == (cfg.n_layers, cfg.d_model, cfg.q_dim)
    assert torch.equal(wq, b["blocks"]["attn"]["wq"])
    # scale / sqrt(shape[-2]), as repro.models.layers._init_one
    assert abs(wq.std().item() * cfg.d_model ** 0.5 - 1.0) < 0.05
    assert torch.all(a["blocks"]["attn"]["ln"] == 1)
    assert torch.all(a["blocks"]["attn"]["bq"] == 0)
    assert count_params(a) == api.n_params() == cfg.n_params()


def test_convert_checks_tree_and_moves_bfloat16_bits():
    cfg = reduced(get_config("qwen2-7b"))
    jcfg = jax_reduced(jax_get_config("qwen2-7b"))
    japi = jax_build_model(
        jcfg, JaxParallelConfig(param_dtype="bfloat16"), make_local_mesh(1, 1))
    tree = jax.tree.map(np.asarray, japi.init(jax.random.key(1)))
    params = params_from_jax_numpy(tree, cfg, device="cpu")
    wq = params["blocks"]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        wq.view(torch.int16).numpy(),
        tree["blocks"]["attn"]["wq"].view(np.int16))
    bad = dict(tree, embed=tree["embed"][:, :8])
    with pytest.raises(ValueError, match="embed"):
        params_from_jax_numpy(bad, cfg, device="cpu")
    missing = {k: v for k, v in tree.items() if k != "lm_head"}
    with pytest.raises(ValueError, match="keys"):
        params_from_jax_numpy(missing, cfg, device="cpu")
