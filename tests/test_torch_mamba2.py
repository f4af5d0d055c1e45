"""PyTorch port vs the JAX package: the Mamba2 (SSM) family on the CPU —
reduced mamba2-1.3b (2 layers, d_model 64, 8 heads of P = 16, N = 16,
chunk 8), f32, with JAX's parameters carried over by ``repro_torch.convert``
and perturbed (``A_log``, ``dt_bias`` and ``D_skip`` start constant per
head, which would hide a head-index mix-up). The JAX side runs on a 1x1
mesh. On the CPU the port's prefill scan is the plain version of the
ssd_scan kernel.

Tolerances (f32): the causal conv 1e-6; the block atol = rtol = 1e-5;
logits and all four cache leaves atol = rtol = 1e-4 (both run the same f32
math, with sums taken in another order); greedy token ids equal; decode
after prefill against a longer prefill 2e-3, as
``tests/test_models_smoke.py::test_decode_matches_prefill``.
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
from repro.models import mamba2 as jmamba2  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.convert import params_from_jax_numpy  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.models import mamba2  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from test_torch_model import _perturb  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "mamba2-1.3b"
PERTURB = ("ln", "final_ln", "gn", "A_log", "dt_bias", "D_skip")
CACHES = ("conv_x", "conv_B", "conv_C", "h")
F32 = dict(param_dtype="float32", compute_dtype="float32")


def jax_and_port_ssm_lm():
    """Reduced mamba2-1.3b in both packages on identical parameters."""
    japi = jax_build_model(jax_reduced(jax_get_config(ARCH)),
                           JaxParallelConfig(**F32), make_local_mesh(1, 1))
    jparams = _perturb(japi.init(jax.random.key(0)),
                       np.random.default_rng(0), PERTURB)
    cfg = reduced(get_config(ARCH))
    api = build_model(cfg, ParallelConfig(**F32), device="cpu")
    params = api.load(params_from_jax_numpy(
        jax.tree.map(np.asarray, jparams), cfg, device="cpu"))
    return japi, jparams, api, params


@pytest.fixture(scope="module")
def lm():
    return jax_and_port_ssm_lm()


def _tokens(seed, B, S):
    return np.random.default_rng(seed).integers(1, 256, size=(B, S))


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32)
    st = rng.normal(size=(2, 3, 12)).astype(np.float32) if with_state \
        else None
    jy, jst = jmamba2._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                   None if st is None else jnp.asarray(st))
    ty, tst = mamba2._causal_conv(torch.as_tensor(x), torch.as_tensor(w),
                                  None if st is None else torch.as_tensor(st))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-6)
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst), atol=1e-6)


def test_block_prefill_and_decode_match_jax(lm):
    """One SSM block: a prefill of 11 tokens (two chunks of 8, the second
    ragged), then one decode step on its caches."""
    japi, jparams, api, params = lm
    jblk = jax.tree.map(lambda a: a[1], jparams["blocks"])
    blk = api._layer(params["blocks"], 1)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 11, 64)).astype(np.float32)
    x1 = rng.normal(size=(2, 1, 64)).astype(np.float32)
    pos = jnp.asarray([11, 11], jnp.int32)
    jy, jc = jax.jit(lambda p, v: jmamba2.ssm_block_apply(
        japi._ctx("prefill", None), p, v))(jblk, jnp.asarray(x))
    jy1, jc1 = jax.jit(lambda p, v, c: jmamba2.ssm_block_apply(
        japi._ctx("decode", pos), p, v, c))(jblk, jnp.asarray(x1), jc)
    ty, tc = mamba2.ssm_block_apply(
        T.Ctx(cfg=api.cfg, mode="prefill"), blk, torch.as_tensor(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-5)
    assert tc["h"].dtype == torch.float32 and tc["h"].shape == (2, 8, 16, 16)
    for n in CACHES:
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                   atol=1e-5, rtol=1e-5)
    cache = {n: t.clone() for n, t in tc.items()}
    views = dict(cache)
    ty1, tc1 = mamba2.ssm_block_apply(
        T.Ctx(cfg=api.cfg, mode="decode", positions=torch.tensor([11, 11])),
        blk, torch.as_tensor(x1), cache)
    assert all(tc1[n] is views[n] for n in CACHES)       # updated in place
    np.testing.assert_allclose(ty1.numpy(), np.asarray(jy1), atol=1e-5,
                               rtol=1e-5)
    for n in CACHES:
        np.testing.assert_allclose(tc1[n].numpy(), np.asarray(jc1[n]),
                                   atol=1e-5, rtol=1e-5)


def test_prefill_logits_and_caches_match_jax(lm):
    japi, jparams, api, params = lm
    tokens = _tokens(3, 2, 13)
    jl, jc = jax.jit(japi.prefill_fn)(
        jparams, {"tokens": jnp.asarray(tokens, jnp.int32)})
    before = ssd_ops.launches
    tl, tc = api.prefill_fn(params, {"tokens": torch.as_tensor(tokens)})
    assert ssd_ops.launches == before             # the CPU never launches
    assert tl.shape == (2, 1, 256) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert set(tc) == set(CACHES)
    assert tc["h"].shape == (2, 2, 8, 16, 16)
    assert tc["conv_x"].shape == (2, 2, 3, 128)
    for n in CACHES:
        assert tc[n].shape == jc[n].shape
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]), **TOL)


def test_decode_steps_and_greedy_tokens_match_jax(lm):
    """Prefill 2 sequences of 10 tokens, then 4 greedy decode steps: the
    logits and all four cache leaves after them agree, and each side's
    greedy tokens are the other's."""
    japi, jparams, api, params = lm
    tokens = _tokens(4, 2, 10)
    jl, jc = jax.jit(japi.prefill_fn)(
        jparams, {"tokens": jnp.asarray(tokens, jnp.int32)})
    tl, tc = api.prefill_fn(params, {"tokens": torch.as_tensor(tokens)})
    jdecode = jax.jit(japi.decode_fn)
    jtok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None]
    ttok = tl[:, -1].argmax(-1, keepdim=True)
    np.testing.assert_array_equal(ttok.numpy(), jtok)
    for step in range(4):
        pos = np.full((2,), 10 + step)
        jl, jc = jdecode(jparams, jc, jnp.asarray(jtok, jnp.int32),
                         jnp.asarray(pos, jnp.int32))
        tl, tc = api.decode_fn(params, tc, ttok, torch.as_tensor(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        jtok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None]
        ttok = tl[:, -1].argmax(-1, keepdim=True)
        np.testing.assert_array_equal(ttok.numpy(), jtok)
    for n in CACHES:
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]), **TOL)


def test_decode_matches_prefill():
    """The port's counterpart of test_decode_matches_prefill for mamba2:
    decode(t_S) after prefill(t_0..S-1) gives prefill(t_0..S)'s last
    logits, on the port's own random parameters."""
    cfg = reduced(get_config(ARCH))
    api = build_model(cfg, ParallelConfig(**F32), device="cpu")
    params = api.init(seed=2)
    B, S = 2, 16
    toks = torch.as_tensor(_tokens(0, B, S + 1))
    _, cache = api.prefill_fn(params, {"tokens": toks[:, :S]})
    logits_b, _ = api.decode_fn(params, cache, toks[:, S:S + 1],
                                torch.full((B,), S))
    logits_full, _ = api.prefill_fn(params, {"tokens": toks})
    np.testing.assert_allclose(logits_b[:, -1].numpy(),
                               logits_full[:, -1].numpy(), atol=2e-3,
                               rtol=2e-3)


def test_convert_carries_a_jax_mamba2_tree():
    cfg = reduced(get_config(ARCH))
    japi = jax_build_model(jax_reduced(jax_get_config(ARCH)),
                           JaxParallelConfig(param_dtype="float32"),
                           make_local_mesh(1, 1))
    tree = jax.tree.map(np.asarray, japi.init(jax.random.key(4)))
    params = params_from_jax_numpy(tree, cfg, device="cpu")
    names = ("ln", "in_x", "in_z", "in_B", "in_C", "in_dt", "conv_x",
             "conv_B", "conv_C", "dt_bias", "A_log", "D_skip", "gn", "out")
    assert set(params["blocks"]) == set(names)
    for name in names:
        a = tree["blocks"][name]
        t = params["blocks"][name]
        assert t.dtype == torch.float32 and tuple(t.shape) == a.shape
        np.testing.assert_array_equal(t.numpy(), a)
    assert params["blocks"]["conv_x"].shape == (2, 4, 128)
    assert params["blocks"]["in_dt"].shape == (2, 64, 8)
    assert "lm_head" not in params                  # tied embeddings
    blocks = {k: v for k, v in tree["blocks"].items() if k != "A_log"}
    with pytest.raises(ValueError, match="blocks"):
        params_from_jax_numpy(dict(tree, blocks=blocks), cfg, device="cpu")
