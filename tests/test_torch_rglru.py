"""PyTorch port vs the JAX package: the hybrid (RG-LRU + local attention)
family on the CPU — reduced recurrentgemma-9b with 5 layers (one group of
(rec, rec, attn) and a tail of 2 recurrent layers; d_model 64, 4 heads of
16 over 1 kv head, window 8, which binds at S = 20), f32, with JAX's
parameters carried over by ``repro_torch.convert`` and perturbed (``lam``
starts constant over the channels and ``b_a``/``b_i`` at zero, which would
hide a channel mix-up). The JAX side runs on a 1x1 mesh. On the CPU the
port's prefill scan and prefill attention are the plain versions of the
rglru_scan and flash kernels.

Tolerances (f32): the block-diagonal product and the mixer atol = rtol =
1e-5; logits and every cache leaf atol = rtol = 1e-4 (the same f32 math,
with sums taken in another order, and the prefill recurrence sequential in
the port, an associative scan in JAX); greedy token ids equal; decode after
prefill against a longer prefill 2e-3, as
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
from repro.models import rglru as jrglru  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.convert import params_from_jax_numpy  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.rglru_scan import ops as rg_ops  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import rglru  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from test_torch_model import _perturb  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "recurrentgemma-9b"
N_LAYERS = 5
PERTURB = ("ln", "final_ln", "lam", "b_a", "b_i", "bi", "bo")
F32 = dict(param_dtype="float32", compute_dtype="float32")


def _cfgs():
    return (jax_reduced(jax_get_config(ARCH), n_layers=N_LAYERS),
            reduced(get_config(ARCH), n_layers=N_LAYERS))


def jax_and_port_hybrid_lm():
    """Reduced recurrentgemma-9b in both packages on identical
    parameters."""
    jcfg, cfg = _cfgs()
    japi = jax_build_model(jcfg, JaxParallelConfig(**F32),
                           make_local_mesh(1, 1))
    jparams = _perturb(japi.init(jax.random.key(0)),
                       np.random.default_rng(0), PERTURB)
    api = build_model(cfg, ParallelConfig(**F32), device="cpu")
    params = api.load(params_from_jax_numpy(
        jax.tree.map(np.asarray, jparams), cfg, device="cpu"))
    return japi, jparams, api, params


@pytest.fixture(scope="module")
def lm():
    return jax_and_port_hybrid_lm()


def _tokens(seed, B, S):
    return np.random.default_rng(seed).integers(1, 256, size=(B, S))


def _leaves(tree, path=()):
    """(path, leaf) pairs of a nested dict, in sorted key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], path + (k,))]
    return [(path, tree)]


def _batch_caches(trees, lens, smax):
    """Batch-1 prefill caches (numpy trees) -> one batch: every "k"/"v"
    leaf (n, 1, S_i, Hkv, D) zero-padded into (n, B, smax, Hkv, D) at rows
    [0, S_i), every state leaf concatenated along the batch."""
    def walk(name, leaves):
        if isinstance(leaves[0], dict):
            return {k: walk(k, [t[k] for t in leaves]) for k in leaves[0]}
        if name in ("k", "v"):
            a = leaves[0]
            out = np.zeros((a.shape[0], len(leaves), smax) + a.shape[3:],
                           a.dtype)
            for i, (t, n) in enumerate(zip(leaves, lens)):
                out[:, i, :n] = t[:, 0]
            return out
        return np.concatenate(leaves, axis=1)
    return walk(None, trees)


def test_block_diag_apply_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    w = rng.normal(size=(4, 16, 16)).astype(np.float32)
    b = rng.normal(size=(4, 16)).astype(np.float32)
    jy = jrglru._block_diag_apply(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(b), 4)
    ty = rglru._block_diag_apply(torch.as_tensor(x), torch.as_tensor(w),
                                 torch.as_tensor(b), 4)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-5)
    # block n of the output sees only block n of the input
    xz = x.copy()
    xz[..., 16:32] = 0.0
    tz = rglru._block_diag_apply(torch.as_tensor(xz), torch.as_tensor(w),
                                 torch.as_tensor(b), 4)
    np.testing.assert_array_equal(tz.numpy()[..., 32:], ty.numpy()[..., 32:])


def test_mixer_prefill_and_decode_match_jax(lm):
    """One RG-LRU mixer (the tail's second layer): a prefill of 11 tokens,
    then one decode step on its caches."""
    japi, jparams, api, params = lm
    jp = jax.tree.map(lambda a: a[1], jparams["tail"]["mix"])
    p = api._layer(params["tail"], 1)["mix"]
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 11, 64)).astype(np.float32)
    x1 = rng.normal(size=(2, 1, 64)).astype(np.float32)
    pos = jnp.asarray([11, 11], jnp.int32)
    jy, jc = jax.jit(lambda p_, v: jrglru.rglru_mixer_apply(
        japi._ctx("prefill", None), p_, v))(jp, jnp.asarray(x))
    jy1, jc1 = jax.jit(lambda p_, v, c: jrglru.rglru_mixer_apply(
        japi._ctx("decode", pos), p_, v, c))(jp, jnp.asarray(x1), jc)
    ty, tc = rglru.rglru_mixer_apply(
        T.Ctx(cfg=api.cfg, mode="prefill"), p, torch.as_tensor(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-5)
    assert tc["h"].dtype == torch.float32 and tc["h"].shape == (2, 64)
    assert tc["conv"].shape == (2, 3, 64)
    for n in ("conv", "h"):
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                   atol=1e-5, rtol=1e-5)
    cache = {n: t.clone() for n, t in tc.items()}
    views = dict(cache)
    ty1, tc1 = rglru.rglru_mixer_apply(
        T.Ctx(cfg=api.cfg, mode="decode", positions=torch.tensor([11, 11])),
        p, torch.as_tensor(x1), cache)
    assert all(tc1[n] is views[n] for n in ("conv", "h"))   # in place
    np.testing.assert_allclose(ty1.numpy(), np.asarray(jy1), atol=1e-5,
                               rtol=1e-5)
    for n in ("conv", "h"):
        np.testing.assert_allclose(tc1[n].numpy(), np.asarray(jc1[n]),
                                   atol=1e-5, rtol=1e-5)


def test_prefill_logits_and_caches_match_jax(lm):
    """S = 20 > window 8: the local window binds in the attention layer."""
    japi, jparams, api, params = lm
    tokens = _tokens(3, 2, 20)
    jl, jc = jax.jit(japi.prefill_fn)(
        jparams, {"tokens": jnp.asarray(tokens, jnp.int32)})
    rg_before, fa_before = rg_ops.launches, fa_ops.launches
    tl, tc = api.prefill_fn(params, {"tokens": torch.as_tensor(tokens)})
    assert (rg_ops.launches, fa_ops.launches) == (rg_before, fa_before)
    assert tl.shape == (2, 1, 256) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    jleaves = _leaves(jax.tree.map(np.asarray, jc))
    tleaves = _leaves(tc)
    assert [p for p, _ in tleaves] == [p for p, _ in jleaves]
    assert [p for p, _ in tleaves] == [
        ("groups", "attn2", "k"), ("groups", "attn2", "v"),
        ("groups", "rec0", "conv"), ("groups", "rec0", "h"),
        ("groups", "rec1", "conv"), ("groups", "rec1", "h"),
        ("tail", "conv"), ("tail", "h")]
    assert tc["groups"]["attn2"]["k"].shape == (1, 2, 20, 1, 16)
    assert tc["tail"]["h"].shape == (2, 2, 64)
    assert tc["tail"]["h"].dtype == torch.float32
    for (path, t), (_, j) in zip(tleaves, jleaves):
        assert t.shape == j.shape, path
        np.testing.assert_allclose(t.numpy(), j, **TOL, err_msg=str(path))


def test_decode_steps_on_padded_caches_and_greedy_tokens_match_jax(lm):
    """Two sequences of 20 and 13 tokens prefilled at batch 1, their
    attention caches padded into 32-row buffers and their state caches
    concatenated; then 4 greedy decode steps at positions 20.. and 13..:
    the logits and every cache leaf after them agree, and each side's
    greedy tokens are the other's."""
    japi, jparams, api, params = lm
    lens = (20, 13)
    prompts = [_tokens(4 + i, 1, n) for i, n in enumerate(lens)]
    jpre = [jax.jit(japi.prefill_fn)(jparams, {"tokens": jnp.asarray(
        p, jnp.int32)}) for p in prompts]
    tpre = [api.prefill_fn(params, {"tokens": torch.as_tensor(p)})
            for p in prompts]
    jc = jax.tree.map(jnp.asarray, _batch_caches(
        [jax.tree.map(np.asarray, c) for _, c in jpre], lens, 32))
    tc = L.tree_map(lambda _, a: torch.as_tensor(a), _batch_caches(
        [L.tree_map(lambda _, t: t.numpy(), c) for _, c in tpre], lens, 32))
    jtok = np.concatenate([np.asarray(jnp.argmax(lg[:, -1], -1))[:, None]
                           for lg, _ in jpre])
    ttok = torch.cat([lg[:, -1].argmax(-1, keepdim=True) for lg, _ in tpre])
    np.testing.assert_array_equal(ttok.numpy(), jtok)
    jdecode = jax.jit(japi.decode_fn)
    for step in range(4):
        pos = np.asarray(lens) + step
        jl, jc = jdecode(jparams, jc, jnp.asarray(jtok, jnp.int32),
                         jnp.asarray(pos, jnp.int32))
        tl, tc = api.decode_fn(params, tc, ttok, torch.as_tensor(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        jtok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None]
        ttok = tl[:, -1].argmax(-1, keepdim=True)
        np.testing.assert_array_equal(ttok.numpy(), jtok)
    for (path, t), (_, j) in zip(_leaves(tc),
                                 _leaves(jax.tree.map(np.asarray, jc))):
        np.testing.assert_allclose(t.numpy(), j, **TOL, err_msg=str(path))
    # the padding past each sequence's last written row stays zero
    k = tc["groups"]["attn2"]["k"]
    assert float(k[:, 0, 24:].abs().sum()) == 0.0
    assert float(k[:, 1, 17:].abs().sum()) == 0.0


def test_decode_matches_prefill():
    """The port's counterpart of test_decode_matches_prefill for the
    hybrid: decode(t_S) after prefill(t_0..S-1), on attention caches padded
    by 8 rows, gives prefill(t_0..S)'s last logits, on the port's own
    random parameters."""
    _, cfg = _cfgs()
    api = build_model(cfg, ParallelConfig(**F32), device="cpu")
    params = api.init(seed=2)
    B, S = 2, 16
    toks = torch.as_tensor(_tokens(0, B, S + 1))
    _, cache = api.prefill_fn(params, {"tokens": toks[:, :S]})
    cache = L.tree_map(lambda path, a: torch.cat(
        [a, a.new_zeros(a.shape[:2] + (8,) + a.shape[3:])], dim=2)
        if path[-1] in ("k", "v") else a, cache)
    logits_b, _ = api.decode_fn(params, cache, toks[:, S:S + 1],
                                torch.full((B,), S))
    logits_full, _ = api.prefill_fn(params, {"tokens": toks})
    np.testing.assert_allclose(logits_b[:, -1].numpy(),
                               logits_full[:, -1].numpy(), atol=2e-3,
                               rtol=2e-3)


def test_convert_carries_a_jax_hybrid_tree():
    jcfg, cfg = _cfgs()
    japi = jax_build_model(jcfg, JaxParallelConfig(param_dtype="float32"),
                           make_local_mesh(1, 1))
    tree = jax.tree.map(np.asarray, japi.init(jax.random.key(4)))
    params = params_from_jax_numpy(tree, cfg, device="cpu")
    tleaves, jleaves = _leaves(params), _leaves(tree)
    assert [p for p, _ in tleaves] == [p for p, _ in jleaves]
    for (path, t), (_, a) in zip(tleaves, jleaves):
        assert t.dtype == torch.float32 and tuple(t.shape) == a.shape, path
        np.testing.assert_array_equal(t.numpy(), a)
    assert set(params) == {"embed", "final_ln", "groups", "lm_head", "tail"}
    assert params["groups"]["rec0"]["mix"]["w_a"].shape == (1, 4, 16, 16)
    assert params["tail"]["mix"]["conv"].shape == (2, 4, 64)
    assert params["groups"]["attn2"]["attn"]["wk"].shape == (1, 64, 16)
    mix = {k: v for k, v in tree["groups"]["rec0"]["mix"].items()
           if k != "lam"}
    broken = dict(tree, groups=dict(tree["groups"], rec0=dict(
        tree["groups"]["rec0"], mix=mix)))
    with pytest.raises(ValueError, match="groups/rec0/mix"):
        params_from_jax_numpy(broken, cfg, device="cpu")
    with pytest.raises(ValueError, match="tail"):
        params_from_jax_numpy({k: v for k, v in tree.items() if k != "tail"},
                              cfg, device="cpu")


@pytest.mark.parametrize("S", [1, 2, 7, 8, 33, 257, 4096])
@pytest.mark.parametrize("with_h0", [False, True])
def test_train_scan_matches_jax_associative_scan(S, with_h0):
    """The train-mode recurrence (``_rglru_assoc_scan``: JAX's
    associative scan, log depth) against JAX's ``_rglru_scan`` at the
    mixer's 1e-5, ragged lengths and h0 included, at recurrentgemma-9b's
    decay scale (log_a down to -8 softplus(1) a step)."""
    rng = np.random.default_rng(S + with_h0)
    la = (-8 * np.log1p(np.e) * rng.uniform(size=(2, S, 6))).astype(
        np.float32)
    gx = rng.normal(size=(2, S, 6)).astype(np.float32)
    h0 = rng.normal(size=(2, 6)).astype(np.float32) if with_h0 else None
    jy, jl = jrglru._rglru_scan(jnp.asarray(la), jnp.asarray(gx),
                                None if h0 is None else jnp.asarray(h0))
    ty, tl = rglru._rglru_assoc_scan(torch.tensor(la), torch.tensor(gx),
                                     None if h0 is None else torch.tensor(h0))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                               rtol=1e-5)


def test_train_scan_gradients_match_the_loop():
    """Autograd through the associative scan gives the per-step loop's
    gradients (log_a, gx and h0)."""
    g = torch.Generator().manual_seed(0)
    la = -torch.rand(2, 37, 5, generator=g) * 3
    gx = torch.randn(2, 37, 5, generator=g)
    h0 = torch.randn(2, 5, generator=g)
    w = torch.randn(2, 37, 5, generator=g)
    grads = []
    for scan in (rglru._rglru_assoc_scan, rglru._rglru_scan):
        args = [t.clone().requires_grad_() for t in (la, gx, h0)]
        y, last = scan(*args)
        ((y * w).sum() + last.sum()).backward()
        grads.append([a.grad for a in args])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                   rtol=1e-5)
