"""PyTorch port vs the JAX package: the vlm family (reduced internvl2-1b:
2 layers, d 64, 4 patch positions) on the CPU, with JAX's parameters
carried over by ``repro_torch.convert``.

Tolerances: f32, atol = rtol = 1e-4 for logits and caches (the same f32
math, sums in another order); greedy ids equal; train as
``tests/test_torch_train.py`` (loss rtol 1e-5, every gradient leaf within
1e-4 of its largest |g|); decode after a prefill against a
one-token-longer prefill within 2e-3, as ``tests/test_models_smoke.py``;
the flash wrapper's CPU path against the Pallas kernel in interpret mode
at the repo's 2e-5 (f32) / 3e-2 (bf16).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import ParallelConfig as JaxParallelConfig  # noqa: E402
from repro.data.pipeline import DataConfig as JaxDataConfig  # noqa: E402
from repro.data.pipeline import TokenSource as JaxTokenSource  # noqa: E402
from repro.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention as jax_flash)
from repro.launch.mesh import make_local_mesh  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402

from _torch_jax_models import (LOSS_RTOL, TOL, assert_grads_close,  # noqa: E402
                               assert_trees_close, def_shapes, grow_kv,
                               jax_def_shapes, lm_batch, pair, stub_inputs,
                               to_jax, to_torch)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.convert import params_from_jax_numpy  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenSource  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.training.step import loss_and_grads  # noqa: E402

ARCH = "internvl2-1b"


@pytest.fixture(scope="module")
def models():
    return pair(ARCH)


def _prompt(seed, B, S, cfg):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(1, cfg.vocab_size,
                                    size=(B, S)).astype(np.int32)}
    batch.update(stub_inputs(cfg, B, seed + 100))
    return batch


def test_prefill_logits_and_caches_match_jax(models):
    japi, jparams, api, params = models
    cfg = api.cfg
    batch = _prompt(1, 2, 12, cfg)
    jl, jc = jax.jit(japi.prefill_fn)(jparams, to_jax(batch))
    tl, tc = api.prefill_fn(params, to_torch(batch))
    assert tl.shape == (2, 1, cfg.vocab_size) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert sorted(tc) == ["k", "v"]
    assert tc["k"].shape == (cfg.n_layers, 2, 12, cfg.n_kv_heads,
                             cfg.head_dim)
    assert_trees_close(tc, jc, **TOL)


def test_decode_steps_match_jax(models):
    """Prefill, then 4 greedy decode steps (tokens only, as in JAX)
    against a 32-row cache: logits, greedy ids and the caches after."""
    japi, jparams, api, params = models
    B, S_p, S = 2, 9, 32
    batch = _prompt(2, B, S_p, api.cfg)
    jl, jc = jax.jit(japi.prefill_fn)(jparams, to_jax(batch))
    tl, tc = api.prefill_fn(params, to_torch(batch))
    jc, tc = grow_kv(jc, S, jnp), grow_kv(tc, S, torch)
    jdecode = jax.jit(japi.decode_fn)
    jnext = np.asarray(jnp.argmax(jl[:, -1], -1))
    tnext = tl[:, -1].argmax(-1).numpy()
    np.testing.assert_array_equal(tnext, jnext)
    for step in range(4):
        pos = np.full((B,), S_p + step)
        jl, jc = jdecode(jparams, jc, jnp.asarray(jnext[:, None], jnp.int32),
                         jnp.asarray(pos, jnp.int32))
        tl, tc = api.decode_fn(params, tc, torch.as_tensor(tnext[:, None]),
                               torch.as_tensor(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        jnext = np.asarray(jnp.argmax(jl[:, -1], -1))
        tnext = tl[:, -1].argmax(-1).numpy()
        np.testing.assert_array_equal(tnext, jnext)
    assert_trees_close(tc, jc, **TOL)


def test_decode_after_prefill_matches_longer_prefill(models):
    """decode(t_S) after prefill(t_0..S-1) equals prefill(t_0..S) at the
    last position (tests/test_models_smoke.py's check, port against
    port)."""
    _, _, api, params = models
    S = 16
    full = _prompt(4, 2, S + 1, api.cfg)
    head = dict(full, tokens=full["tokens"][:, :S])
    _, caches = api.prefill_fn(params, to_torch(head))
    got, _ = api.decode_fn(params, grow_kv(caches, 24, torch),
                           torch.as_tensor(full["tokens"][:, S:]),
                           torch.full((2,), S))
    want, _ = api.prefill_fn(params, to_torch(full))
    np.testing.assert_allclose(got[:, -1].numpy(), want[:, -1].numpy(),
                               atol=2e-3, rtol=2e-3)


def test_patches_replace_the_first_positions(models):
    """The patch positions' tokens do not matter; the patches do; a prompt
    shorter than the patch positions raises."""
    _, _, api, params = models
    nv = api.cfg.n_vision_tokens
    batch = _prompt(5, 2, 10, api.cfg)
    a, _ = api.prefill_fn(params, to_torch(batch))
    other = dict(batch, tokens=batch["tokens"].copy())
    other["tokens"][:, :nv] = 3
    b, _ = api.prefill_fn(params, to_torch(other))
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    other["patches"] = batch["patches"] * -5.0
    c, _ = api.prefill_fn(params, to_torch(other))
    assert np.abs(a.numpy() - c.numpy()).max() > 1e-4
    short = dict(batch, tokens=batch["tokens"][:, :nv - 1])
    with pytest.raises(ValueError, match="patch positions"):
        api.prefill_fn(params, to_torch(short))


@pytest.mark.parametrize("fused", [False, True], ids=["xent", "fused_xent"])
def test_loss_and_grads_match_jax(fused):
    """jax.value_and_grad(api.loss_fn) on a 1x1 mesh against the port's
    loss and autograd, the patch positions' labels masked."""
    japi, jparams, api, params = pair(ARCH, fused_xent=fused)
    batch = dict(lm_batch(1, 2, 12, api.cfg.vocab_size),
                 **stub_inputs(api.cfg, 2, 7))
    batch["labels"][:, :api.cfg.n_vision_tokens] = -100
    (jl, jm), jg = jax.jit(jax.value_and_grad(japi.loss_fn, has_aux=True))(
        jparams, to_jax(batch))
    tl, tm, tg = loss_and_grads(api, params, to_torch(batch))
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    assert set(tm) == set(jm)
    assert int(tm["tokens"]) == int(jm["tokens"])
    assert_grads_close(tg, jg)


def test_patches_change_the_loss(models):
    _, _, api, params = models
    batch = dict(lm_batch(2, 2, 12, api.cfg.vocab_size),
                 **stub_inputs(api.cfg, 2, 8))
    a = float(api.loss_fn(params, to_torch(batch))[0])
    batch["patches"] = batch["patches"] * -5.0
    b = float(api.loss_fn(params, to_torch(batch))[0])
    assert np.isfinite(a) and np.isfinite(b) and abs(a - b) > 1e-4


def test_token_source_batch_through_loss_fn(models):
    """The port's TokenSource (with patches, their labels masked) equals
    JAX's, and its batch gives JAX's loss."""
    japi, jparams, api, params = models
    cfg = api.cfg
    kw = dict(seq_len=12, global_batch=2, vocab_size=cfg.vocab_size,
              d_model=cfg.d_model, n_vision_tokens=cfg.n_vision_tokens)
    batch = TokenSource(DataConfig(**kw)).train_batch(3)
    jbatch = JaxTokenSource(JaxDataConfig(**kw)).train_batch(3)
    assert sorted(batch) == ["labels", "patches", "tokens"]
    assert (batch["labels"][:, :cfg.n_vision_tokens] == -100).all()
    for k in batch:
        np.testing.assert_array_equal(batch[k], jbatch[k])
    jl, _ = jax.jit(japi.loss_fn)(jparams, to_jax(batch))
    tl, _ = api.loss_fn(params, to_torch(batch))
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)


def test_train_path_calls_no_kernel_wrapper(models, monkeypatch):
    _, _, api, params = models

    def boom(*args, **kwargs):
        raise AssertionError("a kernel wrapper was called")
    monkeypatch.setattr(L, "flash_attention", boom)
    fa_ops.reset_launches()
    batch = to_torch(dict(lm_batch(3, 2, 12, api.cfg.vocab_size),
                          **stub_inputs(api.cfg, 2, 9)))
    loss, _, _ = loss_and_grads(api, params, batch)
    assert np.isfinite(float(loss)) and fa_ops.launches == 0
    with pytest.raises(AssertionError, match="kernel wrapper"):
        api.prefill_fn(params, batch)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_wrapper_cpu_group7_matches_pallas(dtype):
    """The wrapper's CPU path at internvl2-1b's attention (Hq 14 over Hkv
    2: group 7, head dim 64, causal) against JAX's Pallas kernel in
    interpret mode."""
    rng = np.random.default_rng(6)
    B, S, Hq, Hkv, D = 1, 128, 14, 2, 64
    q = rng.normal(size=(B, S, Hq, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
            for _ in range(2))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_flash(jnp.asarray(q, jd), jnp.asarray(k, jd),
                     jnp.asarray(v, jd), causal=True, block_q=64,
                     block_k=64, interpret=True)
    fa_ops.reset_launches()
    got = fa_ops.flash_attention(*(torch.as_tensor(a).to(td)
                                   for a in (q, k, v)), causal=True)
    tol = 2e-5 if dtype == "float32" else 3e-2
    assert fa_ops.launches == 0 and got.dtype == td
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def test_full_size_tree_matches_jax_and_converts():
    """internvl2-1b at full size: the port's definitions equal JAX's path
    for path (493,780,992 parameters, the tied 151,655-row table); a tree
    of JAX's shapes (depth and vocabulary cut, widths full) carries
    across."""
    mesh = make_local_mesh(1, 1)
    api = build_model(get_config(ARCH), ParallelConfig(), device="cpu")
    assert def_shapes(api.defs) == jax_def_shapes(jax_build_model(
        jax_get_config(ARCH), JaxParallelConfig(), mesh).defs)
    assert api.n_params() == 493_780_992
    assert "lm_head" not in api.defs
    cut = dict(n_layers=1, vocab_size=64)
    jdefs = jax_build_model(dataclasses.replace(jax_get_config(ARCH), **cut),
                            JaxParallelConfig(), mesh).defs
    tree = jax.tree.map(lambda d: np.full(d.shape, 0.5, np.float32), jdefs,
                        is_leaf=lambda x: hasattr(x, "logical"))
    out = params_from_jax_numpy(
        tree, dataclasses.replace(get_config(ARCH), **cut), device="cpu")
    assert def_shapes(out) == jax_def_shapes(jdefs)
    assert out["blocks"]["attn"]["bq"].shape == (1, 896)
