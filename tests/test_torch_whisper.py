"""PyTorch port vs the JAX package: the audio family (reduced whisper-base:
2 encoder + 2 decoder layers, d 64, 16 frames) on the CPU, with JAX's
parameters carried over by ``repro_torch.convert``.

Tolerances: f32, atol = rtol = 1e-4 for logits and caches (the same f32
math, sums in another order); greedy ids equal; the sinusoidal table
within 1e-6; train as ``tests/test_torch_train.py`` (loss rtol 1e-5,
every gradient leaf within 1e-4 of its largest |g|); decode after a
prefill against a one-token-longer prefill within 2e-3, as
``tests/test_models_smoke.py``; the flash wrapper's CPU path against the
Pallas kernel in interpret mode at the repo's 2e-5 (f32) / 3e-2 (bf16).
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
from repro.models import layers as jL  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.models import whisper as jW  # noqa: E402
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
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models import whisper as W  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.training.step import loss_and_grads  # noqa: E402

ARCH = "whisper-base"


@pytest.fixture(scope="module")
def models():
    return pair(ARCH)


def _prompt(seed, B, S, cfg):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(1, cfg.vocab_size,
                                    size=(B, S)).astype(np.int32)}
    batch.update(stub_inputs(cfg, B, seed + 100))
    return batch


@pytest.mark.parametrize("n,d", [(16, 64), (1500, 512), (7, 10)])
def test_sinusoidal_positions_match_jax(n, d):
    got = L.sinusoidal_positions(n, d)
    assert got.shape == (n, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jL.sinusoidal_positions(n, d)),
                               atol=1e-6, rtol=0)


def test_encode_matches_jax(models):
    japi, jparams, api, params = models
    frames = stub_inputs(api.cfg, 2, 3)["frames"]
    jctx = japi._ctx("prefill", None)
    want = jW.encode(jctx, japi._cast(jparams), jnp.asarray(frames))
    ctx = T.Ctx(cfg=api.cfg, mode="prefill")
    got = W.encode(ctx, params, torch.as_tensor(frames))
    assert got.shape == (2, api.cfg.n_encoder_frames, api.cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_logits_and_every_cache_leaf_match_jax(models):
    japi, jparams, api, params = models
    cfg = api.cfg
    batch = _prompt(1, 2, 12, cfg)
    jl, jc = jax.jit(japi.prefill_fn)(jparams, to_jax(batch))
    tl, tc = api.prefill_fn(params, to_torch(batch))
    assert tl.shape == (2, 1, cfg.vocab_size) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    L_, H, D = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    assert tc["self"]["k"].shape == (L_, 2, 12, H, D)
    assert tc["cross_k"].shape == (L_, 2, cfg.n_encoder_frames, H, D)
    assert sorted(tc) == ["cross_k", "cross_v", "self"]
    assert_trees_close(tc, jc, **TOL)


def test_decode_steps_match_jax(models):
    """Prefill, then 4 greedy decode steps against a 32-row self cache:
    the logits agree at every step, the greedy ids are equal, and the
    caches after them too (cross K/V untouched)."""
    japi, jparams, api, params = models
    B, S_p, S = 2, 9, 32
    batch = _prompt(2, B, S_p, api.cfg)
    jl, jc = jax.jit(japi.prefill_fn)(jparams, to_jax(batch))
    tl, tc = api.prefill_fn(params, to_torch(batch))
    jc, tc = grow_kv(jc, S, jnp), grow_kv(tc, S, torch)
    cross = tc["cross_k"].clone()
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
    assert torch.equal(tc["cross_k"], cross)


def test_decode_after_prefill_matches_longer_prefill(models):
    """decode(t_S) after prefill(t_0..S-1) equals prefill(t_0..S) at the
    last position (tests/test_models_smoke.py's check, port against
    port), sequences at different positions in one batch."""
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


def test_kv_override_branch_matches_jax(models):
    """attn_apply's cross-attention branch at decode: the query with its
    bias, no cache written, kv_len masking rows per sequence."""
    japi, jparams, api, params = models
    cfg = api.cfg
    rng = np.random.default_rng(5)
    B, F = 3, 16
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    k, v = (rng.normal(size=(B, F, cfg.n_kv_heads, cfg.head_dim))
            .astype(np.float32) for _ in range(2))
    kv_len = np.array([16, 5, 1], np.int32)
    jp = jax.tree.map(lambda a: a[0], jparams["dec_blocks"]["cross"])
    jctx = japi._ctx("decode", jnp.zeros((B,), jnp.int32))
    want, wcache = jT.attn_apply(jctx, jp, jnp.asarray(x), kv_override=(
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(kv_len)))
    tp = L.tree_map(lambda _, a: a[0], params["dec_blocks"]["cross"])
    ctx = T.Ctx(cfg=cfg, mode="decode", positions=torch.zeros(B))
    got, cache = T.attn_apply(ctx, tp, torch.as_tensor(x), kv_override=(
        torch.as_tensor(k), torch.as_tensor(v), torch.as_tensor(kv_len)))
    assert wcache is None and cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="decode"):
        T.attn_apply(T.Ctx(cfg=cfg, mode="prefill"), tp, torch.as_tensor(x),
                     kv_override=(torch.as_tensor(k), torch.as_tensor(v),
                                  torch.as_tensor(kv_len)))


@pytest.mark.parametrize("fused", [False, True], ids=["xent", "fused_xent"])
def test_loss_and_grads_match_jax(fused):
    """jax.value_and_grad(api.loss_fn) on a 1x1 mesh against the port's
    loss and autograd; whisper takes the plain xent under fused_xent too,
    in both packages."""
    japi, jparams, api, params = pair(ARCH, fused_xent=fused)
    batch = dict(lm_batch(1, 2, 12, api.cfg.vocab_size),
                 **stub_inputs(api.cfg, 2, 7))
    (jl, jm), jg = jax.jit(jax.value_and_grad(japi.loss_fn, has_aux=True))(
        jparams, to_jax(batch))
    tl, tm, tg = loss_and_grads(api, params, to_torch(batch))
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    assert set(tm) == set(jm)
    assert int(tm["tokens"]) == int(jm["tokens"])
    assert_grads_close(tg, jg, zero=("bk",))


def test_frames_change_the_loss(models):
    _, _, api, params = models
    batch = dict(lm_batch(2, 2, 12, api.cfg.vocab_size),
                 **stub_inputs(api.cfg, 2, 8))
    a = float(api.loss_fn(params, to_torch(batch))[0])
    batch["frames"] = batch["frames"] * -5.0
    b = float(api.loss_fn(params, to_torch(batch))[0])
    assert np.isfinite(a) and np.isfinite(b) and abs(a - b) > 1e-4


def test_token_source_batch_through_loss_fn(models):
    """The port's TokenSource (with frames) equals JAX's, and its batch
    gives JAX's loss."""
    japi, jparams, api, params = models
    cfg = api.cfg
    kw = dict(seq_len=12, global_batch=2, vocab_size=cfg.vocab_size,
              d_model=cfg.d_model, n_frames=cfg.n_encoder_frames)
    batch = TokenSource(DataConfig(**kw)).train_batch(3)
    jbatch = JaxTokenSource(JaxDataConfig(**kw)).train_batch(3)
    assert sorted(batch) == ["frames", "labels", "tokens"]
    for k in batch:
        np.testing.assert_array_equal(batch[k], jbatch[k])
    jl, _ = jax.jit(japi.loss_fn)(jparams, to_jax(batch))
    tl, _ = api.loss_fn(params, to_torch(batch))
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)


def test_train_path_calls_no_kernel_wrapper(models, monkeypatch):
    """JAX's loss_fn reaches no Pallas kernel: the port's calls no kernel
    wrapper (patched to raise), while prefill does reach it."""
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


@pytest.mark.parametrize("Sq,Sk,dtype", [(64, 128, "float32"),
                                         (128, 64, "float32"),
                                         (64, 192, "bfloat16")])
def test_flash_wrapper_cpu_cross_attention_matches_pallas(Sq, Sk, dtype):
    """The wrapper's CPU path (the plain version) with causal=False and
    Sq != Sk, the shape of the decoder's cross-attention, against JAX's
    Pallas kernel in interpret mode (Sq, Sk multiples of its 64 blocks)."""
    rng = np.random.default_rng(6)
    B, H, D = 1, 4, 64
    q = rng.normal(size=(B, Sq, H, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, Sk, H, D)).astype(np.float32)
            for _ in range(2))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_flash(jnp.asarray(q, jd), jnp.asarray(k, jd),
                     jnp.asarray(v, jd), causal=False, block_q=64,
                     block_k=64, interpret=True)
    fa_ops.reset_launches()
    got = fa_ops.flash_attention(*(torch.as_tensor(a).to(td)
                                   for a in (q, k, v)), causal=False)
    tol = 2e-5 if dtype == "float32" else 3e-2
    assert got.shape == (B, Sq, H, D) and got.dtype == td
    assert fa_ops.launches == 0
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _jax_defs(cfg):
    return jax_build_model(cfg, JaxParallelConfig(),
                           make_local_mesh(1, 1)).defs


def test_full_size_tree_matches_jax_and_converts():
    """whisper-base at full size: the port's definitions equal JAX's, path
    for path and shape for shape (87,463,424 parameters with the
    32,768-row pos_dec); a tree of JAX's shapes (depth and vocabulary cut,
    widths full) carries across through ``params_from_jax_numpy``."""
    api = build_model(get_config(ARCH), ParallelConfig(), device="cpu")
    assert def_shapes(api.defs) == jax_def_shapes(
        _jax_defs(jax_get_config(ARCH)))
    assert api.n_params() == 87_463_424
    assert sorted(api.defs["dec_blocks"]) == ["cross", "mlp", "self"]
    assert W.MAX_DECODER_POS == jW.MAX_DECODER_POS
    cut = dict(n_layers=1, n_encoder_layers=1, vocab_size=64)
    jdefs = _jax_defs(dataclasses.replace(jax_get_config(ARCH), **cut))
    tree = jax.tree.map(lambda d: np.full(d.shape, 0.5, np.float32), jdefs,
                        is_leaf=jL.is_def)
    out = params_from_jax_numpy(
        tree, dataclasses.replace(get_config(ARCH), **cut), device="cpu")
    assert def_shapes(out) == jax_def_shapes(jdefs)
    assert out["dec_blocks"]["cross"]["wq"].shape == (1, 512, 512)
    assert out["pos_dec"].shape == (W.MAX_DECODER_POS, 512)
