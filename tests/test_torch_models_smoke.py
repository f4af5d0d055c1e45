"""The port's counterpart of ``tests/test_models_smoke.py``: every arch of
``ARCH_IDS`` at its ``reduced()`` config, f32 on the CPU, held against the
JAX package on the same parameters (JAX's own, perturbed where it
initialises ones or zeros, carried over by ``repro_torch.convert``; the
helpers of ``tests/_torch_jax_models.py``):

- the prefill logits and every cache leaf (``api.prefill_fn``);
- 3 greedy decode steps on the caches grown to 24 rows: the logits, the
  greedy tokens (equal) and the caches after (``api.decode_fn``);
- one train step's loss, JAX's ``make_train_step`` against the port's
  (SGD), and the step count.

Then a softcapped variant (``logit_softcap=1.0``) of reduced qwen2-7b and
granite-20b (one kv head: multi-query), whose prefill goes through the
port's flash wrapper to its plain version: at S = 32, where JAX
materialises the scores (``masked_attention``), with 2 decode steps, and
at S = 640 with 128-row blocks, where JAX takes its blocked
``flash_attention_jnp`` (checked by a spy).

Tolerance: ``tests/test_torch_model.py``'s, atol = rtol = 1e-4. Both
packages compute in f32 on the same parameters and inputs; only the order
of the sums differs, which moves the logits by ~1e-6 of their scale.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS as JAX_ARCH_IDS  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training.step import make_train_step as jax_make_train_step  # noqa: E402

from _torch_jax_models import (TOL, assert_trees_close, grow_kv,  # noqa: E402
                               lm_batch, pair, stub_inputs, to_jax,
                               to_torch)

from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training.step import make_train_step  # noqa: E402

B, S_P, S_MAX, STEPS = 2, 12, 24, 3
SOFTCAP = {"logit_softcap": 1.0}
SOFTCAP_ARCHS = ("qwen2-7b", "granite-20b")
BLOCK = 128                     # JAX's q_block / kv_block at S = 640
_PAIRS = {}


def _pair(arch, softcap: bool = False):
    """``pair`` once per (arch, softcap) for the module."""
    key = (arch, softcap)
    if key not in _PAIRS:
        _PAIRS[key] = pair(arch, dict(SOFTCAP) if softcap else None,
                           **(dict(q_block=BLOCK, kv_block=BLOCK)
                              if softcap else {}))
    return _PAIRS[key]


def _prompt(seed, S, cfg):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(1, cfg.vocab_size,
                                    size=(B, S)).astype(np.int32)}
    batch.update(stub_inputs(cfg, B, seed + 100))
    return batch


def _decode_and_compare(japi, jparams, api, params, jl, jc, tl, tc, S,
                        steps, rows=S_MAX):
    """Greedy decode ``steps`` tokens in both packages from prefill
    logits / caches at length S, the attention caches grown to ``rows``;
    logits and greedy ids agree each step."""
    jc, tc = grow_kv(jc, rows, jnp), grow_kv(tc, rows, torch)
    jdecode = jax.jit(japi.decode_fn)
    jnext = np.asarray(jnp.argmax(jl[:, -1], -1))
    tnext = tl[:, -1].argmax(-1).numpy()
    np.testing.assert_array_equal(tnext, jnext)
    for step in range(steps):
        pos = np.full((B,), S + step)
        jl, jc = jdecode(jparams, jc, jnp.asarray(jnext[:, None], jnp.int32),
                         jnp.asarray(pos, jnp.int32))
        tl, tc = api.decode_fn(params, tc, torch.as_tensor(tnext[:, None]),
                               torch.as_tensor(pos))
        assert tl.shape == (B, 1, api.cfg.vocab_size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        jnext = np.asarray(jnp.argmax(jl[:, -1], -1))
        tnext = tl[:, -1].argmax(-1).numpy()
        np.testing.assert_array_equal(tnext, jnext)
    return jc, tc


def test_arch_ids_match_jax():
    assert ARCH_IDS == JAX_ARCH_IDS and len(ARCH_IDS) == 10


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_logits_and_caches_match_jax(arch):
    japi, jparams, api, params = _pair(arch)
    batch = _prompt(1, S_P, api.cfg)
    jl, jc = jax.jit(japi.prefill_fn)(jparams, to_jax(batch))
    tl, tc = api.prefill_fn(params, to_torch(batch))
    assert tl.shape == (B, 1, api.cfg.vocab_size)
    assert tl.dtype == torch.float32 and torch.isfinite(tl).all()
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert_trees_close(tc, jc, **TOL)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_steps_and_greedy_tokens_match_jax(arch):
    japi, jparams, api, params = _pair(arch)
    batch = _prompt(2, S_P, api.cfg)
    jl, jc = jax.jit(japi.prefill_fn)(jparams, to_jax(batch))
    tl, tc = api.prefill_fn(params, to_torch(batch))
    jc, tc = _decode_and_compare(japi, jparams, api, params, jl, jc, tl, tc,
                                 S_P, STEPS)
    assert_trees_close(tc, jc, **TOL)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_loss_matches_jax(arch):
    japi, jparams, api, params = _pair(arch)
    params = L.tree_map(lambda _, a: a.clone(), params)   # stepped in place
    batch = lm_batch(3, B, 16, api.cfg.vocab_size)
    batch.update(stub_inputs(api.cfg, B, 103))
    ocfg = dict(name="sgd", lr=0.1)
    jo, to = jopt.Optimizer(jopt.OptConfig(**ocfg)), \
        topt.Optimizer(topt.OptConfig(**ocfg))
    jstate = {"params": jparams, "opt": jo.init(jparams),
              "step": jnp.zeros((), jnp.int32)}
    tstate = {"params": params, "opt": to.init(params),
              "step": torch.zeros((), dtype=torch.int32)}
    jstate, jm = jax.jit(jax_make_train_step(japi, jo))(jstate,
                                                        to_jax(batch))
    tstate, tm = make_train_step(api, to)(tstate, to_torch(batch))
    assert np.isfinite(float(tm["loss"]))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **TOL)
    assert int(tstate["step"]) == int(jstate["step"]) == 1


@pytest.mark.parametrize("S", [32, 640])
@pytest.mark.parametrize("arch", SOFTCAP_ARCHS)
def test_softcap_prefill_and_decode_match_jax(arch, S, monkeypatch):
    """The softcapped model's prefill through the port's flash wrapper (the
    plain version on the CPU) against JAX's ``masked_attention`` (S = 32)
    and blocked ``flash_attention_jnp`` (S = 640); at S = 32 also 2 decode
    steps (``decode_attention`` caps in both packages). The cap must move
    the logits: the same weights without it give others."""
    japi, jparams, api, params = _pair(arch, softcap=True)
    assert api.cfg.logit_softcap == 1.0
    blocked = []
    real = jL.flash_attention_jnp
    monkeypatch.setattr(jL, "flash_attention_jnp",
                        lambda *a, **kw: blocked.append(kw["softcap"])
                        or real(*a, **kw))
    batch = _prompt(4, S, api.cfg)
    jl, jc = jax.jit(japi.prefill_fn)(jparams, to_jax(batch))
    # the layer scan traces its body once: one call at S = 640, none at 32
    assert blocked == ([1.0] if S > 512 else [])
    tl, tc = api.prefill_fn(params, to_torch(batch))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert_trees_close(tc, jc, **TOL)
    _, _, plain_api, _ = _pair(arch)
    uncapped, _ = plain_api.prefill_fn(params, to_torch(batch))
    assert (uncapped - tl).abs().max() > 1e-3
    if S <= 512:
        _decode_and_compare(japi, jparams, api, params, jl, jc, tl, tc, S,
                            2, rows=S + 8)
