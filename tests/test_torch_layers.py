"""The port's layers against ``repro.models.layers`` on seeded numpy
inputs, in f32 on the CPU (atol = rtol = 1e-5: the same f32 math, with
sums taken in another order)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
RNG = np.random.default_rng(7)


def _n(*shape, scale=1.0):
    return (scale * RNG.normal(size=shape)).astype(np.float32)


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def _T(*xs):
    return [torch.as_tensor(x) for x in xs]


def _J(*xs):
    return [jnp.asarray(x) for x in xs]


def test_rms_norm():
    x, w = _n(2, 5, 48), _n(48)
    _close(TL.rms_norm(*_T(x, w), eps=1e-6), JL.rms_norm(*_J(x, w), eps=1e-6))


def test_layer_norm():
    x, w, b = _n(3, 40, scale=3.0), _n(40), _n(40)
    _close(TL.layer_norm(*_T(x, w, b)), JL.layer_norm(*_J(x, w, b)))


def test_swiglu_and_gelu():
    g, u = _n(4, 64, scale=2.0), _n(4, 64)
    _close(TL.swiglu(*_T(g, u)), JL.swiglu(*_J(g, u)))
    _close(TL.gelu(*_T(g)), JL.gelu(*_J(g)))


@pytest.mark.parametrize("positions", ["prefill", "decode"])
def test_rope(positions):
    x = _n(3, 6, 4, 32)
    if positions == "prefill":
        pos = np.arange(6)[None, :]
    else:                                   # per-row positions, (B, 1)
        x = x[:, :1]
        pos = np.array([[5], [17], [300]])
    _close(TL.rope(torch.as_tensor(x), torch.as_tensor(pos), 1e6),
           JL.rope(jnp.asarray(x), jnp.asarray(pos, jnp.int32), 1e6))


@pytest.mark.parametrize("kw", [
    dict(causal=True),
    dict(causal=True, window=5),
    dict(causal=False, softcap=2.0),
    dict(causal=True, q_offset=3, kv_len=np.array([9, 6])),
])
def test_masked_attention(kw):
    q, k, v = _n(2, 6, 4, 16), _n(2, 9, 2, 16), _n(2, 9, 2, 16)
    kw = dict(kw)
    kv_len = kw.pop("kv_len", None)
    t = TL.masked_attention(*_T(q, k, v), **kw,
                            kv_len=None if kv_len is None
                            else torch.as_tensor(kv_len))
    j = JL.masked_attention(*_J(q, k, v), **kw,
                            kv_len=None if kv_len is None
                            else jnp.asarray(kv_len))
    _close(t, j)


@pytest.mark.parametrize("window", [0, 4])
def test_decode_attention(window):
    q, kc, vc = _n(3, 1, 6, 16), _n(3, 12, 2, 16), _n(3, 12, 2, 16)
    pos = np.array([0, 5, 11])
    _close(TL.decode_attention(*_T(q, kc, vc, pos), window=window),
           JL.decode_attention(*_J(q, kc, vc, pos), window=window))


def test_attention_cpu_matches_jax_dispatch():
    """The prefill dispatch on a CPU tensor (the kernel's plain version)
    against JAX's ``attention`` with K/V repeated to Hq heads, as the JAX
    "tp" recipe calls it."""
    q, k, v = _n(2, 20, 6, 32), _n(2, 20, 2, 32), _n(2, 20, 2, 32)
    t = TL.attention(*_T(q, k, v), causal=True, window=7)
    j = JL.attention(jnp.asarray(q), jnp.repeat(jnp.asarray(k), 3, 2),
                     jnp.repeat(jnp.asarray(v), 3, 2), causal=True, window=7)
    _close(t, j)
