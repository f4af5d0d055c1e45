"""The port's flash attention against the JAX package's kernel and oracle.

On the CPU the port's wrapper takes the plain version
(``repro_torch.kernels.flash_attention.ref``), which is held against the
Pallas kernel in interpret mode and against ``naive_attention`` on the
five shapes of ``tests/test_kernels.py``. Ragged lengths, which the Pallas
kernel does not take, and recurrentgemma-9b's head dim of 256 are held
against ``naive_attention`` only. The CUDA
kernel is held against the plain version on the card (``gpu`` marker).

Tolerances are the repo's own: 2e-5 in f32, 3e-2 in bf16.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import naive_attention  # noqa: E402

CASES = [  # B, S, Hq, Hkv, D, causal, window, dtype (tests/test_kernels.py)
    (2, 256, 4, 2, 64, True, 0, "float32"),
    (1, 128, 8, 1, 32, True, 0, "float32"),
    (2, 256, 4, 4, 64, True, 64, "float32"),
    (1, 256, 2, 2, 128, False, 0, "float32"),
    (1, 128, 4, 2, 64, True, 0, "bfloat16"),
]
RAGGED = [
    (1, 100, 4, 2, 64, True, 0, "float32"),
    (2, 100, 6, 3, 32, True, 24, "bfloat16"),
]
HEAD_DIM_256 = [  # recurrentgemma-9b's heads (16 over 1 kv head, D 256)
    (1, 77, 16, 1, 256, True, 0, "float32"),
    (1, 100, 16, 1, 256, True, 24, "bfloat16"),
]
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tol(dtype):
    return 2e-5 if dtype == "float32" else 3e-2


def _inputs(seed, B, S, Hq, Hkv, D):
    """f32 numpy inputs from a seed (rounded to the case's dtype by each
    side in the same way: both use round-to-nearest-even)."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, Hq, D)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, D)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, D)).astype(np.float32))


def _jax_side():
    import jax.numpy as jnp
    from repro.kernels.flash_attention.ops import flash_attention
    from repro.kernels.flash_attention.ref import naive_attention as jnaive
    return jnp, flash_attention, jnaive


def _port(q, k, v, dtype, causal, window, device="cpu"):
    t = [torch.as_tensor(x).to(device=device, dtype=TORCH_DT[dtype])
         for x in (q, k, v)]
    return ops.flash_attention(*t, causal=causal, window=window)


@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal,window,dtype", CASES)
def test_plain_matches_pallas_interpret(B, S, Hq, Hkv, D, causal, window,
                                        dtype):
    jnp, jflash, _ = _jax_side()
    q, k, v = _inputs(0, B, S, Hq, Hkv, D)
    jd = getattr(jnp, dtype)
    ref = jflash(jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
                 causal=causal, window=window, block_q=64, block_k=64,
                 interpret=True)
    out = _port(q, k, v, dtype, causal, window)
    assert out.dtype == TORCH_DT[dtype] and out.shape == (B, S, Hq, D)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               atol=_tol(dtype), rtol=_tol(dtype))


@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal,window,dtype",
                         CASES + RAGGED + HEAD_DIM_256)
def test_plain_matches_naive_attention(B, S, Hq, Hkv, D, causal, window,
                                       dtype):
    jnp, _, jnaive = _jax_side()
    q, k, v = _inputs(1, B, S, Hq, Hkv, D)
    jd = getattr(jnp, dtype)
    ref = jnaive(jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
                 causal=causal, window=window)
    out = _port(q, k, v, dtype, causal, window)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               atol=_tol(dtype), rtol=_tol(dtype))


def test_cpu_tensor_takes_plain_version_without_launch():
    q, k, v = _inputs(2, 1, 40, 4, 2, 16)
    before = ops.launches
    out = _port(q, k, v, "float32", True, 0)
    assert ops.launches == before
    ref = naive_attention(*(torch.as_tensor(x) for x in (q, k, v)))
    assert torch.equal(out, ref)
    # the launch path itself refuses a tensor that is not on the card
    t = [torch.as_tensor(x).transpose(1, 2).reshape(-1, 40, 16).contiguous()
         for x in (q, k, v)]
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention_bhsd(*t, group=2)
    assert ops.launches == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal,window,dtype",
                         CASES + RAGGED + HEAD_DIM_256)
def test_kernel_matches_plain_on_card(cuda, B, S, Hq, Hkv, D, causal, window,
                                      dtype):
    q, k, v = _inputs(3, B, S, Hq, Hkv, D)
    before = ops.launches
    out = _port(q, k, v, dtype, causal, window, device=cuda)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    t = [torch.as_tensor(x).to(device=cuda, dtype=TORCH_DT[dtype])
         for x in (q, k, v)]
    ref = naive_attention(*t, causal=causal, window=window)
    torch.testing.assert_close(out.float(), ref.float(), atol=_tol(dtype),
                               rtol=_tol(dtype))
