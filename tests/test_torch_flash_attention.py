"""The port's flash attention against the JAX package's kernel and oracle.

On the CPU the port's wrapper takes the plain version
(``repro_torch.kernels.flash_attention.ref``), which is held against the
Pallas kernel in interpret mode and against ``naive_attention`` on the
five shapes of ``tests/test_kernels.py``. Ragged lengths, which the Pallas
kernel does not take, and recurrentgemma-9b's head dim of 256 are held
against ``naive_attention`` only. ``tiled_attention``, the bf16 kernel's
rounding points in plain PyTorch (online softmax over kv tiles, P rounded
to bf16 before P V), is held in bf16 against both on small versions of
the served shapes. The CUDA kernel is held against the plain version on
the card (``gpu`` marker), on the edges of its tensor-core path too.

Tolerances are the repo's own: 2e-5 in f32, 3e-2 in bf16.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    naive_attention, tiled_attention)

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
# the edges of the bf16 tensor-core path: Sq = Sk not a multiple of 16 or
# 64, every head dim, GQA groups 1, 4, 7 and 16, and (window 8 at S 100)
# q rows 80-95, one warp's rows, all masked in the first kv tile visited
EDGES = [
    (1, 77, 4, 4, 16, True, 0, "bfloat16"),
    (1, 100, 8, 2, 32, True, 8, "bfloat16"),
    (2, 129, 14, 2, 64, True, 0, "bfloat16"),
    (1, 200, 16, 1, 128, True, 16, "bfloat16"),
    (1, 150, 16, 1, 256, True, 40, "bfloat16"),
    (1, 65, 4, 4, 128, False, 0, "bfloat16"),
    (1, 1, 4, 1, 64, True, 0, "bfloat16"),
    (1, 300, 16, 1, 256, False, 0, "bfloat16"),
    (1, 100, 8, 2, 32, True, 8, "float32"),
]
# small versions of the served shapes (qwen2-7b's group 7, olmoe-1b-7b's
# Hq = Hkv, recurrentgemma-9b's D 256 under a window that binds, ragged S)
SERVED_SMALL = [
    (1, 128, 14, 2, 64, True, 0, "bfloat16"),
    (1, 128, 4, 4, 128, True, 0, "bfloat16"),
    (1, 100, 4, 1, 256, True, 24, "bfloat16"),
    (2, 77, 6, 3, 32, True, 0, "bfloat16"),
]
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# tiled_attention's error against the f32-softmax oracle: q, k, v and the
# output are bf16, and P is rounded to bf16 (2^-9 of each weight) before
# P V, so the output moves by about 2^-9 |o| (|o| <= max |v| ~ 4 here);
# the repo's bf16 tolerance of 3e-2 holds it with room
TILED_TOL = 3e-2
KV_TILE = 64   # the bf16 kernel's kv tile, at every head dim


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
                         CASES + RAGGED + HEAD_DIM_256 + EDGES)
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


@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal,window,dtype",
                         SERVED_SMALL + EDGES[:-1])
def test_tiled_bf16_matches_naive_attention(B, S, Hq, Hkv, D, causal,
                                            window, dtype):
    jnp, _, jnaive = _jax_side()
    q, k, v = _inputs(4, B, S, Hq, Hkv, D)
    ref = jnaive(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                 causal=causal, window=window)
    t = [torch.as_tensor(x).bfloat16() for x in (q, k, v)]
    out = tiled_attention(*t, causal=causal, window=window,
                          block_k=KV_TILE)
    assert out.dtype == torch.bfloat16 and out.shape == (B, S, Hq, D)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               atol=TILED_TOL, rtol=TILED_TOL)


@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal,window,dtype",
                         SERVED_SMALL[:2] + [CASES[-1]])
def test_tiled_bf16_matches_pallas_interpret(B, S, Hq, Hkv, D, causal,
                                             window, dtype):
    jnp, jflash, _ = _jax_side()
    q, k, v = _inputs(5, B, S, Hq, Hkv, D)
    ref = jflash(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                 causal=causal, window=window, block_q=64, block_k=64,
                 interpret=True)
    t = [torch.as_tensor(x).bfloat16() for x in (q, k, v)]
    out = tiled_attention(*t, causal=causal, window=window,
                          block_k=KV_TILE)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               atol=TILED_TOL, rtol=TILED_TOL)


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
                         [c for c in EDGES if c[-1] == "bfloat16"])
def test_bhsd_layout_matches_model_layout_on_card(cuda, B, S, Hq, Hkv, D,
                                                  causal, window, dtype):
    """bf16 reads the model layout in place; through the (B*H, S, D)
    entry point the same kernel must give the same numbers."""
    q, k, v = _inputs(6, B, S, Hq, Hkv, D)
    out = _port(q, k, v, dtype, causal, window, device=cuda)
    t = [torch.as_tensor(x).to(device=cuda, dtype=TORCH_DT[dtype])
         .transpose(1, 2).reshape(-1, S, D).contiguous() for x in (q, k, v)]
    before = ops.launches
    bhsd = ops.flash_attention_bhsd(*t, causal=causal, window=window,
                                    group=Hq // Hkv)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    assert torch.equal(bhsd.reshape(B, Hq, S, D).transpose(1, 2), out)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal,window,dtype",
                         CASES + RAGGED + HEAD_DIM_256 + EDGES)
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
