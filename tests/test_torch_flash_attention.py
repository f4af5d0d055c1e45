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
the card (``gpu`` marker), on the edges of its tensor-core paths too.

The wgmma path (bf16, D 64 / 128 / 256): ``flash_path`` for each dtype,
head dim and alignment; ``tiled_attention`` at that path's kv tiles (128
rows at D 128, 64 at D 256) with a ragged Sk, a window that binds inside
a tile and softcap 1.0 against JAX's oracle; on the card the path against
``naive_attention`` on its edges (``WGMMA_EDGES``) through both layouts,
each call one launch on "wgmma" and none on "tc".

The logit softcap: ``naive_attention`` and ``layers.attention`` (the
wrapper's CPU path) with softcap 1.0 and 50.0 against JAX's
``masked_attention`` and ``flash_attention_jnp`` (causal, windowed,
non-causal Sq != Sk, a q_offset, granite-20b's group of 48 on one kv
head); ``tiled_attention``'s capped bf16 arithmetic against JAX's oracle;
on the card the kernel with a softcap on every edge and granite's MQA.

The tf32x3 path (f32, D 64 / 128 / 256: split TF32 on wgmma):
``tf32x3_attention``, the kernel's arithmetic at its kv tiles, against
the Pallas kernel in interpret mode and JAX's oracles (ragged S, Sq != Sk,
D 256, q_offset, softcap 1.0 and 50.0), and against a float64 oracle
where the scaled scores reach +-30 (a single TF32 product, lo dropped,
misses there); ``flash_path``'s f32 cases; on the card the path against
``naive_attention`` on ``WGMMA_EDGES``, (c5)'s softcap shapes and (s)'s
context-parallel ranks, two calls bitwise equal, both layouts equal.

Tolerances are the repo's own: 2e-5 in f32, 3e-2 in bf16.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fref  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    naive_attention, tf32x3_attention, tiled_attention)

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
KV_TILE = 64   # the tc path's kv tile, and the wgmma path's at D 128
               # and 256 (WGMMA_TILES holds D 64's 128 rows)


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


# flash_path: (dtype, D, aligned) -> the path, or the exception it raises
PATH_CASES = [("float32", D, al, "fma") for D in (16, 32)
              for al in (True, False)] + \
    [("float32", D, True, "tf32x3") for D in (64, 128, 256)] + \
    [("float32", D, False, ValueError) for D in (64, 256)] + \
    [("bfloat16", D, True, "tc") for D in (16, 32)] + \
    [("bfloat16", D, True, "wgmma") for D in (64, 128, 256)] + \
    [("bfloat16", D, False, ValueError) for D in (16, 64, 128)] + \
    [("bfloat16", 48, True, ValueError), ("float16", 64, True, TypeError)]


@pytest.mark.parametrize("dtype,D,aligned,want", PATH_CASES)
def test_flash_path(dtype, D, aligned, want):
    dt = getattr(torch, dtype)
    if isinstance(want, str):
        assert ops.flash_path(dt, D, aligned) == want
    else:
        with pytest.raises(want):
            ops.flash_path(dt, D, aligned)


# tiled_attention at the wgmma path's kv tiles (128 rows at D <= 128, 64 at
# D 256): (B, S, Hq, Hkv, D, causal, window, softcap, block_k); S 300 is
# ragged against either tile, window 40 binds inside a tile
WGMMA_TILES = [(1, 300, 4, 2, 128, True, 0, 0.0, 128),
               (1, 300, 4, 1, 128, True, 40, 0.0, 128),
               (1, 300, 4, 4, 128, False, 0, 1.0, 128),
               (1, 300, 4, 1, 256, True, 40, 0.0, 64),
               (1, 300, 4, 1, 256, True, 0, 1.0, 64),
               (1, 300, 6, 3, 64, True, 40, 1.0, 128)]


@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal,window,cap,block_k",
                         WGMMA_TILES)
def test_tiled_bf16_at_wgmma_tiles_matches_jax(B, S, Hq, Hkv, D, causal,
                                               window, cap, block_k):
    """The wgmma path's arithmetic at its own kv tiles against JAX's
    capped oracle (``masked_attention``) in bf16, at TILED_TOL."""
    import jax.numpy as jnp
    from repro.models import layers as jL
    q, k, v = _inputs(13, B, S, Hq, Hkv, D)
    ref = jL.masked_attention(*(jnp.asarray(x, jnp.bfloat16)
                                for x in (q, k, v)),
                              causal=causal, window=window, softcap=cap)
    t = [torch.as_tensor(x).bfloat16() for x in (q, k, v)]
    out = tiled_attention(*t, causal=causal, window=window,
                          block_k=block_k, softcap=cap)
    assert out.dtype == torch.bfloat16 and out.shape == (B, S, Hq, D)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               atol=TILED_TOL, rtol=TILED_TOL)


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


# granite-20b's multi-query attention (48 q heads on one kv head, D 128)
# at small lengths, for the card
GRANITE = [(1, S, 48, 1, 128, True, 0, dt)
           for S in (32, 200) for dt in ("bfloat16", "float32")]


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal,window,dtype",
                         CASES + RAGGED + HEAD_DIM_256 + EDGES + GRANITE)
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


# the logit softcap: (B, Sq, Sk, Hq, Hkv, D, causal, window, q_offset);
# Sq and Sk multiples of SOFTCAP_BLOCK, as JAX's flash_attention_jnp needs
SOFTCAP_SHAPES = {
    "causal": (1, 128, 128, 4, 2, 32, True, 0, 0),
    "window": (2, 128, 128, 4, 4, 16, True, 24, 0),
    "full_sq_ne_sk": (1, 64, 128, 8, 8, 16, False, 0, 0),
    "q_offset": (1, 64, 128, 4, 2, 32, True, 0, 64),
    "mqa_group48": (1, 64, 64, 48, 1, 16, True, 0, 0),
}
SOFTCAP_BLOCK = 32
SOFTCAPS = (1.0, 50.0)


def _qkv(seed, B, Sq, Sk, Hq, Hkv, D):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, Hq, D)).astype(np.float32),
            rng.normal(size=(B, Sk, Hkv, D)).astype(np.float32),
            rng.normal(size=(B, Sk, Hkv, D)).astype(np.float32))


@pytest.mark.parametrize("cap", SOFTCAPS)
@pytest.mark.parametrize("name", list(SOFTCAP_SHAPES))
def test_softcap_plain_and_attention_match_jax(name, cap):
    """``naive_attention`` and ``layers.attention`` (through the wrapper's
    CPU path) with a softcap against JAX's ``masked_attention`` and its
    blocked ``flash_attention_jnp``, f32, 2e-5."""
    import jax.numpy as jnp
    from repro.models import layers as jL
    from repro_torch.models import layers as L
    B, Sq, Sk, Hq, Hkv, D, causal, window, off = SOFTCAP_SHAPES[name]
    q, k, v = _qkv(7, B, Sq, Sk, Hq, Hkv, D)
    kw = dict(causal=causal, window=window, q_offset=off, softcap=cap)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    refs = {"masked_attention": jL.masked_attention(jq, jk, jv, **kw),
            "flash_attention_jnp": jL.flash_attention_jnp(
                jq, jk, jv, q_block=SOFTCAP_BLOCK, kv_block=SOFTCAP_BLOCK,
                **kw)}
    t = [torch.as_tensor(x) for x in (q, k, v)]
    before = ops.launches
    outs = {"naive_attention": naive_attention(*t, **kw),
            "layers.attention": L.attention(*t, **kw)}
    assert ops.launches == before
    for got_name, got in outs.items():
        assert got.shape == (B, Sq, Hq, D)
        for ref_name, ref in refs.items():
            np.testing.assert_allclose(
                got.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5,
                err_msg=f"{got_name} vs {ref_name}")
    if cap == 1.0:   # the cap bends these scores: the output moves
        plain = naive_attention(*t, causal=causal, window=window,
                                q_offset=off)
        assert (plain - outs["naive_attention"]).abs().max() > 1e-2


@pytest.mark.parametrize("cap", SOFTCAPS)
@pytest.mark.parametrize("name", ["causal", "window", "mqa_group48"])
def test_tiled_bf16_softcap_matches_naive_attention(name, cap):
    """The bf16 kernel's capped arithmetic (the max in capped units, log2
    e alone as the exp2 factor) against JAX's capped oracle in bf16."""
    from repro.models import layers as jL
    import jax.numpy as jnp
    B, S, _, Hq, Hkv, D, causal, window, _ = SOFTCAP_SHAPES[name]
    q, k, v = _qkv(8, B, S, S, Hq, Hkv, D)
    ref = jL.masked_attention(*(jnp.asarray(x, jnp.bfloat16)
                                for x in (q, k, v)),
                              causal=causal, window=window, softcap=cap)
    t = [torch.as_tensor(x).bfloat16() for x in (q, k, v)]
    out = tiled_attention(*t, causal=causal, window=window,
                          block_k=KV_TILE, softcap=cap)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               atol=TILED_TOL, rtol=TILED_TOL)


def test_attention_with_softcap_takes_the_wrapper_without_launch():
    """``layers.attention`` no longer raises on a softcap: a CPU tensor
    goes through the flash wrapper to its plain version, no launch; a
    negative softcap is refused."""
    from repro_torch.models import layers as L
    q, k, v = (torch.as_tensor(x) for x in _qkv(9, 1, 40, 40, 4, 2, 16))
    before = ops.launches
    out = L.attention(q, k, v, causal=True, window=0, softcap=5.0)
    assert ops.launches == before
    assert torch.equal(out, naive_attention(q, k, v, softcap=5.0))
    with pytest.raises(ValueError, match="softcap"):
        ops.flash_attention(q, k, v, softcap=-1.0)


@pytest.mark.gpu
@pytest.mark.parametrize("cap", SOFTCAPS)
@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal,window,dtype", EDGES + GRANITE)
def test_kernel_softcap_matches_plain_on_card(cuda, B, S, Hq, Hkv, D, causal,
                                              window, dtype, cap):
    q, k, v = _inputs(10, B, S, Hq, Hkv, D)
    t = [torch.as_tensor(x).to(device=cuda, dtype=TORCH_DT[dtype])
         for x in (q, k, v)]
    before = ops.launches
    out = ops.flash_attention(*t, causal=causal, window=window, softcap=cap)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    ref = naive_attention(*t, causal=causal, window=window, softcap=cap)
    torch.testing.assert_close(out.float(), ref.float(), atol=_tol(dtype),
                               rtol=_tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_layers_attention_with_softcap_launches_on_card(cuda, dtype):
    from repro_torch.models import layers as L
    t = [torch.as_tensor(x).to(device=cuda, dtype=TORCH_DT[dtype])
         for x in _qkv(12, 1, 100, 100, 8, 2, 64)]
    before = ops.launches
    out = L.attention(*t, causal=True, window=0, softcap=1.0)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    torch.testing.assert_close(
        out.float(), naive_attention(*t, softcap=1.0).float(),
        atol=_tol(dtype), rtol=_tol(dtype))


# the edges of the wgmma path, (B, Sq, Sk, Hq, Hkv, D, causal, window), bf16
# (chip_smoke.py's FLASH_EDGES hold them too): Sq and Sk not multiples of
# the 64- or 128-row tiles (77, 129, 300), Sq = 1, Sq != Sk non-causal (300
# x 1500), GQA groups 1, 7, 8 and 48, every head dim, and window 40 at S
# 300: a block takes 64 q rows at D <= 128 and 128 at D 256, and in the
# block at rows 128-191 the last warp's rows (176-191), at D 256 in the
# block at rows 128-255 the second warpgroup's (192-255), are all masked
# in the first kv tile visited (keys 0-127 at D 64, 64-127 at D 128 and
# 256).
WGMMA_EDGES = [(1, 77, 77, 4, 4, 64, True, 0),
               (2, 129, 129, 14, 2, 64, True, 0),
               (2, 300, 300, 28, 4, 64, True, 0),
               (1, 300, 300, 8, 8, 64, True, 40),
               (1, 300, 1500, 8, 8, 64, False, 0),
               (1, 1, 1, 4, 1, 64, True, 0),
               (1, 300, 300, 48, 1, 128, True, 0),
               (1, 300, 300, 56, 8, 128, True, 40),
               (1, 200, 200, 16, 1, 128, True, 16),
               (1, 300, 1500, 48, 1, 128, False, 0),
               (1, 1, 1, 48, 1, 128, True, 0),
               (1, 300, 300, 16, 1, 256, True, 40),
               (1, 129, 129, 7, 1, 256, True, 0),
               (1, 77, 300, 16, 1, 256, False, 0),
               (1, 1, 1, 16, 1, 256, True, 0)]


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal,window", WGMMA_EDGES)
def test_wgmma_path_matches_plain_on_card(cuda, B, Sq, Sk, Hq, Hkv, D,
                                          causal, window, layout):
    q, k, v = (torch.as_tensor(x).to(device=cuda, dtype=torch.bfloat16)
               for x in _qkv(14, B, Sq, Sk, Hq, Hkv, D))
    before = dict(ops.launches_by_path)
    if layout == "bshd":
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
    else:
        t = [x.transpose(1, 2).reshape(-1, x.shape[1], D).contiguous()
             for x in (q, k, v)]
        out = ops.flash_attention_bhsd(*t, causal=causal, window=window,
                                       group=Hq // Hkv)
        out = out.reshape(B, Hq, Sq, D).transpose(1, 2)
    torch.cuda.synchronize()
    moved = {p: n - before[p] for p, n in ops.launches_by_path.items()}
    assert moved == {"fma": 0, "tc": 0, "wgmma": 1, "tf32x3": 0}
    ref = naive_attention(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(out.float(), ref.float(),
                               atol=_tol("bfloat16"), rtol=_tol("bfloat16"))


# ---- the tf32x3 path: f32 at D 64 / 128 / 256 in split TF32 ----

# (B, Sq, Sk, Hq, Hkv, D, causal, window), f32: tests/test_kernels.py's f32
# cases, recurrentgemma-9b's D 256 and a non-causal Sq != Sk, all of them
# multiples of the Pallas kernel's 64-row blocks
TF32X3_PALLAS = [(B, S, S, Hq, Hkv, D, causal, window)
                 for B, S, Hq, Hkv, D, causal, window, dt in CASES
                 if dt == "float32"] + \
    [(1, 256, 256, 4, 1, 256, True, 0), (1, 128, 256, 4, 4, 64, False, 0),
     (1, 128, 256, 4, 2, 128, False, 0)]
# ragged lengths (against either tile: 64, 32 or 16 kv rows), windows that
# bind inside a tile, a ragged Sq != Sk
TF32X3_RAGGED = [(1, 100, 100, 4, 2, 64, True, 0),
                 (1, 100, 100, 8, 2, 128, True, 24),
                 (1, 77, 77, 16, 1, 256, True, 0),
                 (1, 150, 150, 16, 1, 256, True, 40),
                 (1, 77, 300, 16, 1, 256, False, 0),
                 (2, 129, 129, 14, 2, 64, True, 0)]


def _qkv_t(seed, B, Sq, Sk, Hq, Hkv, D, scale=1.0):
    return [torch.as_tensor(x) * scale
            for x in _qkv(seed, B, Sq, Sk, Hq, Hkv, D)]


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal,window", TF32X3_PALLAS)
def test_tf32x3_plain_matches_pallas_interpret(B, Sq, Sk, Hq, Hkv, D,
                                               causal, window):
    jnp, jflash, _ = _jax_side()
    q, k, v = _qkv(15, B, Sq, Sk, Hq, Hkv, D)
    ref = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                 causal=causal, window=window, block_q=64, block_k=64,
                 interpret=True)
    out = tf32x3_attention(*(torch.as_tensor(x) for x in (q, k, v)),
                           causal=causal, window=window)
    assert out.dtype == torch.float32 and out.shape == (B, Sq, Hq, D)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal,window",
                         TF32X3_PALLAS + TF32X3_RAGGED)
def test_tf32x3_plain_matches_naive_attention(B, Sq, Sk, Hq, Hkv, D, causal,
                                              window):
    jnp, _, jnaive = _jax_side()
    q, k, v = _qkv(16, B, Sq, Sk, Hq, Hkv, D)
    ref = jnaive(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                 causal=causal, window=window)
    out = tf32x3_attention(*(torch.as_tensor(x) for x in (q, k, v)),
                           causal=causal, window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=2e-5)


# (B, Sq, Sk, Hq, Hkv, D, causal, window, q_offset) at the path's head dims
TF32X3_CAPPED = {
    "causal": (1, 128, 128, 4, 2, 64, True, 0, 0),
    "window": (2, 100, 100, 4, 4, 128, True, 24, 0),
    "full_sq_ne_sk": (1, 64, 130, 8, 8, 256, False, 0, 0),
    "q_offset": (1, 64, 128, 4, 2, 128, True, 0, 64),
    "q_offset_window": (1, 50, 150, 16, 1, 256, True, 40, 100),
    "mqa_group48": (1, 64, 64, 48, 1, 128, True, 0, 0),
}


@pytest.mark.parametrize("cap", (0.0,) + SOFTCAPS)
@pytest.mark.parametrize("name", list(TF32X3_CAPPED))
def test_tf32x3_plain_softcap_and_offset_match_jax(name, cap):
    """``tf32x3_attention`` with a q_offset and softcap 0, 1.0 and 50.0
    against JAX's ``masked_attention`` in f32, 2e-5."""
    import jax.numpy as jnp
    from repro.models import layers as jL
    B, Sq, Sk, Hq, Hkv, D, causal, window, off = TF32X3_CAPPED[name]
    q, k, v = _qkv(17, B, Sq, Sk, Hq, Hkv, D)
    kw = dict(causal=causal, window=window, q_offset=off, softcap=cap)
    ref = jL.masked_attention(*(jnp.asarray(x) for x in (q, k, v)), **kw)
    out = tf32x3_attention(*(torch.as_tensor(x) for x in (q, k, v)), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=2e-5)


def _attention_f64(q, k, v, *, causal, window, q_offset=0, softcap=0.0):
    """Materialized attention in float64: the truth the f32 versions are
    held to where the scores are large."""
    B, Sq, Hq, D = q.shape
    Sk, G = k.shape[1], Hq // k.shape[2]
    kr = k.double().repeat_interleave(G, dim=2)
    vr = v.double().repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), kr) * D ** -0.5
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    qpos = q_offset + torch.arange(Sq)[:, None]
    kpos = torch.arange(Sk)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    s = s.masked_fill(~mask, -torch.inf)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vr), s


# inputs scaled so that the scaled scores reach +-30: (B, S, Hq, Hkv, D,
# causal, window, softcap, the scale of q and k)
TF32X3_LARGE = [(1, 100, 4, 2, 64, True, 0, 0.0, 2.8),
                (1, 100, 4, 1, 128, True, 24, 0.0, 3.0),
                (1, 77, 4, 1, 256, False, 0, 0.0, 2.8),
                (1, 100, 4, 2, 128, True, 0, 50.0, 3.0)]


@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal,window,cap,scale",
                         TF32X3_LARGE)
def test_tf32x3_plain_at_large_scores_matches_f64(monkeypatch, B, S, Hq, Hkv,
                                                  D, causal, window, cap,
                                                  scale):
    """Scaled scores up to +-30, where an error in the split or the
    exponent shows: ``tf32x3_attention`` within 2e-5 of float64, and the
    same arithmetic with lo dropped (one TF32 product) beyond it."""
    q, k, v = _qkv_t(18, B, S, S, Hq, Hkv, D)
    q, k = q * scale, k * scale
    kw = dict(causal=causal, window=window, softcap=cap)
    want, scores = _attention_f64(q, k, v, **kw)
    reach = scores[scores > -torch.inf].abs().max().item()
    assert reach >= (30.0 if cap == 0 else 0.5 * cap), reach
    out = tf32x3_attention(q, k, v, **kw)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=2e-5,
                               rtol=2e-5)
    split = fref.tf32_split
    monkeypatch.setattr(fref, "tf32_split", lambda a: (
        split(a)[0], torch.zeros_like(a, dtype=torch.float32)))
    one = tf32x3_attention(q, k, v, **kw)
    assert not np.allclose(one.numpy(), want.numpy(), atol=2e-5, rtol=2e-5)


def test_cpu_f32_at_tf32x3_head_dims_takes_plain_version_without_launch():
    q, k, v = _qkv_t(19, 1, 40, 40, 4, 2, 64)
    before = (ops.launches, dict(ops.launches_by_path))
    out = ops.flash_attention(q, k, v, causal=True, softcap=1.0)
    assert (ops.launches, dict(ops.launches_by_path)) == before
    assert torch.equal(out, naive_attention(q, k, v, softcap=1.0))


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal,window", WGMMA_EDGES)
def test_tf32x3_path_matches_plain_on_card(cuda, B, Sq, Sk, Hq, Hkv, D,
                                           causal, window, layout):
    """f32 at D >= 64 on the wgmma path's edges: one "tf32x3" launch a
    call, within 2e-5 of the plain version; two calls bitwise equal; the
    (B*H, S, D) entry point equal to the model layout's bit for bit."""
    q, k, v = (x.to(cuda) for x in _qkv_t(20, B, Sq, Sk, Hq, Hkv, D))
    before = dict(ops.launches_by_path)
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    moved = {p: n - before[p] for p, n in ops.launches_by_path.items()}
    assert moved == {"fma": 0, "tc": 0, "wgmma": 0, "tf32x3": 1}
    ref = naive_attention(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)
    if layout == "bshd":
        again = ops.flash_attention(q, k, v, causal=causal, window=window)
    else:
        t = [x.transpose(1, 2).reshape(-1, x.shape[1], D).contiguous()
             for x in (q, k, v)]
        again = ops.flash_attention_bhsd(*t, causal=causal, window=window,
                                         group=Hq // Hkv)
        again = again.reshape(B, Hq, Sq, D).transpose(1, 2)
    torch.cuda.synchronize()
    assert torch.equal(again, out)


# chip_smoke.py (c5)'s softcap shapes (scripts/torch_flash_cases.py's
# SOFTCAP_SHAPES), (B, Sq, Sk, Hq, Hkv, D, causal, window, q_offset)
C5_SHAPES = [(1, 1024, 1024, 28, 4, 128, True, 0, 0),
             (1, 1024, 1024, 16, 1, 256, True, 2048, 0),
             (1, 300, 1500, 8, 8, 64, False, 0, 0),
             (1, 256, 1024, 28, 4, 128, True, 0, 768),
             (1, 1024, 1024, 48, 1, 128, True, 0, 0)]


@pytest.mark.gpu
@pytest.mark.parametrize("cap", SOFTCAPS)
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal,window,off", C5_SHAPES)
def test_tf32x3_softcap_matches_plain_on_card(cuda, B, Sq, Sk, Hq, Hkv, D,
                                              causal, window, off, cap):
    q, k, v = (x.to(cuda) for x in _qkv_t(21, B, Sq, Sk, Hq, Hkv, D))
    kw = dict(causal=causal, window=window, q_offset=off, softcap=cap)
    before = ops.launches_by_path["tf32x3"]
    out = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.launches_by_path["tf32x3"] == before + 1
    torch.testing.assert_close(out, naive_attention(q, k, v, **kw),
                               atol=2e-5, rtol=2e-5)


# chip_smoke.py (s)'s context-parallel splits: (Hq, Hkv, D, S, n ranks,
# window)
CP_SPLITS = [(28, 4, 128, 1024, 4, 0), (28, 4, 128, 1024, 16, 0),
             (16, 1, 256, 4096, 16, 2048)]


@pytest.mark.gpu
@pytest.mark.parametrize("Hq,Hkv,D,S,n,window", CP_SPLITS)
def test_tf32x3_cp_ranks_match_plain_on_card(cuda, Hq, Hkv, D, S, n, window):
    """Each rank's query rows against the full K/V at q_offset r S / n, f32:
    within 2e-5 of the plain version, one tf32x3 launch a rank."""
    q, k, v = (x.to(cuda) for x in _qkv_t(22, 1, S, S, Hq, Hkv, D))
    s = S // n
    before = ops.launches_by_path["tf32x3"]
    for r in range(n):
        part = q[:, r * s:(r + 1) * s].contiguous()
        kw = dict(causal=True, window=window, q_offset=r * s)
        out = ops.flash_attention(part, k, v, **kw)
        torch.testing.assert_close(out, naive_attention(part, k, v, **kw),
                                   atol=2e-5, rtol=2e-5)
    torch.cuda.synchronize()
    assert ops.launches_by_path["tf32x3"] == before + n
