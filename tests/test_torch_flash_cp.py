"""The context-parallel ``q_offset`` of the port's flash attention.

Query row i of a rank's slice sits at key position ``q_offset + i`` among
the keys gathered from every rank. On seeded numpy inputs:

* the plain version (``ref.naive_attention``) with an offset equals the
  matching rows of the unsplit causal / windowed attention (f32, 1e-6);
* the kernel wrapper's CPU path does too, and it is charged the pairs its
  offset keeps (``work.unmasked_pairs``, whose per-rank counts sum to the
  unsplit count);
* the port's ``flash_attention_cp`` (the blocked train-mode form) equals
  JAX's ``flash_attention_jnp(..., q_offset=...)`` at the flash tests'
  f32 tolerance (2e-5);
* on the card (``gpu`` marker), the CUDA kernel with an offset equals
  the plain version at (c)'s tolerances, f32 and bf16.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import naive_attention  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.roofline import op_analysis, work  # noqa: E402

# (B, S, Hq, Hkv, D, n ranks, window)
CASES = [(1, 64, 4, 2, 16, 4, 0), (2, 96, 6, 3, 32, 3, 0),
         (1, 128, 4, 1, 16, 4, 40), (1, 64, 8, 8, 64, 2, 16)]
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, B, S, Hq, Hkv, D):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, Hq, D)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, D)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, D)).astype(np.float32))


def _t(*xs, dtype=torch.float32, device="cpu"):
    return [torch.as_tensor(x).to(device=device, dtype=dtype) for x in xs]


@pytest.mark.parametrize("B,S,Hq,Hkv,D,n,window", CASES)
def test_plain_with_offset_equals_rows_of_unsplit(B, S, Hq, Hkv, D, n,
                                                  window):
    q, k, v = _t(*_inputs(0, B, S, Hq, Hkv, D))
    whole = naive_attention(q, k, v, causal=True, window=window)
    s = S // n
    for r in range(n):
        part = naive_attention(q[:, r * s:(r + 1) * s], k, v, causal=True,
                               window=window, q_offset=r * s)
        torch.testing.assert_close(part, whole[:, r * s:(r + 1) * s],
                                   atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("B,S,Hq,Hkv,D,n,window", CASES)
def test_wrapper_cpu_path_with_offset_and_its_charge(B, S, Hq, Hkv, D, n,
                                                     window):
    q, k, v = _t(*_inputs(1, B, S, Hq, Hkv, D))
    whole = ops.flash_attention(q, k, v, causal=True, window=window)
    s = S // n
    before = ops.launches
    for r in range(n):
        part = q[:, r * s:(r + 1) * s]
        out = ops.flash_attention(part, k, v, causal=True, window=window,
                                  q_offset=r * s)
        torch.testing.assert_close(out, whole[:, r * s:(r + 1) * s],
                                   atol=1e-6, rtol=1e-6)
        rep = op_analysis.analyze(ops.flash_attention, part, k, v,
                                  causal=True, window=window, q_offset=r * s)
        assert rep["flops"] == 4 * B * Hq * D * work.unmasked_pairs(
            s, S, True, window, r * s)
    assert ops.launches == before          # the CPU path launches nothing


@pytest.mark.parametrize("window", [0, 5, 40])
@pytest.mark.parametrize("S,n", [(64, 4), (96, 3), (100, 5), (33, 1)])
def test_unmasked_pairs_with_offsets_sum_to_unsplit(S, n, window):
    s = S // n
    whole = work.unmasked_pairs(n * s, S, True, window)
    assert sum(work.unmasked_pairs(s, S, True, window, r * s)
               for r in range(n)) == whole
    # against the mask itself
    i = 7 + np.arange(s)[:, None]
    j = np.arange(S)[None, :]
    mask = (j <= i) & ((j > i - window) if window else True)
    assert work.unmasked_pairs(s, S, True, window, 7) == int(mask.sum())
    # the last rank keeps the most pairs of a causal split
    if n > 1 and not window:
        assert work.unmasked_pairs(s, S, True, 0, (n - 1) * s) > \
            work.unmasked_pairs(s, S, True, 0, 0)


@pytest.mark.parametrize("window", [0, 5, 40])
@pytest.mark.parametrize("S,n", [(64, 4), (96, 3), (64, 16), (33, 1)])
def test_flash_work_bytes_count_the_keys_a_rank_sees(S, n, window):
    """A rank reads only the keys some row of its slice keeps: the columns
    of the mask with at least one kept pair."""
    s = S // n
    B, Hq, Hkv, D = 2, 4, 2, 16
    for r in range(n):
        i = r * s + np.arange(s)[:, None]
        j = np.arange(S)[None, :]
        mask = (j <= i) & ((j > i - window) if window else True)
        seen = int(mask.any(axis=0).sum())
        assert work.visible_keys(s, S, True, window, r * s) == seen
        _, nbytes = work.flash_work(
            (B, s, S, Hq, Hkv, D, True, window, torch.bfloat16), r * s)
        assert nbytes == 2 * (2 * B * s * Hq * D + 2 * B * seen * Hkv * D)
    # a call without the causal mask reads every key
    assert work.visible_keys(4, S, False, 0) == S


@pytest.mark.parametrize("B,S,Hq,Hkv,D,n,window",
                         [(1, 64, 4, 2, 16, 4, 0), (2, 64, 6, 3, 32, 2, 0),
                          (1, 128, 4, 1, 16, 4, 40)])
def test_flash_attention_cp_equals_jax(B, S, Hq, Hkv, D, n, window):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import layers as jL
    q, k, v = _inputs(2, B, S, Hq, Hkv, D)
    s = S // n
    for r in range(n):
        qs = q[:, r * s:(r + 1) * s]
        want = jL.flash_attention_cp(
            jnp.asarray(qs), jnp.asarray(k), jnp.asarray(v),
            q_offset=r * s, causal=True, window=window, q_block=8,
            kv_block=16)
        got = L.flash_attention_cp(*_t(qs, k, v), q_offset=r * s,
                                   causal=True, window=window, q_block=8,
                                   kv_block=16)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=2e-5, rtol=2e-5)
    # and it equals the plain version's rows
    whole = naive_attention(*_t(q, k, v), causal=True, window=window)
    got = torch.cat([L.flash_attention_cp(
        *_t(q[:, r * s:(r + 1) * s], k, v), q_offset=r * s, causal=True,
        window=window, q_block=8, kv_block=16) for r in range(n)], dim=1)
    torch.testing.assert_close(got, whole, atol=2e-5, rtol=2e-5)


def test_attention_passes_the_offset_to_the_kernel_wrapper():
    q, k, v = _t(*_inputs(3, 1, 32, 4, 2, 16))
    got = L.attention(q[:, 16:], k, v, causal=True, q_offset=16)
    want = naive_attention(q, k, v, causal=True)[:, 16:]
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,n,window",
                         CASES + [(1, 1024, 28, 4, 128, 16, 0),
                                  (1, 4096, 16, 1, 256, 16, 2048)])
def test_kernel_with_offset_matches_plain_on_card(cuda, B, S, Hq, Hkv, D, n,
                                                  window, dtype):
    tol = 2e-5 if dtype == "float32" else 3e-2
    q, k, v = _t(*_inputs(4, B, S, Hq, Hkv, D), dtype=TORCH_DT[dtype],
                 device=cuda)
    whole = ops.flash_attention(q, k, v, causal=True, window=window)
    s = S // n
    before = ops.launches
    outs = []
    for r in range(n):
        part = q[:, r * s:(r + 1) * s].contiguous()
        out = ops.flash_attention(part, k, v, causal=True, window=window,
                                  q_offset=r * s)
        ref = naive_attention(part, k, v, causal=True, window=window,
                              q_offset=r * s)
        torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                   rtol=tol)
        outs.append(out)
    torch.cuda.synchronize()
    assert ops.launches == before + n
    torch.testing.assert_close(torch.cat(outs, 1).float(), whole.float(),
                               atol=tol, rtol=tol)
