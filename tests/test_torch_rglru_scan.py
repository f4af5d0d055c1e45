"""The port's RG-LRU scan (rglru_scan) against the JAX package's kernel,
model path and oracle.

On the CPU the port's wrapper takes the plain version
(``repro_torch.kernels.rglru_scan.ref.rglru_scan_reference``), which is
held against the Pallas kernel in interpret mode and against JAX's
``rglru_reference`` on the four shapes of ``tests/test_kernels.py``
(strong decay included), and against the JAX model's ``_rglru_scan`` (an
associative scan) where the Pallas kernel cannot go: S not a chunk
multiple, an initial state. ``rglru_chunked_reference`` (the CUDA kernel's
algorithm: chunks scanned locally with running decay products, a carry
pass, the fix-up) is held against the plain version, JAX's oracle and the
Pallas kernel with many chunks, ragged S, S = 1, B > 1, h0 and strong
decay. The CUDA kernel is held against the plain version on the card (``gpu`` marker), ragged shapes included. JAX is
imported inside the CPU tests only: the machine with the card has none.

Tolerance: atol 1e-5, as ``tests/test_kernels.py`` (every path runs the
recurrence in f32; the associative scan multiplies the decays in another
order); bf16 h_all within one rounding of the f32 h (rtol 2^-8).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.rglru_scan import ops  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import (  # noqa: E402
    rglru_chunked_reference, rglru_reference, rglru_scan_reference)

CASES = [  # B, S, C, chunk, strong_decay (tests/test_kernels.py)
    (2, 64, 16, 16, False),
    (1, 128, 32, 64, False),
    (3, 32, 8, 32, True),
    (1, 256, 16, 128, True),   # strong decay: the matrix form would overflow
]
RAGGED = [  # S and C that no chunk or warp divides
    (2, 77, 45),
    (1, 300, 130),
]
# the chunk-parallel kernel's structure (chunks of 8 steps, rounds of 256,
# 32 channels a block): S = 1, 7, 9, 257, 4096; C = 4097; B = 4 with h0
CARD_SHAPES = [  # B, S, C, scale, with_h0
    (1, 1, 64, 2.0, True),
    (2, 7, 40, 2.0, False),
    (2, 9, 40, 8.0, True),
    (1, 257, 96, 2.0, True),
    (1, 4096, 256, 2.0, False),
    (1, 300, 4097, 2.0, True),
    (4, 200, 512, 8.0, True),
]
# the chunked algorithm on the CPU: many chunks, S not a multiple of L,
# S = 1, B > 1, h0, strong decay
CHUNKED = [  # B, S, C, L, scale, with_h0
    (1, 256, 16, 16, 2.0, False),     # 16 chunks
    (2, 77, 24, 8, 2.0, True),        # ragged S, h0
    (3, 1, 8, 16, 2.0, True),         # S = 1 from h0
    (1, 15, 8, 16, 8.0, False),       # S = L - 1, strong decay
    (2, 17, 8, 16, 8.0, True),        # S = L + 1, strong decay, h0
    (1, 200, 32, 16, 8.0, True),      # 13 chunks, strong decay, h0
    (1, 7, 8, 8, 8.0, False),         # S = L - 1 at the kernel's L = 8
    (2, 9, 8, 8, 2.0, True),          # S = L + 1 at the kernel's L = 8
]
TOL = 1e-5
BF16_RTOL = 2.0 ** -8
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, B, S, C, scale=2.0, with_h0=False):
    """f32 numpy inputs as tests/test_kernels.py draws them (log_a <= 0),
    and an optional initial state."""
    rng = np.random.default_rng(seed)
    log_a = (-np.abs(rng.normal(size=(B, S, C))) * scale).astype(np.float32)
    b = rng.normal(size=(B, S, C)).astype(np.float32)
    h0 = rng.normal(size=(B, C)).astype(np.float32) if with_h0 else None
    return log_a, b, h0


@pytest.mark.parametrize("B,S,C,chunk,strong_decay", CASES)
def test_plain_matches_pallas_interpret_and_oracle(B, S, C, chunk,
                                                   strong_decay):
    import jax.numpy as jnp
    from repro.kernels.rglru_scan.ops import rglru_scan as jax_rglru_scan
    from repro.kernels.rglru_scan.ref import \
        rglru_reference as jax_rglru_reference
    log_a, b, _ = _inputs(0, B, S, C, 8.0 if strong_decay else 2.0)
    jy = jax_rglru_scan(jnp.asarray(log_a), jnp.asarray(b), chunk=chunk,
                        interpret=True)
    jyr = jax_rglru_reference(jnp.asarray(log_a), jnp.asarray(b))
    before = ops.launches
    y, h = ops.rglru_scan(torch.as_tensor(log_a), torch.as_tensor(b))
    assert ops.launches == before                 # the CPU never launches
    assert y.shape == (B, S, C) and y.dtype == torch.float32
    assert h.shape == (B, C) and h.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(jyr), atol=TOL)
    np.testing.assert_array_equal(h.numpy(), y[:, -1].numpy())
    yr = rglru_reference(torch.as_tensor(log_a), torch.as_tensor(b))
    np.testing.assert_allclose(yr.numpy(), np.asarray(jyr), atol=TOL)


@pytest.mark.parametrize("B,S,C,scale,with_h0", [
    (2, 64, 16, 2.0, False),
    (1, 77, 45, 2.0, False),      # S and C ragged
    (2, 45, 24, 8.0, True),       # an initial state, strong decay
    (3, 1, 8, 2.0, True),         # one step from h0
])
def test_scan_matches_jax_model_path(B, S, C, scale, with_h0):
    import jax.numpy as jnp
    from repro.models.rglru import _rglru_scan
    log_a, b, h0 = _inputs(1, B, S, C, scale, with_h0)
    jy, jh = _rglru_scan(jnp.asarray(log_a), jnp.asarray(b),
                         None if h0 is None else jnp.asarray(h0))
    y, h = ops.rglru_scan(torch.as_tensor(log_a), torch.as_tensor(b),
                          None if h0 is None else torch.as_tensor(h0))
    assert y.shape == (B, S, C) and h.shape == (B, C)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=TOL)


@pytest.mark.parametrize("B,S,C,L,scale,with_h0", CHUNKED)
def test_chunked_matches_plain_oracle_and_pallas(B, S, C, L, scale,
                                                 with_h0):
    """The kernel's chunked algorithm (local scans with running products, a
    carry pass, the fix-up) against the plain version, JAX's oracle and the
    Pallas kernel in interpret mode, atol 1e-5. Those two have no h0 and
    the Pallas kernel takes S % chunk == 0 only: h0 is folded into the
    first step (gx_0 += exp(log_a_0) h0, as the JAX model does) and S is
    padded with log_a = 0, gx = 0 steps, which change no earlier h."""
    import jax.numpy as jnp
    from repro.kernels.rglru_scan.ops import rglru_scan as jax_rglru_scan
    from repro.kernels.rglru_scan.ref import \
        rglru_reference as jax_rglru_reference
    log_a, b, h0 = _inputs(6, B, S, C, scale, with_h0)
    t0 = None if h0 is None else torch.as_tensor(h0)
    y, h = rglru_chunked_reference(torch.as_tensor(log_a),
                                   torch.as_tensor(b), t0, L)
    assert y.shape == (B, S, C) and y.dtype == torch.float32
    assert h.shape == (B, C) and h.dtype == torch.float32
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    np.testing.assert_array_equal(h.numpy(), y[:, -1].numpy())
    yp, hp = rglru_scan_reference(torch.as_tensor(log_a),
                                  torch.as_tensor(b), t0)
    np.testing.assert_allclose(y.numpy(), yp.numpy(), atol=TOL)
    np.testing.assert_allclose(h.numpy(), hp.numpy(), atol=TOL)
    folded = b.copy()
    if h0 is not None:
        folded[:, 0] += np.exp(log_a[:, 0]) * h0
    chunk = 16
    pad = -S % chunk
    la_p, b_p = (np.pad(a, [(0, 0), (0, pad), (0, 0)])
                 for a in (log_a, folded))
    jy = jax_rglru_scan(jnp.asarray(la_p), jnp.asarray(b_p), chunk=chunk,
                        interpret=True)
    jyr = jax_rglru_reference(jnp.asarray(log_a), jnp.asarray(folded))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy)[:, :S], atol=TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(jyr), atol=TOL)


def test_plain_keeps_input_dtype():
    log_a, b, h0 = (torch.as_tensor(a)
                    for a in _inputs(2, 2, 40, 24, with_h0=True))
    y, h = ops.rglru_scan(log_a.bfloat16(), b.bfloat16(), h0)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    yf, hf = ops.rglru_scan(log_a.bfloat16().float(), b.bfloat16().float(),
                            h0)
    np.testing.assert_array_equal(y.float().numpy(),
                                  yf.bfloat16().float().numpy())
    np.testing.assert_array_equal(h.numpy(), hf.numpy())


def test_launch_checks_raise_on_what_the_kernel_does_not_take():
    """The wrapper's checks, on a box without a card: what the kernel takes
    is decided before the device, so each refusal shows here."""
    log_a, b, h0 = (torch.as_tensor(a)
                    for a in _inputs(3, 2, 16, 8, with_h0=True))
    before = ops.launches
    with pytest.raises(ValueError, match="CUDA"):
        ops._check(log_a, b, h0)
    with pytest.raises(TypeError, match="one dtype"):
        ops._check(log_a, b.bfloat16(), None)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops._check(log_a.double(), b.double(), None)
    with pytest.raises(ValueError, match="expected log_a"):
        ops._check(log_a, b[:, :8], None)
    with pytest.raises(ValueError, match="h0 must be"):
        ops._check(log_a, b, h0[:1])
    with pytest.raises(ValueError, match="h0 must be"):
        ops._check(log_a, b, h0.bfloat16())
    with pytest.raises(ValueError, match="unsupported extent"):
        ops._check(log_a[:, :0], b[:, :0], None)
    with pytest.raises(ValueError, match="contiguous"):
        ops._check(log_a.transpose(1, 2).contiguous().transpose(1, 2), b,
                   None)
    assert ops.launches == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,C,scale,with_h0",
                         [(B, S, C, 8.0 if sd else 2.0, False)
                          for B, S, C, _, sd in CASES]
                         + [(B, S, C, 2.0, True) for B, S, C in RAGGED]
                         + CARD_SHAPES)
def test_kernel_matches_plain_on_card(cuda, B, S, C, scale, with_h0, dtype):
    log_a, b, h0 = _inputs(4, B, S, C, scale, with_h0)
    la, bb = (torch.as_tensor(a).to(cuda, TORCH_DT[dtype])
              for a in (log_a, b))
    h0 = None if h0 is None else torch.as_tensor(h0).to(cuda)
    before = ops.launches
    y, h = ops.rglru_scan(la, bb, h0)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    assert y.dtype == TORCH_DT[dtype] and h.dtype == torch.float32
    # the plain version in f32 on the same (widened) inputs: the kernel
    # rounds each h to bf16 once, half an ulp, at most 2^-8 of |h|
    yr, hr = rglru_scan_reference(la.float(), bb.float(), h0)
    rtol = BF16_RTOL if dtype == "bfloat16" else 0.0
    torch.testing.assert_close(y.float(), yr, atol=TOL, rtol=rtol)
    torch.testing.assert_close(h, hr, atol=TOL, rtol=0.0)


@pytest.mark.gpu
def test_kernel_raises_on_what_it_does_not_take(cuda):
    log_a, b, _ = (None if a is None else torch.as_tensor(a).to(cuda)
                   for a in _inputs(5, 1, 16, 8))
    before = ops.launches
    with pytest.raises(TypeError, match="one dtype"):
        ops.rglru_scan(log_a, b.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        ops.rglru_scan(log_a.transpose(1, 2).contiguous().transpose(1, 2), b)
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.rglru_scan(log_a, b, torch.zeros(1, 8))
    assert ops.launches == before
