"""The port's SSD chunked scan (ssd_scan) against the JAX package's kernel,
model path and oracle.

On the CPU the port's wrapper takes the plain version
(``repro_torch.kernels.ssd_scan.ref.ssd_chunked_reference``), which is held
against the Pallas kernel in interpret mode and against ``ssd_reference``
(the per-token recurrence) on the shapes of ``tests/test_kernels.py``, and
against JAX's ``_ssd_chunked`` where the kernel cannot go: S below the
chunk, S not a chunk multiple, an initial state. The CUDA kernel is held
against the plain version on the card (``gpu`` marker), ragged shapes
included. JAX is imported inside the CPU tests only: the machine with the
card has none.

``ssd_state_passing_reference`` (the CUDA kernel's decomposition: C B^T
once per (b, chunk), per-chunk outputs and states, then state passing) is
held against the plain version, the per-token oracle and the Pallas kernel
with many chunks, ragged S, S = 1, B > 1 and strong decay.
``ssd_tf32x3_reference`` (the kernel's numerics: each of its products in
split TF32, hi hi + hi lo + lo hi of operands rounded as cvt.rna.tf32
rounds) is held against the Pallas kernel and the per-token oracle on all
of those shapes at the kernel's tolerance; ``tf32_split`` on its own.

Tolerance: atol 1e-3, as ``tests/test_kernels.py``; 1e-5 between the
chunked f32 paths (the same algorithm, sums in another order); bf16 y
within one rounding of y (rtol 2^-8).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.ssd_scan import ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_chunked_reference, ssd_reference, ssd_state_passing_reference,
    ssd_tf32x3_reference, tf32_split)

CASES = [  # B, S, H, P, N, chunk (tests/test_kernels.py)
    (2, 64, 3, 16, 32, 16),
    (1, 128, 2, 32, 16, 32),
    (2, 32, 1, 8, 8, 8),
    (1, 64, 4, 16, 16, 64),   # single chunk
]
RAGGED = [  # S not a chunk multiple, P not a multiple of the kernel's 32
    (2, 77, 3, 24, 40, 32),
    (1, 300, 2, 40, 128, 256),
]
# the chunk-parallel kernel's structure: 8 and 16 chunks (the look-back),
# B = 4 at mamba2-1.3b's widths, P not a multiple of the block's 32 columns
CARD_SHAPES = [
    (1, 2048, 8, 64, 128, 256),
    (1, 4096, 4, 64, 128, 256),
    (4, 300, 64, 64, 128, 256),
    (2, 600, 3, 40, 128, 256),
]
# the edges of the kernel's 64-row tiles: S under and across a tile (1, 7,
# 33, 65), P of 8, 24, 40 and N of 8, 40 (not multiples of 16), B = 4;
# one chunk of three and of four query tiles on a small grid (split over
# two blocks a (b, h))
TILE_EDGES = [
    (1, 1, 4, 64, 128, 256),
    (2, 7, 3, 24, 40, 256),
    (4, 33, 2, 8, 8, 256),
    (1, 65, 5, 40, 128, 256),
    (4, 65, 3, 24, 8, 32),
    (2, 130, 4, 8, 40, 64),
    (2, 150, 4, 24, 40, 256),
    (2, 230, 4, 24, 40, 256),
]
# the decomposition on the CPU: many chunks, S not a chunk multiple, S = 1,
# B > 1; last field: strong decay (A and dt scaled up, so exp(Lc) and the
# decays underflow inside a chunk)
STATE_PASSING = [  # B, S, H, P, N, chunk, strong_decay
    (1, 128, 2, 8, 16, 8, False),     # 16 chunks
    (2, 96, 3, 16, 8, 8, False),      # 12 chunks, B = 2
    (3, 70, 2, 8, 16, 8, False),      # 9 chunks, the last of 6 tokens
    (1, 1, 2, 8, 8, 16, False),       # S = 1
    (2, 45, 2, 16, 8, 4, True),       # 12 chunks, ragged, strong decay
    (1, 128, 2, 8, 16, 16, True),     # 8 chunks, strong decay
]
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, B, S, H, P, N):
    """f32 numpy inputs as tests/test_kernels.py draws them."""
    rng = np.random.default_rng(seed)
    xh = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = (np.abs(rng.normal(size=(B, S, H))) * 0.5).astype(np.float32)
    Bm = rng.normal(size=(B, S, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, N)).astype(np.float32)
    A = (-np.abs(rng.normal(size=(H,))) - 0.1).astype(np.float32)
    return xh, dt, Bm, Cm, A


def _pallas_padded(args, S, chunk):
    """The Pallas kernel in interpret mode on S padded to a chunk multiple
    with dt = 0, x = 0 tokens (it takes S % chunk == 0 only; the padding
    changes neither y before it nor h)."""
    import jax.numpy as jnp
    from repro.kernels.ssd_scan.ops import ssd_scan as jax_ssd_scan
    Q = min(chunk, S)
    pad = -S % Q
    xh, dt, Bm, Cm, A = args
    padded = [np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
              for a in (xh, dt, Bm, Cm)]
    jy, jh = jax_ssd_scan(*(jnp.asarray(a) for a in padded), jnp.asarray(A),
                          chunk=Q, interpret=True)
    return np.asarray(jy)[:, :S], np.asarray(jh)


def _strong(xh, dt, Bm, Cm, A):
    """Strong decay: A dt down to about -60 a step."""
    return xh, dt * 4.0, Bm, Cm, A * 16.0


def _bh(xh, dt, Bm, Cm, A):
    """Model layout -> the kernel layout of the oracle (B, C broadcast over
    heads, as the JAX wrapper does)."""
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    x2 = xh.transpose(0, 2, 1, 3).reshape(B * H, S, P)
    dt2 = dt.transpose(0, 2, 1).reshape(B * H, S, 1)
    Bm2 = np.broadcast_to(Bm[:, None], (B, H, S, N)).reshape(B * H, S, N)
    Cm2 = np.broadcast_to(Cm[:, None], (B, H, S, N)).reshape(B * H, S, N)
    A2 = np.broadcast_to(A[None, :], (B, H)).reshape(B * H, 1)
    return x2, dt2, Bm2, Cm2, A2


@pytest.mark.parametrize("B,S,H,P,N,chunk", CASES)
def test_plain_matches_pallas_interpret_and_oracle(B, S, H, P, N, chunk):
    import jax.numpy as jnp
    from repro.kernels.ssd_scan.ops import ssd_scan as jax_ssd_scan
    from repro.kernels.ssd_scan.ref import ssd_reference as jax_ssd_reference
    args = _inputs(0, B, S, H, P, N)
    jy, jh = jax_ssd_scan(*(jnp.asarray(a) for a in args), chunk=chunk,
                          interpret=True)
    before = ops.launches
    y, h = ops.ssd_scan(*(torch.as_tensor(a) for a in args), chunk=chunk)
    assert ops.launches == before                 # the CPU never launches
    assert y.shape == (B, S, H, P) and y.dtype == torch.float32
    assert h.shape == (B, H, P, N) and h.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-3)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-3)
    # the port's per-token oracle, against the JAX one and the scan
    bh = _bh(*args)
    yr, hr = ssd_reference(*(torch.as_tensor(np.array(a)) for a in bh))
    jyr, jhr = jax_ssd_reference(*(jnp.asarray(a) for a in bh))
    np.testing.assert_allclose(yr.numpy(), np.asarray(jyr), atol=1e-3)
    np.testing.assert_allclose(hr.numpy(), np.asarray(jhr), atol=1e-3)
    np.testing.assert_allclose(
        y.numpy(), yr.reshape(B, H, S, P).permute(0, 2, 1, 3).numpy(),
        atol=1e-3)
    np.testing.assert_allclose(h.numpy(), hr.reshape(B, H, P, N).numpy(),
                               atol=1e-3)


@pytest.mark.parametrize("B,S,H,P,N,chunk,with_h0", [
    (2, 64, 3, 16, 32, 16, False),
    (2, 5, 2, 8, 8, 16, False),       # S < chunk: one chunk of S
    (1, 77, 3, 24, 40, 32, False),    # S not a chunk multiple
    (2, 45, 2, 16, 8, 16, True),      # an initial state, ragged
])
def test_chunked_reference_matches_jax_model_path(B, S, H, P, N, chunk,
                                                  with_h0):
    import jax.numpy as jnp
    from repro.models.mamba2 import _ssd_chunked
    args = _inputs(1, B, S, H, P, N)
    h0 = (np.random.default_rng(2).normal(size=(B, H, P, N))
          .astype(np.float32) if with_h0 else None)
    jy, jh = _ssd_chunked(*(jnp.asarray(a) for a in args),
                          h0=None if h0 is None else jnp.asarray(h0),
                          chunk=chunk)
    y, h = ssd_chunked_reference(*(torch.as_tensor(a) for a in args),
                                 h0=None if h0 is None else
                                 torch.as_tensor(h0), chunk=chunk)
    assert y.shape == (B, S, H, P) and h.shape == (B, H, P, N)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-5,
                               rtol=1e-5)
    if h0 is not None:            # the wrapper's plain path takes h0 too
        y2, h2 = ops.ssd_scan(*(torch.as_tensor(a) for a in args),
                              chunk=chunk, h0=torch.as_tensor(h0))
        np.testing.assert_array_equal(y2.numpy(), y.numpy())
        np.testing.assert_array_equal(h2.numpy(), h.numpy())


@pytest.mark.parametrize("B,S,H,P,N,chunk,strong_decay", STATE_PASSING)
def test_state_passing_matches_plain_oracle_and_pallas(B, S, H, P, N, chunk,
                                                       strong_decay):
    """The kernel's decomposition against the plain version (the same
    function, sums in another order: 1e-5), the per-token oracle and the
    Pallas kernel in interpret mode (atol 1e-3, as tests/test_kernels.py).
    The Pallas kernel takes S % chunk == 0 only, so its inputs are padded
    with dt = 0, x = 0 tokens, which change neither y before them nor h."""
    import jax.numpy as jnp
    from repro.kernels.ssd_scan.ops import ssd_scan as jax_ssd_scan
    args = _inputs(8, B, S, H, P, N)
    if strong_decay:
        args = _strong(*args)
    targs = [torch.as_tensor(a) for a in args]
    y, h = ssd_state_passing_reference(*targs, chunk=chunk)
    assert y.shape == (B, S, H, P) and h.shape == (B, H, P, N)
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    yp, hp = ssd_chunked_reference(*targs, chunk=chunk)
    np.testing.assert_allclose(y.numpy(), yp.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(h.numpy(), hp.numpy(), atol=1e-5, rtol=1e-5)
    bh = _bh(*args)
    yr, hr = ssd_reference(*(torch.as_tensor(np.array(a)) for a in bh))
    np.testing.assert_allclose(
        y.numpy(), yr.reshape(B, H, S, P).permute(0, 2, 1, 3).numpy(),
        atol=1e-3)
    np.testing.assert_allclose(h.numpy(), hr.reshape(B, H, P, N).numpy(),
                               atol=1e-3)
    Q = min(chunk, S)
    pad = -S % Q
    xh, dt, Bm, Cm, A = args
    padded = [np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
              for a in (xh, dt, Bm, Cm)]
    jy, jh = jax_ssd_scan(*(jnp.asarray(a) for a in padded), jnp.asarray(A),
                          chunk=Q, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy)[:, :S], atol=1e-3)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-3)


@pytest.mark.parametrize("B,S,H,P,N,chunk,strong_decay",
                         [(*c, False) for c in CASES + RAGGED] + STATE_PASSING)
def test_tf32x3_reference_matches_pallas_and_oracle(B, S, H, P, N, chunk,
                                                    strong_decay):
    """The kernel's split-TF32 numerics keep the f32 tolerance: against the
    Pallas kernel in interpret mode and the per-token oracle (atol 1e-3, as
    tests/test_kernels.py), at the tests' unit-normal scale, strong decay
    included; and within 1e-4 of the f32 decomposition."""
    args = _inputs(9, B, S, H, P, N)
    if strong_decay:
        args = _strong(*args)
    targs = [torch.as_tensor(a) for a in args]
    y, h = ssd_tf32x3_reference(*targs, chunk=chunk)
    assert y.shape == (B, S, H, P) and h.shape == (B, H, P, N)
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    jy, jh = _pallas_padded(args, S, chunk)
    np.testing.assert_allclose(y.numpy(), jy, atol=1e-3)
    np.testing.assert_allclose(h.numpy(), jh, atol=1e-3)
    yr, hr = ssd_reference(*(torch.as_tensor(np.array(a))
                             for a in _bh(*args)))
    np.testing.assert_allclose(
        y.numpy(), yr.reshape(B, H, S, P).permute(0, 2, 1, 3).numpy(),
        atol=1e-3)
    np.testing.assert_allclose(h.numpy(), hr.reshape(B, H, P, N).numpy(),
                               atol=1e-3)
    ys, hs = ssd_state_passing_reference(*targs, chunk=chunk)
    np.testing.assert_allclose(y.numpy(), ys.numpy(), atol=1e-4)
    np.testing.assert_allclose(h.numpy(), hs.numpy(), atol=1e-4)


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 3.0e4, 1e30])
def test_tf32_split_reproduces_f32(scale):
    """hi + lo is a to within 2^-21 of |a|; hi and lo carry 10 mantissa
    bits (their low 13 bits are zero); the rounding is to nearest with ties
    away from zero, as cvt.rna.tf32.f32 rounds."""
    a = torch.as_tensor(np.random.default_rng(10).normal(size=4096)
                        .astype(np.float32)) * scale
    hi, lo = tf32_split(a)
    assert hi.dtype == torch.float32 and lo.dtype == torch.float32
    assert int((hi.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert int((lo.view(torch.int32) & 0x1FFF).abs().max()) == 0
    err = ((hi.double() + lo.double()) - a.double()).abs()
    assert bool((err <= 2.0 ** -21 * a.double().abs()).all())
    assert bool(((hi - a).abs() <= 2.0 ** -11 * a.abs()).all())
    # ties: 1 + 2^-11 is half-way between two tf32 values and rounds up in
    # magnitude, on either sign; just below half-way rounds down (scaled by
    # the power of two nearest ``scale``, which keeps the mantissas)
    p2 = 2.0 ** float(np.round(np.log2(scale)))
    one = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                        1.0 + 2.0 ** -11 - 2.0 ** -23]) * p2
    h1, _ = tf32_split(one.float())
    ref = torch.tensor([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0]) * p2
    np.testing.assert_array_equal(h1.numpy(), ref.float().numpy())
    inf = torch.tensor([float("inf"), -float("inf"), float("nan")])
    hi_s, _ = tf32_split(inf)
    assert hi_s[0] == float("inf") and hi_s[1] == -float("inf")
    assert bool(torch.isnan(hi_s[2]))


def test_plain_keeps_input_dtype_for_y():
    args = [torch.as_tensor(a) for a in _inputs(3, 1, 40, 2, 16, 16)]
    y, h = ops.ssd_scan(*(a.bfloat16() for a in args[:4]), args[4],
                        chunk=16)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    yf, hf = ops.ssd_scan(*(a.bfloat16().float() for a in args[:4]),
                          args[4], chunk=16)
    np.testing.assert_array_equal(y.float().numpy(),
                                  yf.bfloat16().float().numpy())
    np.testing.assert_array_equal(h.numpy(), hf.numpy())


def test_launch_checks_raise_on_what_the_kernel_does_not_take():
    """The wrapper's checks, on a box without a card: what the kernel takes
    is decided before the device, so each refusal shows here."""
    x, dt, Bm, Cm, A = (torch.as_tensor(a)
                        for a in _inputs(4, 1, 16, 2, 8, 8))
    before = ops.launches
    with pytest.raises(ValueError, match="CUDA"):
        ops._check(x, dt, Bm, Cm, A, None, 8)
    with pytest.raises(ValueError, match="initial state"):
        ops._check(x, dt, Bm, Cm, A, torch.zeros(1, 2, 8, 8), 8)
    with pytest.raises(TypeError, match="one dtype"):
        ops._check(x, dt, Bm.bfloat16(), Cm, A, None, 8)
    with pytest.raises(TypeError, match="A must be float32"):
        ops._check(x, dt, Bm, Cm, A.double(), None, 8)
    with pytest.raises(ValueError, match="expected xh"):
        ops._check(x, dt, Bm[:, :8], Cm, A, None, 8)
    big = torch.zeros(1, 16, ops.MAX_STATE + 1)
    with pytest.raises(ValueError, match="unsupported extent"):
        ops._check(x, dt, big, big, A, None, 8)
    long = [torch.as_tensor(a) for a in _inputs(5, 1, 300, 2, 8, 8)]
    with pytest.raises(ValueError, match="unsupported extent"):
        ops._check(*long, None, ops.MAX_CHUNK + 1)
    with pytest.raises(ValueError, match="contiguous"):
        ops._check(x.transpose(2, 3).contiguous().transpose(2, 3), dt, Bm,
                   Cm, A, None, 8)
    # TMA: rows of H P and N elements a multiple of 16 bytes, bases on
    # 16-byte boundaries
    odd = [torch.as_tensor(a) for a in _inputs(11, 1, 16, 3, 5, 8)]
    with pytest.raises(ValueError, match="16-byte"):
        ops._check(*odd, None, 8)
    narrow = [torch.as_tensor(a) for a in _inputs(12, 1, 16, 2, 8, 6)]
    with pytest.raises(ValueError, match="16-byte"):
        ops._check(*narrow, None, 8)
    shifted = torch.zeros(Bm.numel() + 1)[1:].view(Bm.shape)
    with pytest.raises(ValueError, match="16-byte"):
        ops._check(x, dt, shifted, Cm, A, None, 8)
    assert ops.launches == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,S,H,P,N,chunk,strong_decay",
    [(*c, False) for c in CASES + RAGGED + CARD_SHAPES + TILE_EDGES] +
    [(2, 300, 3, 24, 40, 256, True), (1, 77, 2, 64, 128, 32, True)])
def test_kernel_matches_plain_on_card(cuda, B, S, H, P, N, chunk,
                                      strong_decay, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    args = _inputs(6, B, S, H, P, N)
    if strong_decay:
        args = _strong(*args)
    xh, dt, Bm, Cm, A = (torch.as_tensor(a).to(cuda) for a in args)
    xh, dt, Bm, Cm = (t.to(TORCH_DT[dtype]) for t in (xh, dt, Bm, Cm))
    before = ops.launches
    y, h = ops.ssd_scan(xh, dt, Bm, Cm, A, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    assert y.dtype == TORCH_DT[dtype] and h.dtype == torch.float32
    yr, hr = ssd_chunked_reference(xh, dt, Bm, Cm, A, chunk=chunk)
    rtol = 2.0 ** -8 if dtype == "bfloat16" else 0.0
    torch.testing.assert_close(y.float(), yr, atol=1e-3, rtol=rtol)
    torch.testing.assert_close(h, hr, atol=1e-3, rtol=0.0)


@pytest.mark.gpu
def test_kernel_raises_on_what_it_does_not_take(cuda):
    xh, dt, Bm, Cm, A = (torch.as_tensor(a).to(cuda)
                         for a in _inputs(7, 1, 16, 2, 8, 8))
    before = ops.launches
    with pytest.raises(ValueError, match="initial state"):
        ops.ssd_scan(xh, dt, Bm, Cm, A, chunk=8,
                     h0=torch.zeros(1, 2, 8, 8, device=cuda))
    with pytest.raises(TypeError, match="one dtype"):
        ops.ssd_scan(xh, dt.bfloat16(), Bm, Cm, A, chunk=8)
    with pytest.raises(ValueError, match="contiguous"):
        ops.ssd_scan(xh.transpose(2, 3).contiguous().transpose(2, 3), dt,
                     Bm, Cm, A, chunk=8)
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.ssd_scan(xh, dt, Bm, Cm, A.cpu(), chunk=8)
    assert ops.launches == before
