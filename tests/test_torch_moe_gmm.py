"""The port's grouped matmul (moe_gmm) against the JAX package's kernel and
oracle.

On the CPU the port's wrapper takes the plain version
(``repro_torch.kernels.moe_gmm.ref``), which is held against the Pallas
kernel in interpret mode and against ``gmm_reference`` on the shapes of
``tests/test_kernels.py``, with random counts and with counts of 0 and C;
so is the plain version of the swap path's split over D
(``gmm_split_reference``) at 1, 2, 4 and 8 blocks, at D of 520 and 2048
too, where every block has a partial to add. The CUDA kernel is held
against the plain version on the card (``gpu`` marker), ragged shapes and
the edges of its tensor-core paths (C of 1, 8, 9 and 160; D and F not
multiples of 8, the fill path's 8- and 16-row tiles) included, each on the
path ``gmm_path`` picks; the ``wgmma`` path (bf16, C > 16) and the
``swap`` path (bf16, C <= 16) on their own edges at ``chip_smoke.py``'s
``GMM_TOL``, the swap path also within one bf16 ulp of the split's plain
version. The f32 "tf32x3" path (split TF32 on wgmma) has its own plain
version, ``gmm_tf32x3_reference``, held here against the Pallas kernel in
interpret mode and the JAX oracle at 1e-4 (every split over D of the
decode tile included), and against float64 at olmoe's D = 2048, where it
must come closer than a plain TF32 product; on the card the path is held
on its edges (``TF32_EDGES``) to the plain version at 1e-4. The wrapper's
choice of path (``ops.gmm_path``) and of the split over D
(``ops.gmm_splits``) are pure functions, tested here.

Tolerances are the repo's own: 1e-4 in f32, 1e-1 in bf16 (``GMM_TOL``:
3e-2 in bf16 for the wgmma edges, on weights at std D^-1/2).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.moe_gmm import ops  # noqa: E402
from repro_torch.kernels.moe_gmm.ref import (  # noqa: E402
    gmm_reference, gmm_split_reference, gmm_tf32x3_reference)
from repro_torch.kernels.moe_gmm.tiling import (TF32_DEPTH,  # noqa: E402
                                               split_bounds)
from repro_torch.kernels.tf32 import tf32_round  # noqa: E402

CASES = [  # E, C, D, F, dtype (tests/test_kernels.py)
    (4, 32, 16, 24, "float32"),
    (2, 64, 32, 32, "float32"),
    (3, 16, 8, 8, "bfloat16"),
]
RAGGED = [  # no dimension a multiple of the kernel's tiles or 16-byte packs
    (5, 21, 37, 45, "float32"),
    (3, 70, 50, 130, "bfloat16"),
]
EDGES = [  # the bf16 tensor-core paths' edges (C <= 16: the swapped tile)
    (4, 1, 64, 128, "bfloat16"),      # C = 1
    (3, 8, 72, 136, "bfloat16"),      # C = 8, decode's tile; F past a block
    (4, 1, 36, 64, "bfloat16"),       # the fill path's 8-row tile: D % 8
    (3, 8, 40, 100, "bfloat16"),      # ... at C = 8; F % 8 != 0
    (3, 9, 40, 100, "bfloat16"),      # C = 9: a 16-row tile; F % 8 != 0
    (2, 160, 96, 264, "bfloat16"),    # C = 160: three 64-row tiles
    (3, 21, 37, 45, "bfloat16"),      # D and F not multiples of 8
    (2, 160, 96, 264, "float32"),
]
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
COUNTS = ("random", "zero", "full")
# the wgmma path (bf16, C > 16, D and F multiples of 8): C of 17, 63, 64,
# 65, 128, 160, 192 and 2560; E of 1 and 64; D and F multiples of 64 and
# of 8 only; olmoe-1b-7b's SwiGLU products (d_model 2048, expert d_ff
# 1024) both ways, at the serve prefill's C and the expert-parallel one's
WGMMA_EDGES = [  # E, C, D, F
    (1, 17, 64, 64),
    (2, 63, 72, 136),
    (3, 64, 128, 128),
    (2, 65, 64, 192),
    (64, 128, 72, 136),
    (2, 160, 96, 264),
    (3, 192, 256, 512),
    (2, 300, 64, 136),      # an odd number of 128-row tiles; 3 w boxes
    (1, 2560, 128, 64),
    (64, 160, 2048, 1024),
    (64, 160, 1024, 2048),
    (4, 2560, 2048, 1024),
    (4, 2560, 1024, 2048),
]
WGMMA_COUNTS = ("random", "zero", "full", "one")
# the swap path (bf16, C <= 16, D and F multiples of 8): C of 1, 7, 8, 9
# and 16; E of 1, 4 and 64; D of 64, 72 and 2048; F of 64, 136, 1024 and
# 2048; olmoe-1b-7b's decode products on one card and under EP 16 (4
# experts a device); on 132 SMs the split over D is 1 (64 experts), 2 (EP
# down), 4 (EP gate/up) and 8 (one expert, 2 tiles)
SWAP_EDGES = [  # E, C, D, F
    (1, 1, 64, 64),
    (4, 7, 72, 136),
    (3, 9, 64, 2048),
    (64, 16, 72, 64),
    (1, 16, 2048, 136),
    (64, 8, 2048, 1024),
    (64, 8, 1024, 2048),
    (4, 16, 2048, 1024),
    (4, 16, 1024, 2048),
    (4, 8, 2048, 1024),
]
SWAP_COUNTS = ("random", "zero", "full", "one", "decode")
SPLITS = (1, 2, 4, 8)
# D of 8 tiles of 64 and more, so that every split has partials to add:
# 520 (9 tiles: uneven at 2, 4 and 8 blocks) and 2048 (olmoe's d_model)
SPLIT_CASES = [(E, C, D, F, dtype) for E, C, D, F in
               ((2, 16, 520, 64), (4, 16, 2048, 256))
               for dtype in ("bfloat16", "float32")]
# the tf32x3 path (f32 where TMA can address the tensors: D and F
# multiples of 4): C of 1, 7, 8, 9, 16 (the decode tiles, split over D),
# 17, 48, 64 (the 64-row tile), 65, 160 and 2560 (the 128-row tile); E of
# 1, 4 and 64; D and F multiples of 4 but not of 8, and of 32 and 128 only
# in part; olmoe-1b-7b's products on one card (decode, T=300 and T=1024
# prefills) and under EP 16 (replicated decode, the all-to-all buffer)
TF32_EDGES = [  # E, C, D, F
    (1, 1, 36, 44),
    (4, 7, 68, 132),
    (3, 8, 100, 260),
    (2, 9, 4, 4),
    (64, 16, 36, 12),
    (1, 16, 2048, 136),
    (2, 17, 36, 44),
    (3, 48, 132, 196),
    (2, 64, 64, 128),
    (2, 65, 100, 36),
    (3, 160, 68, 260),
    (1, 2560, 36, 68),
    (64, 8, 2048, 1024),
    (64, 8, 1024, 2048),
    (64, 48, 2048, 1024),
    (64, 160, 2048, 1024),
    (64, 160, 1024, 2048),
    (4, 16, 2048, 1024),
    (4, 16, 1024, 2048),
    (4, 8, 2048, 1024),
    (4, 2560, 2048, 1024),
    (4, 2560, 1024, 2048),
]
TF32_COUNTS = ("random", "zero", "full", "one")
# the plain tf32x3 version's CPU edges against the JAX oracle: C of 1, 7,
# 9, 16 (split over D), 17, 48, 65, 160, 2560; D of 4, 36 and 100 (not
# multiples of the 32-deep tile), 520 (every split has tiles to add)
TF32_CPU_EDGES = [  # E, C, D, F, splits
    (1, 1, 36, 44, 1),
    (4, 7, 68, 132, 2),
    (2, 9, 4, 4, 1),
    (3, 16, 520, 12, 8),
    (2, 16, 100, 20, 4),
    (2, 17, 36, 44, 1),
    (3, 48, 132, 36, 1),
    (2, 65, 100, 36, 1),
    (3, 160, 68, 20, 1),
    (1, 2560, 36, 12, 1),
]
GMM_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# the swap path against the split's plain version on the card: at most one
# bf16 ulp (rtol 2^-7), and 1e-4 for sums that cancel
ULP_TOL = {"atol": 1e-4, "rtol": 2 ** -7}


def _tol(dtype):
    return 1e-4 if dtype == "float32" else 1e-1


def _inputs(seed, E, C, D, F, counts):
    """f32 numpy inputs from a seed (each side rounds them to the case's
    dtype in the same way, round-to-nearest-even), int32 counts."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(E, C, D)).astype(np.float32)
    w = rng.normal(size=(E, D, F)).astype(np.float32)
    cnt = {"random": rng.integers(0, C + 1, size=(E,)),
           "zero": np.zeros((E,)),
           "full": np.full((E,), C),
           "one": np.where(np.arange(E) == E - 1, C, 0)}[counts].astype(
               np.int32)
    cnt[0] = 0          # every case has an empty expert
    return x, w, cnt


def _port(x, w, cnt, dtype, device="cpu"):
    return ops.grouped_matmul(
        torch.as_tensor(x).to(device=device, dtype=TORCH_DT[dtype]),
        torch.as_tensor(w).to(device=device, dtype=TORCH_DT[dtype]),
        torch.as_tensor(cnt).to(device))


@pytest.mark.parametrize("counts", COUNTS)
@pytest.mark.parametrize("E,C,D,F,dtype", CASES)
def test_plain_matches_pallas_interpret_and_reference(E, C, D, F, dtype,
                                                      counts):
    import jax.numpy as jnp
    from repro.kernels.moe_gmm.ops import grouped_matmul as jgmm
    from repro.kernels.moe_gmm.ref import gmm_reference as jref
    x, w, cnt = _inputs(0, E, C, D, F, counts)
    jd = getattr(jnp, dtype)
    jx, jw, jc = jnp.asarray(x, jd), jnp.asarray(w, jd), jnp.asarray(cnt)
    kernel = jgmm(jx, jw, jc, block_c=16, block_f=8, block_d=8,
                  interpret=True)
    oracle = jref(jx, jw, jc)
    before = ops.launches
    out = _port(x, w, cnt, dtype)
    plain = gmm_reference(*(torch.as_tensor(a) for a in (x, w, cnt)))
    assert ops.launches == before                 # the CPU never launches
    assert out.dtype == TORCH_DT[dtype] and out.shape == (E, C, F)
    for ref in (kernel, oracle):
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(ref, np.float32),
                                   atol=_tol(dtype), rtol=_tol(dtype))
    rows = np.arange(C)[None, :, None] >= cnt[:, None, None]
    assert not np.any(np.where(rows, out.float().numpy(), 0.0))
    if dtype == "float32":
        np.testing.assert_allclose(plain.numpy(), np.asarray(oracle),
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("counts", COUNTS)
@pytest.mark.parametrize("E,C,D,F,dtype", EDGES)
def test_plain_matches_reference_on_edges(E, C, D, F, dtype, counts):
    """Shapes the Pallas kernel's blocks do not tile: the oracle only."""
    import jax.numpy as jnp
    from repro.kernels.moe_gmm.ref import gmm_reference as jref
    x, w, cnt = _inputs(4, E, C, D, F, counts)
    jd = getattr(jnp, dtype)
    oracle = jref(jnp.asarray(x, jd), jnp.asarray(w, jd), jnp.asarray(cnt))
    out = _port(x, w, cnt, dtype)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(oracle, np.float32),
                               atol=_tol(dtype), rtol=_tol(dtype))


@functools.cache
def _jax_out(kind, E, C, D, F, dtype, counts, seed):
    """The Pallas kernel in interpret mode ("pallas") or the JAX oracle
    ("oracle") on ``_inputs(seed, ...)``, computed once a case."""
    import jax.numpy as jnp
    from repro.kernels.moe_gmm.ops import grouped_matmul as jgmm
    from repro.kernels.moe_gmm.ref import gmm_reference as jref
    x, w, cnt = _inputs(seed, E, C, D, F, counts)
    jd = getattr(jnp, dtype)
    jx, jw, jc = jnp.asarray(x, jd), jnp.asarray(w, jd), jnp.asarray(cnt)
    out = jgmm(jx, jw, jc, block_c=16, block_f=8, block_d=8,
               interpret=True) if kind == "pallas" else jref(jx, jw, jc)
    return np.asarray(out, np.float32)


def _split_plain(x, w, cnt, dtype, splits):
    return gmm_split_reference(
        torch.as_tensor(x).to(TORCH_DT[dtype]),
        torch.as_tensor(w).to(TORCH_DT[dtype]), torch.as_tensor(cnt), splits)


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("counts", COUNTS)
@pytest.mark.parametrize("E,C,D,F,dtype", CASES)
def test_split_plain_matches_pallas_interpret(E, C, D, F, dtype, counts,
                                              splits):
    """The swap path's sum over D in ``splits`` f32 partials, against the
    Pallas kernel."""
    x, w, cnt = _inputs(0, E, C, D, F, counts)
    out = _split_plain(x, w, cnt, dtype, splits)
    assert out.dtype == TORCH_DT[dtype] and out.shape == (E, C, F)
    np.testing.assert_allclose(
        out.float().numpy(), _jax_out("pallas", E, C, D, F, dtype, counts, 0),
        atol=_tol(dtype), rtol=_tol(dtype))
    rows = np.arange(C)[None, :, None] >= cnt[:, None, None]
    assert not np.any(np.where(rows, out.float().numpy(), 0.0))


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("counts", COUNTS)
@pytest.mark.parametrize("E,C,D,F,dtype", EDGES)
def test_split_plain_matches_reference_on_edges(E, C, D, F, dtype, counts,
                                                splits):
    """The same on the edges (D of 36, 37, 40, 64, 72, 96: none a multiple
    of splits x 64 beyond 1), against the JAX oracle."""
    x, w, cnt = _inputs(4, E, C, D, F, counts)
    out = _split_plain(x, w, cnt, dtype, splits)
    np.testing.assert_allclose(
        out.float().numpy(), _jax_out("oracle", E, C, D, F, dtype, counts, 4),
        atol=_tol(dtype), rtol=_tol(dtype))


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("counts", COUNTS)
@pytest.mark.parametrize("E,C,D,F,dtype", SPLIT_CASES)
def test_split_plain_matches_reference_at_depth(E, C, D, F, dtype, counts,
                                                splits):
    """The same where every block has a partial to add (D of 520 and 2048),
    against the JAX oracle."""
    assert sum(hi > lo for lo, hi in split_bounds(D, splits)) == splits
    x, w, cnt = _inputs(5, E, C, D, F, counts)
    out = _split_plain(x, w, cnt, dtype, splits)
    np.testing.assert_allclose(
        out.float().numpy(), _jax_out("oracle", E, C, D, F, dtype, counts, 5),
        atol=_tol(dtype), rtol=_tol(dtype))


def _tf32x3_plain(x, w, cnt, splits):
    return gmm_tf32x3_reference(*(torch.as_tensor(a) for a in (x, w, cnt)),
                                splits)


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("counts", TF32_COUNTS)
@pytest.mark.parametrize("E,C,D,F,dtype", CASES)
def test_tf32x3_plain_matches_pallas_interpret(E, C, D, F, dtype, counts,
                                               splits):
    """The tf32x3 path's arithmetic (split TF32, 32-deep D tiles, the split
    over D) in f32 against the Pallas kernel in interpret mode and the JAX
    oracle, within f32's 1e-4, on tests/test_kernels.py's shapes."""
    x, w, cnt = _inputs(0, E, C, D, F, counts)
    out = _tf32x3_plain(x, w, cnt, splits)
    assert out.dtype == torch.float32 and out.shape == (E, C, F)
    for kind in ("pallas", "oracle"):
        np.testing.assert_allclose(
            out.numpy(), _jax_out(kind, E, C, D, F, "float32", counts, 0),
            atol=1e-4, rtol=1e-4)
    rows = np.arange(C)[None, :, None] >= cnt[:, None, None]
    assert not np.any(np.where(rows, out.numpy(), 0.0))


@pytest.mark.parametrize("counts", TF32_COUNTS)
@pytest.mark.parametrize("E,C,D,F,splits", TF32_CPU_EDGES)
def test_tf32x3_plain_matches_reference_on_edges(E, C, D, F, splits, counts):
    """The same on the tf32x3 path's edges, against the JAX oracle."""
    x, w, cnt = _inputs(6, E, C, D, F, counts)
    out = _tf32x3_plain(x, w, cnt, splits)
    np.testing.assert_allclose(
        out.numpy(), _jax_out("oracle", E, C, D, F, "float32", counts, 6),
        atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("splits", SPLITS)
def test_tf32x3_plain_beats_plain_tf32_at_depth(splits):
    """At olmoe's d_model (D = 2048) the split-TF32 sum lies within 1e-5
    of the float64 product, and closer than a plain TF32 product (each
    operand rounded to tf32 once) by a factor of 100 or more."""
    E, C, D, F = 2, 16, 2048, 64
    rng = np.random.default_rng(7)
    x = rng.normal(size=(E, C, D)).astype(np.float32)
    w = (rng.normal(size=(E, D, F)) * D ** -0.5).astype(np.float32)
    cnt = np.array([C, 11], np.int32)
    exact = np.einsum("ecd,edf->ecf", x.astype(np.float64),
                      w.astype(np.float64))
    exact[1, 11:] = 0.0
    got = _tf32x3_plain(x, w, cnt, splits).numpy().astype(np.float64)
    xt, wt = (tf32_round(torch.as_tensor(a)).double().numpy() for a in (x, w))
    plain = np.einsum("ecd,edf->ecf", xt, wt)
    plain[1, 11:] = 0.0
    err, err_tf32 = np.abs(got - exact).max(), np.abs(plain - exact).max()
    assert err <= 1e-5 and 100 * err < err_tf32, (err, err_tf32)


def test_tf32x3_split_uses_32_deep_tiles():
    assert TF32_DEPTH == 32
    assert split_bounds(520, 8, TF32_DEPTH) == [
        (0, 64), (64, 128), (128, 192), (192, 256), (256, 320), (320, 384),
        (384, 448), (448, 520)]
    assert split_bounds(100, 4, TF32_DEPTH) == [(0, 32), (32, 64), (64, 96),
                                                (96, 100)]
    assert split_bounds(100, 8, TF32_DEPTH) == [
        (0, 0), (0, 32), (32, 32), (32, 64), (64, 64), (64, 96), (96, 96),
        (96, 100)]


@pytest.mark.parametrize("D,splits,bounds", [
    (64, 1, [(0, 64)]),
    (72, 2, [(0, 64), (64, 72)]),
    (37, 4, [(0, 0), (0, 0), (0, 0), (0, 37)]),
    (2048, 4, [(0, 512), (512, 1024), (1024, 1536), (1536, 2048)]),
    (1024, 8, [(128 * r, 128 * (r + 1)) for r in range(8)]),
    (200, 2, [(0, 128), (128, 200)]),
    (520, 8, [(0, 64), (64, 128), (128, 192), (192, 256), (256, 320),
              (320, 384), (384, 448), (448, 520)]),
])
def test_split_bounds_cover_d_in_rank_order(D, splits, bounds):
    assert split_bounds(D, splits) == bounds


@pytest.mark.parametrize("E,C,D,F,sms,splits", [
    (4, 16, 2048, 1024, 132, 4),    # EP 16 replicated decode, gate/up
    (4, 16, 1024, 2048, 132, 2),    # ... down
    (4, 8, 2048, 1024, 132, 4),     # ... at cap_mult 2.0
    (64, 8, 2048, 1024, 132, 1),    # one card's decode: 512 tiles
    (64, 8, 1024, 2048, 132, 1),
    (1, 16, 2048, 136, 132, 8),     # 2 tiles: never above 8
    (1, 1, 64, 64, 132, 1),         # never more blocks than D / 64
    (1, 1, 200, 64, 132, 2),
    (1, 16, 256, 128, 132, 4),
    (4, 16, 2048, 1024, 114, 2),    # fewer SMs
    (4, 160, 2048, 1024, 132, 1),   # C > 16: not the swap path
])
def test_splits_fill_the_card_from_the_shape(E, C, D, F, sms, splits):
    got = ops.gmm_splits(E, C, D, F, sms)
    assert got == splits
    assert got in SPLITS and got * 64 <= max(D, 64)
    assert got == 1 or E * -(-F // ops.SWAP_COLS) * got <= sms


@pytest.mark.parametrize("dtype,C,D,F,aligned,path", [
    (torch.float32, 8, 2048, 1024, True, "tf32x3"),
    (torch.float32, 160, 2048, 1024, True, "tf32x3"),
    (torch.float32, 21, 37, 45, False, "fma"),
    (torch.float32, 1, 4, 4, True, "tf32x3"),
    (torch.float32, 16, 36, 44, True, "tf32x3"),
    (torch.float32, 2560, 1024, 2048, True, "tf32x3"),
    (torch.float32, 8, 2048, 1024, False, "fma"),
    (torch.float32, 160, 2048, 1024, False, "fma"),
    (torch.float32, 16, 37, 64, True, "fma"),
    (torch.float32, 48, 64, 45, True, "fma"),
    (torch.float32, 21, 37, 45, True, "fma"),
    (torch.bfloat16, 1, 64, 128, True, "swap"),
    (torch.bfloat16, 8, 2048, 1024, True, "swap"),
    (torch.bfloat16, 16, 37, 45, False, "fill"),
    (torch.bfloat16, 16, 2048, 1024, True, "swap"),
    (torch.bfloat16, 7, 72, 136, True, "swap"),
    (torch.bfloat16, 8, 2048, 1024, False, "fill"),
    (torch.bfloat16, 1, 36, 64, True, "fill"),
    (torch.bfloat16, 8, 40, 100, True, "fill"),
    (torch.bfloat16, 9, 64, 100, True, "fill"),
    (torch.bfloat16, 16, 64, 45, True, "fill"),
    (torch.bfloat16, 17, 64, 64, True, "wgmma"),
    (torch.bfloat16, 160, 2048, 1024, True, "wgmma"),
    (torch.bfloat16, 160, 72, 136, True, "wgmma"),
    (torch.bfloat16, 2560, 1024, 2048, True, "wgmma"),
    (torch.bfloat16, 160, 2048, 1024, False, "fill"),
    (torch.bfloat16, 21, 37, 45, True, "fill"),
    (torch.bfloat16, 70, 64, 130, True, "fill"),
    (torch.bfloat16, 70, 50, 128, True, "fill"),
])
def test_path_is_chosen_from_dtype_shape_and_alignment(dtype, C, D, F,
                                                       aligned, path):
    assert ops.gmm_path(dtype, C, D, F, aligned) == path
    assert path in ops.PATHS


def test_path_choice_refuses_other_dtypes():
    with pytest.raises(TypeError, match="no path"):
        ops.gmm_path(torch.float16, 160, 2048, 1024, True)


def test_cpu_calls_count_no_path():
    x, w, cnt = _inputs(1, 2, 24, 16, 8, "random")
    before = dict(ops.launches_by_path)
    _port(x, w, cnt, "bfloat16")
    assert ops.launches_by_path == before


def test_cpu_f32_calls_count_no_path():
    """An f32 call on the CPU, at a shape the tf32x3 path takes on the
    card, goes to the plain version and counts no launch on any path."""
    x, w, cnt = _inputs(1, 2, 24, 16, 8, "random")
    before, paths = ops.launches, dict(ops.launches_by_path)
    out = _port(x, w, cnt, "float32")
    assert ops.launches == before and ops.launches_by_path == paths
    np.testing.assert_allclose(
        out.numpy(),
        gmm_reference(*(torch.as_tensor(a) for a in (x, w, cnt))).numpy())


def test_launch_path_refuses_cpu_tensors():
    x, w, cnt = _inputs(1, 2, 8, 16, 8, "random")
    t = [torch.as_tensor(a) for a in (x, w, cnt)]
    before = ops.launches
    with pytest.raises(ValueError, match="CUDA"):
        ops._check(*t)
    assert ops.launches == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("counts", COUNTS)
@pytest.mark.parametrize("E,C,D,F,dtype", CASES + RAGGED + EDGES)
def test_kernel_matches_plain_on_card(cuda, E, C, D, F, dtype, counts):
    torch.backends.cuda.matmul.allow_tf32 = False
    x, w, cnt = _inputs(2, E, C, D, F, counts)
    before, paths = ops.launches, dict(ops.launches_by_path)
    out = _port(x, w, cnt, dtype, device=cuda)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    path = ops.gmm_path(TORCH_DT[dtype], C, D, F, True)
    assert ops.launches_by_path[path] == paths[path] + 1
    xd, wd = (torch.as_tensor(a).to(cuda, TORCH_DT[dtype]) for a in (x, w))
    ref = gmm_reference(xd, wd, torch.as_tensor(cnt).to(cuda))
    torch.testing.assert_close(out.float(), ref.float(), atol=_tol(dtype),
                               rtol=_tol(dtype))


@pytest.mark.gpu
def test_kernel_raises_on_what_it_does_not_take(cuda):
    x, w, cnt = _inputs(3, 2, 8, 16, 8, "random")
    xt, wt = torch.as_tensor(x, device=cuda), torch.as_tensor(w, device=cuda)
    before = ops.launches
    with pytest.raises(TypeError, match="int32"):
        ops.grouped_matmul(xt, wt, torch.as_tensor(cnt, device=cuda).long())
    with pytest.raises(TypeError, match="dtype"):
        ops.grouped_matmul(xt, wt.bfloat16(), torch.as_tensor(cnt,
                                                              device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        ops.grouped_matmul(xt.transpose(1, 2).contiguous().transpose(1, 2),
                           wt, torch.as_tensor(cnt, device=cuda))
    assert ops.launches == before


def _card_inputs(seed, E, C, D, F, counts, device):
    """bf16 x ~ N(0, 1) and w ~ N(0, 1 / D) drawn on the card (the
    olmoe-width cases are 134 M weights), int32 counts; "one": every row
    of one expert in use, the others empty; "decode": one row in each of
    half the experts (at least one), as a decode step routes."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    x = torch.randn((E, C, D), generator=gen, device=device).bfloat16()
    w = (torch.randn((E, D, F), generator=gen, device=device)
         * D ** -0.5).bfloat16()
    if counts == "random":
        cnt = torch.randint(0, C + 1, (E,), generator=gen, device=device,
                            dtype=torch.int32)
    elif counts == "decode":
        cnt = torch.zeros((E,), dtype=torch.int32, device=device)
        cnt[torch.randperm(E, generator=gen, device=device)[
            :max(1, E // 2)]] = 1
    else:
        cnt = torch.full((E,), C if counts == "full" else 0,
                         dtype=torch.int32, device=device)
        if counts == "one":
            cnt[E // 2] = C
    return x, w, cnt


@pytest.mark.gpu
@pytest.mark.parametrize("counts", WGMMA_COUNTS)
@pytest.mark.parametrize("E,C,D,F", WGMMA_EDGES)
def test_wgmma_path_matches_plain_on_card(cuda, E, C, D, F, counts):
    x, w, cnt = _card_inputs(5, E, C, D, F, counts, cuda)
    before, paths = ops.launches, dict(ops.launches_by_path)
    out = ops.grouped_matmul(x, w, cnt)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    assert ops.launches_by_path["wgmma"] == paths["wgmma"] + 1
    ref = gmm_reference(x, w, cnt)
    torch.testing.assert_close(out.float(), ref.float(),
                               atol=GMM_TOL[torch.bfloat16],
                               rtol=GMM_TOL[torch.bfloat16])
    rows = torch.arange(C, device=cuda)[None, :, None] >= cnt[:, None, None]
    assert not out.float().masked_select(rows).any()


@pytest.mark.gpu
def test_wgmma_path_refuses_what_tma_cannot_address(cuda):
    """The entry point refuses the wgmma path for a shape it cannot take
    instead of running another kernel."""
    x, w, cnt = _card_inputs(6, 2, 32, 37, 45, "full", cuda)
    lib = ops.build().lib
    out = torch.empty((2, 32, 45), dtype=torch.bfloat16, device=cuda)
    err = lib.repro_moe_gmm(x.data_ptr(), w.data_ptr(), cnt.data_ptr(),
                            out.data_ptr(), ops.PATHS.index("wgmma"), 1, 2,
                            32, 37, 45,
                            torch.cuda.current_stream().cuda_stream)
    assert err != 0


@pytest.mark.gpu
@pytest.mark.parametrize("counts", SWAP_COUNTS)
@pytest.mark.parametrize("E,C,D,F", SWAP_EDGES)
def test_swap_path_matches_plain_on_card(cuda, E, C, D, F, counts):
    """One launch on the swap path (its split over D as ``gmm_splits``
    picks it for this card), within GMM_TOL of the plain version and one
    bf16 ulp of the split's plain version; rows >= counts[e] exactly zero;
    two calls bitwise equal (the partials are summed in rank order)."""
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 plain versions
    x, w, cnt = _card_inputs(7, E, C, D, F, counts, cuda)
    before, paths = ops.launches, dict(ops.launches_by_path)
    out = ops.grouped_matmul(x, w, cnt)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    assert ops.launches_by_path["swap"] == paths["swap"] + 1
    splits = ops.gmm_splits(E, C, D, F, ops._sm_count(cuda))
    torch.testing.assert_close(out.float(), gmm_reference(x, w, cnt).float(),
                               atol=GMM_TOL[torch.bfloat16],
                               rtol=GMM_TOL[torch.bfloat16])
    torch.testing.assert_close(
        out.float(), gmm_split_reference(x, w, cnt, splits).float(),
        **ULP_TOL)
    rows = torch.arange(C, device=cuda)[None, :, None] >= cnt[:, None, None]
    assert not out.float().masked_select(rows).any()
    again = ops.grouped_matmul(x, w, cnt)
    torch.cuda.synchronize()
    assert torch.equal(out, again)


@pytest.mark.gpu
@pytest.mark.parametrize("splits", SPLITS)
def test_swap_path_takes_every_split_on_card(cuda, splits):
    """The entry point at each split of one EP-shaped call (4 experts,
    C 16, D 2048, F 256: 8 tiles): within one bf16 ulp of the split's
    plain version, and the same bits when run twice."""
    torch.backends.cuda.matmul.allow_tf32 = False
    E, C, D, F = 4, 16, 2048, 256
    x, w, cnt = _card_inputs(8, E, C, D, F, "random", cuda)
    lib = ops.build().lib
    outs = []
    for _ in range(2):
        out = torch.empty((E, C, F), dtype=torch.bfloat16, device=cuda)
        err = lib.repro_moe_gmm(x.data_ptr(), w.data_ptr(), cnt.data_ptr(),
                                out.data_ptr(), ops.PATHS.index("swap"),
                                splits, E, C, D, F,
                                torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        assert err == 0
        outs.append(out)
    torch.testing.assert_close(outs[0].float(),
                               gmm_split_reference(x, w, cnt, splits).float(),
                               **ULP_TOL)
    assert torch.equal(outs[0], outs[1])


@pytest.mark.gpu
@pytest.mark.parametrize("E,C,D,F,splits", [
    (2, 8, 37, 64, 1),      # D not a multiple of 8
    (2, 16, 64, 45, 1),     # F not a multiple of 8
    (2, 17, 64, 64, 1),     # C > 16
    (2, 8, 2048, 64, 3),    # not a cluster of 1, 2, 4 or 8
    (2, 8, 2048, 64, 16),
])
def test_swap_path_refuses_what_tma_cannot_address(cuda, E, C, D, F,
                                                   splits):
    """The entry point refuses the swap path (and a split it does not
    take) instead of running another kernel; the wrapper sends such
    shapes to the fill path."""
    x, w, cnt = _card_inputs(9, E, C, D, F, "full", cuda)
    lib = ops.build().lib
    out = torch.zeros((E, C, F), dtype=torch.bfloat16, device=cuda)
    err = lib.repro_moe_gmm(x.data_ptr(), w.data_ptr(), cnt.data_ptr(),
                            out.data_ptr(), ops.PATHS.index("swap"), splits,
                            E, C, D, F,
                            torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err != 0 and not out.any()


def _card_f32(seed, E, C, D, F, counts, device):
    """f32 x ~ N(0, 1), w ~ N(0, 1 / D) and int32 counts, drawn on the card
    as ``_card_inputs`` draws them."""
    x, w, cnt = _card_inputs(seed, E, C, D, F, counts, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)
    return (torch.randn((E, C, D), generator=gen, device=device),
            torch.randn((E, D, F), generator=gen, device=device) * D ** -0.5,
            cnt)


@pytest.mark.gpu
@pytest.mark.parametrize("counts", TF32_COUNTS + ("decode",))
@pytest.mark.parametrize("E,C,D,F", TF32_EDGES)
def test_tf32x3_path_matches_plain_on_card(cuda, E, C, D, F, counts):
    """One "tf32x3" launch (its split over D as ``gmm_splits`` picks it for
    this card), within f32's 1e-4 of the plain version and of the plain
    version of its own arithmetic; rows >= counts[e] exactly zero; two
    calls bitwise equal."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x, w, cnt = _card_f32(10, E, C, D, F, counts, cuda)
    before, paths = ops.launches, dict(ops.launches_by_path)
    out = ops.grouped_matmul(x, w, cnt)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    assert ops.launches_by_path["tf32x3"] == paths["tf32x3"] + 1
    assert out.dtype == torch.float32 and out.shape == (E, C, F)
    splits = ops.gmm_splits(E, C, D, F, ops._sm_count(cuda))
    tol = GMM_TOL[torch.float32]
    torch.testing.assert_close(out, gmm_reference(x, w, cnt), atol=tol,
                               rtol=tol)
    torch.testing.assert_close(out, gmm_tf32x3_reference(x, w, cnt, splits),
                               atol=tol, rtol=tol)
    rows = torch.arange(C, device=cuda)[None, :, None] >= cnt[:, None, None]
    assert not out.masked_select(rows).any()
    again = ops.grouped_matmul(x, w, cnt)
    torch.cuda.synchronize()
    assert torch.equal(out, again)


@pytest.mark.gpu
@pytest.mark.parametrize("splits", SPLITS)
def test_tf32x3_path_takes_every_split_on_card(cuda, splits):
    """The entry point at each split of one EP-shaped f32 call (4 experts,
    C 16, D 2048, F 256): within 1e-4 of the plain version of that split,
    and the same bits when run twice."""
    torch.backends.cuda.matmul.allow_tf32 = False
    E, C, D, F = 4, 16, 2048, 256
    x, w, cnt = _card_f32(11, E, C, D, F, "random", cuda)
    lib = ops.build().lib
    outs = []
    for _ in range(2):
        out = torch.empty((E, C, F), device=cuda)
        err = lib.repro_moe_gmm(x.data_ptr(), w.data_ptr(), cnt.data_ptr(),
                                out.data_ptr(), ops.PATHS.index("tf32x3"),
                                splits, E, C, D, F,
                                torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        assert err == 0
        outs.append(out)
    torch.testing.assert_close(outs[0],
                               gmm_tf32x3_reference(x, w, cnt, splits),
                               atol=1e-4, rtol=1e-4)
    assert torch.equal(outs[0], outs[1])


@pytest.mark.gpu
@pytest.mark.parametrize("E,C,D,F,splits,shift", [
    (2, 8, 38, 64, 1, 0),      # D not a multiple of 4
    (2, 16, 64, 46, 1, 0),     # F not a multiple of 4
    (2, 32, 64, 64, 1, 1),     # x's base off 16 bytes
    (2, 17, 64, 64, 2, 0),     # a split over D at C > 16
    (2, 8, 2048, 64, 3, 0),    # not a cluster of 1, 2, 4 or 8
])
def test_tf32x3_path_refuses_what_tma_cannot_address(cuda, E, C, D, F,
                                                     splits, shift):
    """The entry point refuses the tf32x3 path (and a split it does not
    take) instead of running another kernel; the wrapper sends such
    shapes to the fma path."""
    x, w, cnt = _card_f32(12, E, C, D, F, "full", cuda)
    xs = torch.empty(E * C * D + shift, device=cuda)[shift:].view(E, C, D)
    xs.copy_(x)
    lib = ops.build().lib
    out = torch.zeros((E, C, F), device=cuda)
    err = lib.repro_moe_gmm(xs.data_ptr(), w.data_ptr(), cnt.data_ptr(),
                            out.data_ptr(), ops.PATHS.index("tf32x3"), splits,
                            E, C, D, F,
                            torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err != 0 and not out.any()
    if splits == 1:
        assert ops.gmm_path(torch.float32, C, D, F,
                            xs.data_ptr() % 16 == 0) == "fma"
