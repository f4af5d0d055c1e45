"""The port's grouped matmul (moe_gmm) against the JAX package's kernel and
oracle.

On the CPU the port's wrapper takes the plain version
(``repro_torch.kernels.moe_gmm.ref``), which is held against the Pallas
kernel in interpret mode and against ``gmm_reference`` on the shapes of
``tests/test_kernels.py``, with random counts and with counts of 0 and C.
The CUDA kernel is held against the plain version on the card (``gpu``
marker), ragged shapes and the edges of its tensor-core paths (C of 1, 8,
9 and 160; D and F not multiples of 8) included; the ``wgmma`` path (bf16,
C > 16) on its own edges at ``chip_smoke.py``'s ``GMM_TOL``. The wrapper's
choice of path (``ops.gmm_path``) is a pure function, tested here.

Tolerances are the repo's own: 1e-4 in f32, 1e-1 in bf16 (``GMM_TOL``:
3e-2 in bf16 for the wgmma edges, on weights at std D^-1/2).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.moe_gmm import ops  # noqa: E402
from repro_torch.kernels.moe_gmm.ref import gmm_reference  # noqa: E402

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
GMM_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


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
           "full": np.full((E,), C)}[counts].astype(np.int32)
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


@pytest.mark.parametrize("dtype,C,D,F,aligned,path", [
    (torch.float32, 8, 2048, 1024, True, "fma"),
    (torch.float32, 160, 2048, 1024, True, "fma"),
    (torch.float32, 21, 37, 45, False, "fma"),
    (torch.bfloat16, 1, 64, 128, True, "swap"),
    (torch.bfloat16, 8, 2048, 1024, True, "swap"),
    (torch.bfloat16, 16, 37, 45, False, "swap"),
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
    before = ops.launches
    out = _port(x, w, cnt, dtype, device=cuda)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
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
    of one expert in use, the others empty."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    x = torch.randn((E, C, D), generator=gen, device=device).bfloat16()
    w = (torch.randn((E, D, F), generator=gen, device=device)
         * D ** -0.5).bfloat16()
    if counts == "random":
        cnt = torch.randint(0, C + 1, (E,), generator=gen, device=device,
                            dtype=torch.int32)
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
                            out.data_ptr(), ops.PATHS.index("wgmma"), 2, 32,
                            37, 45, torch.cuda.current_stream().cuda_stream)
    assert err != 0
