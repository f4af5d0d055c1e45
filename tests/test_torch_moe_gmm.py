"""The port's grouped matmul (moe_gmm) against the JAX package's kernel and
oracle.

On the CPU the port's wrapper takes the plain version
(``repro_torch.kernels.moe_gmm.ref``), which is held against the Pallas
kernel in interpret mode and against ``gmm_reference`` on the shapes of
``tests/test_kernels.py``, with random counts and with counts of 0 and C.
The CUDA kernel is held against the plain version on the card (``gpu``
marker), ragged shapes and the edges of its tensor-core paths (C of 1, 8,
9 and 160; D and F not multiples of 8) included.

Tolerances are the repo's own: 1e-4 in f32, 1e-1 in bf16.
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
