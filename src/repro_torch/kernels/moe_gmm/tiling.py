"""How the swap path (bf16, C <= 16) and the tf32x3 path (f32) cut the
product into tiles: 128 output columns a tile; D in tiles of 64 (bf16) or
32 (f32: 128 bytes either way); at C <= 16 a cluster of at most 8 blocks
along D. ``csrc/moe_gmm.cu`` has the same numbers (``SW_BN``, ``SW_BK``,
``SW_MAX_SPLITS``, ``TF_BN``, ``TF_BK``, ``split_lo``); ``ops.build``
checks the library against these when it loads it. The wrapper
(``ops.gmm_splits``) and the plain versions of the split
(``ref.gmm_split_reference``, ``ref.gmm_tf32x3_reference``) read them
from here.
"""
from __future__ import annotations

# the swap path's output columns a tile, D a stage, and largest cluster
SWAP_COLS = 128
SWAP_DEPTH = 64
MAX_SPLITS = 8
# the tf32x3 path's output columns a tile and D a stage
TF32_COLS = 128
TF32_DEPTH = 32


def split_bounds(D: int, splits: int,
                 depth: int = SWAP_DEPTH) -> list[tuple[int, int]]:
    """The D range [lo, hi) that each of ``splits`` blocks sums: rank r
    takes D tiles r nk / splits .. (r + 1) nk / splits of the nk tiles of
    ``depth`` (some ranges are empty where splits > nk)."""
    nk = -(-D // depth)
    return [(min(D, depth * (r * nk // splits)),
             min(D, depth * ((r + 1) * nk // splits)))
            for r in range(splits)]
