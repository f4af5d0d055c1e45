"""How the swap path (bf16, C <= 16) cuts the product into tiles: 128
output columns a tile, D in tiles of 64, a cluster of at most 8 blocks
along D. ``csrc/moe_gmm.cu`` has the same numbers (``SW_BN``, ``SW_BK``,
``SW_MAX_SPLITS``, ``split_lo``); ``ops.build`` checks the library against
these when it loads it. The wrapper (``ops.gmm_splits``) and the plain
version of the split (``ref.gmm_split_reference``) read them from here.
"""
from __future__ import annotations

# the swap path's output columns a tile, D a stage, and largest cluster
SWAP_COLS = 128
SWAP_DEPTH = 64
MAX_SPLITS = 8


def split_bounds(D: int, splits: int) -> list[tuple[int, int]]:
    """The D range [lo, hi) that each of ``splits`` blocks sums: rank r
    takes D tiles r nk / splits .. (r + 1) nk / splits of the nk tiles of
    64 (some ranges are empty where splits > nk)."""
    nk = -(-D // SWAP_DEPTH)
    return [(min(D, SWAP_DEPTH * (r * nk // splits)),
             min(D, SWAP_DEPTH * ((r + 1) * nk // splits)))
            for r in range(splits)]
