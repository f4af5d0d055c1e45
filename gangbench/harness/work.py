"""The work of one call of each hand-written kernel, from its shapes: the
operations its algorithm needs and the bytes it must move, each input
read once and each output written once (a frozen copy of the port's
``roofline/work.py`` formulas, with the routing-dependent counts of
moe_gmm passed in as numbers), and the peaks of the card they are held
against.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# NVIDIA's data sheet, H100 SXM, dense rates, at the 700 W limit. f32 work
# on the tensor cores runs as three TF32 products (split TF32): a third of
# the TF32 rate is its ceiling.
PEAKS = {
    "H100": {"bf16": 989e12, "f32": 495e12 / 3, "bytes": 3.35e12},
}


def peaks(kind: str) -> Optional[dict]:
    """The peaks of a card by its ``torch.cuda.get_device_name()``."""
    for key, value in PEAKS.items():
        if key in kind:
            return value
    return None


def bound_s(ops: float, nbytes: float, dtype: str, kind: str
            ) -> Optional[float]:
    """The least time the card could take: the larger of the operations
    over the peak rate of ``dtype`` and the bytes over the memory rate."""
    p = peaks(kind)
    if p is None:
        return None
    return max(ops / p[dtype], nbytes / p["bytes"])


def unmasked_pairs(Sq: int, Sk: int, causal: bool, window: int,
                   q_offset: int = 0) -> int:
    """(q, k) pairs of an Sq x Sk attention that the mask keeps."""
    i = q_offset + np.arange(Sq)
    hi = np.minimum(i, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros(Sq, int)
    return int(np.maximum(hi - lo + 1, 0).sum())


def visible_keys(Sq: int, Sk: int, causal: bool, window: int,
                 q_offset: int = 0) -> int:
    lo = max(q_offset - window + 1, 0) if window > 0 else 0
    hi = min(q_offset + Sq, Sk) if causal else Sk
    return max(hi - lo, 0)


def flash_work(B, Sq, Sk, Hq, Hkv, D, causal, window, itemsize,
               q_offset: int = 0) -> Tuple[int, int]:
    """4 x Hq x D operations a kept (q, k) pair; q read and o written
    once, k and v of the keys some row may see read once."""
    ops = 4 * B * Hq * D * unmasked_pairs(Sq, Sk, causal, window, q_offset)
    keys = visible_keys(Sq, Sk, causal, window, q_offset)
    return ops, itemsize * (2 * B * Sq * Hq * D + 2 * B * keys * Hkv * D)


def gmm_work(rows: int, experts_used: float, D: int, F: int,
             itemsize: int) -> Tuple[float, float]:
    """One grouped product of ``rows`` (token, expert) rows, D -> F:
    2 rows D F operations; the rows read, the used experts' weights read,
    the rows written."""
    return (2.0 * rows * D * F,
            float(itemsize) * (rows * D + experts_used * D * F + rows * F))


def experts_used(tokens: int, top_k: int, n_experts: int) -> float:
    """Experts that ``tokens`` tokens, each routed to ``top_k`` distinct
    experts, reach in expectation when routing is uniform."""
    return n_experts * (1.0 - (1.0 - top_k / n_experts) ** tokens)


def ssd_work(B, S, H, P, N, chunk, itemsize) -> Tuple[int, int]:
    """The chunked SSD scan: per chunk of q tokens the q (q + 1) / 2 pairs
    of the causal triangle, C B^T once per (b, chunk), per head the intra-
    chunk product, the inter-chunk term and the state update; x, dt, B,
    C, A read once, y and the final state written once."""
    Q = min(chunk, S)
    ops = 0
    for c0 in range(0, S, Q):
        q = min(Q, S - c0)
        pairs = unmasked_pairs(q, q, True, 0)
        ops += 2 * B * (pairs * N + H * (pairs * P + 2 * q * N * P))
    nbytes = itemsize * (2 * B * S * H * P + B * S * H + 2 * B * S * N) \
        + 4 * H + 4 * B * H * P * N
    return ops, nbytes
