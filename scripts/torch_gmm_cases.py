"""moe_gmm's timed shapes, shared by ``chip_smoke.py`` ((c2)'s serve rows,
(t)'s expert-parallel rows) and ``scripts/torch_gmm_times.py``.

Imports torch only at import time; ``ep_cases`` reads olmoe-1b-7b's
config from whichever checkout's ``repro_torch`` is on the path.
"""
from __future__ import annotations

import torch

# olmoe-1b-7b's serve path on one card: (label, E, C, D, F, counts); counts
# "decode" (32 of the 64 experts hold one row) or "route<T>" (the rows T
# random tokens give each expert under top-8 routing, at most C)
SERVE_SHAPES = [
    ("decode gate/up", 64, 8, 2048, 1024, "decode"),
    ("decode down", 64, 8, 1024, 2048, "decode"),
    ("prefill T=1024 gate/up", 64, 160, 2048, 1024, "route1024"),
    ("prefill T=1024 down", 64, 160, 1024, 2048, "route1024"),
    ("prefill T=300 gate/up", 64, 48, 2048, 1024, "route300"),
]

# (t): olmoe-1b-7b's expert-parallel shapes under EP 16: 4 experts a
# device; the all-to-all receive buffer of a 1024-token prefill rank (16
# senders x the capacity), and the replicated decode's buffer of 8 tokens
# a data rank under both capacity formulas (JAX's 4.0 baseline and the
# tight one at 2.0)
EP_N, EP_DECODE_T = 16, 8


def ep_cases() -> list[tuple]:
    """(label, E_loc, C, d_model, d_ff) of each (t) buffer."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as M
    cfg = get_config("olmoe-1b-7b")
    E, k, D, Fd = cfg.moe.n_experts, cfg.moe.top_k, cfg.d_model, cfg.d_ff
    e_loc = E // EP_N
    cap = M._capacity(1024, k, E, cfg.moe.capacity_factor)
    out = [("a2a prefill", e_loc, EP_N * cap, D, Fd)]
    for mult in (4.0, 2.0):
        c = M._decode_capacity(mult, EP_DECODE_T, k, E)
        out.append((f"replicated decode cap_mult {mult}", e_loc, c, D, Fd))
    return out


def gmm_counts(kind: str, E: int, C: int, gen, dev) -> torch.Tensor:
    """Rows in use a expert: "zero", "full" (C), "one" (every row in one
    expert), "random" (uniform in [0, C]), "decode" or "route<T>"."""
    if kind in ("zero", "full"):
        return torch.full((E,), 0 if kind == "zero" else C,
                          dtype=torch.int32, device=dev)
    if kind == "one":
        return torch.zeros((E,), dtype=torch.int32, device=dev).index_fill_(
            0, torch.tensor([E // 2], device=dev), C)
    if kind == "random":
        return torch.randint(0, C + 1, (E,), generator=gen, device=dev,
                             dtype=torch.int32)
    if kind == "decode":
        used = torch.randperm(E, generator=gen, device=dev)[:E // 2]
        return torch.zeros((E,), dtype=torch.int32, device=dev).index_fill_(
            0, used, 1)
    T = int(kind.removeprefix("route"))
    probs = torch.softmax(torch.randn((T, E), generator=gen, device=dev), -1)
    tope = torch.topk(probs, 8, dim=-1).indices.reshape(-1)
    return torch.bincount(tope, minlength=E).clamp(max=C).to(torch.int32)
