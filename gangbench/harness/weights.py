"""Weights drawn on the device from the seed, leaf by stacked leaf, in the
type they are served in.

A spec is a list of (path, shape, kind, arg) in a fixed order: the order
fixes which numbers of the generator each leaf takes, so the same seed
gives the same tree. Kinds: "normal" (std ``arg``), "normal1" (1 + std
``arg``), "ones", "zeros", "log_loguniform" (log of a log-uniform draw
on ``arg`` = (lo, hi)), "softplus_inv_loguniform" (the softplus inverse
of such a draw).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Spec = List[Tuple[Tuple[str, ...], Tuple[int, ...], str, object]]


def _loguniform(shape, lo, hi, gen, device):
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    return torch.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))


def draw(spec: Spec, seed: int, device, dtype: torch.dtype) -> Dict:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**63)
    tree: Dict = {}
    for path, shape, kind, arg in spec:
        if kind in ("normal", "normal1"):
            t = torch.randn(shape, generator=gen, device=device, dtype=dtype)
            t.mul_(arg)
            if kind == "normal1":
                t.add_(1.0)
        elif kind == "ones":
            t = torch.ones(shape, device=device, dtype=dtype)
        elif kind == "zeros":
            t = torch.zeros(shape, device=device, dtype=dtype)
        elif kind == "log_loguniform":
            t = torch.log(_loguniform(shape, *arg, gen, device)).to(dtype)
        elif kind == "softplus_inv_loguniform":
            x = _loguniform(shape, *arg, gen, device)
            t = (x + torch.log(-torch.expm1(-x))).to(dtype)
        else:
            raise ValueError(f"unknown weight kind {kind!r}")
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    return tree

