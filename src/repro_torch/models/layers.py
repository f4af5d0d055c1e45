"""Core layers of the port: param-def system, norms, RoPE, attention, MLP.

Counterpart of ``repro.models.layers`` with the same numerics (f32 norm
statistics, silu/gelu in f32, RoPE angles in f32, split-half rotation).

* Params are nested dicts of tensors. Each model first constructs a
  matching nested dict of :class:`ParamDef` (shape + logical axis names +
  initializer), from which ``init_params`` draws real tensors.
* Attention: ``attention`` is the prefill path. On the card it is the
  hand-written flash kernel (``repro_torch.kernels.flash_attention``) at
  every prompt length — the kernel that replaces the JAX package's jnp
  flash twin; on the CPU the kernel wrapper takes its plain version.
  ``decode_attention`` is single-query attention against a KV cache in
  plain torch ops (the JAX package has no Pallas kernel for it).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.ops import flash_attention


# --------------------------------------------------------------------------
# Param definition system
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "normal"        # normal | zeros | ones | small_normal
    scale: float = 1.0          # stddev multiplier for normal inits

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} vs logical {self.logical}")


def tree_map(fn, tree, path: Tuple[str, ...] = ()):
    """Apply ``fn(path, leaf)`` to every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def _init_one(gen: torch.Generator, d: ParamDef, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)
    fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
    std = d.scale / math.sqrt(max(fan_in, 1))
    out = torch.empty(d.shape, dtype=dtype, device=device)
    # draw f32 one leading slice at a time, so a stacked leaf never needs
    # an f32 copy of the whole stack
    rows = out.view(-1, *d.shape[-2:]) if len(d.shape) > 2 else out[None]
    for r in rows:
        r.copy_(torch.randn(r.shape, generator=gen, dtype=torch.float32,
                            device=device) * std)
    return out


def init_params(defs, *, seed: int, dtype: torch.dtype,
                device: torch.device):
    """Draw every leaf at JAX's scale (``scale / sqrt(shape[-2])``) with a
    seeded generator on ``device``. The numbers differ from
    ``jax.random``'s; tests carry JAX's parameters over instead
    (``repro_torch.convert``)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return tree_map(lambda _, d: _init_one(gen, d, dtype, device), defs)


def stack_defs(defs, n: int, axis_name: str = "layers"):
    """Prepend a layer dimension of size n to every ParamDef in the tree."""
    return tree_map(
        lambda _, d: ParamDef((n,) + d.shape, (axis_name,) + d.logical,
                              d.init, d.scale), defs)


def count_params(tree) -> int:
    return int(sum(x.numel() for x in tree_leaves(tree)))


# --------------------------------------------------------------------------
# Norms / activations
# --------------------------------------------------------------------------
def rms_norm(x, weight, eps: float = 1e-6):
    dtype = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return out.to(dtype) * weight.to(dtype)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    dtype = x.dtype
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return out.to(dtype) * weight.to(dtype) + bias.to(dtype)


def swiglu(gate, up):
    return F.silu(gate.float()).to(gate.dtype) * up


def gelu(x):
    return F.gelu(x.float(), approximate="tanh").to(x.dtype)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------
def rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freq = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half))
    ang = positions[..., :, None].float() * freq      # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------
NEG_INF = -1e30


def masked_attention(q, k, v, *, causal: bool = True, window: int = 0,
                     q_offset: int = 0, kv_len=None, softcap: float = 0.0):
    """Plain (materialized-scores) attention. Use only for small Sq*Sk.

    q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D). q_offset: absolute position
    of q[0]. kv_len: optional (B,) valid kv length. Returns (B, Sq, Hq, D).
    """
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D) * (D ** -0.5)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    if kv_len is not None:
        mask = mask[None] & (kpos[None] < kv_len[:, None, None])
        mask = mask[:, None, None]                      # (B,1,1,Sq,Sk)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v)
    return out.reshape(B, Sq, Hq, D)


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              softcap: float = 0.0, q_offset: int = 0):
    """Prefill attention. q: (B, S, Hq, D); k, v: (B, S, Hkv, D) with GQA
    left to the kernel (group = Hq // Hkv).

    A CUDA tensor goes to the flash kernel at every length, and the call
    raises where the kernel cannot compute it (``softcap``, ``q_offset``).
    A CPU tensor goes to the kernel's plain version through the same
    wrapper."""
    if q.is_cuda and (softcap != 0.0 or q_offset != 0):
        raise NotImplementedError(
            "the CUDA flash kernel has no logit softcap and no q_offset")
    if softcap != 0.0 or q_offset != 0:
        return masked_attention(q, k, v, causal=causal, window=window,
                                q_offset=q_offset, softcap=softcap)
    return flash_attention(q, k, v, causal=causal, window=window)


def decode_attention(q, k_cache, v_cache, pos, *, window: int = 0,
                     softcap: float = 0.0):
    """Single-position attention against a cache.

    q: (B, 1, Hq, D); caches: (B, Smax, Hkv, D); pos: (B,) current index
    (the new token's position; cache entries > pos are invalid).
    """
    B, _, Hq, D = q.shape
    Hkv = k_cache.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, D) * (D ** -0.5)
    s = torch.einsum("bhgd,bkhd->bhgk", qg.float(), k_cache.float())
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    kpos = torch.arange(k_cache.shape[1], device=q.device)[None, :]
    mask = kpos <= pos[:, None]
    if window > 0:
        mask &= kpos > pos[:, None] - window
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache)
    return out.reshape(B, 1, Hq, D)
