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
  ``train_attention`` is the train path: JAX's own dispatch between
  ``masked_attention`` and ``flash_attention_blocked`` (the counterpart of
  its jnp ``flash_attention_jnp``), under autograd; the kernel has no
  backward, and JAX's training path reaches no Pallas kernel either.
  ``decode_attention`` is single-query attention against a KV cache in
  plain torch ops (the JAX package has no Pallas kernel for it).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Shard
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.sharding import spmd


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


def unstack(tree, n: int):
    """The n per-layer views of a tree of stacked (n, ...) leaves, from one
    ``unbind`` a leaf (under autograd its backward is one ``stack``)."""
    if isinstance(tree, dict):
        parts = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(tree.unbind(0))


def param_logical(defs):
    """The tree of each leaf's logical axis names (JAX's ``param_logical``)."""
    return tree_map(lambda _, d: d.logical, defs)


def param_shapes(defs, dtype: torch.dtype = torch.float32):
    """The tree of (shape, dtype) of each leaf: JAX's ``param_shapes``,
    whose ``ShapeDtypeStruct`` leaves become ``torch.Size`` + dtype
    pairs (``ShapeDtype``)."""
    return tree_map(lambda _, d: ShapeDtype(torch.Size(d.shape), dtype),
                    defs)


@dataclasses.dataclass(frozen=True)
class ShapeDtype:
    shape: torch.Size
    dtype: torch.dtype


def count_params(tree) -> int:
    return int(sum(x.numel() for x in tree_leaves(tree)))


def dense(x, w):
    """``x @ w`` (w 2-D) over x's last dim, as one 2-D product: the same
    numbers as ``@``. On a mesh, where x's sharded dims and w's columns
    make the product local, it is one per-device product
    (``_local_placements``): DTensor's own matmul flattens x's leading
    dims, which turns two sharded dims into a strided sharding it cannot
    trace without data, and broadcasts w into a batched product when a
    dim has size 1 (a decode step's (B, 1, D))."""
    if isinstance(x, DTensor) and isinstance(w, DTensor):
        out = _local_placements(x, w)
        if out is not None:
            return spmd.shard_map(lambda a, b: a @ b, x.device_mesh,
                                  (x.placements, w.placements), out)(x, w)
    return (x.reshape(-1, x.shape[-1]) @ w).reshape(*x.shape[:-1],
                                                    w.shape[-1])


def _local_placements(x, w):
    """The placements of x @ w when every device can compute its block of
    the output from its own blocks of x and w (x not sharded on its last
    dim, w not on its rows, no mesh dim sharding both); else None."""
    last = x.dim() - 1
    out = []
    for px, pw in zip(x.placements, w.placements):
        if isinstance(px, Partial) or isinstance(pw, Partial) or \
                (isinstance(pw, Shard) and pw.dim == 0):
            return None
        if isinstance(px, Shard):
            if px.dim == last or isinstance(pw, Shard):
                return None
            out.append(px)
        else:
            out.append(Shard(last) if isinstance(pw, Shard) else px)
    return tuple(out)


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


def sinusoidal_positions(n: int, d: int, dtype=torch.float32, device=None):
    """(n, d) table of [sin | cos] of position / 10000^(2i/d), i < d // 2:
    built in numpy float64 and cast once, as the JAX package builds it."""
    pos = np.arange(n)[:, None]
    dim = np.arange(d // 2)[None, :]
    ang = pos * (1.0 / (10000 ** (2 * dim / d)))
    table = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.as_tensor(table).to(device=device, dtype=dtype)


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
    """Prefill attention. q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D) with GQA
    left to the kernel (group = Hq // Hkv); query row i sits at key
    position ``q_offset + i`` (context parallelism passes its rank's
    offset among the gathered keys).

    A CUDA tensor goes to the flash kernel at every length, a logit
    ``softcap`` included (the kernel caps the scaled scores); a CPU tensor
    goes to the kernel's plain version through the same wrapper."""
    return flash_attention(q, k, v, causal=causal, window=window,
                           q_offset=q_offset, softcap=softcap)


def flash_attention_blocked(q, k, v, *, causal: bool = True,
                            window: int = 0, q_offset: int = 0,
                            q_block: int = 512, kv_block: int = 1024,
                            softcap: float = 0.0):
    """Blocked online-softmax attention in torch ops (JAX's
    ``flash_attention_jnp``).

    q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D), Sq a multiple of q_block and
    Sk of kv_block; ``q_offset`` is the key position of q[0] (context
    parallelism passes ``rank * local_len``). Kv blocks that the causal mask or the window hide
    entirely are skipped, as JAX's ``lax.cond`` skips them. Scores and the
    softmax statistics are f32; the running output is in v's dtype, as in
    JAX. Returns (B, Sq, Hq, D)."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    if Sq % q_block or Sk % kv_block:
        raise ValueError(f"Sq {Sq} / Sk {Sk} not multiples of q_block "
                         f"{q_block} / kv_block {kv_block}")
    dev = q.device
    outs = []
    for q_row in range(0, Sq, q_block):
        q_start = q_offset + q_row
        qblk = q[:, q_row:q_row + q_block].reshape(
            B, q_block, Hkv, G, D) * (D ** -0.5)
        qpos = q_start + torch.arange(q_block, device=dev)[:, None]
        m = torch.full((B, Hkv, G, q_block), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, Hkv, G, q_block, D), dtype=v.dtype, device=dev)
        for k_start in range(0, Sk, kv_block):
            if causal and k_start > q_start + q_block - 1:
                continue
            if window > 0 and k_start + kv_block - 1 <= q_start - window:
                continue
            kblk = k[:, k_start:k_start + kv_block]
            vblk = v[:, k_start:k_start + kv_block]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qblk.float(), kblk.float())
            if softcap > 0:
                s = torch.tanh(s / softcap) * softcap
            kpos = k_start + torch.arange(kv_block, device=dev)[None, :]
            mask = torch.ones((q_block, kv_block), dtype=torch.bool,
                              device=dev)
            if causal:
                mask &= kpos <= qpos
            if window > 0:
                mask &= kpos > qpos - window
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(vblk.dtype), vblk)
            acc = acc * corr[..., None].to(acc.dtype) + pv
            m = m_new
        out = acc / l.clamp_min(1e-20)[..., None].to(acc.dtype)
        outs.append(out.permute(0, 3, 1, 2, 4))     # (B, q_block, Hkv, G, D)
    return torch.cat(outs, dim=1).reshape(B, Sq, Hq, D)


# context-parallel entry point: the same math, an explicit q_offset
flash_attention_cp = flash_attention_blocked


def train_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, q_block: int = 512,
                    kv_block: int = 1024):
    """Train-mode attention: JAX's ``layers.attention`` dispatch (short or
    ragged sequences materialize the scores, long ones go blocked), in
    torch ops that autograd differentiates. Calls no kernel."""
    S = q.shape[1]
    if S <= max(q_block, 512) or S % q_block or S % kv_block:
        return masked_attention(q, k, v, causal=causal, window=window,
                                softcap=softcap)
    return flash_attention_blocked(q, k, v, causal=causal, window=window,
                                   softcap=softcap, q_block=q_block,
                                   kv_block=kv_block)


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


def decode_attention_partial(q, k_cache, v_cache, pos, row0: int, *,
                             window: int = 0, softcap: float = 0.0):
    """``decode_attention`` over a slice of the cache whose first row is at
    position ``row0``, as the softmax's partial terms in f32: the row max
    m (B, Hkv, G), the sum l of exp(s - m) and acc = sum exp(s - m) v
    (B, Hkv, G, D). Slices combine as exp(m_i - max m) weights of their l
    and acc (a slice with no valid row has m = NEG_INF and weight 0)."""
    B, _, Hq, D = q.shape
    Hkv = k_cache.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, D) * (D ** -0.5)
    s = torch.einsum("bhgd,bkhd->bhgk", qg.float(), k_cache.float())
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    kpos = row0 + torch.arange(k_cache.shape[1], device=q.device)[None, :]
    mask = kpos <= pos[:, None]
    if window > 0:
        mask &= kpos > pos[:, None] - window
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    acc = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return m, p.sum(dim=-1), acc


# the matrix products that remat "dots" keeps (JAX's checkpoint_dots saves
# every dot_general; einsum and matmul reach these at the aten level)
DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat(body: Callable, policy: str) -> Callable:
    """JAX's ``_remat`` policies: "none" keeps every activation; "dots"
    keeps the matrix products' outputs and recomputes the rest in the
    backward; any other ("block", "full") keeps only the body's inputs."""
    if policy == "none":
        return body
    kw = {"use_reentrant": False}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    return lambda *args: checkpoint(body, *args, **kw)
