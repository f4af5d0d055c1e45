"""Optimizers of the port, written per leaf over the nested parameter
dicts: AdamW, Adafactor (factored second moment) and SGD, with JAX's
learning-rate schedule and global-norm clipping (counterpart of
``repro.training.optimizer``).

Not ``torch.optim``: JAX's AdamW adds weight decay only to leaves with
ndim >= 2, adds it to the step before the learning rate, and bias-corrects
as ``training/optimizer.py:69-91`` writes it; ``torch.optim.AdamW`` does
none of these the same way.

``update`` changes the parameters and the state in place and returns
them (JAX donates both to the jitted step). The step count ``count`` is a
0-d int32 tensor on the CPU: the schedule is computed on the host, so a
step reads nothing back from the card. ``state_dtype`` "bfloat16" keeps
the moments in bf16, each update computed in f32. ``state_pspecs``
gives the state's partition specs from the parameters' (JAX's): the
moments as their parameters, Adafactor's factored rows and columns
without the factored dim, the step count replicated.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.models.layers import tree_leaves, tree_map

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"              # adamw | adafactor | sgd
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    state_dtype: str = "float32"
    warmup: int = 100
    decay_steps: int = 10_000
    min_lr_frac: float = 0.1


def lr_at(cfg: OptConfig, step) -> float:
    """Linear warm-up then cosine decay to ``min_lr_frac``, in float32 as
    JAX computes it. ``step``: an int or a 0-d tensor."""
    f32 = np.float32
    step = f32(int(step))
    warm = min(f32(1.0), (step + f32(1)) / f32(max(cfg.warmup, 1)))
    prog = np.clip((step - f32(cfg.warmup))
                   / f32(max(cfg.decay_steps - cfg.warmup, 1)),
                   f32(0.0), f32(1.0))
    cos = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * prog))
    frac = f32(cfg.min_lr_frac) + f32(1 - cfg.min_lr_frac) * cos
    return float(f32(cfg.lr) * warm * frac)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (a 0-d tensor on
    the leaves' device)."""
    return torch.sqrt(sum(x.float().square().sum() for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """Scale every leaf by min(1, max_norm / global norm), in place.
    Returns (grads, the norm before clipping)."""
    g = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(g, min=1e-9), max=1.0)
    for x in tree_leaves(grads):
        x.mul_(scale)
    return grads, g


def _zeros(p, dtype, shape=None, drop=None):
    """Zeros of ``shape`` (default p's) on p's device. On a mesh (p a
    DTensor) laid out as p, with p's dim ``drop`` removed when ``shape``
    drops it (Adafactor's factored rows and columns, as ``state_pspecs``
    gives them)."""
    if not isinstance(p, DTensor):
        return torch.zeros(p.shape if shape is None else shape, dtype=dtype,
                           device=p.device)
    if shape is None:
        return torch.zeros_like(p, dtype=dtype)
    pl = []
    for x in p.placements:
        if isinstance(x, Shard):
            d = x.dim % p.dim()
            x = Replicate() if d == drop else Shard(d - (d > drop))
        pl.append(x)
    return distribute_tensor(
        torch.zeros(shape, dtype=dtype, device=p.device_mesh.device_type),
        p.device_mesh, pl, src_data_rank=None)


def _count():
    return torch.zeros((), dtype=torch.int32)


def _apply_step(p, step, lr: float, weight_decay: float) -> None:
    """p -= lr * (step + wd * p for matrices), the step in f32."""
    if p.dim() >= 2:
        step.add_(p.float(), alpha=weight_decay)
    if p.dtype == torch.float32:
        p.add_(step, alpha=-lr)
    else:
        p.copy_(p.float().add_(step, alpha=-lr))


def _store(dst, src) -> None:
    """Write an f32 result into a state leaf that may be bf16 (no-op when
    ``src`` is the leaf itself)."""
    if src is not dst:
        dst.copy_(src)


class Optimizer:
    """(init, update) over nested dicts of tensors; ``update`` runs in
    place, under ``torch.no_grad``."""

    def __init__(self, cfg: OptConfig):
        self.cfg = cfg

    # ---- adamw -------------------------------------------------------------
    def _adamw_init(self, params):
        dt = DTYPES[self.cfg.state_dtype]
        return {"m": tree_map(lambda _, p: _zeros(p, dt), params),
                "v": tree_map(lambda _, p: _zeros(p, dt), params),
                "count": _count()}

    def _adamw_update(self, grads, state, params):
        c = self.cfg
        cnt = int(state["count"]) + 1
        lr = lr_at(c, cnt)
        b1c = float(1 - np.float32(c.b1) ** np.float32(cnt))
        b2c = float(1 - np.float32(c.b2) ** np.float32(cnt))
        for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state["m"]),
                              tree_leaves(state["v"]), tree_leaves(params)):
            g32 = g.float()
            m32 = m.float().mul_(c.b1).add_(g32, alpha=1 - c.b1)
            v32 = v.float().mul_(c.b2).addcmul_(g32, g32, value=1 - c.b2)
            _store(m, m32)
            _store(v, v32)
            step = (m32 / b1c).div_((v32 / b2c).sqrt_().add_(c.eps))
            _apply_step(p, step, lr, c.weight_decay)
        state["count"].fill_(cnt)
        return params, state

    # ---- adafactor ----------------------------------------------------------
    def _adafactor_init(self, params):
        dt = DTYPES[self.cfg.state_dtype]

        def st(_, p):
            if p.dim() >= 2:
                n = p.dim()
                return {"vr": _zeros(p, dt, p.shape[:-1], n - 1),
                        "vc": _zeros(p, dt, p.shape[:-2] + p.shape[-1:],
                                     n - 2)}
            return {"v": _zeros(p, dt)}
        return {"f": tree_map(st, params), "count": _count()}

    def _adafactor_update(self, grads, state, params):
        c = self.cfg
        cnt = int(state["count"]) + 1
        lr = lr_at(c, cnt)
        beta = float(1.0 - np.float32(cnt + 1) ** np.float32(-0.8))

        def one(path, p):
            g, f = _at(grads, path), _at(state["f"], path)
            g32 = g.float()
            sq = g32.square().add_(1e-30)
            if p.dim() >= 2:
                vr = f["vr"].float().mul_(beta).add_(sq.mean(dim=-1),
                                                     alpha=1 - beta)
                vc = f["vc"].float().mul_(beta).add_(sq.mean(dim=-2),
                                                     alpha=1 - beta)
                _store(f["vr"], vr)
                _store(f["vc"], vc)
                denom = (vr[..., None] * vc[..., None, :]
                         / vr.mean(dim=-1)[..., None, None].clamp_min(1e-30))
                step = g32 / (denom.sqrt_().add_(1e-12))
            else:
                v = f["v"].float().mul_(beta).add_(sq, alpha=1 - beta)
                _store(f["v"], v)
                step = g32 / (v.sqrt().add_(1e-12))
            # relative step clipping (Shazeer & Stern)
            rms = step.square().mean().sqrt()
            step.div_(rms.clamp_min(1.0))
            _apply_step(p, step, lr, c.weight_decay)
        tree_map(one, params)
        state["count"].fill_(cnt)
        return params, state

    # ---- sgd ---------------------------------------------------------------
    def _sgd_init(self, params):
        return {"count": _count()}

    def _sgd_update(self, grads, state, params):
        cnt = int(state["count"]) + 1
        lr = lr_at(self.cfg, cnt)
        for g, p in zip(tree_leaves(grads), tree_leaves(params)):
            if p.dtype == torch.float32:
                p.add_(g.float(), alpha=-lr)
            else:
                p.copy_(p.float().add_(g.float(), alpha=-lr))
        state["count"].fill_(cnt)
        return params, state

    # ---- public -------------------------------------------------------------
    def init(self, params):
        return getattr(self, f"_{self.cfg.name}_init")(params)

    def state_pspecs(self, param_pspecs, param_shapes):
        """The state's ``Rules.spec`` tuples from the parameters' specs
        and shapes (trees of tuples and of anything with ``.shape``)."""
        if self.cfg.name == "adamw":
            return {"m": param_pspecs, "v": param_pspecs, "count": ()}
        if self.cfg.name == "adafactor":
            def st(spec, shape):
                if isinstance(spec, dict):
                    return {k: st(spec[k], shape[k]) for k in spec}
                dims = len(getattr(shape, "shape", shape))
                parts = list(spec) + [None] * (dims - len(spec))
                if dims >= 2:
                    return {"vr": _trim(parts[:-1]),
                            "vc": _trim(parts[:-2] + parts[-1:])}
                return {"v": _trim(parts)}
            return {"f": st(param_pspecs, param_shapes), "count": ()}
        return {"count": ()}

    @torch.no_grad()
    def update(self, grads, state, params):
        """One step: clip ``grads`` (in place) when ``grad_clip`` > 0, then
        update ``params`` and ``state`` in place. Returns (params, state)."""
        if self.cfg.grad_clip > 0:
            grads, _ = clip_by_global_norm(grads, self.cfg.grad_clip)
        return getattr(self, f"_{self.cfg.name}_update")(grads, state,
                                                         params)


def _trim(parts) -> tuple:
    """A spec without its trailing Nones, as ``PartitionSpec`` prints."""
    parts = list(parts)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree
