"""Carry parameters across from the JAX package.

The one place where the two layouts meet. The port keeps the JAX tree as
it is — the same paths (``embed``, ``lm_head``, ``final_ln``,
``blocks/attn/{ln,wq,wk,wv,wo,bq,bk,bv}``, ``blocks/mlp/{ln,wg,wu,wd}``
for the dense family, ``blocks/moe/{ln,router,wg,wu,wd}`` for MoE, with
the expert weights (L, E, D, F) / (L, E, F, D), and ``blocks/{ln,in_x,
in_z,in_B,in_C,in_dt,conv_x,conv_B,conv_C,dt_bias,A_log,D_skip,gn,out}``
for SSM (Mamba2), the conv weights (L, W, C); for the hybrid
(RecurrentGemma) ``groups/rec<i>/mix/{ln,w_gate_branch,w_x_branch,conv,
w_a,b_a,w_i,b_i,lam,w_out}``, ``groups/rec<i>/mlp/...``,
``groups/attn<i>/{attn,mlp}/...`` stacked over the groups, with the
block-diagonal gates (G, nb, bw, bw), and ``tail/{mix,mlp}/...`` stacked
over the tail layers; for the vlm family the dense tree; for audio
(Whisper) ``embed``, ``pos_dec``, ``enc_blocks/{attn,mlp}/...``,
``enc_ln``, ``enc_ln_b``, ``dec_blocks/{self,cross,mlp}/...`` and
``final_ln``, ``final_ln_b``), the layers stacked along the leading
dimension, and the ``x @ W`` orientation — so conversion is a copy of
each leaf.

DAVE-2's flat tree (``dave2_params_from_jax_numpy``) is the exception: its
HWIO conv weights become OIHW.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.deeppicar import Dave2Config
from repro_torch.device import resolve_device
from repro_torch.models.dave2 import conv_weight, dave2_defs
from repro_torch.models.model import build_defs


def params_from_jax_numpy(tree, cfg: ModelConfig,
                          device: Optional[str | torch.device] = None,
                          dtype: Optional[torch.dtype] = None, *, api=None):
    """``tree``: the JAX parameter tree as numpy arrays, as
    ``jax.tree.map(np.asarray, api.init(key))`` gives it. Returns the same
    tree as torch tensors on ``device`` (default ``cuda``), in ``dtype``
    (default: each array's own float type; bfloat16 arrays come across
    bit for bit). With ``api`` (a ``ModelApi`` on a mesh of more than one
    device) each leaf is this rank's shard, placed by ``api.rules_p``:
    the numbers are those of one device.

    Raises if a path is missing or extra, or a shape differs from the
    port's definitions for ``cfg``."""
    defs = build_defs(cfg) if api is None else api.defs
    device = resolve_device(device)

    def walk(d, t, path):
        if isinstance(d, dict):
            if not isinstance(t, dict) or set(t) != set(d):
                got = sorted(t) if isinstance(t, dict) else type(t).__name__
                raise ValueError(f"param tree at '{'/'.join(path)}': keys "
                                 f"{got}, expected {sorted(d)}")
            return {k: walk(d[k], t[k], path + (k,)) for k in d}
        a = np.asarray(t)
        if tuple(a.shape) != tuple(d.shape):
            raise ValueError(f"param {'/'.join(path)}: shape {a.shape}, "
                             f"expected {d.shape}")
        out = _to_torch(a, device, dtype)
        return out if api is None else api._place(path, out)
    return walk(defs, tree, ())


def dave2_params_from_jax_numpy(tree, cfg: Dave2Config,
                                device: Optional[str | torch.device] = None,
                                dtype: Optional[torch.dtype] = None):
    """``tree``: JAX's flat DAVE-2 dict as numpy arrays. Returns the port's
    dict on ``device`` (default ``cuda``): each HWIO conv weight transposed
    to contiguous OIHW (``transpose(3, 2, 0, 1)``,
    ``models.dave2.conv_weight``), every other leaf copied, the fc weights
    in the ``x @ W`` orientation. Raises if a key is missing or extra, or a
    shape differs from ``dave2_defs(cfg)``."""
    defs = dave2_defs(cfg)
    device = resolve_device(device)
    if set(tree) != set(defs):
        raise ValueError(f"DAVE-2 params: keys {sorted(tree)}, expected "
                         f"{sorted(defs)}")
    out = {}
    for k, d in defs.items():
        a = np.asarray(tree[k])
        if tuple(a.shape) != tuple(d.shape):
            raise ValueError(f"param {k}: shape {a.shape}, expected "
                             f"{d.shape}")
        t = _to_torch(a, device, dtype)
        out[k] = conv_weight(t) if t.dim() == 4 else t
    return out


def _to_torch(a: np.ndarray, device, dtype: Optional[torch.dtype]):
    if a.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own (ml_dtypes supplies it): move
        # the bits, which are bfloat16's in either library
        t = torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))     # a writable copy
    t = t.to(device)
    return t if dtype is None else t.to(dtype)

