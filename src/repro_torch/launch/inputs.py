"""Stand-ins for every model input and cache per (architecture x shape):
the counterpart of ``repro.launch.inputs``, whose ``ShapeDtypeStruct``
leaves carry a sharding.

Each leaf is a ``TensorSpec``: the global shape and dtype, and the
placements that ``ModelApi.rules_a`` gives its logical dim names on the
api's mesh. ``materialize`` turns a tree of specs into tensors with no
data: under a ``FakeTensorMode`` (the dry run) fake tensors that carry
their placements, a DTensor of this rank's local shard on a mesh of more
than one device. The cache trees follow the port's layout, which is
JAX's: ``ModelApi.decode_fn``'s caches.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.models.model import ModelApi
from repro_torch.models.whisper import MAX_DECODER_POS


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    shape: Tuple[int, ...]
    dtype: torch.dtype
    logical: Tuple
    placements: Tuple
    local_shape: Tuple[int, ...]


def _spec(shape, dtype, api: ModelApi, logical) -> TensorSpec:
    shape = tuple(shape)
    return TensorSpec(shape, dtype, tuple(logical),
                      api.rules_a.placements(logical, shape),
                      api.rules_a.local_shape(logical, shape))


def _cd(api: ModelApi) -> torch.dtype:
    return torch.bfloat16 if api.cfg.dtype == "bfloat16" else torch.float32


def batch_specs(api: ModelApi, shape: ShapeConfig) -> Dict[str, Any]:
    """Inputs for train (kind train) or prefill (kind prefill)."""
    cfg = api.cfg
    B, S = shape.global_batch, shape.seq_len
    cd = _cd(api)
    out: Dict[str, Any] = {
        "tokens": _spec((B, S), torch.int32, api, ("batch", None))}
    if shape.kind == "train":
        out["labels"] = _spec((B, S), torch.int32, api, ("batch", None))
    if cfg.family == "vlm":
        out["patches"] = _spec((B, cfg.n_vision_tokens, cfg.d_model), cd,
                               api, ("batch", None, None))
    if cfg.family == "audio":
        out["frames"] = _spec((B, cfg.n_encoder_frames, cfg.d_model), cd,
                              api, ("batch", None, None))
    return out


def decode_token_specs(api: ModelApi, shape: ShapeConfig):
    B = shape.global_batch
    return (_spec((B, 1), torch.int32, api, ("batch", None)),
            _spec((B,), torch.int32, api, ("batch",)))


def _attn_cache_specs(api: ModelApi, n_layers: int, B: int, S: int):
    cfg = api.cfg
    lg = (None, "batch", "kv_seq", None, None)
    shp = (n_layers, B, S, cfg.n_kv_heads, cfg.head_dim)
    return {"k": _spec(shp, _cd(api), api, lg),
            "v": _spec(shp, _cd(api), api, lg)}


def cache_specs(api: ModelApi, shape: ShapeConfig) -> Any:
    """The cache tree ``ModelApi.decode_fn`` takes."""
    cfg = api.cfg
    B, S = shape.global_batch, shape.seq_len
    cd = _cd(api)
    fam = cfg.family
    if fam in ("dense", "vlm", "moe"):
        return _attn_cache_specs(api, cfg.n_layers, B, S)
    if fam == "ssm":
        s = cfg.ssm
        di = s.d_inner(cfg.d_model)
        H = s.n_heads(cfg.d_model)
        N, P, W = s.state_dim, s.head_dim, s.conv_width
        Lr = cfg.n_layers
        return {
            "conv_x": _spec((Lr, B, W - 1, di), cd, api,
                            (None, "batch", None, "ssm_inner")),
            "conv_B": _spec((Lr, B, W - 1, N), cd, api,
                            (None, "batch", None, None)),
            "conv_C": _spec((Lr, B, W - 1, N), cd, api,
                            (None, "batch", None, None)),
            "h": _spec((Lr, B, H, P, N), torch.float32, api,
                       (None, "batch", "ssm_heads", None, None)),
        }
    if fam == "hybrid":
        g = cfg.rglru
        Wd = g.lru_width or cfg.d_model
        n_groups, tail = divmod(cfg.n_layers, len(g.pattern))

        def rec_cache(n):
            return {"conv": _spec((n, B, g.conv_width - 1, Wd), cd, api,
                                  (None, "batch", None, "lru")),
                    "h": _spec((n, B, Wd), torch.float32, api,
                               (None, "batch", "lru"))}

        groups = {f"{kind}{i}": rec_cache(n_groups) if kind == "rec"
                  else _attn_cache_specs(api, n_groups, B, S)
                  for i, kind in enumerate(g.pattern)}
        out = {"groups": groups}
        if tail:
            out["tail"] = rec_cache(tail)
        return out
    if fam == "audio":
        L, F = cfg.n_layers, cfg.n_encoder_frames
        lg = (None, "batch", None, None, None)
        shp = (L, B, F, cfg.n_kv_heads, cfg.head_dim)
        return {"self": _attn_cache_specs(api, L, B, min(S, MAX_DECODER_POS)),
                "cross_k": _spec(shp, cd, api, lg),
                "cross_v": _spec(shp, cd, api, lg)}
    raise ValueError(fam)


def materialize(tree, api: ModelApi):
    """Tensors with no data for a tree of ``TensorSpec`` (a tuple of trees
    too): on a mesh of more than one device DTensors of this rank's
    ``local_shape``, else plain tensors of the global shape, on the api's
    device. Under a ``FakeTensorMode`` they are fake and take no memory."""
    if isinstance(tree, dict):
        return {k: materialize(v, api) for k, v in tree.items()}
    if isinstance(tree, tuple) and not isinstance(tree, TensorSpec):
        return tuple(materialize(v, api) for v in tree)
    if not api.sharded:
        return torch.zeros(tree.shape, dtype=tree.dtype, device=api.device)
    from torch.distributed.tensor import DTensor
    local = torch.zeros(tree.local_shape, dtype=tree.dtype,
                        device=api.device)
    return DTensor.from_local(local, api.mesh, tree.placements,
                              run_check=False, shape=torch.Size(tree.shape),
                              stride=_contiguous_stride(tree.shape))


def _contiguous_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))
