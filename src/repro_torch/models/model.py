"""ModelApi of the port: build / init / prefill / decode for the dense,
MoE, SSM (Mamba2) and hybrid (RG-LRU + local attention, RecurrentGemma)
families (counterpart of those branches of ``repro.models.model``).

Parameters are the JAX package's tree, as nested dicts of tensors with the
same paths, shapes and ``x @ W`` orientation, and the layers stacked along
a leading dimension. A Python loop over layers replaces ``lax.scan``.
JAX's ``_cast`` casts every float32 parameter to the compute dtype on
every call (fused away under ``jit``); eagerly that would copy the weights
on every decode step, so the port casts once, in :meth:`ModelApi.load`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba2
from repro_torch.models import moe as M
from repro_torch.models import rglru
from repro_torch.models import transformer as T

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class ModelApi:
    cfg: ModelConfig
    parallel: ParallelConfig
    defs: Any
    device: torch.device

    # ---- params ----------------------------------------------------------
    def compute_dtype(self) -> torch.dtype:
        return DTYPES[self.parallel.compute_dtype] if \
            self.cfg.dtype == "bfloat16" else DTYPES[self.cfg.dtype]

    def init(self, seed: int = 0):
        """Random parameters drawn on the device from ``seed`` at JAX's
        scale, cast once for the forward pass."""
        params = L.init_params(self.defs, seed=seed,
                               dtype=DTYPES[self.parallel.param_dtype],
                               device=self.device)
        return self.load(params)

    def load(self, params):
        """Move a parameter tree to the device and cast its float leaves
        to the compute dtype, once. For float32 leaves this is JAX's
        per-call ``_cast``; a bfloat16 leaf under a float32 compute dtype
        is widened, which is exactly JAX's type promotion at each use."""
        cd = self.compute_dtype()

        def one(path, a):
            want = tuple(self._def_at(path).shape)
            if tuple(a.shape) != want:
                raise ValueError(f"param {'/'.join(path)}: shape "
                                 f"{tuple(a.shape)}, expected {want}")
            a = a.to(self.device)
            return a.to(cd) if a.is_floating_point() else a
        return L.tree_map(one, params)

    def _def_at(self, path):
        d = self.defs
        for k in path:
            d = d[k]
        return d

    def n_params(self) -> int:
        return int(sum(torch.Size(d.shape).numel()
                       for d in L.tree_leaves(self.defs)))

    # ---- forward ----------------------------------------------------------
    def _layer(self, blocks, i: int):
        return L.tree_map(lambda _, a: a[i], blocks)

    def _run_blocks(self, params, x, ctx, caches=None):
        """The layer loop (JAX's ``_run_uniform`` / ``_run_moe``). Prefill
        (``caches`` None) collects each layer's cache leaves and returns
        (x, caches stacked along a leading layer dimension, aux): {"k",
        "v"} (L, B, S, Hkv, D) for attention, {"conv_x", "conv_B",
        "conv_C", "h"} (L, B, ...) for SSM. Decode updates ``caches`` in
        place and returns (x, caches, {}). For MoE at prefill, aux holds
        the layer means of the load-balance and router-z losses."""
        cfg = self.cfg
        fam = cfg.family
        if fam == "hybrid":
            return self._run_hybrid(params, x, ctx, caches)
        names = mamba2.CACHE_NAMES if fam == "ssm" else ("k", "v")
        collected = {n: [] for n in names}
        lb = rz = 0.0
        for i in range(cfg.n_layers):
            blk = self._layer(params["blocks"], i)
            cache = None if caches is None else \
                {n: caches[n][i] for n in names}
            if fam == "moe":
                x, c, aux = M.moe_block_apply(ctx, blk, x, cache)
                if aux:
                    lb = lb + aux["load_balance"]
                    rz = rz + aux["router_z"]
            elif fam == "ssm":
                x, c = mamba2.ssm_block_apply(ctx, blk, x, cache)
            else:
                x, c = T.dense_block_apply(ctx, blk, x, cache)
            if caches is None:
                for n in names:
                    collected[n].append(c[n])
        if caches is not None:
            return x, caches, {}
        aux = {"load_balance": lb / cfg.n_layers,
               "router_z": rz / cfg.n_layers} if fam == "moe" else {}
        return x, {n: torch.stack(v) for n, v in collected.items()}, aux

    def _run_hybrid(self, params, x, ctx, caches=None):
        """The layer loop of the hybrid (JAX's ``_run_hybrid``): the groups
        of ``cfg.rglru.pattern`` (params["groups"][f"{kind}{i}"], stacked
        over n_groups), then the recurrent tail layers (params["tail"],
        stacked). Prefill (``caches`` None) returns the caches stacked the
        same way: {"groups": {"rec<i>": {"conv", "h"}, "attn<i>": {"k",
        "v"}}, "tail": {"conv", "h"}}. Decode updates ``caches`` in
        place."""
        kinds = {"rec": rglru.rec_block_apply,
                 "attn": rglru.attn_block_apply_rg}
        pattern = self.cfg.rglru.pattern
        n_groups, n_tail = divmod(self.cfg.n_layers, len(pattern))
        layers = [("groups", f"{kind}{i}", g, kinds[kind])
                  for g in range(n_groups) for i, kind in enumerate(pattern)]
        layers += [("tail", None, j, rglru.rec_block_apply)
                   for j in range(n_tail)]
        collected = {}
        for part, key, j, apply in layers:
            stack = params[part] if key is None else params[part][key]
            cache = None
            if caches is not None:
                c = caches[part] if key is None else caches[part][key]
                cache = self._layer(c, j)
            x, c = apply(ctx, self._layer(stack, j), x, cache)
            if caches is None:
                collected.setdefault((part, key), []).append(c)
        if caches is not None:
            return x, caches, {}
        out = {"groups": {}}
        for (part, key), cs in collected.items():
            leaves = {n: torch.stack([c[n] for c in cs]) for n in cs[0]}
            if key is None:
                out[part] = leaves
            else:
                out[part][key] = leaves
        return x, out, {}

    @torch.no_grad()
    def prefill_fn(self, params, batch):
        """batch["tokens"]: (B, S) int. Returns (logits (B, 1, V) f32,
        caches): {"k", "v"} (L, B, S, Hkv, D); for SSM {"conv_x",
        "conv_B", "conv_C"} (L, B, W-1, C) in the compute dtype and {"h"}
        (L, B, H, P, N) f32; for the hybrid the tree of ``_run_hybrid``,
        {"conv"} (n, B, W-1, Wd) in the compute dtype, {"h"} (n, B, Wd)
        f32 and {"k", "v"} (n_groups, B, S, Hkv, D). The MoE aux losses
        are dropped, as in JAX."""
        cfg = self.cfg
        tokens = batch["tokens"]
        S = tokens.shape[1]
        positions = torch.arange(S, device=tokens.device)[None, :]
        ctx = T.Ctx(cfg=cfg, mode="prefill", positions=positions)
        x = T.embed_tokens(cfg, params, tokens, self.compute_dtype())
        x, caches, _ = self._run_blocks(params, x, ctx)
        x = T.final_norm(cfg, params, x)
        logits = T.lm_logits(cfg, params, x[:, -1:, :])
        return logits, caches

    @torch.no_grad()
    def decode_fn(self, params, caches, tokens, pos):
        """tokens: (B, 1) int; pos: (B,) position of the new token;
        caches {"k", "v"}: (L, B, Smax, Hkv, D); for SSM the state leaves
        of ``prefill_fn``; for the hybrid its tree with every "k", "v"
        leaf grown to (n_groups, B, Smax, Hkv, D) (rows past a sequence's
        length are never read: ``decode_attention`` masks kpos > pos).
        Updated in place. Returns (logits (B, 1, V) f32, caches)."""
        cfg = self.cfg
        ctx = T.Ctx(cfg=cfg, mode="decode", positions=pos)
        x = T.embed_tokens(cfg, params, tokens, self.compute_dtype())
        x, caches, _ = self._run_blocks(params, x, ctx, caches)
        x = T.final_norm(cfg, params, x)
        return T.lm_logits(cfg, params, x), caches


# --------------------------------------------------------------------------
# Construction
# --------------------------------------------------------------------------
def build_defs(cfg: ModelConfig, parallel: Optional[ParallelConfig] = None):
    if cfg.family == "dense":
        return T.lm_defs(cfg, T.dense_block_defs)
    if cfg.family == "moe":
        return T.lm_defs(cfg, M.moe_block_defs)
    if cfg.family == "ssm":
        return T.lm_defs(cfg, mamba2.ssm_block_defs)
    if cfg.family == "hybrid":
        return _hybrid_defs(cfg)
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported to repro_torch yet "
        f"(ROADMAP.md, queue A); 'dense', 'moe', 'ssm' and 'hybrid' are")


def _hybrid_defs(cfg: ModelConfig):
    """JAX's hybrid tree: the pattern's blocks stacked over n_groups under
    "groups" (keyed f"{kind}{i}"), the recurrent remainder under "tail",
    untied "embed" / "lm_head" unless the config ties them."""
    pattern = cfg.rglru.pattern
    plen = len(pattern)
    n_groups, tail = divmod(cfg.n_layers, plen)
    group_defs = {f"{kind}{i}": (rglru.rec_block_defs(cfg) if kind == "rec"
                                 else rglru.attn_block_defs_rg(cfg))
                  for i, kind in enumerate(pattern)}
    D, V = cfg.d_model, cfg.vocab_size
    defs = {
        "embed": L.ParamDef((V, D), ("vocab", "embed") if cfg.tie_embeddings
                            else ("vocab_in", "embed_in")),
        "final_ln": L.ParamDef((D,), ("embed",), "ones"),
        "groups": L.stack_defs(group_defs, n_groups),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = L.ParamDef((D, V), ("embed", "vocab"))
    if tail:
        if any(pattern[i % plen] != "rec"
               for i in range(n_groups * plen, cfg.n_layers)):
            raise ValueError("tail layers must be recurrent")
        defs["tail"] = L.stack_defs(rglru.rec_block_defs(cfg), tail)
    return defs


def build_model(cfg: ModelConfig, parallel: ParallelConfig,
                device: Optional[str | torch.device] = None) -> ModelApi:
    """``device`` defaults to ``cuda`` (see ``repro_torch.device``)."""
    return ModelApi(cfg=cfg, parallel=parallel,
                    defs=build_defs(cfg, parallel),
                    device=resolve_device(device))
