"""ModelApi of the port: build / init / loss / prefill / decode for the
dense, MoE, SSM (Mamba2) and hybrid (RG-LRU + local attention,
RecurrentGemma) families (counterpart of those branches of
``repro.models.model``).

Parameters are the JAX package's tree, as nested dicts of tensors with the
same paths, shapes and ``x @ W`` orientation, and the layers stacked along
a leading dimension. A Python loop over layers replaces ``lax.scan``; the
stacks are unbound into per-layer views once per call, so the backward of
a training step gathers each stack's gradient with one ``stack`` instead
of one stack-sized zero tensor a layer. JAX's ``_cast`` casts every
float32 parameter to the compute dtype on every call (fused away under
``jit``). Eagerly that would copy the weights on every decode step, so
serving casts once, in :meth:`ModelApi.load`; ``loss_fn`` casts on every
call, as JAX does, so that gradients reach the float32 masters.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba2
from repro_torch.models import moe as M
from repro_torch.models import rglru
from repro_torch.models import transformer as T

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# the matrix products that remat "dots" keeps (JAX's checkpoint_dots saves
# every dot_general; einsum and matmul reach these at the aten level)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(body: Callable, policy: str) -> Callable:
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


def _unstack(tree, n: int):
    """The n per-layer views of a tree of stacked (n, ...) leaves."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(tree.unbind(0))


# --------------------------------------------------------------------------
# Loss
# --------------------------------------------------------------------------
def xent_loss(logits, labels):
    """Masked softmax cross-entropy in f32; labels < 0 are ignored.
    Returns (mean nll over the kept tokens, {"tokens": their count})."""
    mask = labels >= 0
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp_min(0).long()[..., None])[..., 0]
    nll = (lse - gold) * mask
    n = mask.sum()
    return nll.sum() / n.clamp_min(1), {"tokens": n}


def fused_xent_loss(x, table, labels, tied: bool, chunk: int = 1024):
    """Chunked-vocab fused softmax-xent (JAX's ``fused_xent_loss``): the
    sequence in ``max(1, S // chunk)`` chunks, each chunk's f32 logits
    reduced to (lse, gold) and dropped; the backward recomputes them a
    chunk at a time (checkpointed), so the (B, S, V) logits never exist."""
    B, S, D = x.shape
    mask = labels >= 0
    labels_c = labels.clamp_min(0).long()
    nchunk = max(1, S // chunk)
    cs = S // nchunk
    if cs * nchunk != S:
        raise ValueError(f"S={S} does not split into {nchunk} equal chunks")

    def step(xc, lc, mc, table):
        xf = xc.float()
        logits = xf @ (table.float().T if tied else table.float())
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, lc[..., None])[..., 0]
        return ((lse - gold) * mc).sum()

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(nchunk):
        sl = slice(c * cs, (c + 1) * cs)
        total = total + checkpoint(step, x[:, sl], labels_c[:, sl],
                                   mask[:, sl], table, use_reentrant=False)
    n = mask.sum()
    return total / n.clamp_min(1), {"tokens": n}


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

    def _cast(self, params):
        """JAX's per-call ``_cast``: float32 leaves to the compute dtype
        (differentiable, so gradients reach the float32 masters); other
        leaves as they are."""
        cd = self.compute_dtype()
        return L.tree_map(
            lambda _, a: a.to(cd) if a.dtype == torch.float32 else a, params)

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
        place and returns (x, caches, {}). Train returns (x, None, aux),
        each block under the ``parallel.remat`` policy. For MoE at train
        and prefill, aux holds the layer means of the load-balance and
        router-z losses."""
        cfg = self.cfg
        fam = cfg.family
        if fam == "hybrid":
            return self._run_hybrid(params, x, ctx, caches)
        names = mamba2.CACHE_NAMES if fam == "ssm" else ("k", "v")
        apply = {"moe": M.moe_block_apply,
                 "ssm": mamba2.ssm_block_apply}.get(fam, T.dense_block_apply)

        def body(blk, x, cache):
            """(x, cache, load_balance, router_z): the losses are 0.0 but
            where an MoE layer computed them (train, prefill)."""
            out = apply(ctx, blk, x, cache)
            aux = out[2] if len(out) > 2 else {}
            return (out[0], out[1], aux.get("load_balance", 0.0),
                    aux.get("router_z", 0.0))

        if ctx.mode == "train":
            body = _remat(body, self.parallel.remat)
        collected = {n: [] for n in names}
        lb = rz = 0.0
        for i, blk in enumerate(_unstack(params["blocks"], cfg.n_layers)):
            cache = None if caches is None else \
                {n: caches[n][i] for n in names}
            x, c, lb_i, rz_i = body(blk, x, cache)
            lb, rz = lb + lb_i, rz + rz_i
            if ctx.mode == "prefill":
                for n in names:
                    collected[n].append(c[n])
        if caches is not None:
            return x, caches, {}
        aux = {"load_balance": lb / cfg.n_layers,
               "router_z": rz / cfg.n_layers} if fam == "moe" else {}
        if ctx.mode == "train":
            return x, None, aux
        return x, {n: torch.stack(v) for n, v in collected.items()}, aux

    def _run_hybrid(self, params, x, ctx, caches=None):
        """The layer loop of the hybrid (JAX's ``_run_hybrid``): the groups
        of ``cfg.rglru.pattern`` (params["groups"][f"{kind}{i}"], stacked
        over n_groups), then the recurrent tail layers (params["tail"],
        stacked). Prefill (``caches`` None) returns the caches stacked the
        same way: {"groups": {"rec<i>": {"conv", "h"}, "attn<i>": {"k",
        "v"}}, "tail": {"conv", "h"}}. Decode updates ``caches`` in
        place. Train remats a whole group, or a tail layer, as JAX remats
        its scan bodies, and returns no caches."""
        kinds = {"rec": rglru.rec_block_apply,
                 "attn": rglru.attn_block_apply_rg}
        pattern = self.cfg.rglru.pattern
        n_groups, n_tail = divmod(self.cfg.n_layers, len(pattern))
        group = [(f"{kind}{i}", kinds[kind]) for i, kind in enumerate(pattern)]
        units = [("groups", g, group) for g in range(n_groups)]
        units += [("tail", j, [(None, rglru.rec_block_apply)])
                  for j in range(n_tail)]
        blocks = {part: _unstack(params[part], n)
                  for part, n in (("groups", n_groups), ("tail", n_tail))
                  if n}

        def run_unit(members, blk, x, cache):
            cs = []
            for key, apply in members:
                c = cache if cache is None or key is None else cache[key]
                x, c = apply(ctx, blk if key is None else blk[key], x, c)
                cs.append(c)
            return x, cs

        collected = {}
        for part, j, members in units:
            fn = functools.partial(run_unit, members)
            if ctx.mode == "train":
                fn = _remat(fn, self.parallel.remat)
            cache = None if caches is None else self._layer(caches[part], j)
            x, cs = fn(blocks[part][j], x, cache)
            if ctx.mode == "prefill":
                for (key, _), c in zip(members, cs):
                    collected.setdefault((part, key), []).append(c)
        if caches is not None:
            return x, caches, {}
        if ctx.mode == "train":
            return x, None, {}
        out = {"groups": {}}
        for (part, key), cs in collected.items():
            leaves = {n: torch.stack([c[n] for c in cs]) for n in cs[0]}
            if key is None:
                out[part] = leaves
            else:
                out[part][key] = leaves
        return x, out, {}

    def loss_fn(self, params, batch):
        """JAX's ``loss_fn``: ``params`` are the float32 masters (cast to
        the compute dtype here, on every call); batch {"tokens", "labels"}
        (B, S) int, labels < 0 ignored. Returns (loss, metrics) with the
        MoE aux losses added as JAX adds them (``router_aux_coef`` x
        load-balance + 1e-4 x router-z) and reported in ``metrics``."""
        cfg = self.cfg
        params = self._cast(params)
        tokens = batch["tokens"]
        S = tokens.shape[1]
        positions = torch.arange(S, device=tokens.device)[None, :]
        ctx = T.Ctx(cfg=cfg, mode="train", positions=positions,
                    q_block=self.parallel.q_block,
                    kv_block=self.parallel.kv_block)
        x = T.embed_tokens(cfg, params, tokens, self.compute_dtype())
        x, _, aux = self._run_blocks(params, x, ctx)
        x = T.final_norm(cfg, params, x)
        if self.parallel.fused_xent:
            table = params["embed"] if cfg.tie_embeddings \
                else params["lm_head"]
            loss, metrics = fused_xent_loss(x, table, batch["labels"],
                                            cfg.tie_embeddings)
        else:
            loss, metrics = xent_loss(T.lm_logits(cfg, params, x),
                                      batch["labels"])
        if aux:
            loss = loss + (cfg.moe.router_aux_coef * aux["load_balance"]
                           + 1e-4 * aux["router_z"])
            metrics.update(aux)
        metrics["loss"] = loss
        return loss, metrics

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
