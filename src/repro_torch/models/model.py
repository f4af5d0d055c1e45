"""ModelApi of the port: build / init / loss / prefill / decode for every
family of ``repro.models.model``: dense, MoE, SSM (Mamba2), hybrid (RG-LRU
+ local attention, RecurrentGemma), vlm (InternVL2: a dense LM whose first
``n_vision_tokens`` positions take the stub vision tower's patches) and
audio (the Whisper encoder-decoder, ``models.whisper``).

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

``build_model(cfg, parallel, device, mesh=...)`` puts the model on a mesh
(``repro_torch.launch.mesh``): the logical-axis rules (``rules_p`` for
parameters, ``rules_a`` for activations) and the recipe (``tp`` / ``cp``)
are JAX's. On a mesh of more than one device every parameter leaf is a
DTensor placed by ``rules_p``, each layer's weights are gathered over the
FSDP axes where the layer runs (JAX's ZeRO-3 gather inside the scan), and
the forward is the parallel paths of ``transformer`` and ``moe``. On a
one-device mesh, or none, nothing is a DTensor.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import torch
from torch.distributed.tensor import DTensor, Shard, distribute_tensor
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba2
from repro_torch.models import moe as M
from repro_torch.models import rglru
from repro_torch.models import transformer as T
from repro_torch.models import whisper
from repro_torch.obs import spans as obs_spans
from repro_torch.sharding import spmd
from repro_torch.sharding.partition import (Rules, constrain, make_rules,
                                            mesh_shape, multi_device)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# --------------------------------------------------------------------------
# Loss
# --------------------------------------------------------------------------
def _gold(logits, labels, ctx=None):
    """logits (B, S, V) at labels (B, S) (clamped to >= 0). On a mesh with
    the vocab over model each device reads the labels in its columns and
    the partial sums are reduced where they are read; with the vocab whole
    each device reads its own rows."""
    labels = labels.clamp_min(0).long()
    if ctx is None or not ctx.sharded:
        return logits.gather(-1, labels[..., None])[..., 0]
    axis = ctx.parallel.model_axis
    pl = tuple(logits.placements)
    on_model = pl[ctx.mesh.mesh_dim_names.index(axis)]
    if not (isinstance(on_model, Shard) and on_model.dim == 2):
        # the vocab whole on every device: each gathers its own rows
        rows = spmd.follow(pl, {0: 0, 1: 1})
        if not isinstance(labels, DTensor):
            labels = distribute_tensor(labels, ctx.mesh, ctx.place(),
                                       src_data_rank=None)
        return spmd.shard_map(
            lambda lg, lb: lg.gather(-1, lb[..., None])[..., 0], ctx.mesh,
            (pl, rows), rows)(logits, labels)

    def local(lg, lb):
        V = lg.shape[-1]
        lo = spmd.axis_index(ctx.mesh, axis) * V
        inside = (lb >= lo) & (lb < lo + V)
        g = lg.gather(-1, (lb - lo).clamp(0, V - 1)[..., None])[..., 0]
        return torch.where(inside, g, 0.0)

    return spmd.shard_map(local, ctx.mesh,
                          (ctx.place(batch=0, model=2), ctx.place(batch=0)),
                          ctx.place(batch=0, model="partial"))(logits, labels)


def xent_loss(logits, labels, ctx=None):
    """Masked softmax cross-entropy in f32; labels < 0 are ignored.
    Returns (mean nll over the kept tokens, {"tokens": their count})."""
    mask = labels >= 0
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = _gold(logits, labels, ctx)
    nll = (lse - gold) * mask
    n = mask.sum()
    return nll.sum() / n.clamp_min(1), {"tokens": n}


def fused_xent_loss(x, table, labels, tied: bool, chunk: int = 1024,
                    ctx=None):
    """Chunked-vocab fused softmax-xent (JAX's ``fused_xent_loss``): the
    sequence in ``max(1, S // chunk)`` chunks, each chunk's f32 logits
    reduced to (lse, gold) and dropped; the backward recomputes them a
    chunk at a time (checkpointed), so the (B, S, V) logits never exist."""
    B, S, D = x.shape
    rules = None if ctx is None else ctx.rules
    x = constrain(x, rules, ("batch", None, None))
    mask = labels >= 0
    labels_c = labels.clamp_min(0).long()
    nchunk = max(1, S // chunk)
    cs = S // nchunk
    if cs * nchunk != S:
        raise ValueError(f"S={S} does not split into {nchunk} equal chunks")

    def step(xc, lc, mc, table):
        xf = xc.float()
        logits = xf @ (table.float().T if tied else table.float())
        logits = constrain(logits, rules, ("batch", None, "vocab"))
        lse = torch.logsumexp(logits, dim=-1)
        return ((lse - _gold(logits, lc, ctx)) * mc).sum()

    total = 0.0
    for c in range(nchunk):
        sl = slice(c * cs, (c + 1) * cs)
        total = total + checkpoint(step, x[:, sl], labels_c[:, sl],
                                   mask[:, sl], table, use_reentrant=False)
    n = mask.sum()
    return total / n.clamp_min(1), {"tokens": n}


def _on_mesh(method):
    """An entry point of ``ModelApi`` that, on a mesh of more than one
    device, runs under ``spmd.implicit_replication``."""
    @functools.wraps(method)
    def call(self, *args, **kw):
        if not self.sharded:
            return method(self, *args, **kw)
        with spmd.implicit_replication():
            return method(self, *args, **kw)
    return call


@dataclasses.dataclass
class ModelApi:
    cfg: ModelConfig
    parallel: ParallelConfig
    defs: Any
    device: torch.device
    mesh: Any = None
    rules_p: Optional[Rules] = None
    rules_a: Optional[Rules] = None
    recipe: str = "tp"
    # the leaves are DTensors: by default on a mesh of more than one
    # device; True on a one-rank DeviceMesh too (``build_model``)
    sharded: Optional[bool] = None

    def __post_init__(self):
        if self.sharded is None:
            self.sharded = multi_device(self.mesh)

    def param_shapes(self):
        """JAX's ``param_shapes``: (shape, dtype) of every leaf."""
        return L.param_shapes(self.defs, DTYPES[self.parallel.param_dtype])

    def param_pspecs(self):
        """JAX's ``param_pspecs``: each leaf's ``Rules.spec`` tuple."""
        return L.tree_map(lambda _, d: self.rules_p.spec(d.logical, d.shape),
                          self.defs)

    def param_shardings(self):
        """Each leaf's DTensor placements on the mesh (JAX's
        ``param_shardings``)."""
        return L.tree_map(
            lambda _, d: self.rules_p.placements(d.logical, d.shape),
            self.defs)

    def _place(self, path, a):
        """A full tensor (the same on every rank) as this rank's shard of
        the leaf at ``path``, placed by ``rules_p``; a plain tensor on a
        one-device mesh."""
        if not self.sharded or isinstance(a, DTensor):
            return a
        d = self._def_at(path)
        return distribute_tensor(
            a, self.mesh, self.rules_p.placements(d.logical, d.shape),
            src_data_rank=None)

    def _gather_fsdp(self, tree, defs):
        """A tree of DTensor leaves redistributed for compute: the FSDP
        axes gathered, the model axis kept (JAX's per-layer ZeRO-3 gather);
        ``defs`` gives the leaves' logical names, a stacked leaf's without
        its layer dim."""
        if not self.sharded:
            return tree
        rules_c = self._rules_c

        def one(path, a):
            d = defs
            for k in path:
                d = d[k]
            logical = d.logical[-a.dim():] if a.dim() else ()
            return a.redistribute(self.mesh,
                                  rules_c.placements(logical, a.shape))
        return L.tree_map(one, tree)

    @functools.cached_property
    def _rules_c(self) -> Rules:
        """``rules_p`` with the FSDP dims ("embed", "vocab_in") whole."""
        table = dict(self.rules_p.table, embed=None, vocab_in=None)
        return Rules(table, self.mesh)

    # ---- params ----------------------------------------------------------
    def compute_dtype(self) -> torch.dtype:
        return DTYPES[self.parallel.compute_dtype] if \
            self.cfg.dtype == "bfloat16" else DTYPES[self.cfg.dtype]

    def init(self, seed: int = 0):
        """Random parameters drawn on the device from ``seed`` at JAX's
        scale, cast once for the forward pass (on a mesh each rank draws
        the same full leaves and keeps its shards)."""
        params = L.init_params(self.defs, seed=seed,
                               dtype=DTYPES[self.parallel.param_dtype],
                               device=self.device)
        return self.load(params)

    def load(self, params):
        """Move a parameter tree to the device and cast its float leaves
        to the compute dtype, once. For float32 leaves this is JAX's
        per-call ``_cast``; a bfloat16 leaf under a float32 compute dtype
        is widened, which is exactly JAX's type promotion at each use. On
        a mesh each leaf is placed by ``rules_p`` (``_place``)."""
        cd = self.compute_dtype()

        def one(path, a):
            want = tuple(self._def_at(path).shape)
            if tuple(a.shape) != want:
                raise ValueError(f"param {'/'.join(path)}: shape "
                                 f"{tuple(a.shape)}, expected {want}")
            if not isinstance(a, DTensor):
                a = a.to(self.device)
            a = a.to(cd) if a.is_floating_point() else a
            return self._place(path, a)
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
    def _embed_in(self, params, batch, ctx=None):
        """Token embeddings in the compute dtype; for vlm the first
        ``n_vision_tokens`` positions are replaced by batch["patches"]
        (B, n_vision_tokens, D). A vlm sequence shorter than that raises
        (JAX's concatenation would silently lengthen it)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = T.embed_tokens(cfg, params, tokens, self.compute_dtype(), ctx)
        if cfg.family == "vlm":
            nv = cfg.n_vision_tokens
            if tokens.shape[1] < nv:
                raise ValueError(f"a vlm sequence holds the {nv} patch "
                                 f"positions first; got {tokens.shape[1]}")
            x = constrain(x, ctx.rules, ("batch", None, None))
            patches = self._batch_leaf(batch["patches"],
                                       ("batch", None, None))
            x = torch.cat([patches.to(x.dtype), x[:, nv:]], dim=1)
            x = constrain(x, ctx.rules, ("batch", "seq", None))
        return x

    def _batch_leaf(self, t, logical):
        """A stub input (patches, frames) at the placements ``rules_a``
        gives ``logical`` on a mesh: a plain tensor, the same on every
        rank, is distributed."""
        if not self.sharded:
            return t
        if isinstance(t, DTensor):
            return constrain(t, self.rules_a, logical)
        return distribute_tensor(t.to(self.device), self.mesh,
                                 self.rules_a.placements(logical, t.shape),
                                 src_data_rank=None)

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
            body = L.remat(body, self.parallel.remat)
        collected = {n: [] for n in names}
        lb = rz = 0.0
        for i, blk in enumerate(L.unstack(params["blocks"], cfg.n_layers)):
            blk = self._gather_fsdp(blk, self.defs["blocks"])
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
        blocks = {part: L.unstack(params[part], n)
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
                fn = L.remat(fn, self.parallel.remat)
            cache = None if caches is None else self._layer(caches[part], j)
            blk = self._gather_fsdp(blocks[part][j], self.defs[part])
            x, cs = fn(blk, x, cache)
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

    @_on_mesh
    def loss_fn(self, params, batch):
        """JAX's ``loss_fn``: ``params`` are the float32 masters (cast to
        the compute dtype here, on every call); batch {"tokens", "labels"}
        (B, S) int, labels < 0 ignored, with "patches" for vlm and
        "frames" for audio. Returns (loss, metrics) with the
        MoE aux losses added as JAX adds them (``router_aux_coef`` x
        load-balance + 1e-4 x router-z) and reported in ``metrics``."""
        cfg = self.cfg
        params = self._cast(params)
        if cfg.family == "audio":
            return self._whisper_loss(params, batch)
        ctx = self._ctx("train", batch["tokens"])
        params = self._top(params)
        x = self._embed_in(params, batch, ctx)
        x, _, aux = self._run_blocks(params, x, ctx)
        x = T.final_norm(cfg, params, x)
        if self.parallel.fused_xent:
            table = params["embed"] if cfg.tie_embeddings \
                else params["lm_head"]
            loss, metrics = fused_xent_loss(x, table, batch["labels"],
                                            cfg.tie_embeddings, ctx=ctx)
        else:
            loss, metrics = xent_loss(T.lm_logits(cfg, params, x, ctx),
                                      batch["labels"], ctx)
        if aux:
            loss = loss + (cfg.moe.router_aux_coef * aux["load_balance"]
                           + 1e-4 * aux["router_z"])
            metrics.update(aux)
        metrics["loss"] = loss
        return loss, metrics

    @_on_mesh
    @torch.no_grad()
    def prefill_fn(self, params, batch):
        """batch["tokens"]: (B, S) int. Returns (logits (B, 1, V) f32,
        caches): {"k", "v"} (L, B, S, Hkv, D); for SSM {"conv_x",
        "conv_B", "conv_C"} (L, B, W-1, C) in the compute dtype and {"h"}
        (L, B, H, P, N) f32; for the hybrid the tree of ``_run_hybrid``,
        {"conv"} (n, B, W-1, Wd) in the compute dtype, {"h"} (n, B, Wd)
        f32 and {"k", "v"} (n_groups, B, S, Hkv, D). The MoE aux losses
        are dropped, as in JAX. vlm takes batch["patches"] too; audio takes
        batch["frames"] (B, F, D) and returns the tree of
        ``whisper.run_decoder_train``. The call is the span
        ``model.prefill_fn`` while ``obs.spans`` is on: the host's time
        to enqueue the step's work."""
        with obs_spans.span("model.prefill_fn"):
            cfg = self.cfg
            if cfg.family == "audio":
                return self._whisper_prefill(params, batch)
            ctx = self._ctx("prefill", batch["tokens"])
            params = self._top(params)
            x = self._embed_in(params, batch, ctx)
            x, caches, _ = self._run_blocks(params, x, ctx)
            x = constrain(T.final_norm(cfg, params, x), ctx.rules,
                          ("batch", None, None))
            logits = T.lm_logits(cfg, params, x[:, -1:, :], ctx)
            return logits, caches

    @_on_mesh
    @torch.no_grad()
    def decode_fn(self, params, caches, tokens, pos):
        """tokens: (B, 1) int; pos: (B,) position of the new token;
        caches {"k", "v"}: (L, B, Smax, Hkv, D); for SSM the state leaves
        of ``prefill_fn``; for the hybrid its tree with every "k", "v"
        leaf grown to (n_groups, B, Smax, Hkv, D) (rows past a sequence's
        length are never read: ``decode_attention`` masks kpos > pos); for
        audio the tree of ``prefill_fn`` with "self" grown to (L, B, Smax,
        H, D). vlm embeds the tokens only, as in JAX. Updated in place.
        Returns (logits (B, 1, V) f32, caches). The call is the span
        ``model.decode_fn`` while ``obs.spans`` is on."""
        with obs_spans.span("model.decode_fn"):
            cfg = self.cfg
            if cfg.family == "audio":
                return self._whisper_decode(params, caches, tokens, pos)
            ctx = self._ctx("decode", positions=pos)
            params = self._top(params)
            x = T.embed_tokens(cfg, params, tokens, self.compute_dtype(),
                               ctx)
            x, caches, _ = self._run_blocks(params, x, ctx, caches)
            x = T.final_norm(cfg, params, x)
            return T.lm_logits(cfg, params, x, ctx), caches

    def _top(self, params):
        """The leaves outside the layer stacks gathered for compute."""
        if not self.sharded:
            return params
        blocks = ("blocks", "groups", "tail", "enc_blocks", "dec_blocks")
        top = {k: v for k, v in params.items() if k not in blocks}
        return dict(params, **self._gather_fsdp(top, self.defs))

    def _ctx(self, mode: str, tokens=None, positions=None) -> T.Ctx:
        """Train / prefill context: positions 0..S-1 of ``tokens`` (B, S);
        decode: ``positions`` (B,)."""
        batch = (tokens if tokens is not None else positions).shape[0]
        if positions is None:
            positions = torch.arange(tokens.shape[1],
                                     device=self.device)[None]
        return T.Ctx(cfg=self.cfg, mode=mode, positions=positions,
                     batch=batch, q_block=self.parallel.q_block,
                     kv_block=self.parallel.kv_block,
                     parallel=self.parallel,
                     rules=self.rules_a if self.sharded else None,
                     mesh=self.mesh, recipe=self.recipe,
                     sharded=self.sharded)

    # ---- whisper ----------------------------------------------------------
    def _whisper_gather(self, part: str):
        """A layer of ``part`` laid out for compute (``_gather_fsdp``)."""
        return lambda blk: self._gather_fsdp(blk, self.defs[part])

    def _whisper_forward(self, params, batch, ctx):
        """Encoder over batch["frames"], then the decoder over
        batch["tokens"]: (final-normed x (B, S, D), caches or None)."""
        params = self._top(params)
        cd = self.compute_dtype()
        x = whisper.decoder_embed(params, batch["tokens"], ctx.positions,
                                  cd, ctx)
        x = constrain(x, ctx.rules, ("batch", "seq", None))
        frames = self._batch_leaf(batch["frames"], ("batch", None, None))
        enc = whisper.encode(ctx, params, frames.to(cd),
                             self._whisper_gather("enc_blocks"))
        x, caches = whisper.run_decoder_train(
            ctx, params, x, enc, self._whisper_gather("dec_blocks"))
        return T.final_norm(self.cfg, params, x), caches, params

    def _whisper_loss(self, params, batch):
        """The plain ``xent_loss`` under ``fused_xent`` too, as in JAX."""
        ctx = self._ctx("train", batch["tokens"])
        x, _, params = self._whisper_forward(params, batch, ctx)
        loss, metrics = xent_loss(T.lm_logits(self.cfg, params, x, ctx),
                                  batch["labels"], ctx)
        metrics["loss"] = loss
        return loss, metrics

    def _whisper_prefill(self, params, batch):
        ctx = self._ctx("prefill", batch["tokens"])
        x, caches, params = self._whisper_forward(params, batch, ctx)
        return T.lm_logits(self.cfg, params, x[:, -1:, :], ctx), caches

    def _whisper_decode(self, params, caches, tokens, pos):
        cfg = self.cfg
        ctx = self._ctx("decode", positions=pos)
        params = self._top(params)
        x = whisper.decoder_embed(params, tokens, pos[:, None],
                                  self.compute_dtype(), ctx)
        x, caches = whisper.run_decoder_decode(
            ctx, params, x, caches, self._whisper_gather("dec_blocks"))
        x = T.final_norm(cfg, params, x)
        return T.lm_logits(cfg, params, x, ctx), caches


# --------------------------------------------------------------------------
# Construction
# --------------------------------------------------------------------------
def build_defs(cfg: ModelConfig, parallel: Optional[ParallelConfig] = None):
    if cfg.family in ("dense", "vlm"):
        return T.lm_defs(cfg, T.dense_block_defs)
    if cfg.family == "audio":
        return whisper.whisper_defs(cfg)
    if cfg.family == "moe":
        ws = bool(parallel and parallel.moe_weight_stationary)
        return T.lm_defs(cfg, lambda c: M.moe_block_defs(c, ws))
    if cfg.family == "ssm":
        return T.lm_defs(cfg, mamba2.ssm_block_defs)
    if cfg.family == "hybrid":
        return _hybrid_defs(cfg)
    raise ValueError(f"unknown model family {cfg.family!r}")


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
                device: Optional[str | torch.device] = None, *,
                mesh=None, sharded: Optional[bool] = None) -> ModelApi:
    """``device`` defaults to ``cuda`` (see ``repro_torch.device``);
    ``mesh`` (``launch.mesh``) sets the rules, the recipe and the
    ``pad_attention_heads`` lever as JAX's ``build_model`` does.
    ``sharded`` (default: the mesh has more than one device) puts the
    leaves on the mesh as DTensors and runs the parallel paths: True on a
    ``DeviceMesh`` of one rank runs them with every axis of size 1."""
    if sharded and not hasattr(mesh, "get_group"):
        raise ValueError("sharded=True needs a DeviceMesh")
    rules_p, rules_a = make_rules(mesh, parallel)
    tp = mesh_shape(mesh).get(parallel.model_axis, 1)
    if parallel.pad_attention_heads and tp > 1 and cfg.n_heads % tp:
        # hillclimb lever: pad Hq to a TP multiple so head-parallel
        # attention applies; the padded count must stay a GQA multiple
        padded = ((cfg.n_heads + tp - 1) // tp) * tp
        if cfg.n_kv_heads and padded % cfg.n_kv_heads == 0:
            cfg = dataclasses.replace(cfg, n_heads=padded)
    return ModelApi(cfg=cfg, parallel=parallel,
                    defs=build_defs(cfg, parallel),
                    device=resolve_device(device), mesh=mesh,
                    rules_p=rules_p, rules_a=rules_a,
                    recipe=T.recipe_for(cfg, tp), sharded=sharded)
