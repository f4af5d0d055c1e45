"""Whisper-base encoder-decoder backbone of the port (counterpart of
``repro.models.whisper``). [arXiv:2212.04356]

The mel/conv frontend is a stub, as in JAX: the model consumes
precomputed frame embeddings (B, n_frames, d_model). The backbone is
real: pre-LN, learned decoder positions, sinusoidal encoder positions,
GELU MLPs, MHA with biases. Decode uses a self-attention KV cache plus
per-layer cross-attention K/V computed from the encoder output at
prefill.

Attention: JAX computes the encoder's self-attention and the decoder's
cross-attention with ``masked_attention(causal=False)``, the materialized
form of the function the flash kernel computes with ``causal=False``.
At prefill the port sends both to ``layers.attention`` (the flash kernel
on the card, its plain version on the CPU): at 1500 frames the
materialized scores would be 72 MB of f32 a sequence a layer. At train
they stay ``masked_attention`` under autograd (JAX's training reaches no
Pallas kernel). At decode the cross-attention is ``decode_attention``
over the cached K/V (``transformer.attn_apply(kv_override=...)``).

On a mesh (DTensors) the attention follows ``transformer.recipe_for``,
as the dense block does: under "tp" (the heads divide the model axis) q
runs head-sharded against K / V whole over model; under "cp" (whisper-base:
8 heads, model 16) each device attends whole heads against K / V whole:
where the query rows split over model, the attention weights are
gathered whole and each device takes its rows; where they do not (the
encoder's 1500 frames over 16), the projections split their columns
over model, their products are gathered, and the devices split the
heads by rows (``_heads_by_rows``: 8 head groups x 2 row blocks). The
cross K / V are projected the same way and laid out whole over model,
as the decode cache holds them. The layers' weights are gathered over
the FSDP axes where each layer runs (``gather``).

The parameter tree is JAX's: the same paths, shapes and ``x @ W``
orientation, the layers stacked along a leading dimension.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import (Ctx, _local_kv, _qkv, _replicate,
                                            attn_apply, attn_defs, mlp_apply,
                                            mlp_defs)
from repro_torch.sharding import spmd
from repro_torch.sharding.partition import constrain

MAX_DECODER_POS = 32768  # JAX's table: its decode_32k shape exceeds 448


def enc_block_defs(cfg: ModelConfig) -> Dict[str, Any]:
    return {"attn": attn_defs(cfg), "mlp": mlp_defs(cfg)}


def dec_block_defs(cfg: ModelConfig) -> Dict[str, Any]:
    return {"self": attn_defs(cfg), "cross": attn_defs(cfg),
            "mlp": mlp_defs(cfg)}


def whisper_defs(cfg: ModelConfig) -> Dict[str, Any]:
    D, V = cfg.d_model, cfg.vocab_size
    return {
        "embed": L.ParamDef((V, D), ("vocab", "embed")),
        "pos_dec": L.ParamDef((MAX_DECODER_POS, D), (None, "embed"),
                              "normal", 0.02),
        "enc_blocks": L.stack_defs(enc_block_defs(cfg), cfg.n_encoder_layers),
        "enc_ln": L.ParamDef((D,), ("embed",), "ones"),
        "enc_ln_b": L.ParamDef((D,), ("embed",), "zeros"),
        "dec_blocks": L.stack_defs(dec_block_defs(cfg), cfg.n_layers),
        "final_ln": L.ParamDef((D,), ("embed",), "ones"),
        "final_ln_b": L.ParamDef((D,), ("embed",), "zeros"),
    }


def _full_attention(ctx: Ctx, q, k, v):
    """Non-causal attention: the flash kernel's wrapper at prefill,
    materialized scores under autograd at train."""
    if ctx.mode == "train":
        return L.masked_attention(q, k, v, causal=False)
    return L.attention(q, k, v, causal=False)


def _heads_by_rows(ctx: Ctx, q, k, v):
    """Attention whose query rows do not split over the model axis (the
    encoder's 1500 frames over 16): the axis's n devices take gcd(H, n)
    groups of whole heads x n / gcd(H, n) blocks of rows, each attends its
    block, and the blocks are gathered whole onto every device. None
    when the rows do not split that way either."""
    cfg = ctx.cfg
    n = ctx.model_axis_size
    n_h = math.gcd(cfg.n_heads, n)
    n_s = n // n_h
    B, Sq, H, Dh = q.shape
    if Sq % n_s:
        return None
    axis = ctx.parallel.model_axis
    G = cfg.n_heads // cfg.n_kv_heads
    hl, rows = H // n_h, Sq // n_s

    def local(ql, kl, vl):
        g, b = divmod(spmd.axis_index(ctx.mesh, axis), n_s)
        kl, vl, _ = _local_kv(kl, vl, g * hl, hl, G)
        o = _full_attention(ctx, ql[:, b * rows:(b + 1) * rows,
                                    g * hl:(g + 1) * hl], kl, vl)
        o = spmd.all_gather(o[None], ctx.mesh, axis, dim=0)
        Bl = o.shape[1]
        return o.reshape(n_h, n_s, Bl, rows, hl, Dh).permute(
            2, 1, 3, 0, 4, 5).reshape(Bl, Sq, H, Dh)

    spec = ctx.place(batch=0)
    return spmd.shard_map(local, ctx.mesh, (spec, spec, spec),
                          spec)(q, k, v)


def _attend_full(ctx: Ctx, q, k, v):
    """``_full_attention`` of q (B, Sq, H, Dh) against k, v (B, Sk, Hkv,
    Dh); on a mesh on each device's shard (see the module docstring)."""
    if not ctx.sharded:
        return _full_attention(ctx, q, k, v)
    cfg = ctx.cfg
    n = ctx.model_axis_size
    kvspec = ctx.place(batch=0)
    if ctx.recipe == "cp" and q.shape[1] % n:
        out = _heads_by_rows(ctx, q, k, v)
        if out is not None:
            return out
    if ctx.recipe == "tp":
        axis = ctx.parallel.model_axis
        G = cfg.n_heads // cfg.n_kv_heads
        hl = cfg.n_heads // n

        def local(ql, kl, vl):
            h0 = spmd.axis_index(ctx.mesh, axis) * hl
            kl, vl, _ = _local_kv(kl, vl, h0, hl, G)
            return _full_attention(ctx, ql, kl, vl)
        qspec = ctx.place(batch=0, model=2)
    else:
        def local(ql, kl, vl):
            return _full_attention(ctx, ql, kl, vl)
        qspec = ctx.place(batch=0,
                          model=1 if q.shape[1] % n == 0 else None)
    return spmd.shard_map(local, ctx.mesh, (qspec, kvspec, kvspec),
                          qspec)(q, k, v)


def _weights(ctx: Ctx, p, h):
    """The attention weights and the normed input as the recipe takes
    them: under "cp" the weights whole, under "tp" the input whole over
    model (the dense block's constraints)."""
    if ctx.sharded and ctx.recipe == "cp":
        return _replicate(p, ctx), h
    if ctx.recipe == "tp":
        h = constrain(h, ctx.rules, ("batch", None, None))
    return p, h


def _project(ctx: Ctx, h, w, b, n_heads):
    """``h @ w + b`` as (B, S, n_heads, Dh); on a mesh with w's columns
    over model (the projection split) and the product gathered whole,
    since the heads need not divide the axis."""
    y = constrain(L.dense(h, w) + b, ctx.rules, ("batch", None, None))
    return y.reshape(h.shape[0], h.shape[1], n_heads, ctx.cfg.head_dim)


def _rows_project(ctx: Ctx, x, w):
    """``x @ w`` for x (B, S, K) whole over model and w's rows over it:
    each device its rows' partial product, summed where it is read (so
    that the gradient of x stays a partial sum, never a head split)."""
    axis = ctx.parallel.model_axis

    def local(xl, wl):
        k = wl.shape[0]
        r = spmd.axis_index(ctx.mesh, axis)
        return xl[..., r * k:(r + 1) * k] @ wl

    return spmd.shard_map(local, ctx.mesh,
                          (ctx.place(batch=0), ctx.place(model=0)),
                          ctx.place(batch=0, model="partial"))(x, w)


def _enc_attn(ctx: Ctx, p, x):
    """Non-causal encoder self-attention. Under "cp" with frames that do
    not split over model, the projections split their columns over it
    and the attention its heads by rows (``_heads_by_rows``)."""
    cfg = ctx.cfg
    h = L.layer_norm(x, p["ln"], p["ln_b"], cfg.norm_eps)
    B, S = x.shape[0], x.shape[1]
    if ctx.sharded and ctx.recipe == "cp" and S % ctx.model_axis_size:
        h = constrain(h, ctx.rules, ("batch", None, None))
        q = _project(ctx, h, p["wq"], p["bq"], cfg.n_heads)
        k = _project(ctx, h, p["wk"], p["bk"], cfg.n_kv_heads)
        v = _project(ctx, h, p["wv"], p["bv"], cfg.n_kv_heads)
        out = _attend_full(ctx, q, k, v).reshape(B, S, cfg.q_dim)
        return x + _rows_project(ctx, out, p["wo"])
    p, h = _weights(ctx, p, h)
    q, k, v = _qkv(ctx, p, h)
    out = _attend_full(ctx, q, k, v)
    return x + L.dense(out.reshape(B, S, cfg.q_dim), p["wo"])


def _cross_attn(ctx: Ctx, p, x, enc_kv):
    """Decoder cross-attention. enc_kv: (k, v) each (B, F, H, Dh)."""
    cfg = ctx.cfg
    p, h = _weights(ctx, p, L.layer_norm(x, p["ln"], p["ln_b"],
                                         cfg.norm_eps))
    B, S = h.shape[0], h.shape[1]
    q = (L.dense(h, p["wq"]) + p["bq"]).reshape(B, S, cfg.n_heads,
                                                 cfg.head_dim)
    k, v = enc_kv
    out = _attend_full(ctx, q, k, v)
    return x + L.dense(out.reshape(B, S, cfg.q_dim), p["wo"])


def _cross_kv(ctx: Ctx, p, enc_out):
    """The cross K / V (B, F, Hkv, Dh) of one layer, whole over model on a
    mesh (the decode cache's layout): the projections split over model's
    columns, their products gathered."""
    if not ctx.sharded:
        cfg = ctx.cfg
        B, F = enc_out.shape[0], enc_out.shape[1]
        return tuple((enc_out @ p[w] + p[b]).reshape(
            B, F, cfg.n_kv_heads, cfg.head_dim)
            for w, b in (("wk", "bk"), ("wv", "bv")))
    enc_out = constrain(enc_out, ctx.rules, ("batch", None, None))
    n = ctx.cfg.n_kv_heads
    return (_project(ctx, enc_out, p["wk"], p["bk"], n),
            _project(ctx, enc_out, p["wv"], p["bv"], n))


def _same(blk):
    return blk


def encode(ctx: Ctx, params, frames, gather: Callable = _same):
    """frames: (B, F, D) stub embeddings -> encoder output (B, F, D).
    ``gather`` lays a layer's weights out for compute (on a mesh the
    FSDP gather)."""
    cfg = ctx.cfg
    F = frames.shape[1]
    x = frames + L.sinusoidal_positions(F, cfg.d_model, frames.dtype,
                                        frames.device)[None]
    x = constrain(x, ctx.rules, ("batch", None, None))

    def body(blk, x):
        return mlp_apply(ctx, blk["mlp"], _enc_attn(ctx, blk["attn"], x))

    if ctx.mode == "train":          # JAX's jax.checkpoint of a whole layer
        body = L.remat(body, "block")
    for blk in L.unstack(params["enc_blocks"], cfg.n_encoder_layers):
        x = body(gather(blk), x)
    return L.layer_norm(x, params["enc_ln"], params["enc_ln_b"], cfg.norm_eps)


def decoder_embed(params, tokens, positions, compute_dtype,
                  ctx: Optional[Ctx] = None):
    """Token embeddings plus the learned positions' rows, in the compute
    dtype. tokens (B, S); positions broadcastable to (B, S). On a mesh
    each device looks its batch rows up in the tables gathered whole."""
    if ctx is None or not ctx.sharded:
        return (params["embed"][tokens]
                + params["pos_dec"][positions]).to(compute_dtype)
    whole, spec = spmd.placements(ctx.mesh), ctx.place(batch=0)
    return spmd.shard_map(
        lambda e, p, t, i: (e[t] + p[i]).to(compute_dtype), ctx.mesh,
        (whole, whole, spec,
         spec if isinstance(positions, DTensor) else None),
        spec)(params["embed"], params["pos_dec"], tokens, positions)


def run_decoder_train(ctx: Ctx, params, x, enc_out, gather: Callable = _same):
    """Train / prefill pass over the decoder blocks. Returns (x, caches):
    at prefill {"self": {"k", "v"} (L, B, S, H, Dh), "cross_k", "cross_v"
    (L, B, F, H, Dh)}, at train None (each layer rematerialized)."""
    cfg = ctx.cfg

    def body(blk, x):
        y, self_cache = attn_apply(ctx, blk["self"], x)
        ekv = _cross_kv(ctx, blk["cross"], enc_out)
        y = _cross_attn(ctx, blk["cross"], y, ekv)
        return mlp_apply(ctx, blk["mlp"], y), self_cache, ekv

    if ctx.mode == "train":          # JAX's jax.checkpoint of a whole layer
        body = L.remat(body, "block")
    collected = []
    for blk in L.unstack(params["dec_blocks"], cfg.n_layers):
        x, self_cache, ekv = body(gather(blk), x)
        if ctx.mode == "prefill":
            collected.append((self_cache, ekv))
    if ctx.mode != "prefill":
        return x, None
    return x, {"self": {n: torch.stack([c[n] for c, _ in collected])
                        for n in ("k", "v")},
               "cross_k": torch.stack([e[0] for _, e in collected]),
               "cross_v": torch.stack([e[1] for _, e in collected])}


def run_decoder_decode(ctx: Ctx, params, x, cache, gather: Callable = _same):
    """One-token decode. cache: {"self": {"k", "v"} (L, B, Smax, H, Dh),
    "cross_k", "cross_v" (L, B, F, H, Dh)}; the new token's self K/V are
    written in place at ``ctx.positions`` (clamped), the cross K/V are only
    read. Returns (x, cache)."""
    cfg = ctx.cfg
    B = x.shape[0]
    kv_len = torch.full((B,), cache["cross_k"].shape[2], dtype=torch.long,
                        device=x.device)
    for i, blk in enumerate(L.unstack(params["dec_blocks"], cfg.n_layers)):
        blk = gather(blk)
        x, _ = attn_apply(ctx, blk["self"], x,
                          cache={n: cache["self"][n][i] for n in ("k", "v")})
        x, _ = attn_apply(ctx, blk["cross"], x, kv_override=(
            cache["cross_k"][i], cache["cross_v"][i], kv_len))
        x = mlp_apply(ctx, blk["mlp"], x)
    return x, cache
