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

The parameter tree is JAX's: the same paths, shapes and ``x @ W``
orientation, the layers stacked along a leading dimension.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import (Ctx, _qkv, attn_apply, attn_defs,
                                            mlp_apply, mlp_defs)
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


def _enc_attn(ctx: Ctx, p, x):
    """Non-causal encoder self-attention."""
    cfg = ctx.cfg
    h = L.layer_norm(x, p["ln"], p["ln_b"], cfg.norm_eps)
    q, k, v = _qkv(ctx, p, h)
    out = _full_attention(ctx, q, k, v)
    B, S = x.shape[0], x.shape[1]
    return x + out.reshape(B, S, cfg.q_dim) @ p["wo"]


def _cross_attn(ctx: Ctx, p, x, enc_kv):
    """Decoder cross-attention. enc_kv: (k, v) each (B, F, H, Dh)."""
    cfg = ctx.cfg
    h = L.layer_norm(x, p["ln"], p["ln_b"], cfg.norm_eps)
    B, S = h.shape[0], h.shape[1]
    q = ((h @ p["wq"]) + p["bq"]).reshape(B, S, cfg.n_heads, cfg.head_dim)
    k, v = enc_kv
    out = _full_attention(ctx, q, k, v)
    return x + out.reshape(B, S, cfg.q_dim) @ p["wo"]


def _cross_kv(cfg: ModelConfig, p, enc_out):
    B, F = enc_out.shape[0], enc_out.shape[1]
    k = ((enc_out @ p["wk"]) + p["bk"]).reshape(B, F, cfg.n_kv_heads,
                                                cfg.head_dim)
    v = ((enc_out @ p["wv"]) + p["bv"]).reshape(B, F, cfg.n_kv_heads,
                                                cfg.head_dim)
    return k, v


def encode(ctx: Ctx, params, frames):
    """frames: (B, F, D) stub embeddings -> encoder output (B, F, D)."""
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
        x = body(blk, x)
    return L.layer_norm(x, params["enc_ln"], params["enc_ln_b"], cfg.norm_eps)


def decoder_embed(params, tokens, positions, compute_dtype):
    """Token embeddings plus the learned positions' rows, in the compute
    dtype. tokens (B, S); positions broadcastable to (B, S)."""
    return (params["embed"][tokens]
            + params["pos_dec"][positions]).to(compute_dtype)


def run_decoder_train(ctx: Ctx, params, x, enc_out):
    """Train / prefill pass over the decoder blocks. Returns (x, caches):
    at prefill {"self": {"k", "v"} (L, B, S, H, Dh), "cross_k", "cross_v"
    (L, B, F, H, Dh)}, at train None (each layer rematerialized)."""
    cfg = ctx.cfg

    def body(blk, x):
        y, self_cache = attn_apply(ctx, blk["self"], x)
        ekv = _cross_kv(cfg, blk["cross"], enc_out)
        y = _cross_attn(ctx, blk["cross"], y, ekv)
        return mlp_apply(ctx, blk["mlp"], y), self_cache, ekv

    if ctx.mode == "train":          # JAX's jax.checkpoint of a whole layer
        body = L.remat(body, "block")
    collected = []
    for blk in L.unstack(params["dec_blocks"], cfg.n_layers):
        x, self_cache, ekv = body(blk, x)
        if ctx.mode == "prefill":
            collected.append((self_cache, ekv))
    if ctx.mode != "prefill":
        return x, None
    return x, {"self": {n: torch.stack([c[n] for c, _ in collected])
                        for n in ("k", "v")},
               "cross_k": torch.stack([e[0] for _, e in collected]),
               "cross_v": torch.stack([e[1] for _, e in collected])}


def run_decoder_decode(ctx: Ctx, params, x, cache):
    """One-token decode. cache: {"self": {"k", "v"} (L, B, Smax, H, Dh),
    "cross_k", "cross_v" (L, B, F, H, Dh)}; the new token's self K/V are
    written in place at ``ctx.positions`` (clamped), the cross K/V are only
    read. Returns (x, cache)."""
    cfg = ctx.cfg
    B = x.shape[0]
    kv_len = torch.full((B,), cache["cross_k"].shape[2], dtype=torch.long,
                        device=x.device)
    for i, blk in enumerate(L.unstack(params["dec_blocks"], cfg.n_layers)):
        x, _ = attn_apply(ctx, blk["self"], x,
                          cache={n: cache["self"][n][i] for n in ("k", "v")})
        x, _ = attn_apply(ctx, blk["cross"], x, kv_override=(
            cache["cross_k"][i], cache["cross_v"][i], kv_len))
        x = mlp_apply(ctx, blk["mlp"], x)
    return x, cache
