"""Dense decoder-only transformer of the port (qwen2-*, minitron, granite).

Counterpart of the dense path of ``repro.models.transformer`` on one
device: no mesh, so no ``shard_map``/``constrain`` and no sequence- or
context-parallel projections. Two differences from the JAX "tp" recipe:

* GQA is left to the attention kernel (group = Hq // Hkv) instead of
  repeating K and V to Hq heads first — the same math with Hq/Hkv times
  less KV traffic;
* the decode-step cache update is an in-place indexed write into the
  caller's cache (the JAX engine donates its cache buffer instead).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


@dataclasses.dataclass
class Ctx:
    cfg: ModelConfig
    mode: str                       # prefill | decode
    positions: Any = None           # (1, S) int64 for prefill, (B,) decode


# --------------------------------------------------------------------------
# Dense attention block
# --------------------------------------------------------------------------
def attn_defs(cfg: ModelConfig) -> Dict[str, L.ParamDef]:
    D, Q, KV = cfg.d_model, cfg.q_dim, cfg.kv_dim
    d = {
        "ln": L.ParamDef((D,), ("embed",), "ones"),
        "wq": L.ParamDef((D, Q), ("embed", "heads")),
        "wk": L.ParamDef((D, KV), ("embed", "kv")),
        "wv": L.ParamDef((D, KV), ("embed", "kv")),
        "wo": L.ParamDef((Q, D), ("heads", "embed")),
    }
    if cfg.qkv_bias:
        d["bq"] = L.ParamDef((Q,), ("heads",), "zeros")
        d["bk"] = L.ParamDef((KV,), ("kv",), "zeros")
        d["bv"] = L.ParamDef((KV,), ("kv",), "zeros")
    if cfg.norm_style() == "layernorm":
        d["ln_b"] = L.ParamDef((D,), ("embed",), "zeros")
    return d


def mlp_defs(cfg: ModelConfig) -> Dict[str, L.ParamDef]:
    D, F = cfg.d_model, cfg.d_ff
    d = {"ln": L.ParamDef((D,), ("embed",), "ones")}
    if cfg.act == "swiglu":
        d["wg"] = L.ParamDef((D, F), ("embed", "mlp"))
        d["wu"] = L.ParamDef((D, F), ("embed", "mlp"))
        d["wd"] = L.ParamDef((F, D), ("mlp", "embed"))
    else:
        d["wi"] = L.ParamDef((D, F), ("embed", "mlp"))
        d["wo_mlp"] = L.ParamDef((F, D), ("mlp", "embed"))
        d["bi"] = L.ParamDef((F,), ("mlp",), "zeros")
        d["bo"] = L.ParamDef((D,), ("embed",), "zeros")
    if cfg.norm_style() == "layernorm":
        d["ln_b"] = L.ParamDef((D,), ("embed",), "zeros")
    return d


def dense_block_defs(cfg: ModelConfig) -> Dict[str, Any]:
    return {"attn": attn_defs(cfg), "mlp": mlp_defs(cfg)}


def _norm(cfg, p, x):
    if cfg.norm_style() == "layernorm":
        return L.layer_norm(x, p["ln"], p["ln_b"], cfg.norm_eps)
    return L.rms_norm(x, p["ln"], cfg.norm_eps)


def _qkv(cfg: ModelConfig, p, h):
    q = h @ p["wq"]
    k = h @ p["wk"]
    v = h @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    B, S = h.shape[0], h.shape[1]
    q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    return q, k, v


def attn_apply(ctx: Ctx, p, x, cache: Optional[dict] = None):
    """Self-attention sub-block. Returns (x + attn_out, cache).

    prefill: the returned cache is {"k", "v"} of shape (B, S, Hkv, D).
    decode: ``cache`` holds this layer's (B, Smax, Hkv, D) views of the
    engine's cache; the new token's K/V are written into them in place at
    ``ctx.positions`` and the same dict is returned.
    """
    cfg = ctx.cfg
    h = _norm(cfg, p, x)

    if ctx.mode == "decode":
        B = h.shape[0]
        q, knew, vnew = _qkv(cfg, p, h)                  # S = 1
        pos = ctx.positions                              # (B,)
        if cfg.rope_theta > 0:
            q = L.rope(q, pos[:, None], cfg.rope_theta)
            knew = L.rope(knew, pos[:, None], cfg.rope_theta)
        kc, vc = cache["k"], cache["v"]
        # dynamic_update_slice clamps the start index into range; slots
        # past the end (finished, still stepping) write the last row
        rows = torch.arange(B, device=x.device)
        at = pos.clamp(max=kc.shape[1] - 1)
        kc[rows, at] = knew[:, 0]
        vc[rows, at] = vnew[:, 0]
        out = L.decode_attention(q, kc, vc, pos, window=cfg.window,
                                 softcap=cfg.logit_softcap)
        attn_out = out.reshape(B, 1, cfg.q_dim) @ p["wo"]
        return x + attn_out, cache

    q, k, v = _qkv(cfg, p, h)
    if cfg.rope_theta > 0:
        q = L.rope(q, ctx.positions, cfg.rope_theta)
        k = L.rope(k, ctx.positions, cfg.rope_theta)
    new_cache = {"k": k, "v": v} if ctx.mode == "prefill" else None
    out = L.attention(q, k, v, causal=True, window=cfg.window,
                      softcap=cfg.logit_softcap)
    B, S = x.shape[0], x.shape[1]
    attn_out = out.reshape(B, S, cfg.q_dim) @ p["wo"]
    return x + attn_out, new_cache


def mlp_apply(ctx: Ctx, p, x):
    cfg = ctx.cfg
    h = _norm(cfg, p, x)
    if cfg.act == "swiglu":
        hidden = L.swiglu(h @ p["wg"], h @ p["wu"])
        out = hidden @ p["wd"]
    else:
        hh = L.gelu(h @ p["wi"] + p["bi"])
        out = hh @ p["wo_mlp"] + p["bo"]
    return x + out


def dense_block_apply(ctx: Ctx, p, x, cache=None):
    x, new_cache = attn_apply(ctx, p["attn"], x, cache)
    x = mlp_apply(ctx, p["mlp"], x)
    return x, new_cache


# --------------------------------------------------------------------------
# Full LM assembly
# --------------------------------------------------------------------------
def lm_defs(cfg: ModelConfig, block_defs_fn) -> Dict[str, Any]:
    D, V = cfg.d_model, cfg.vocab_size
    defs: Dict[str, Any] = {
        "final_ln": L.ParamDef((D,), ("embed",), "ones"),
    }
    if cfg.tie_embeddings:
        defs["embed"] = L.ParamDef((V, D), ("vocab", "embed"), scale=1.0)
    else:
        defs["embed"] = L.ParamDef((V, D), ("vocab_in", "embed_in"), scale=1.0)
        defs["lm_head"] = L.ParamDef((D, V), ("embed", "vocab"))
    if cfg.norm_style() == "layernorm":
        defs["final_ln_b"] = L.ParamDef((D,), ("embed",), "zeros")
    defs["blocks"] = L.stack_defs(block_defs_fn(cfg), cfg.n_layers)
    return defs


def embed_tokens(cfg: ModelConfig, params, tokens,
                 compute_dtype=torch.bfloat16):
    return params["embed"][tokens].to(compute_dtype)


def lm_logits(cfg: ModelConfig, params, x):
    """f32 logits, as the JAX package computes them."""
    xf = x.float()
    if cfg.tie_embeddings:
        return xf @ params["embed"].float().T
    return xf @ params["lm_head"].float()


def final_norm(cfg, params, x):
    if cfg.norm_style() == "layernorm":
        return L.layer_norm(x, params["final_ln"], params["final_ln_b"],
                            cfg.norm_eps)
    return L.rms_norm(x, params["final_ln"], cfg.norm_eps)
