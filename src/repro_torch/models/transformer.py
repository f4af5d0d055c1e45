"""Dense decoder-only transformer of the port (qwen2-*, minitron, granite,
the internvl2 LM), on one device or on a mesh (counterpart of
``repro.models.transformer``).

Sharding recipes (decided per arch at build time, ``recipe_for``):

* ``tp`` -- Megatron-style tensor parallel: the residual is ("batch",
  "seq"->model); inside a block the hidden is gathered over model, q runs
  head-sharded over model, and the output projections reduce back to the
  residual's layout (with ``explicit_rs`` the in- and out-projections are
  ``_sp_in_project`` / ``_rs_project``, an explicit all-gather and
  reduce-scatter over the sequence). Requires n_heads % tp == 0.
* ``cp`` -- context parallel for archs whose head counts don't divide the
  model axis: the residual stays seq-sharded, the attention weights are
  gathered whole, and attention runs per device on its query rows against
  K/V all-gathered over model, the flash kernel taking the rank's
  ``q_offset`` (``_cp_attention``).

On a mesh the tensors are DTensors and each of JAX's ``constrain`` points
redistributes to its rule's placements; the per-device bodies of JAX's
``shard_map`` are ``sharding.spmd.shard_map``. On one device (no mesh,
or every axis of size 1) every parallel path takes its unsharded branch
and nothing is a DTensor, unless the model was built ``sharded`` on a
``DeviceMesh`` of one rank: then the parallel paths run on DTensors, each
axis of size 1.

Differences from JAX's "tp" recipe, kept on purpose:

* GQA is left to the attention kernel (group = Hq // Hkv) instead of
  repeating K and V to Hq heads: K and V are gathered over model, and each
  device selects the kv heads its q heads read at the shard boundary
  (``_local_kv``), repeating them only where a kv head serves q heads of
  two devices;
* the decode-step cache update is an in-place indexed write into the
  caller's cache (the JAX engine donates its cache buffer instead); on a
  mesh whose cache is sequence-sharded ("kv_seq"), each device writes the
  rows it holds and decode attention combines the devices' partial
  softmax sums (``_decode_attention_sharded``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Shard, distribute_tensor

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.models import layers as L
from repro_torch.sharding import spmd
from repro_torch.sharding.partition import (Rules, batch_axes, constrain,
                                            mesh_shape, multi_device)


@dataclasses.dataclass
class Ctx:
    cfg: ModelConfig
    mode: str                       # train | prefill | decode
    positions: Any = None           # (1, S) train/prefill, (B,) decode
    q_block: int = 512              # train attention's blocks (JAX's
    kv_block: int = 1024            # ParallelConfig.q_block / kv_block)
    parallel: Optional[ParallelConfig] = None
    rules: Optional[Rules] = None   # activation rules
    mesh: Any = None                # DeviceMesh / OneDeviceMesh / None
    recipe: str = "tp"              # tp | cp
    batch: Optional[int] = None     # the global batch, when known
    # the tensors are DTensors: by default on a mesh of more than one
    # device (``ModelApi.sharded`` passes its own); set once, with the
    # model axis's size
    sharded: Optional[bool] = None
    model_axis_size: int = dataclasses.field(init=False)

    def __post_init__(self):
        if self.sharded is None:
            self.sharded = multi_device(self.mesh)
        self.model_axis_size = 1 if self.parallel is None else \
            mesh_shape(self.mesh).get(self.parallel.model_axis, 1)

    def batch_axes(self) -> Tuple[str, ...]:
        """The axes the batch dim is over: none that do not divide the
        global batch (a batch of 1 stays replicated, as the rules give)."""
        if self.parallel is None:
            return ()
        return batch_axes(self.mesh, self.parallel, self.batch)

    def place(self, **dims) -> tuple:
        """Placements of a tensor whose batch dim is ``batch`` (over the
        batch axes) and whose dim ``model`` is over the model axis; see
        ``spmd.placements``."""
        want = {a: dims.get("batch") for a in self.batch_axes()}
        want[self.parallel.model_axis] = dims.get("model")
        return spmd.placements(self.mesh, **want)


def recipe_for(cfg: ModelConfig, tp_size: int) -> str:
    if cfg.n_heads and cfg.n_heads % max(tp_size, 1) == 0:
        return "tp"
    return "cp"


def _replicate(p, ctx: Ctx):
    """A weight tree gathered whole (the cp recipe's ZeRO-3 gather of the
    attention weights)."""
    return {k: v.redistribute(ctx.mesh, spmd.placements(ctx.mesh))
            if isinstance(v, DTensor) else v for k, v in p.items()}


def _sp_in_project(ctx: Ctx, x, ws):
    """Fused Megatron-SP input projection: all-gather the seq-sharded
    residual over model and apply K output-dim-sharded weights in one
    per-device body, so the backward x-grad is one reduce-scatter.
    x: (B, S/n, D); ws: list of (D, K_i) sharded on K_i. Returns
    [(B, S, K_i/n) sharded over model on the last dim]."""
    n = ctx.model_axis_size
    if not ctx.sharded or n == 1 or x.shape[1] % n != 0:
        return [x @ w for w in ws]
    axis = ctx.parallel.model_axis

    def local(xl, *wl):
        h = spmd.all_gather(xl, ctx.mesh, axis, dim=1)
        return tuple(h @ w for w in wl)

    outs = spmd.shard_map(
        local, ctx.mesh,
        (ctx.place(batch=0, model=1),) + (ctx.place(model=1),) * len(ws),
        (ctx.place(batch=0, model=2),) * len(ws))(x, *ws)
    return list(outs)


def _rs_project(ctx: Ctx, h, w):
    """Megatron-SP output projection: the local partial product and a
    reduce-scatter over the sequence (half the bytes of an all-reduce,
    landing in the seq-sharded residual's layout). h: (B, S, K) with K
    sharded over model; w: (K, D) sharded on K. Returns (B, S, D) with S
    sharded over model."""
    n = ctx.model_axis_size
    if not ctx.sharded or n == 1 or h.shape[1] % n != 0:
        return h @ w
    axis = ctx.parallel.model_axis

    def local(hl, wl):
        return spmd.reduce_scatter(hl @ wl, ctx.mesh, axis, dim=1)

    return spmd.shard_map(local, ctx.mesh,
                          (ctx.place(batch=0, model=2),
                           ctx.place(model=0)),
                          ctx.place(batch=0, model=1))(h, w)


def _local_kv(k, v, h0: int, hl: int, G: int):
    """The kv heads that q heads [h0, h0 + hl) read (kv head of q head h:
    h // G), as (k, v, group): a slice when the q heads cover whole kv
    heads, one head when they share one, else the kv heads repeated to q
    heads and sliced (group 1)."""
    if hl % G == 0 and h0 % G == 0:
        return k[:, :, h0 // G:(h0 + hl) // G], \
            v[:, :, h0 // G:(h0 + hl) // G], G
    if h0 // G == (h0 + hl - 1) // G:
        j = h0 // G
        return k[:, :, j:j + 1], v[:, :, j:j + 1], hl
    idx = torch.arange(h0, h0 + hl, device=k.device) // G
    return k[:, :, idx], v[:, :, idx], 1


def _attend(ctx: Ctx, q, k, v, *, causal=True, window=0, q_offset=0,
            cp: bool = False):
    """Train: JAX's dispatch in torch ops (``train_attention``, or for a
    context-parallel rank, ``cp``, the blocked form with its offset, rank
    0's included, as JAX's ``_cp_attention`` calls it); prefill: the
    flash kernel's wrapper."""
    cfg = ctx.cfg
    if ctx.mode == "train":
        if q_offset or cp:
            return L.flash_attention_cp(
                q, k, v, causal=causal, window=window, q_offset=q_offset,
                softcap=cfg.logit_softcap,
                q_block=min(ctx.q_block, q.shape[1]),
                kv_block=min(ctx.kv_block, k.shape[1]))
        return L.train_attention(q, k, v, causal=causal, window=window,
                                 softcap=cfg.logit_softcap,
                                 q_block=ctx.q_block, kv_block=ctx.kv_block)
    return L.attention(q, k, v, causal=causal, window=window,
                       softcap=cfg.logit_softcap, q_offset=q_offset)


def _tp_attention(ctx: Ctx, q, k, v, *, causal=True, window=0):
    """tp recipe: q head-sharded over model, K and V whole over model; each
    device attends its q heads to the kv heads they read."""
    cfg = ctx.cfg
    n = ctx.model_axis_size
    if not ctx.sharded:
        return _attend(ctx, q, k, v, causal=causal, window=window)
    axis = ctx.parallel.model_axis
    G = cfg.n_heads // cfg.n_kv_heads
    hl = cfg.n_heads // n

    def local(ql, kl, vl):
        h0 = spmd.axis_index(ctx.mesh, axis) * hl
        kl, vl, _ = _local_kv(kl, vl, h0, hl, G)
        return _attend(ctx, ql, kl, vl, causal=causal, window=window)

    qspec = ctx.place(batch=0, model=2)
    kvspec = ctx.place(batch=0)
    return spmd.shard_map(local, ctx.mesh, (qspec, kvspec, kvspec),
                          qspec)(q, k, v)


def _cp_attention(ctx: Ctx, q, k, v, *, causal=True, window=0):
    """Context-parallel attention: q/k/v seq-sharded over the model axis;
    K/V all-gathered per device, the causal mask offset by the device's
    first query position (``q_offset = rank * s_loc``)."""
    n = ctx.model_axis_size
    if not ctx.sharded:
        return _attend(ctx, q, k, v, causal=causal, window=window)
    if q.shape[1] % n != 0:
        return _replicated_attention(ctx, q, k, v, causal=causal,
                                     window=window)
    axis = ctx.parallel.model_axis

    def local(ql, kl, vl):
        kf = spmd.all_gather(kl, ctx.mesh, axis, dim=1)
        vf = spmd.all_gather(vl, ctx.mesh, axis, dim=1)
        s_loc = ql.shape[1]
        offset = spmd.axis_index(ctx.mesh, axis) * s_loc
        return _attend(ctx, ql, kf, vf, causal=causal, window=window,
                       q_offset=offset, cp=True)

    spec = ctx.place(batch=0, model=1)
    return spmd.shard_map(local, ctx.mesh, (spec, spec, spec), spec)(q, k, v)


def _replicated_attention(ctx: Ctx, q, k, v, *, causal=True, window=0):
    """Attention with q, k and v whole over the model axis (a sequence
    that does not split over it): every device of the axis attends all
    heads of its batch rows."""
    spec = ctx.place(batch=0)
    return spmd.shard_map(
        lambda ql, kl, vl: _attend(ctx, ql, kl, vl, causal=causal,
                                   window=window),
        ctx.mesh, (spec, spec, spec), spec)(q, k, v)


def _write_cache(kc, vc, knew, vnew, pos, row0: int = 0):
    """Write each slot's new K/V row at ``pos - row0`` of the caches
    (B, Smax_local, Hkv, D), in place. JAX's dynamic_update_slice clamps
    the start into range, so a slot past the end (finished, still
    stepping) writes the last row of the whole cache: only the device
    holding that row writes it."""
    B, S_loc = kc.shape[0], kc.shape[1]
    rows = torch.arange(B, device=kc.device)
    at = pos - row0
    mine = (at >= 0) & (at < S_loc)
    at = at.clamp(0, S_loc - 1)
    kc[rows, at] = torch.where(mine[:, None, None], knew[:, 0], kc[rows, at])
    vc[rows, at] = torch.where(mine[:, None, None], vnew[:, 0], vc[rows, at])


def _decode_attention_sharded(ctx: Ctx, q, knew, vnew, kc, vc, pos):
    """Decode attention on a mesh: each device writes the new K/V rows it
    holds (the cache is sequence-sharded over model when "kv_seq" is) and
    attends the query to its rows; the devices' partial softmax sums are
    combined with one max and one sum over model."""
    cfg = ctx.cfg
    axis = ctx.parallel.model_axis
    seq_sharded = isinstance(kc.placements[list(ctx.mesh.mesh_dim_names)
                                           .index(axis)], Shard)
    S_total = kc.shape[1]

    def local(ql, kn, vn, kl, vl, pl):
        S_loc = kl.shape[1]
        row0 = spmd.axis_index(ctx.mesh, axis) * S_loc if seq_sharded else 0
        clamped = pl.clamp(max=S_total - 1)
        _write_cache(kl, vl, kn, vn, clamped, row0)
        if not seq_sharded:
            return L.decode_attention(ql, kl, vl, pl, window=cfg.window,
                                      softcap=cfg.logit_softcap)
        m, l, acc = L.decode_attention_partial(
            ql, kl, vl, pl, row0, window=cfg.window,
            softcap=cfg.logit_softcap)
        m_all = spmd.pmax(m, ctx.mesh, axis)
        corr = torch.exp(m - m_all)
        l = spmd.psum(l * corr, ctx.mesh, axis)
        acc = spmd.psum(acc * corr[..., None], ctx.mesh, axis)
        out = acc / l.clamp_min(1e-20)[..., None]
        B, Hkv, G, D = out.shape
        return out.reshape(B, 1, Hkv * G, D).to(vl.dtype)

    # the caches pass as their local tensors, written in place (never
    # redistributed: a copy would lose the write)
    rep = ctx.place(batch=0)
    return spmd.shard_map(local, ctx.mesh,
                          (rep, rep, rep, None, None, rep),
                          rep)(q, knew, vnew, kc.to_local(), vc.to_local(),
                               pos)


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


def _split_heads(ctx: Ctx, q, k, v):
    """(B, S, Q) / (B, S, KV) projections -> (B, S, H, D) heads. On a mesh
    q is constrained head-sharded over model (tp) and K/V whole over
    model, since the kv heads rarely divide the model axis (JAX gathers
    them the same way on its fused path)."""
    cfg = ctx.cfg
    if ctx.recipe == "tp":
        q = constrain(q, ctx.rules, ("batch", None, "heads"))
        k = constrain(k, ctx.rules, ("batch", None, None))
        v = constrain(v, ctx.rules, ("batch", None, None))
    B, S = q.shape[0], q.shape[1]
    return (q.reshape(B, S, cfg.n_heads, cfg.head_dim),
            k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim),
            v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim))


def _qkv(ctx: Ctx, p, h):
    cfg = ctx.cfg
    q = L.dense(h, p["wq"])
    k = L.dense(h, p["wk"])
    v = L.dense(h, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return _split_heads(ctx, q, k, v)


def attn_apply(ctx: Ctx, p, x, cache: Optional[dict] = None,
               kv_override: Optional[Tuple] = None):
    """Self-attention sub-block. Returns (x + attn_out, cache).

    prefill: the returned cache is {"k", "v"} of shape (B, S, Hkv, D).
    train: no cache; attention is ``layers.train_attention``, no kernel.
    decode: ``cache`` holds this layer's (B, Smax, Hkv, D) views of the
    engine's cache; the new token's K/V are written into them in place at
    ``ctx.positions`` and the same dict is returned.

    kv_override (decode only): (k, v, kv_len) with k, v (B, Sk, Hkv, D)
    and kv_len (B,), the cross-attention of the whisper decoder. The query
    (with its bias, without RoPE, as in JAX) attends to the first kv_len
    rows; nothing is written and the returned cache is None.
    """
    cfg = ctx.cfg
    if ctx.sharded and ctx.recipe == "cp":
        p = _replicate(p, ctx)
    h = _norm(cfg, p, x)
    use_sp_fused = (ctx.parallel is not None and ctx.parallel.explicit_rs
                    and ctx.recipe == "tp" and ctx.mode != "decode")
    if ctx.recipe == "tp" and not use_sp_fused:
        h = constrain(h, ctx.rules, ("batch", None, None))

    if kv_override is not None:
        if ctx.mode != "decode":
            raise ValueError("kv_override is a decode-step argument")
        B = h.shape[0]
        q = L.dense(h, p["wq"])
        if cfg.qkv_bias:
            q = q + p["bq"]
        q = q.reshape(B, 1, cfg.n_heads, cfg.head_dim)
        kf, vf, kv_len = kv_override

        def cross(ql, kl, vl, nl):
            return L.decode_attention(ql, kl, vl, (nl - 1).clamp_min(0),
                                      window=0, softcap=cfg.logit_softcap)
        if ctx.sharded:
            # each device its batch rows, every head, against the cross
            # K / V it holds whole
            if not isinstance(kv_len, DTensor):
                kv_len = distribute_tensor(kv_len, ctx.mesh, ctx.place(),
                                           src_data_rank=None)
            spec = ctx.place(batch=0)
            cross = spmd.shard_map(cross, ctx.mesh, (spec,) * 4, spec)
        out = cross(q, kf, vf, kv_len)
        return x + L.dense(out.reshape(B, 1, cfg.q_dim), p["wo"]), None

    if ctx.mode == "decode":
        B = h.shape[0]
        q, knew, vnew = _qkv(ctx, p, h)                  # S = 1
        pos = ctx.positions                              # (B,)
        if cfg.rope_theta > 0:
            q = L.rope(q, pos[:, None], cfg.rope_theta)
            knew = L.rope(knew, pos[:, None], cfg.rope_theta)
        kc, vc = cache["k"], cache["v"]
        if ctx.sharded:
            out = _decode_attention_sharded(ctx, q, knew, vnew, kc, vc, pos)
        else:
            # dynamic_update_slice clamps the start index into range; slots
            # past the end (finished, still stepping) write the last row
            rows = torch.arange(B, device=x.device)
            at = pos.clamp(max=kc.shape[1] - 1)
            kc[rows, at] = knew[:, 0]
            vc[rows, at] = vnew[:, 0]
            out = L.decode_attention(q, kc, vc, pos, window=cfg.window,
                                     softcap=cfg.logit_softcap)
        attn_out = L.dense(out.reshape(B, 1, cfg.q_dim), p["wo"])
        attn_out = constrain(attn_out, ctx.rules, ("batch", "seq", None))
        return x + attn_out, cache

    if use_sp_fused:
        qf, kf, vf = _sp_in_project(ctx, h, [p["wq"], p["wk"], p["wv"]])
        if cfg.qkv_bias:
            qf, kf, vf = qf + p["bq"], kf + p["bk"], vf + p["bv"]
        q, k, v = _split_heads(ctx, qf, kf, vf)
    else:
        q, k, v = _qkv(ctx, p, h)
    if cfg.rope_theta > 0:
        q = L.rope(q, ctx.positions, cfg.rope_theta)
        k = L.rope(k, ctx.positions, cfg.rope_theta)
    new_cache = None
    if ctx.mode == "prefill":
        new_cache = {
            "k": constrain(k, ctx.rules, ("batch", "kv_seq", None, None)),
            "v": constrain(v, ctx.rules, ("batch", "kv_seq", None, None))}
    if ctx.recipe == "tp":
        out = _tp_attention(ctx, q, k, v, causal=True, window=cfg.window)
    else:
        out = _cp_attention(ctx, q, k, v, causal=True, window=cfg.window)
    B, S = x.shape[0], x.shape[1]
    flat = out.reshape(B, S, cfg.q_dim)
    if use_sp_fused:
        attn_out = _rs_project(ctx, flat, p["wo"])
    else:
        attn_out = L.dense(flat, p["wo"])
    attn_out = constrain(attn_out, ctx.rules, ("batch", "seq", None))
    return x + attn_out, new_cache


def mlp_apply(ctx: Ctx, p, x):
    cfg = ctx.cfg
    h = _norm(cfg, p, x)
    use_rs = (ctx.parallel is not None and ctx.parallel.explicit_rs
              and ctx.recipe == "tp" and ctx.mode != "decode")
    if not use_rs:
        # JAX constrains h in the tp recipe and leaves the cp recipe's
        # gather to GSPMD through the "mlp" constraint on the product;
        # here both gather h, so that no product meets two shardings
        h = constrain(h, ctx.rules, ("batch", None, None))
    if cfg.act == "swiglu":
        if use_rs:
            g, u = _sp_in_project(ctx, h, [p["wg"], p["wu"]])
        else:
            g, u = L.dense(h, p["wg"]), L.dense(h, p["wu"])
        g = constrain(g, ctx.rules, ("batch", None, "mlp"))
        u = constrain(u, ctx.rules, ("batch", None, "mlp"))
        hidden = L.swiglu(g, u)
        out = _rs_project(ctx, hidden, p["wd"]) if use_rs \
            else L.dense(hidden, p["wd"])
    else:
        if use_rs:
            (hi,) = _sp_in_project(ctx, h, [p["wi"]])
        else:
            hi = L.dense(h, p["wi"])
        hh = L.gelu(hi + p["bi"])
        out = (_rs_project(ctx, hh, p["wo_mlp"]) if use_rs
               else L.dense(hh, p["wo_mlp"]))
        out = constrain(out, ctx.rules, ("batch", "seq", None)) + p["bo"]
    out = constrain(out, ctx.rules, ("batch", "seq", None))
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
                 compute_dtype=torch.bfloat16, ctx: Optional[Ctx] = None):
    """Rows of the input table in the compute dtype, constrained to
    ("batch", "seq", None). On a mesh each device looks its tokens up in
    its columns of the table (an untied table's "embed_in" is over model;
    a tied table, rows over model, is gathered whole first)."""
    table = params["embed"]
    if ctx is None or not ctx.sharded:
        return table[tokens].to(compute_dtype)
    axis = ctx.parallel.model_axis
    col = table.placements[list(ctx.mesh.mesh_dim_names).index(axis)]
    if col != Shard(1):
        table = table.redistribute(ctx.mesh, spmd.placements(ctx.mesh))
        col = None
    out = spmd.shard_map(
        lambda t, tok: t[tok].to(compute_dtype), ctx.mesh,
        (tuple(table.placements), ctx.place(batch=0)),
        ctx.place(batch=0, model=None if col is None else 2))(table, tokens)
    return constrain(out, ctx.rules, ("batch", "seq", None))


def lm_logits(cfg: ModelConfig, params, x, ctx: Optional[Ctx] = None):
    """f32 logits, as the JAX package computes them, constrained to
    ("batch", None, "vocab"). On a mesh whose model axis the vocab does
    not divide (the rules leave the table whole over it: mamba2-1.3b,
    whisper-base, internvl2-1b over 16), the rows keep their sequence
    sharding instead, ("batch", "seq", None), so that each device computes
    the logits of its own rows and not all of them."""
    rules = None if ctx is None else ctx.rules
    table = params["embed"].float().T if cfg.tie_embeddings \
        else params["lm_head"].float()
    if rules is not None and not vocab_split(rules, x, cfg.vocab_size):
        xf = constrain(x, rules, ("batch", "seq", None)).float()
        return constrain(L.dense(xf, table), rules, ("batch", "seq", None))
    xf = constrain(x, rules, ("batch", None, None)).float()
    return constrain(L.dense(xf, table), rules, ("batch", None, "vocab"))


def vocab_split(rules: Rules, x, vocab: int) -> bool:
    """The logits of ``x`` (B, S, D) have their vocab over model."""
    spec = rules.spec(("batch", None, "vocab"),
                      (x.shape[0], x.shape[1], vocab))
    return len(spec) == 3 and spec[2] is not None


def final_norm(cfg, params, x):
    if cfg.norm_style() == "layernorm":
        return L.layer_norm(x, params["final_ln"], params["final_ln_b"],
                            cfg.norm_eps)
    return L.rms_norm(x, params["final_ln"], cfg.norm_eps)
