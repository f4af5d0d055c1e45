"""Shared by the port-vs-JAX model tests (training, the vlm and audio
families): a reduced config built in both packages on identical
parameters, the stub inputs (patches, frames) from a seed, and the
gradient comparison."""
import numpy as np
import torch
import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.configs.base import ParallelConfig as JaxParallelConfig
from repro.launch.mesh import make_local_mesh
from repro.models.model import build_model as jax_build_model

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ParallelConfig
from repro_torch.convert import params_from_jax_numpy
from repro_torch.models.model import build_model

TOL = dict(atol=1e-4, rtol=1e-4)
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
ZERO_GRAD = 1e-6
# leaves that JAX initializes to ones/zeros: perturbed so that the norms,
# biases and gates are exercised too
PERTURB = ("ln", "ln_b", "bq", "bk", "bv", "bi", "bo", "final_ln",
           "final_ln_b", "enc_ln", "enc_ln_b", "lam", "b_a", "b_i",
           "dt_bias", "A_log", "D_skip", "gn")


def perturb(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = perturb(v, rng)
        elif k in PERTURB:
            out[k] = v + jnp.asarray(0.1 * rng.normal(size=v.shape), v.dtype)
        else:
            out[k] = v
    return out


def pair(arch, over=None, **par):
    """(japi, jparams, api, params): reduced ``arch`` (with the config
    overrides ``over``) in f32 in both packages, JAX's perturbed
    parameters carried across; ``params`` are the port's f32 tree on the
    CPU (usable as masters and for serving)."""
    over = over or {}
    kw = dict(dict(param_dtype="float32", compute_dtype="float32",
                   q_block=8, kv_block=8), **par)
    japi = jax_build_model(jax_reduced(jax_get_config(arch), **over),
                           JaxParallelConfig(**kw), make_local_mesh(1, 1))
    jparams = perturb(japi.init(jax.random.key(0)), np.random.default_rng(0))
    cfg = reduced(get_config(arch), **over)
    api = build_model(cfg, ParallelConfig(**kw), device="cpu")
    params = params_from_jax_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                   device="cpu")
    return japi, jparams, api, params


def stub_inputs(cfg, B, seed, scale=0.02):
    """{"patches"} for vlm, {"frames"} for audio: normal x ``scale`` from
    ``seed``, as the data pipeline draws them."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        return {"patches": (rng.normal(size=(B, cfg.n_vision_tokens,
                                              cfg.d_model)) * scale
                            ).astype(np.float32)}
    if cfg.family == "audio":
        return {"frames": (rng.normal(size=(B, cfg.n_encoder_frames,
                                             cfg.d_model)) * scale
                           ).astype(np.float32)}
    return {}


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def lm_batch(seed, B, S, vocab):
    """Tokens and next-token labels, the last and a few first masked."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, size=(B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -100
    labels[0, :3] = -100
    return {"tokens": tokens, "labels": labels.astype(np.int32)}


def leaves(tree, path=()):
    """[(path, leaf)] with dict keys sorted (JAX's order)."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in leaves(tree[k], path + (k,))]
    return [("/".join(path), tree)]


def def_shapes(tree):
    """{path: shape} of a port tree of ParamDefs or tensors."""
    return {p: tuple(a.shape) for p, a in leaves(tree)}


def jax_def_shapes(defs):
    """{path: shape} of a JAX tree of ParamDefs or arrays."""
    return {"/".join(k.key for k in path): tuple(d.shape)
            for path, d in jax.tree_util.tree_leaves_with_path(
                defs, is_leaf=lambda x: hasattr(x, "logical"))}


def assert_trees_close(got, want, **tol):
    """Every leaf of the port's tree against JAX's, the same paths."""
    got, want = dict(leaves(got)), dict(leaves(want))
    assert set(got) == set(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path].detach().numpy(),
                                   np.asarray(w), err_msg=path, **tol)


def assert_grads_close(got, want, tol=GRAD_TOL, zero=()):
    """Each gradient leaf within ``tol`` of JAX's largest |g| there. The
    leaves named in ``zero`` (by their last key) have a gradient that is
    zero in exact arithmetic, so both packages give rounding noise there:
    they are held to ZERO_GRAD of the tree's largest |g|, in either
    package. (Without RoPE the key bias is such a leaf: softmax ignores a
    shift that all keys share.)"""
    got, want = dict(leaves(got)), dict(leaves(want))
    assert set(got) == set(want)
    top = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    for path, w in want.items():
        w = np.asarray(w)
        g = got[path].detach().numpy()
        assert g.shape == w.shape, path
        if path.rsplit("/", 1)[-1] in zero:
            assert max(np.abs(g).max(), np.abs(w).max()) <= ZERO_GRAD * top, \
                (path, np.abs(g).max(), np.abs(w).max(), top)
            continue
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(g - w).max())
        assert err <= tol * scale, (path, err, scale)


def grow_kv(tree, S, lib):
    """A prefill cache tree with every "k" / "v" leaf (L, B, S_p, H, D)
    zero-padded to S rows, in ``lib`` (numpy arrays for JAX, or torch)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = grow_kv(v, S, lib)
        elif k in ("k", "v"):
            a = np.asarray(v) if lib is jnp else v
            shape = a.shape[:2] + (S,) + a.shape[3:]
            if lib is jnp:
                pad = np.zeros(shape, a.dtype)
                pad[:, :, :a.shape[2]] = a
                out[k] = jnp.asarray(pad)
            else:
                pad = a.new_zeros(shape)
                pad[:, :, :a.shape[2]] = a
                out[k] = pad
        else:
            out[k] = v
    return out
