"""PyTorch port vs the JAX package: the optimizers, the learning-rate
schedule, global-norm clipping, the train step (microbatch accumulation,
int8 error-feedback compression) and the token source, on the CPU in f32.

Tolerances: one optimizer update from the same params, state and grads
within 1e-6 (f32 elementwise math with the same constants; the clip
norm is a sum taken in another order); bf16 moments within one bf16 ulp
(2^-8 relative). The schedule within rtol 1e-6. Three train steps of a
reduced qwen2-7b (SGD, lr 0.1) from JAX's parameters and batches: losses
within rtol 1e-5, parameters within 1e-6 absolute (the grads agree to
~1e-6 of each leaf's largest |g|); under int8 error feedback, see the
test for the elements that round across a quantization boundary. Token
batches are equal exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.configs.base import ParallelConfig as JaxParallelConfig  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.launch.mesh import make_local_mesh  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training.step import make_train_step as jax_make_train_step  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.convert import params_from_jax_numpy  # noqa: E402
from repro_torch.data import pipeline as tdata  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training.step import make_train_step  # noqa: E402


def _tree(seed, scale=1.0):
    """A parameter-like tree: stacked matrices, a matrix, vectors."""
    rng = np.random.default_rng(seed)
    return {"blocks": {"w": (scale * rng.normal(size=(2, 6, 5))).astype(
                np.float32),
                       "b": (scale * rng.normal(size=(2, 5))).astype(
                np.float32)},
            "head": (scale * rng.normal(size=(5, 7))).astype(np.float32),
            "ln": (1 + 0.1 * rng.normal(size=(7,))).astype(np.float32)}


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else
            torch.tensor(np.asarray(v)) for k, v in tree.items()}


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return {p: a for k in sorted(tree)
                for p, a in _flat(tree[k], path + (k,)).items()}
    return {"/".join(path): np.asarray(
        tree.float() if isinstance(tree, torch.Tensor) else
        jnp.asarray(tree, jnp.float32))}


def _assert_trees_close(got, want, atol, rtol=0.0):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=rtol,
                                   err_msg=k)


CASES = {
    "adamw": dict(name="adamw"),
    "adamw-bf16": dict(name="adamw", state_dtype="bfloat16"),
    "adafactor": dict(name="adafactor"),
    "sgd": dict(name="sgd"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_optimizer_updates_match_jax(case):
    """Three updates of each optimizer, from the same params and grads
    (norm > 1, so clipping binds), against JAX's: params and state."""
    kw = dict(CASES[case], lr=1e-2, warmup=2, decay_steps=10)
    jo, to = jopt.Optimizer(jopt.OptConfig(**kw)), \
        topt.Optimizer(topt.OptConfig(**kw))
    jp = jax.tree.map(jnp.asarray, _tree(0))
    tp = _to_torch(_tree(0))
    js, ts = jo.init(jp), to.init(tp)
    tol = 2 ** -8 if case.endswith("bf16") else 1e-6
    for i in range(3):
        g = _tree(10 + i, scale=3.0)
        jp, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = to.update(_to_torch(g), ts, tp)
        _assert_trees_close(tp, jp, atol=1e-6, rtol=1e-6)
        _assert_trees_close(ts, js, atol=1e-6, rtol=tol)
    assert int(ts["count"]) == 3 and ts["count"].dtype == torch.int32


def test_lr_at_matches_jax_over_the_schedule():
    for kw in (dict(lr=3e-4, warmup=100, decay_steps=10_000),
               dict(lr=1e-2, warmup=5, decay_steps=20, min_lr_frac=0.2),
               dict(lr=1e-3, warmup=0, decay_steps=1)):
        jc, tc = jopt.OptConfig(**kw), topt.OptConfig(**kw)
        for step in (0, 1, 4, 5, 6, 12, 19, 20, 21, 100, 5_000, 20_000):
            np.testing.assert_allclose(topt.lr_at(tc, step),
                                       float(jopt.lr_at(jc, step)),
                                       rtol=1e-6)
        np.testing.assert_allclose(
            topt.lr_at(tc, torch.tensor(7, dtype=torch.int32)),
            float(jopt.lr_at(jc, jnp.int32(7))), rtol=1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 1e3], ids=["binds", "loose"])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = _tree(3, scale=2.0)
    jg, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g), max_norm)
    tg, tn = topt.clip_by_global_norm(_to_torch(g), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    _assert_trees_close(tg, jg, atol=1e-6, rtol=1e-6)


def _dense_models(**par):
    kw = dict(dict(param_dtype="float32", compute_dtype="float32",
                   q_block=8, kv_block=8), **par)
    japi = jax_build_model(jax_reduced(jax_get_config("qwen2-7b")),
                           JaxParallelConfig(**kw), make_local_mesh(1, 1))
    jparams = japi.init(jax.random.key(0))
    cfg = reduced(get_config("qwen2-7b"))
    api = build_model(cfg, ParallelConfig(**kw), device="cpu")
    params = params_from_jax_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                   device="cpu")
    return japi, jparams, api, params


@pytest.mark.parametrize("par", [dict(grad_accum=2),
                                 dict(grad_compress="int8_ef")],
                         ids=["grad_accum", "int8_ef"])
def test_three_train_steps_match_jax(par):
    japi, jparams, api, params = _dense_models(**par)
    # SGD: the step's mechanics under test move the parameters linearly in
    # the grads (Adam's sign-like steps turn the noise of a gradient that
    # is zero in exact arithmetic, such as a key bias's, into whole steps)
    ocfg = dict(name="sgd", lr=0.1, warmup=2, decay_steps=20)
    jo, to = jopt.Optimizer(jopt.OptConfig(**ocfg)), \
        topt.Optimizer(topt.OptConfig(**ocfg))
    jstate = {"params": jparams, "opt": jo.init(jparams),
              "step": jnp.zeros((), jnp.int32)}
    tstate = {"params": params, "opt": to.init(params),
              "step": torch.zeros((), dtype=torch.int32)}
    jstep = jax.jit(jax_make_train_step(japi, jo))
    tstep = make_train_step(api, to)
    src = tdata.TokenSource(tdata.DataConfig(seq_len=16, global_batch=4,
                                             vocab_size=api.cfg.vocab_size))
    for i in range(3):
        b = src.train_batch(i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tstep(tstate, {k: torch.as_tensor(v)
                                    for k, v in b.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
    assert int(tstate["step"]) == 3 and int(tstate["opt"]["count"]) == 3
    if "grad_compress" not in par:
        _assert_trees_close(tstate["params"], jstate["params"], atol=1e-6)
        assert "ef" not in tstate["opt"]
        return
    # int8: a gradient that agrees to ~1e-6 may still round to the other
    # side of a .5 boundary, one quantization level (2 x the largest
    # residual, which is at most half a level) apart. At most 0.1% of a
    # leaf's elements may do so, each by at most one level a step; every
    # other element within 1e-6 (params) / 1e-5 of the leaf's largest
    # |g| (= 127 levels; residuals carry the gradient's own error).
    jp, tp = _flat(jstate["params"]), _flat(tstate["params"])
    je, te = _flat(jstate["opt"]["ef"]), _flat(tstate["opt"]["ef"])
    assert set(te) == set(je) == set(tp)
    for k in je:
        level = 2 * float(np.abs(je[k]).max())
        dp, de = np.abs(tp[k] - jp[k]), np.abs(te[k] - je[k])
        assert (dp > 1e-6).mean() <= 1e-3 and dp.max() <= 3 * 0.1 * level \
            + 1e-6, k
        assert (de > 1e-5 * 127 * level).mean() <= 1e-3, k


def test_compress_grads_matches_jax():
    from repro.training.step import compress_grads as jcompress
    from repro_torch.training.step import compress_grads as tcompress
    g, e = _tree(4, scale=0.5), _tree(5, scale=0.01)
    jg, je = jcompress(jax.tree.map(jnp.asarray, g),
                       jax.tree.map(jnp.asarray, e))
    tg, te = tcompress(_to_torch(g), _to_torch(e))
    _assert_trees_close(tg, jg, atol=1e-7)
    _assert_trees_close(te, je, atol=1e-7)


@pytest.mark.parametrize("kind", ["synthetic", "memmap", "patches+frames"])
def test_token_source_batches_equal_jax(kind, tmp_path):
    kw = dict(seq_len=12, global_batch=3, vocab_size=97, seed=5)
    if kind == "memmap":
        path = tmp_path / "tokens.bin"
        np.random.default_rng(0).integers(0, 97, size=(200,)).astype(
            np.int32).tofile(path)
        kw["path"] = str(path)
    if kind == "patches+frames":
        kw.update(n_vision_tokens=2, d_model=8, n_frames=4)
    js = jdata.TokenSource(jdata.DataConfig(**kw))
    ts = tdata.TokenSource(tdata.DataConfig(**kw))
    for step in (0, 1, 7, 1000):
        jb, tb = js.train_batch(step), ts.train_batch(step)
        assert set(tb) == set(jb)
        for k in jb:
            assert tb[k].dtype == jb[k].dtype, k
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    loader = tdata.ShardedLoader(ts, torch.device("cpu"))
    step, batch = next(loader.iterate(7))
    assert step == 7
    np.testing.assert_array_equal(batch["tokens"].numpy(),
                                  ts.train_batch(7)["tokens"])
