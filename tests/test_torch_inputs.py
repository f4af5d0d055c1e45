"""The port's input and cache stand-ins (``repro_torch.launch.inputs``)
against the JAX package's ``ShapeDtypeStruct`` trees
(``repro.launch.inputs``) for every architecture at every shape.

JAX is built on ``jax.make_mesh((1, 1), ...)`` (its stand-ins need a real
mesh); the port on the production mesh's axis sizes, so that the
placements are not all trivial. Shapes and dtypes must equal JAX's leaf
for leaf, and each leaf's placements must be ``Rules.placements`` of its
logical names, its local shape the global one divided by them.
"""
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS, SHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_shape as jax_get_shape  # noqa: E402
from repro.launch import inputs as JI  # noqa: E402
from repro.launch.recipes import parallel_for as jax_parallel_for  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402

from repro_torch.configs import get_config, get_shape  # noqa: E402
from repro_torch.launch import inputs as TI  # noqa: E402
from repro_torch.launch.mesh import production_shape  # noqa: E402
from repro_torch.launch.recipes import parallel_for  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

DT = {jnp.dtype(jnp.bfloat16): torch.bfloat16,
      jnp.dtype(jnp.float32): torch.float32,
      jnp.dtype(jnp.int32): torch.int32}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, tuple) and not isinstance(tree, TI.TensorSpec):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield "/".join(path), tree


def _apis(arch, shape_id):
    cfg, shape = jax_get_config(arch), jax_get_shape(shape_id)
    japi = jax_build_model(cfg, jax_parallel_for(cfg, shape, False),
                           jax.make_mesh((1, 1), ("data", "model")))
    tcfg, tshape = get_config(arch), get_shape(shape_id)
    api = build_model(tcfg, parallel_for(tcfg, tshape, False), "cpu",
                      mesh=production_shape(False))
    return japi, api, shape, tshape


def _compare(api, got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert set(got) == set(want)
    for path, w in want.items():
        g = got[path]
        assert g.shape == tuple(w.shape), path
        assert g.dtype == DT[jnp.dtype(w.dtype)], path
        assert g.placements == api.rules_a.placements(g.logical, g.shape)
        assert g.local_shape == api.rules_a.local_shape(g.logical, g.shape)


@pytest.mark.parametrize("shape_id", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_jax(arch, shape_id):
    japi, api, shape, tshape = _apis(arch, shape_id)
    _compare(api, TI.cache_specs(api, tshape), JI.cache_specs(japi, shape))
    _compare(api, TI.decode_token_specs(api, tshape),
             JI.decode_token_specs(japi, shape))
    if shape.kind != "decode":
        _compare(api, TI.batch_specs(api, tshape),
                 JI.batch_specs(japi, shape))


def test_materialize_on_one_device_is_plain_zeros():
    from repro_torch.configs import reduced
    from repro_torch.configs.base import ParallelConfig, ShapeConfig
    cfg = reduced(get_config("qwen2-7b"))
    api = build_model(cfg, ParallelConfig(), "cpu")
    shape = ShapeConfig("tiny", 16, 2, "decode")
    caches = TI.materialize(TI.cache_specs(api, shape), api)
    tok, pos = TI.materialize(TI.decode_token_specs(api, shape), api)
    assert caches["k"].shape == (cfg.n_layers, 2, 16, cfg.n_kv_heads,
                                 cfg.head_dim)
    assert not caches["k"].any() and tok.shape == (2, 1) and \
        pos.dtype == torch.int32
