"""The port's logical-axis rules (``repro_torch.sharding.partition``)
against the JAX package's (``repro.sharding.partition``).

JAX's ``make_rules`` and ``Rules`` read only ``mesh.shape``, so both
packages are built on a stub whose ``shape`` is the production mesh's
{"data": 16, "model": 16} (with "pod": 2 for the multi-pod mesh): no 256
devices are needed. For every arch x shape x mesh, every parameter
leaf's ``PartitionSpec`` (``api.param_pspecs()``) and the activation
rules must agree entry for entry; the placements must say what the spec
says; ``constrain`` leaves a plain tensor alone.
"""
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCH_IDS, SHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_shape as jax_get_shape  # noqa: E402
from repro.launch.recipes import parallel_for as jax_parallel_for  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.sharding import partition as jpart  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro_torch.configs import get_config, get_shape  # noqa: E402
from repro_torch.launch.mesh import production_shape  # noqa: E402
from repro_torch.launch.recipes import parallel_for  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.sharding import partition as tpart  # noqa: E402

MESHES = {"16x16": False, "pod2x16x16": True}
# every logical tuple the models constrain or lay inputs out by, with a
# shape at the production batch, sequence and widths
ACT_CASES = [
    (("batch", None), (256, 4096)),
    (("batch",), (128,)),
    (("batch", "seq", None), (256, 4096, 3584)),
    (("batch", None, None), (32, 32768, 8192)),
    (("batch", None, "heads"), (256, 4096, 3584)),
    (("batch", None, "mlp"), (256, 4096, 18944)),
    (("batch", None, "vocab"), (256, 4096, 152064)),
    (("batch", None, "heads", None), (256, 4096, 28, 128)),
    (("batch", "kv_seq", None, None), (128, 32768, 4, 128)),
    ((None, "batch", "kv_seq", None, None), (28, 128, 32768, 4, 128)),
    (("batch", None, "ssm_heads", None), (256, 4096, 64, 64)),
    ((None, "batch", None, "ssm_inner"), (48, 128, 3, 4096)),
    (("batch", None, "lru"), (256, 4096, 4096)),
    ((None, "batch", "lru"), (12, 128, 4096)),
    (("batch", "seq", "experts"), (256, 4096, 64)),
    (("batch", "seq", None), (1, 1, 8)),            # the divisibility fallback
]


class StubMesh:
    """What JAX's rules read of a mesh: its ``shape``."""

    def __init__(self, shape):
        self.shape = dict(shape)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _pair(arch, shape_id, multi_pod):
    shape = production_shape(multi_pod)
    japi = jax_build_model(
        jax_get_config(arch),
        jax_parallel_for(jax_get_config(arch), jax_get_shape(shape_id),
                         multi_pod),
        StubMesh(shape))
    api = build_model(
        get_config(arch),
        parallel_for(get_config(arch), get_shape(shape_id), multi_pod),
        "cpu", mesh=dict(shape))
    return japi, api


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape_id", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rules_equal_jax(arch, shape_id, mesh):
    japi, api = _pair(arch, shape_id, MESHES[mesh])
    assert api.recipe == japi.recipe
    assert api.cfg.n_heads == japi.cfg.n_heads
    want = dict(_leaves(japi.param_pspecs()))
    got = dict(_leaves(api.param_pspecs()))
    assert set(got) == set(want)
    for path, spec in want.items():
        assert got[path] == tuple(spec), path
    assert api.rules_p.table == japi.rules_p.table
    assert api.rules_a.table == japi.rules_a.table
    for logical, shp in ACT_CASES:
        assert api.rules_a.spec(logical, shp) == tuple(
            japi.rules_a.spec(logical, shp)), logical
        assert api.rules_a.spec(logical) == tuple(
            japi.rules_a.spec(logical)), logical


def _check_placements(rules, logical, shape):
    spec = rules.spec(logical, shape)
    pl = rules.placements(logical, shape)
    assert len(pl) == len(rules.shape)
    for axis, p in zip(rules.shape, pl):
        dims = [d for d, a in enumerate(spec)
                if a == axis or (isinstance(a, tuple) and axis in a)]
        assert len(dims) <= 1
        if dims:
            assert p == Shard(dims[0])
        else:
            assert p == Replicate()
    local = rules.local_shape(logical, shape)
    for d, (n, m) in enumerate(zip(shape, local)):
        k = 1
        for axis, p in zip(rules.shape, pl):
            if p == Shard(d):
                k *= rules.shape[axis]
        assert n == m * k


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_placements_agree_with_spec(arch, mesh):
    _, api = _pair(arch, "train_4k", MESHES[mesh])
    for path, d in _leaves(api.defs):
        _check_placements(api.rules_p, d.logical, d.shape)
    for logical, shp in ACT_CASES:
        _check_placements(api.rules_a, logical, shp)


def test_spec_conflicts_and_fallbacks_equal_jax():
    """A mesh axis claimed twice goes to the first claim; a dim that the
    axes do not divide takes the longest dividing prefix of its axes."""
    mesh = {"pod": 2, "data": 16, "model": 16}
    table = {"a": ("pod", "data"), "b": "data", "c": "model",
             "d": ("model", "data")}
    jr = jpart.Rules(table, StubMesh(mesh))
    tr = tpart.Rules(table, mesh)
    cases = [(("a", "b", "c"), (64, 32, 32)),
             (("a", "c"), (6, 32)),          # 6: the pod prefix only
             (("a", "c"), (3, 32)),          # 3: replicated
             (("d", "b"), (48, 32)),         # model divides, data does not
             (("c", "d"), (32, 32)),         # model taken: d keeps data
             ((None, "b", None), (4, 16, 8))]
    for logical, shape in cases:
        assert tr.spec(logical, shape) == tuple(jr.spec(logical, shape))
        assert tr.spec(logical) == tuple(jr.spec(logical))


def test_constrain_returns_a_plain_tensor_unchanged():
    _, api = _pair("qwen2-7b", "train_4k", False)
    x = torch.randn(4, 8, 16)
    assert tpart.constrain(x, api.rules_a, ("batch", "seq", None)) is x
    assert tpart.constrain(x, None, ("batch", None, None)) is x


def test_tree_specs_and_param_logical():
    _, api = _pair("olmoe-1b-7b", "train_4k", False)
    logical = L.param_logical(api.defs)
    shapes = L.param_shapes(api.defs)
    specs = tpart.tree_specs(logical, api.rules_p, shapes)
    assert specs == api.param_pspecs()
    assert tpart.mesh_shape(StubMesh({"data": 2, "model": 4})) == \
        {"data": 2, "model": 4}


def test_implicit_replication_is_scoped_and_nests():
    """``spmd.implicit_replication`` holds only inside its block: a nested
    use keeps the outer setting, and the previous one comes back on exit
    (an exception included)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.sharding import spmd
    disp = DTensor._op_dispatcher
    assert disp._allow_implicit_replication is False
    with spmd.implicit_replication():
        assert disp._allow_implicit_replication is True
        with spmd.implicit_replication(False):
            assert disp._allow_implicit_replication is True
        assert disp._allow_implicit_replication is True
    assert disp._allow_implicit_replication is False
    with pytest.raises(RuntimeError):
        with spmd.implicit_replication():
            raise RuntimeError("inside")
    assert disp._allow_implicit_replication is False
    with spmd.implicit_replication(False):
        assert disp._allow_implicit_replication is False
