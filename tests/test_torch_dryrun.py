"""The port's dry run (``repro_torch.launch.dryrun``) on reduced cells.

A subprocess (a process group is process-global) runs ``run_cell`` under
the ``"fake"`` backend for reduced qwen2-7b (dense, tp) and reduced
olmoe-1b-7b (8 experts top-2, capacity factor 8), train / prefill /
decode, on a (1, 1) and a (2, 4) mesh, and analyses the same calls on
real (zero) tensors on one device with ``op_analysis.analyze``. A second
subprocess with 8 forced host devices, as tests/test_sharding.py runs
JAX, gives JAX's HLO FLOPs of the same decode cells. Checks:

* every cell has the keys ``roofline.report`` and JAX's cells carry;
* collectives are counted on (2, 4) and none on (1, 1);
* on (1, 1) the traced FLOPs equal the plain call's analysis outside
  moe_gmm (whose rows in use a trace without data cannot know), and its
  bytes but for the plain attention's one copy a prefill layer;
* on (2, 4) each device's FLOPs are those of its local shards: an eighth
  of one device's at train and prefill (batch over 2, heads / sequence /
  experts over 4);
* the decode cells' FLOPs per device equal JAX's HLO count exactly (both
  count 2 M K N per product, and the same products on the same local
  shapes), on both meshes;
* ``benchmarks.roofline_bench.run`` reads the cells.
Collective bytes have no JAX oracle here (JAX's own collective count on
this mesh fails at the seed, tests/test_sharding.py).

A third subprocess runs the other families' reduced cells on the (2, 4)
mesh: mamba2-1.3b with no attention heads (the cp recipe of the full
config), recurrentgemma-9b with 5 layers, whisper-base with 2 heads over
model 4 and internvl2-1b with 6 (the cp recipe), train / prefill /
decode, and mamba2's and recurrentgemma's prefill at batch 1 (long_500k's
batch, which stays replicated over data). Each traces, shows collectives,
and at prefill charges ``ssd_scan`` / ``rglru_scan`` their
``roofline.work`` formula on the local shard's shape, once a recurrent
layer.
"""
import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("qwen2-7b", "olmoe-1b-7b")
KINDS = ("train", "prefill", "decode")
MESHES = {"1x1": {"data": 1, "model": 1}, "2x4": {"data": 2, "model": 4}}
OVERRIDES = {"param_dtype": "float32", "compute_dtype": "float32",
             "q_block": 8, "kv_block": 8}
B, S = 4, 32

PORT = r"""
import dataclasses, json, sys
import torch
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import MoEConfig, ShapeConfig
from repro_torch.launch import dryrun, inputs as I
from repro_torch.launch.recipes import parallel_for
from repro_torch.models.model import build_model
from repro_torch.roofline.op_analysis import analyze
from repro_torch.training.optimizer import OptConfig, Optimizer
from repro_torch.training.step import make_train_state, make_train_step
ARCHS, KINDS, MESHES, OV, B, S = json.loads(sys.argv[1])
torch.set_num_threads(1)
out = {"cells": {}, "plain": {}}
for arch in ARCHS:
    cfg = reduced(get_config(arch))
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=MoEConfig(
            n_experts=8, top_k=2, capacity_factor=8.0))
    for kind in KINDS:
        shape = ShapeConfig(f"tiny_{kind}", S, B, kind)
        for tag, mesh in MESHES.items():
            out["cells"][f"{arch} {kind} {tag}"] = dryrun.run_cell(
                arch, shape.name, False, OV, cfg=cfg, shape=shape, mesh=mesh)
        par = parallel_for(cfg, shape, False, **OV)
        api = build_model(cfg, par, "cpu")
        if kind == "train":
            opt = Optimizer(OptConfig(name=par.optimizer,
                                      state_dtype=par.opt_state_dtype))
            args = (make_train_state(api, opt),
                    I.materialize(I.batch_specs(api, shape), api))
            fn = make_train_step(api, opt)
        elif kind == "prefill":
            fn = api.prefill_fn
            args = (api.init(0), I.materialize(I.batch_specs(api, shape), api))
        else:
            fn = api.decode_fn
            args = (api.init(0), I.materialize(I.cache_specs(api, shape), api),
                    *I.materialize(I.decode_token_specs(api, shape), api))
        a = analyze(fn, *args)
        out["plain"][f"{arch} {kind}"] = {"flops": a["flops"],
                                          "bytes": a["bytes"],
                                          "kernels": a["kernels"]}
print("RESULT" + json.dumps(out))
"""

JAX = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json, sys
import jax
from jax.sharding import AxisType, NamedSharding
from repro.configs import get_config, reduced
from repro.configs.base import MoEConfig, ShapeConfig
from repro.launch import inputs as I
from repro.launch.recipes import parallel_for
from repro.models.model import build_model
from repro.roofline.hlo_analysis import analyze
ARCHS, MESHES, OV, B, S = json.loads(sys.argv[1])
out = {}
for arch in ARCHS:
    cfg = reduced(get_config(arch))
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=MoEConfig(
            n_experts=8, top_k=2, capacity_factor=8.0))
    shape = ShapeConfig("tiny_decode", S, B, "decode")
    for tag, m in MESHES.items():
        mesh = jax.make_mesh(tuple(m.values()), tuple(m),
                             axis_types=(AxisType.Auto,) * 2)
        api = build_model(cfg, parallel_for(cfg, shape, False, **OV), mesh)
        params = jax.tree.map(
            lambda s, sp: jax.ShapeDtypeStruct(
                s.shape, s.dtype, sharding=NamedSharding(mesh, sp)),
            api.param_shapes(), api.param_pspecs())
        with mesh:
            c = jax.jit(api.decode_fn).lower(
                params, I.cache_specs(api, shape),
                *I.decode_token_specs(api, shape)).compile()
        out[f"{arch} {tag}"] = analyze(c.as_text())["flops"]
print("RESULT" + json.dumps(out))
"""


FAMILIES = {"mamba2-1.3b": {"n_heads": 0, "vocab_size": 250},
            "recurrentgemma-9b": {"n_layers": 5},
            "whisper-base": {"n_heads": 2, "n_kv_heads": 2,
                             "n_encoder_frames": 6},
            "internvl2-1b": {"n_heads": 6, "vocab_size": 250}}
LONG = ("mamba2-1.3b", "recurrentgemma-9b")

FAMILY = r"""
import json, sys
import torch
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
FAMILIES, LONG, KINDS, OV, B, S = json.loads(sys.argv[1])
torch.set_num_threads(1)
mesh = {"data": 2, "model": 4}
out = {}
for arch, over in FAMILIES.items():
    cfg = reduced(get_config(arch), **over)
    shapes = [ShapeConfig(f"tiny_{k}", S, B, k) for k in KINDS]
    if arch in LONG:
        shapes.append(ShapeConfig("tiny_long", S, 1, "prefill"))
    for shape in shapes:
        out[f"{arch} {shape.name}"] = dryrun.run_cell(
            arch, shape.name, False, OV, cfg=cfg, shape=shape, mesh=mesh)
print("RESULT" + json.dumps(out))
"""


def _run(script, arg):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", script, json.dumps(arg)],
                          env=env, capture_output=True, text=True,
                          timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [x for x in proc.stdout.splitlines() if x.startswith("RESULT")][-1]
    return json.loads(line[len("RESULT"):])


@pytest.fixture(scope="module")
def port():
    return _run(PORT, [ARCHS, KINDS, MESHES, OVERRIDES, B, S])


@pytest.fixture(scope="module")
def families():
    return _run(FAMILY, [FAMILIES, LONG, KINDS, OVERRIDES, B, S])


@pytest.fixture(scope="module")
def jax_decode():
    return _run(JAX, [ARCHS, MESHES, OVERRIDES, B, S])


CELLS = [f"{a} {k} {m}" for a in ARCHS for k in KINDS for m in MESHES]
KEYS = ("arch", "shape", "mesh", "variant", "recipe", "n_params",
        "n_active_params", "chips", "tokens", "dtype", "lower_s",
        "flops_per_device", "bytes_per_device",
        "bytes_inner_loops_per_device", "collectives_per_device", "memory",
        "top_collectives", "top_bytes_ops")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_has_the_keys(port, cell):
    c = port["cells"][cell]
    assert all(k in c for k in KEYS), [k for k in KEYS if k not in c]
    assert set(c["collectives_per_device"]) == {"bytes_by_type", "counts",
                                                "total_bytes"}
    assert c["chips"] == (1 if cell.endswith("1x1") else 8)
    assert c["recipe"] == "tp"
    mem = c["memory"]
    assert mem["argument_size_bytes"] > 0 and mem["output_size_bytes"] > 0
    assert mem["temp_size_bytes"] > 0
    assert c["flops_per_device"] > 0 and c["bytes_per_device"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_collectives_are_counted_on_the_mesh(port, cell):
    coll = port["cells"][cell]["collectives_per_device"]
    if cell.endswith("1x1"):
        assert coll["total_bytes"] == 0
        return
    assert sum(coll["counts"].values()) > 0 and coll["total_bytes"] > 0
    if "olmoe" in cell and "decode" not in cell:
        assert coll["counts"]["all-to-all"] > 0     # the EP exchange
    if "decode" in cell:
        assert coll["counts"]["all-reduce"] > 0     # the softmax combine


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_one_device_trace_equals_the_plain_analysis(port, arch, kind):
    """The same FLOPs; the same bytes but for one copy a prefill layer: the
    plain attention (the CPU path of the kernel wrapper) returns a
    permuted view, which the output projection's reshape copies (read and
    written, f32), where the kernel, and the dry run's stand-in for it,
    returns a contiguous (B, S, Hq, D). moe_gmm's work depends on the
    rows in use, which a trace without data cannot know: the dry run
    charges every row of the capacity buffers, the plain call the rows
    its routing filled; outside the kernels the counts are equal."""
    cell = port["cells"][f"{arch} {kind} 1x1"]
    plain = port["plain"][f"{arch} {kind}"]
    none = {"calls": 0, "flops": 0, "bytes": 0}
    gmm = cell["kernels"].get("moe_gmm", none)
    gmm_plain = plain["kernels"].get("moe_gmm", none)
    assert gmm["calls"] == gmm_plain["calls"]
    assert gmm["flops"] >= gmm_plain["flops"]
    assert cell["flops_per_device"] - gmm["flops"] == \
        plain["flops"] - gmm_plain["flops"]
    copy = 2 * B * S * 4 * 16 * 4 * 2 if kind == "prefill" else 0
    assert (plain["bytes"] - gmm_plain["bytes"]) - \
        (cell["bytes_per_device"] - gmm["bytes"]) == copy


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", ARCHS)
def test_flops_per_device_are_the_local_shards(port, arch, kind):
    one = port["cells"][f"{arch} {kind} 1x1"]["flops_per_device"]
    eight = port["cells"][f"{arch} {kind} 2x4"]["flops_per_device"]
    assert eight * 8 == one


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_flops_equal_jax_hlo(port, jax_decode, arch, mesh):
    got = port["cells"][f"{arch} decode {mesh}"]["flops_per_device"]
    assert got == jax_decode[f"{arch} {mesh}"]


def test_roofline_bench_reads_the_cells(port, tmp_path):
    from repro_torch.benchmarks import roofline_bench
    from repro_torch.roofline.report import markdown_table
    for name, cell in port["cells"].items():
        with open(tmp_path / (name.replace(" ", "_") + ".json"), "w") as f:
            json.dump(cell, f)
    with open(tmp_path / "skipped.json", "w") as f:
        json.dump({"x|y": "a skip list"}, f)
    rows = roofline_bench.run(str(tmp_path))
    assert len(rows) == len(CELLS)
    assert all(r["bound_s"] > 0 for r in rows)
    assert "(no dry-run cells found)" not in markdown_table(rows)


def test_a_second_cell_in_one_process_raises_while_a_group_lives():
    from repro_torch.launch import dryrun
    import torch.distributed as dist
    if dist.is_initialized():
        pytest.skip("a process group is already initialized here")
    dryrun.init_fake_group(2)
    try:
        with pytest.raises(RuntimeError, match="process of its own"):
            dryrun.init_fake_group(2)
    finally:
        dist.destroy_process_group()


FAMILY_CELLS = [f"{a} tiny_{k}" for a in FAMILIES for k in KINDS] + \
    [f"{a} tiny_long" for a in LONG]


@pytest.mark.parametrize("cell", FAMILY_CELLS)
def test_family_cells_trace_with_collectives(families, cell):
    c = families[cell]
    assert all(k in c for k in KEYS), [k for k in KEYS if k not in c]
    assert c["chips"] == 8 and c["flops_per_device"] > 0
    coll = c["collectives_per_device"]
    assert sum(coll["counts"].values()) > 0 and coll["total_bytes"] > 0


@pytest.mark.parametrize("cell", [c for c in FAMILY_CELLS
                                  if c.split()[0] in LONG and
                                  not c.endswith(("train", "decode"))])
def test_scans_are_charged_on_the_local_shard(families, cell):
    """The scan wrappers take each device's shard under ``shard_map``:
    the batch over data (2, unless the batch is 1), the heads or lru
    channels over model (4); one call a recurrent layer."""
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.roofline.work import rglru_work, ssd_work
    arch = cell.split()[0]
    cfg = reduced(get_config(arch), **FAMILIES[arch])
    b = 1 if cell.endswith("long") else B // 2
    if cfg.family == "ssm":
        s = cfg.ssm
        H = s.n_heads(cfg.d_model)
        name, n = "ssd_scan", cfg.n_layers
        ops, nbytes = ssd_work(b, S, H // 4, s.head_dim, s.state_dim,
                               s.chunk, torch.float32)
    else:
        plen = len(cfg.rglru.pattern)
        name = "rglru_scan"
        n = cfg.n_layers - cfg.n_layers // plen
        ops, nbytes = rglru_work(b, S, cfg.d_model // 4, False,
                                 torch.float32)
    assert families[cell]["kernels"][name] == {
        "calls": n, "flops": n * ops, "bytes": n * nbytes}
