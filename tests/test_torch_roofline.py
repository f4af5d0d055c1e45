"""The port's cost analysis and roofline (``repro_torch.roofline``):
exact FLOPs of hand-countable callables, bytes against their operands and
output, no collectives on one device, each kernel wrapper's plain path
charged its kernel's formula (the plain ops' bytes in
``bytes_inner_loops``), the work formulas, the H100 roofline terms of a
hand-built cell, and a tiny f32 qwen2's decode and prefill FLOPs against
JAX's HLO analysis of the jitted functions (within 1%).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.roofline.hlo_analysis import analyze as jax_analyze  # noqa: E402

from repro_torch.benchmarks import roofline_bench  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.moe_gmm import ops as gmm  # noqa: E402
from repro_torch.kernels.rglru_scan import ops as rg  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd  # noqa: E402
from repro_torch.roofline import report, work  # noqa: E402
from repro_torch.roofline.op_analysis import COLLECTIVES, analyze  # noqa: E402

from test_torch_model import jax_and_port_lm  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {"flops", "bytes", "bytes_inner_loops", "collective_bytes",
        "collective_counts", "collective_total", "top_collectives",
        "top_bytes_ops"}


def f32(*shape, seed=0):
    return torch.as_tensor(np.random.default_rng(seed).normal(
        size=shape).astype(np.float32))


def test_single_matmul_flops_exact_and_bytes_bound():
    m, k, n = 128, 256, 512
    r = analyze(torch.matmul, f32(m, k), f32(k, n, seed=1))
    assert KEYS <= set(r)
    assert r["flops"] == 2 * m * k * n
    assert r["bytes"] >= (m * k + k * n + m * n) * 4
    assert r["bytes_inner_loops"] == 0


def test_loop_of_seven_matmuls_multiplies():
    m, L = 64, 7

    def looped(x, ws):
        for w in ws:
            x = x @ w
        return x
    r = analyze(looped, f32(m, m), f32(L, m, m, seed=1))
    assert r["flops"] == L * 2 * m ** 3
    assert r["bytes"] >= L * 3 * m * m * 4


@pytest.mark.parametrize("B,M,K,N", [(3, 4, 5, 6), (8, 16, 32, 8)])
def test_bmm_and_linear_flops_exact(B, M, K, N):
    r = analyze(torch.bmm, f32(B, M, K), f32(B, K, N, seed=1))
    assert r["flops"] == 2 * B * M * K * N
    assert r["bytes"] >= (B * M * K + B * K * N + B * M * N) * 4
    lin = torch.nn.Linear(K, N)
    with torch.no_grad():
        r = analyze(lin, f32(B, M, K))
    assert r["flops"] == 2 * B * M * K * N


def test_conv_flops_exact():
    """2 x outputs x (C_in x kh x kw), as DAVE-2's convolutions count."""
    x, w = f32(2, 3, 66, 200), f32(24, 3, 5, 5, seed=1)
    r = analyze(torch.nn.functional.conv2d, x, w, stride=2)
    Ho, Wo = (66 - 5) // 2 + 1, (200 - 5) // 2 + 1
    assert r["flops"] == 2 * (2 * 24 * Ho * Wo) * (3 * 5 * 5)
    assert r["bytes"] >= (x.numel() + w.numel() + 2 * 24 * Ho * Wo) * 4


def test_no_collectives_on_one_device():
    r = analyze(lambda a: (a @ a).sum(), f32(64, 64))
    assert r["collective_total"] == 0
    assert set(r["collective_bytes"]) == set(COLLECTIVES)
    assert not any(r["collective_counts"].values())
    assert r["top_collectives"] == []


def test_functional_collectives_are_counted(tmp_path):
    """c10d's functional collectives in a one-process gloo group: the
    output bytes of each, under JAX's kind names."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        def step(x):
            y = fc.all_reduce(x, "sum", dist.group.WORLD) + 1
            z = fc.reduce_scatter_tensor(x, "sum", 0, dist.group.WORLD) + 1
            return y, z
        r = analyze(step, f32(64, 32))
    finally:
        dist.destroy_process_group()
    assert r["collective_bytes"]["all-reduce"] == 64 * 32 * 4
    assert r["collective_bytes"]["reduce-scatter"] == 64 * 32 * 4
    assert r["collective_counts"]["all-reduce"] == 1
    assert r["collective_total"] == 2 * 64 * 32 * 4
    assert {t["kind"] for t in r["top_collectives"]} == {
        "_c10d_functional.all_reduce.default",
        "_c10d_functional.reduce_scatter_tensor.default"}


def test_views_and_gathers_move_only_what_they_touch():
    table = f32(1000, 64)
    idx = torch.tensor([[3, 7]])
    r = analyze(lambda t, i: t[i].transpose(-1, -2), table, idx)
    # the two rows read and written, and the indices: not the table
    assert r["bytes"] == 2 * 2 * 64 * 4 + idx.numel() * 8
    buf = torch.zeros(4, 100, 8)

    def write(b, v):
        b[:, torch.tensor([5])] = v
    r = analyze(write, buf, f32(4, 1, 8))
    assert r["bytes"] < buf.numel() * 4


def test_launch_counters_do_not_move():
    for m in (fa, gmm, ssd, rg):
        m.launches = 5
    q, k = f32(1, 8, 2, 16), f32(1, 8, 2, 16, seed=1)
    analyze(fa.flash_attention, q, k, k)
    assert [m.launches for m in (fa, gmm, ssd, rg)] == [5] * 4
    for m in (fa, gmm, ssd, rg):
        m.reset_launches()


def test_a_raising_wrapper_raises_through_the_analysis():
    q = f32(1, 8, 2, 16)
    with pytest.raises(RuntimeError):
        analyze(fa.flash_attention, q, f32(1, 8, 3, 16), f32(1, 8, 3, 16))
    assert work.current() is None


def _check_charged(r, name, formula):
    ops, nbytes = formula
    assert r["kernels"] == {name: {"calls": 1, "flops": ops,
                                   "bytes": nbytes}}
    assert r["flops"] == ops and r["bytes"] == nbytes
    assert r["bytes_inner_loops"] > 0      # the plain version's ops


def test_nested_analyses_keep_the_outer_patch():
    """An analysis inside another restores the outer one's shape-only
    propagation on its way out, and the outer removes its own."""
    from torch.distributed.tensor import DTensor
    prop = DTensor._op_dispatcher.sharding_propagator
    name = "_propagate_tensor_meta_non_cached"
    seen = []

    def outer():
        mine = vars(prop)[name]
        inner = analyze(torch.matmul, f32(4, 8), f32(8, 2, seed=1))
        seen.append(vars(prop).get(name) is mine)
        return inner

    r = analyze(outer)
    assert seen == [True]
    assert name not in vars(prop)
    assert r["flops"] == 2 * 4 * 8 * 2


@pytest.mark.parametrize("Sq,Sk,Hq,Hkv,causal,window", [
    (16, 16, 4, 2, True, 0), (12, 20, 4, 4, False, 0),
    (24, 24, 2, 1, True, 8)])
def test_flash_plain_path_is_charged_its_formula(Sq, Sk, Hq, Hkv, causal,
                                                 window):
    q, k, v = f32(2, Sq, Hq, 16), f32(2, Sk, Hkv, 16, seed=1), \
        f32(2, Sk, Hkv, 16, seed=2)
    r = analyze(fa.flash_attention, q, k, v, causal=causal, window=window)
    _check_charged(r, "flash_attention", work.flash_work(
        (2, Sq, Sk, Hq, Hkv, 16, causal, window, torch.float32)))
    assert r["flops"] == 4 * 2 * Hq * 16 * work.unmasked_pairs(
        Sq, Sk, causal, window)


def test_gmm_plain_path_is_charged_its_formula():
    E, C, D, F = 4, 8, 16, 12
    counts = torch.tensor([8, 0, 3, 5], dtype=torch.int32)
    x, w = f32(E, C, D), f32(E, D, F, seed=1)
    r = analyze(gmm.grouped_matmul, x, w, counts)
    _check_charged(r, "moe_gmm",
                   work.gmm_work(E, C, D, F, counts, torch.float32))
    assert r["flops"] == 2 * 16 * D * F


def test_ssd_plain_path_is_charged_its_formula():
    B, S, H, P, N = 1, 20, 2, 4, 8
    xh, dt = f32(B, S, H, P), torch.nn.functional.softplus(f32(B, S, H, 1))
    Bm, Cm = f32(B, S, N, seed=2), f32(B, S, N, seed=3)
    A = -torch.exp(f32(H, seed=4))
    r = analyze(ssd.ssd_scan, xh, dt[..., 0], Bm, Cm, A, chunk=8)
    _check_charged(r, "ssd_scan",
                   work.ssd_work(B, S, H, P, N, 8, torch.float32))


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_plain_path_is_charged_its_formula(with_h0):
    B, S, C = 2, 9, 16
    log_a, gx = -f32(B, S, C).abs(), f32(B, S, C, seed=1)
    h0 = f32(B, C, seed=2) if with_h0 else None
    r = analyze(rg.rglru_scan, log_a, gx, h0)
    _check_charged(r, "rglru_scan",
                   work.rglru_work(B, S, C, with_h0, torch.float32))
    assert r["flops"] == 3 * B * S * C


@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (1, 1, True, 0), (7, 7, True, 0), (5, 9, True, 0), (9, 5, True, 0),
    (9, 5, False, 0), (16, 16, True, 4), (16, 16, False, 4),
    (300, 1500, False, 0), (33, 33, True, 64)])
def test_unmasked_pairs_equal_the_mask(Sq, Sk, causal, window):
    q, k = np.arange(Sq)[:, None], np.arange(Sk)[None, :]
    mask = np.ones((Sq, Sk), bool)
    if causal:
        mask &= k <= q
    if window > 0:
        mask &= k > q - window
    assert work.unmasked_pairs(Sq, Sk, causal, window) == int(mask.sum())


def test_roofline_row_of_a_hand_built_cell():
    cell = {"arch": "x", "shape": "decode", "mesh": "1", "chips": 2,
            "tokens": 8, "dtype": "bfloat16", "n_params": 1e9,
            "flops_per_device": 989e9, "bytes_per_device": 6.7e9,
            "bytes_inner_loops_per_device": 3.35e9,
            "collectives_per_device": {
                "total_bytes": 90e6, "bytes_by_type": {"all-reduce": 45e6}},
            "memory": {"argument_size_bytes": 2**31}}
    r = report.roofline_row(cell)
    assert r["compute_s"] == pytest.approx(1e-3)
    assert r["memory_s_kernel"] == pytest.approx(2e-3)
    assert r["memory_s"] == pytest.approx(3e-3)
    assert r["collective_s"] == pytest.approx(135e6 / 450e9)
    assert r["dominant"] == "memory" and r["bound_s"] == pytest.approx(2e-3)
    assert r["model_flops_per_dev"] == pytest.approx(2 * 1e9 * 8 / 2)
    assert r["roofline_fraction"] == pytest.approx(8e9 / 989e12 / 2e-3)
    assert r["mem_args_gb"] == pytest.approx(2.0)
    # f32 cells are held to the f32 peak without tensor cores
    r32 = report.roofline_row(dict(cell, dtype="float32"))
    assert r32["compute_s"] == pytest.approx(989e9 / 67e12)
    assert "| x | decode |" in report.markdown_table([r])


def test_cell_from_an_analysis_and_the_bench_without_cells(tmp_path):
    res = analyze(torch.matmul, f32(64, 32), f32(32, 16, seed=1))
    c = report.cell("mm", "decode", res, dtype="float32", tokens=64,
                    n_params=32 * 16)
    r = report.roofline_row(c)
    assert r["compute_s"] == pytest.approx(2 * 64 * 32 * 16 / 67e12)
    assert r["useful_flops_ratio"] == pytest.approx(1.0)
    assert roofline_bench.run(str(tmp_path)) == []
    (tmp_path / "skipped.json").write_text("{}")
    assert roofline_bench.run(str(tmp_path)) == []
    assert report.markdown_table([]) == "(no dry-run cells found)"


def test_check_script_and_bench_run_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run(
        [sys.executable, "scripts/torch_check_op_analysis.py", "--device",
         "cpu"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.count(" ok True") == 3


@pytest.fixture(scope="module")
def lm():
    return jax_and_port_lm()


def test_tiny_qwen2_decode_flops_equal_jax(lm):
    japi, jparams, api, params = lm
    cfg = api.cfg
    B, max_seq = 2, 32
    shape = (cfg.n_layers, B, max_seq, cfg.n_kv_heads, cfg.head_dim)
    tok, pos = np.array([[3], [5]]), np.array([12, 7])
    jr = jax_analyze(jax.jit(japi.decode_fn).lower(
        jparams, {n: jnp.zeros(shape) for n in ("k", "v")},
        jnp.asarray(tok, jnp.int32), jnp.asarray(pos, jnp.int32)
    ).compile().as_text())
    with torch.no_grad():
        r = analyze(api.decode_fn, params,
                    {n: torch.zeros(shape) for n in ("k", "v")},
                    torch.as_tensor(tok), torch.as_tensor(pos))
    assert r["flops"] == pytest.approx(jr["flops"], rel=0.01)
    assert r["kernels"] == {}
    assert r["collective_total"] == 0


@pytest.mark.parametrize("S", [12, 40])
def test_tiny_qwen2_prefill_flops_equal_jax(lm, S):
    """JAX's prefill attention at these lengths is the materialized
    masked product (``layers.masked_attention``), whose HLO counts all
    Sq x Sk pairs; the flash kernel computes only the causal ones, and
    the analysis charges only those. The masked pairs' 4 Hq D each are
    taken off JAX's count; the rest must agree within 1%."""
    japi, jparams, api, params = lm
    cfg = api.cfg
    B = 2
    tokens = np.random.default_rng(1).integers(1, 256, size=(B, S))
    jr = jax_analyze(jax.jit(japi.prefill_fn).lower(
        jparams, {"tokens": jnp.asarray(tokens, jnp.int32)}
    ).compile().as_text())
    with torch.no_grad():
        r = analyze(api.prefill_fn, params,
                    {"tokens": torch.as_tensor(tokens)})
    masked = cfg.n_layers * 4 * B * cfg.n_heads * cfg.head_dim * (
        S * S - work.unmasked_pairs(S, S, True, 0))
    assert r["flops"] == pytest.approx(jr["flops"] - masked, rel=0.01)
    assert r["kernels"]["flash_attention"]["calls"] == cfg.n_layers
    assert r["bytes_inner_loops"] > 0
