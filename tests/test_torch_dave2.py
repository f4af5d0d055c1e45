"""PyTorch port vs the JAX package: DAVE-2 (the paper's control-loop DNN)
and the benchmarks and example that run it on the gang executor, on the CPU.

The parameters are not JAX's init: that init gives zero biases and, with
fan_in = c_in for an HWIO weight, conv pre-activations of std ≈ k, which
saturate tanh and would hide a dropped bias or a flipped kernel. So both
sides get the same numpy draw: conv weights at std 1/sqrt(k·k·c_in), fc
weights at std 1/sqrt(in), biases nonzero. Images are random (with an
all-ones image every VALID map is spatially constant and an (h, w) mix-up
cannot show).

Tolerance (f32 on both sides, sums in another order): atol = rtol = 1e-5.
The benchmarks' tests check structure only, never latency.
"""
import contextlib
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.deeppicar import Dave2Config as JaxDave2Config  # noqa: E402
from repro.models import dave2 as jdave2  # noqa: E402

from repro_torch.benchmarks import fig1_parallelization as fig1  # noqa: E402
from repro_torch.benchmarks import fig6_dnn_cdf as fig6  # noqa: E402
from repro_torch.configs.deeppicar import CONFIG, Dave2Config  # noqa: E402
from repro_torch.convert import dave2_params_from_jax_numpy  # noqa: E402
from repro_torch.device import Lanes  # noqa: E402
from repro_torch.examples import deeppicar_gang  # noqa: E402
from repro_torch.models import dave2  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
JCFG = JaxDave2Config()


def numpy_params(seed=0):
    """JAX-layout DAVE-2 parameters at a scale that keeps tanh unsaturated,
    with nonzero biases."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, d in jdave2.dave2_defs(JCFG).items():
        if k.endswith("_b"):
            out[k] = rng.normal(0.0, 0.1, d.shape).astype(np.float32)
        else:
            fan_in = int(np.prod(d.shape[:-1]))
            out[k] = (rng.normal(0.0, 1.0, d.shape) /
                      np.sqrt(fan_in)).astype(np.float32)
    return out


def images(b, seed=1):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 1.0, (b, *CONFIG.input_hw, 3)).astype(np.float32)


def test_config_is_jax_config():
    assert Dave2Config() == CONFIG
    for f in ("name", "input_hw", "in_channels", "conv", "fc", "n_outputs"):
        assert getattr(CONFIG, f) == getattr(JCFG, f)


def test_defs_match_jax():
    jdefs, defs = jdave2.dave2_defs(JCFG), dave2.dave2_defs(CONFIG)
    assert list(defs) == list(jdefs)
    for k in jdefs:
        assert defs[k].shape == jdefs[k].shape, k
        assert defs[k].init == jdefs[k].init, k
    assert defs["fc0_w"].shape == (1 * 18 * 64, 100)
    n = sum(int(np.prod(d.shape)) for d in defs.values())
    assert 250_000 < n < 254_000, n


@pytest.mark.parametrize("b", [1, 3])
def test_apply_matches_jax(b):
    tree, x = numpy_params(), images(b)
    want = np.asarray(jdave2.dave2_apply(
        JCFG, {k: jnp.asarray(v) for k, v in tree.items()}, jnp.asarray(x)))
    params = dave2_params_from_jax_numpy(tree, CONFIG, device="cpu")
    got = dave2.dave2_apply(CONFIG, params, torch.from_numpy(x))
    assert got.shape == (b, 1)
    assert float(np.abs(want).max()) > 0.05       # not a saturated constant
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_features_flatten_order_matches_jax():
    """The map fc0 reads equals JAX's element for element, in order: an
    NCHW flatten would permute the 1152 entries."""
    tree, x = numpy_params(), images(2, seed=3)
    y = jnp.asarray(x)
    for i, (_, _, s) in enumerate(JCFG.conv):
        y = jax.lax.conv_general_dilated(
            y, jnp.asarray(tree[f"conv{i}_w"]), window_strides=(s, s),
            padding="VALID", dimension_numbers=("NHWC", "HWIO", "NHWC"))
        y = jnp.tanh(y + tree[f"conv{i}_b"])
    want = np.asarray(y.reshape(y.shape[0], -1))
    params = dave2_params_from_jax_numpy(tree, CONFIG, device="cpu")
    got = dave2.dave2_features(CONFIG, params, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 1152)
    np.testing.assert_allclose(got, want, **TOL)


def test_converter_layout():
    tree = numpy_params()
    params = dave2_params_from_jax_numpy(tree, CONFIG, device="cpu")
    for k, a in tree.items():
        t = params[k]
        if a.ndim == 4:
            assert t.is_contiguous()
            np.testing.assert_array_equal(t.numpy(), a.transpose(3, 2, 0, 1))
        else:
            np.testing.assert_array_equal(t.numpy(), a)


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_converter_raises(fault):
    tree = numpy_params()
    if fault == "missing":
        del tree["conv2_b"]
    elif fault == "extra":
        tree["fc9_w"] = np.zeros((2, 2), np.float32)
    else:
        tree["fc0_w"] = tree["fc0_w"].T
    with pytest.raises(ValueError, match="keys|shape"):
        dave2_params_from_jax_numpy(tree, CONFIG, device="cpu")


def test_make_dave2_uses_jax_init_rule():
    gen = torch.Generator().manual_seed(5)
    params, model = dave2.make_dave2(CONFIG, device="cpu", generator=gen)
    again, _ = dave2.make_dave2(CONFIG, device="cpu",
                                generator=torch.Generator().manual_seed(5))
    defs = dave2.dave2_defs(CONFIG)
    for k, d in defs.items():
        assert torch.equal(params[k], again[k]), k
        if d.init == "zeros":
            assert not params[k].any(), k
        shape = d.shape if params[k].dim() < 4 else \
            tuple(d.shape[j] for j in (3, 2, 0, 1))
        assert tuple(params[k].shape) == shape, k
    std = float(params["fc0_w"].std())           # 1/sqrt(shape[-2] = 1152)
    assert abs(std * np.sqrt(1152) - 1.0) < 0.05, std
    x = torch.from_numpy(images(2))
    out = model(x)
    assert out.shape == (2, 1) and torch.isfinite(out).all()
    torch.testing.assert_close(out, dave2.dave2_apply(CONFIG, params, x),
                               rtol=0, atol=0)
    assert model.params["conv0_w"].data_ptr() == params["conv0_w"].data_ptr()


def test_lanes_quantum_keeps_the_error():
    errors = []

    def bad(lane, idx):
        raise ValueError(f"lane {lane} job {idx}")

    q = Lanes(torch.device("cpu"), 2).quantum(bad, errors)
    with pytest.raises(ValueError):
        q(1, 7)
    assert len(errors) == 1 and str(errors[0]) == "lane 1 job 7"


def test_fig6_run_on_cpu():
    rows = fig6.run(duration=0.5, device="cpu")
    assert set(rows) == {"solo", "cosched", "rtgang"}
    assert rows["solo"]["n"] == 100
    for mode in ("cosched", "rtgang"):
        r = rows[mode]
        assert r["n"] > 0, mode
        assert set(r["be_quanta"]) == {"lbm_mem", "cutcp_cpu"}
        assert r["p50_ms"] <= r["p99_ms"] <= r["max_ms"]
        assert "dev_p50_ms" not in r                  # no card, no events


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_fig6_quantum_error_fails_the_run(monkeypatch):
    """A DNN quantum that raises in a lane's worker thread fails the run."""
    real = fig6.make_dave2

    def faulty(cfg, device=None, generator=None):
        params, model = real(cfg, device=device, generator=generator)

        def forward(x):
            if threading.current_thread() is not threading.main_thread():
                raise RuntimeError("quantum fault")
            return model(x)
        return params, forward
    monkeypatch.setattr(fig6, "make_dave2", faulty)
    with pytest.raises(RuntimeError, match="quantum fault"):
        fig6.run(duration=0.3, device="cpu")


def test_fig1_run_on_cpu():
    rows = fig1.run(device="cpu")
    assert [r["cores"] for r in rows if r["bench"] == "fig1a"] == [1, 2, 4]
    (b,) = [r for r in rows if r["bench"] == "fig1b"]
    assert set(b) == {"bench", "dnn_solo_ms", "dnn_corun_ms",
                      "dnn_slowdown", "mem_solo_ms"}
    assert all(r["loop_ms"] > 0 for r in rows if r["bench"] == "fig1a")


def test_fig1_hammering_starts_stops_and_raises(monkeypatch):
    """The co-runner has finished a call when the block starts, makes
    none after it ends, and what its thread raised is raised there."""
    calls = []
    monkeypatch.setattr(fig1, "mem_benchmark", lambda a: calls.append(1))
    with fig1.hammering(torch.device("cpu")):
        assert calls
    stopped = len(calls)
    threading.Event().wait(0.05)
    assert len(calls) == stopped

    def fault(a):
        raise RuntimeError("hog fault")
    monkeypatch.setattr(fig1, "mem_benchmark", fault)
    with pytest.raises(RuntimeError, match="hog fault"):
        with fig1.hammering(torch.device("cpu")):
            pass


def test_fig1_hammering_keeps_calls_in_flight(monkeypatch):
    """On a stream, the co-runner waits for the call IN_FLIGHT launches
    back before its next launch (never for the one it just made, after
    the first), and drains its stream when the block ends. A stand-in
    stream and events count what a card would hold."""
    state = {"queued": 0, "most": 0, "drained": 0, "launched": 0}

    class Stream:
        def synchronize(self):
            state["drained"] += 1
            state["queued"] = 0

    class Event:
        def record(self, stream):
            self.waited = False
            state["queued"] += 1
            state["most"] = max(state["most"], state["queued"])

        def synchronize(self):
            if not self.waited:
                self.waited = True
                state["queued"] -= 1

    def launch(a):
        state["launched"] += 1
        if state["launched"] > 50:
            threading.Event().wait(0.001)   # let the block end
    monkeypatch.setattr(fig1, "new_stream", lambda device: Stream())
    monkeypatch.setattr(fig1, "on", lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(fig1, "mem_benchmark", launch)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    with fig1.hammering(torch.device("cpu")):
        while state["launched"] < 50:
            threading.Event().wait(0.001)
    assert state["most"] == fig1.IN_FLIGHT
    assert state["drained"] == 1 and state["queued"] == 0


def test_fig1_co_runner_launch_replays_a_graph_of_calls(monkeypatch):
    """On the card one co-runner launch replays a CUDA graph of
    CALLS_PER_LAUNCH calls, captured on the co-runner's stream after one
    warm-up call outside the capture; on the CPU it is one call. Stand-in
    graph and stream record what a card would get."""
    state = {"capturing": False, "warm": 0, "captured": 0, "replays": 0,
             "stream": None, "synced": 0}

    class Graph:
        def replay(self):
            state["replays"] += 1

    @contextlib.contextmanager
    def capture(graph, stream=None, capture_error_mode="global"):
        state["capturing"], state["stream"] = True, stream
        yield
        state["capturing"] = False

    class Stream:
        def synchronize(self):
            state["synced"] += 1

    def call(a):
        state["captured" if state["capturing"] else "warm"] += 1
    monkeypatch.setattr(fig1, "mem_benchmark", call)
    monkeypatch.setattr(fig1, "on", lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", capture)
    stream = Stream()
    mem = type("Mem", (), {"device": torch.device("cuda")})()
    launch = fig1.co_runner_launch(mem, stream)
    assert (state["warm"], state["captured"]) == (1, fig1.CALLS_PER_LAUNCH)
    assert state["stream"] is stream and state["synced"] == 1
    launch()
    launch()
    assert state["replays"] == 2 and state["captured"] == \
        fig1.CALLS_PER_LAUNCH
    cpu_launch = fig1.co_runner_launch(torch.ones(2), None)
    cpu_launch()
    assert state["warm"] == 2 and state["replays"] == 2


def test_deeppicar_gang_example_on_cpu(capsys):
    rows = deeppicar_gang.main(["--device", "cpu", "--duration", "0.4"])
    assert set(rows) == {"Co-Sched", "RT-Gang"}
    assert all(r["jobs"] > 0 and len(r["lat_ms"]) > 0 for r in rows.values())
    assert "RT-Gang: dnn p50=" in capsys.readouterr().out


def test_entry_points_default_to_cuda(monkeypatch):
    """Without a card the default device raises; nothing drops to the
    CPU unless asked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dave2.make_dave2(CONFIG)
    with pytest.raises(RuntimeError, match="CUDA"):
        fig6.main(["--duration", "0.1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        fig1.main([])
    with pytest.raises(RuntimeError, match="CUDA"):
        deeppicar_gang.main(["--duration", "0.1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        dave2_params_from_jax_numpy(numpy_params(), CONFIG)
