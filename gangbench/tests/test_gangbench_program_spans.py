"""The readers of the program's own spans (``repro_torch.obs.spans``) on a
hand-built run: known spans and a small device trace give known values,
and each reader gives None without the program's spans or without the
device trace. An untraced run never turns the recorder on."""
import numpy as np
import pytest

from repro_torch.core.executor import GangExecutor
from repro_torch.obs import spans as obs_spans
from repro_torch.obs.spans import Span

from gangbench.harness import catalog
from gangbench.harness.cell import RunData
from gangbench.harness.profile import DeviceTrace
from gangbench.harness.spans import Spans
from gangbench.tests import tiny

ORIGIN = 100.0
READERS = ("rt_backlog_ms", "rt_dispatch_ms", "be_wake_lag_ms",
           "decode_idle_in_enqueue_pct", "decode_host_us_per_launch")


def rt(idx, release, prev_finish, start, end):
    return Span("executor.rt_quantum", 0, ORIGIN + start - 0.001,
                ORIGIN + end,
                {"job": "rt", "idx": idx, "release": ORIGIN + release,
                 "barrier": ORIGIN + start, "start": ORIGIN + start,
                 "prev_finish": None if prev_finish is None
                 else ORIGIN + prev_finish})


def be(lane, t0):
    return Span("executor.be_quantum", lane, ORIGIN + t0, ORIGIN + t0 + 0.001,
                {"job": "hog"})


def denied(lane, t, until):
    return Span("executor.be_denied", lane, ORIGIN + t, ORIGIN + t,
                {"job": "hog", "stalled_until": ORIGIN + until})


def program():
    return [
        # released in the window: backlog 0 / 0.3 s, dispatch 2 / 10 ms
        rt(0, 0.0, None, 0.002, 0.05),
        rt(1, 1.0, 1.3, 1.31, 1.4),
        rt(2, 10.0, 10.1, 10.2, 10.3),      # released after the window
        # lane 1: a stall denied twice, its quantum 40 ms past the refill;
        # one 10 ms past; one with no quantum after it
        denied(1, 0.5, 0.52), denied(1, 0.51, 0.52), be(1, 0.56),
        denied(1, 2.0, 2.02), be(1, 2.03),
        denied(1, 9.0, 9.02),
        # lane 0: an RT quantum comes before the next hog quantum
        denied(0, 1.305, 1.32), be(0, 1.5),
        denied(0, 11.0, 11.02), be(0, 11.1),  # after the window
        # the host inside decode_fn: 0.4 s of the step [3.0, 4.0), and
        # once outside any decode step
        Span("model.decode_fn", 0, ORIGIN + 3.0, ORIGIN + 3.4, {}),
        Span("model.decode_fn", 0, ORIGIN - 50.0, ORIGIN - 49.0, {}),
    ]


def trace():
    # the RT stream (7): [3.1, 3.2) in the enqueue, [3.5, 3.9) after it,
    # [5.0, 5.1) outside the step; stream 8 is the hog's
    return DeviceTrace(
        names=["k"], name_id=np.zeros(4, np.int64),
        stream=np.array([7, 7, 8, 7]),
        t0=np.array([3.1, 3.5, 3.2, 5.0]), t1=np.array([3.2, 3.9, 3.6, 5.1]),
        rt_stream=7)


def run_data(with_program=True, with_trace=True):
    sp = Spans()
    sp.reset(ORIGIN)
    sp.add("decode", 0, 3.0, 4.0, tokens=8, positions=[9] * 8)
    run = RunData(cell="synthetic", model={}, mix={}, seconds=10.0,
                  run_s=11.0, spans=sp, response_s=[0.05, 0.4],
                  period_s=1.0, requests=[], leaf_spans=("decode",),
                  token_spans=("decode",), device_kind="cpu",
                  trace=trace() if with_trace else None)
    if with_program:
        run.program_spans = program()
    return run


def read(name, run):
    return catalog.load_module("metrics", name).read(run)


@pytest.mark.parametrize("name, want", [
    ("rt_backlog_ms", 0.95 * 300.0),
    ("rt_dispatch_ms", 2.0 + 0.95 * 8.0),
    ("be_wake_lag_ms", (40.0 + 10.0) / 2),
    # idle in the step 1.0 - 0.5 s; in the enqueue 0.4 - 0.1 s
    ("decode_idle_in_enqueue_pct", 100.0 * 0.3 / 0.5),
    # 0.4 s of host time over the 2 RT-stream operations begun in the step
    ("decode_host_us_per_launch", 0.4e6 / 2),
])
def test_reader_gives_the_known_value(name, want):
    assert read(name, run_data()) == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_none_without_the_programs_spans(name):
    assert read(name, run_data(with_program=False)) is None
    run = run_data()
    run.program_spans = []
    assert read(name, run) is None


@pytest.mark.parametrize("name", READERS[3:])
def test_device_reader_gives_none_without_the_trace(name):
    assert read(name, run_data(with_trace=False)) is None


def test_rt_parts_add_up_to_the_response():
    from gangbench.harness.program_spans import rt_parts
    run = run_data()
    assert [sum(p) for p in rt_parts(run)] == pytest.approx(run.response_s)


@pytest.mark.parametrize("cell", [tiny.SERVE, tiny.ROUNDS])
def test_untraced_run_never_turns_the_recorder_on(monkeypatch, cell):
    seen = []
    run = GangExecutor.run

    def watched(self, duration_s):
        seen.append(obs_spans.RECORDER.on)
        return run(self, duration_s)
    monkeypatch.setattr(GangExecutor, "run", watched)
    monkeypatch.setattr(obs_spans, "enable",
                        lambda: pytest.fail("the recorder was enabled"))
    obs_spans.drain()
    res = tiny.run(cell, trace=False)
    assert res["correct"], res["checks"]
    assert seen == [False] and not obs_spans.RECORDER.on
    assert obs_spans.drain() == []
