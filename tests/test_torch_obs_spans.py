"""The port's host-span recorder (``repro_torch.obs.spans``) and the spans
the gang executor records into it: off it allocates nothing, on it nests
and names the worker's lane, an RT quantum's spans add up to the
executor's response, and a denied best-effort charge names the end of
the regulator's window."""
import threading
import time
import tracemalloc

import pytest

from repro_torch.core.executor import BEJob, GangExecutor, RTJob
from repro_torch.obs import spans


@pytest.fixture(autouse=True)
def recorder_off():
    spans.disable()
    spans.drain()
    yield
    spans.disable()
    spans.drain()


def test_off_records_nothing_and_allocates_nothing():
    assert not spans.RECORDER.on
    assert spans.span("a") is spans.span("b") is spans.NOOP
    with spans.span("a") as meta:
        assert meta is None
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with spans.span("model.decode_fn"):
                pass
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    only = [tracemalloc.Filter(True, spans.__file__)]
    grown = [d for d in after.filter_traces(only).compare_to(
        before.filter_traces(only), "lineno") if d.size_diff > 0]
    assert grown == []
    assert spans.drain() == []


def test_on_nested_spans_close_in_order_on_the_threads_lane():
    spans.enable()
    with spans.span("outer", k=1):
        with spans.span("inner") as meta:
            meta["filled"] = True
    got = {}

    def lane_thread():
        spans.set_lane(3)
        with spans.span("on_lane"):
            pass
        got["lane"] = spans.lane()
    t = threading.Thread(target=lane_thread)
    t.start()
    t.join(timeout=5.0)
    assert not t.is_alive()
    items = spans.drain()
    assert [s.name for s in items] == ["inner", "outer", "on_lane"]
    inner, outer, on_lane = items
    assert outer.t0 <= inner.t0 <= inner.t1 <= outer.t1
    assert inner.meta == {"filled": True} and outer.meta == {"k": 1}
    assert inner.lane is None and outer.lane is None
    assert on_lane.lane == 3 == got["lane"]
    assert spans.lane() is None          # this thread was never a lane
    assert spans.drain() == []


def _gang(rt_s, period_s, n_jobs, rt_budget, be_bytes, be_s=0.0005,
          interval_s=0.01):
    ex = GangExecutor(n_lanes=2, regulation_interval_s=interval_s)

    def rt(lane, idx):
        with spans.span("body"):
            time.sleep(rt_s)

    def be(lane):
        time.sleep(be_s)
    ex.submit_rt(RTJob("rt", rt, lanes=(0,), prio=10, period_s=period_s,
                       budget_bytes=rt_budget, n_jobs=n_jobs))
    ex.submit_be(BEJob("hog", be, lanes=(0, 1), bytes_per_quantum=be_bytes))
    return ex


def test_rt_quantum_spans_add_up_to_the_response():
    """An RT job whose quantum outlasts its period: per instance, the wait
    for the previous instance (backlog), the executor's dispatch and the
    quantum's run add up to the response."""
    spans.enable()
    ex = _gang(rt_s=0.015, period_s=0.01, n_jobs=8, rt_budget=1e9,
               be_bytes=1e3)
    ex.run(0.4)
    items = spans.drain()
    quanta = {s.meta["idx"]: s for s in items
              if s.name == "executor.rt_quantum"}
    resp = ex.response_times["rt"]
    assert sorted(quanta) == list(range(8)) and len(resp) == 8
    backlogs = []
    for i, s in quanta.items():
        m = s.meta
        assert m["job"] == "rt" and s.lane == 0
        assert s.t0 <= m["barrier"] <= m["start"] <= s.t1
        assert m["release"] == pytest.approx(ex._t0 + 0.01 * i)
        assert (m["prev_finish"] is None) == (i == 0)
        prev = m["prev_finish"] if m["prev_finish"] is not None \
            else m["release"]
        backlog = max(0.0, prev - m["release"])
        dispatch = m["start"] - max(m["release"], prev)
        run = s.t1 - m["start"]
        assert dispatch >= 0.0
        assert backlog + dispatch + run == pytest.approx(resp[i], abs=1e-6)
        backlogs.append(backlog)
    assert max(backlogs) > 0.02       # the backlog grows a period at a time
    bodies = [s for s in items if s.name == "body"]
    assert len(bodies) == 8 and all(b.lane == 0 for b in bodies)
    hog = [s for s in items if s.name == "executor.be_quantum"]
    assert {s.lane for s in hog} <= {0, 1} and len(hog) == \
        sum(ex.be_quanta.values())


def test_be_denials_name_the_regulators_window_end():
    """A best-effort job allowed one quantum a regulation window: each
    denied charge is an instant whose ``stalled_until`` is the end of the
    lane's window, and on the lane the gang never takes the next quantum
    starts no earlier."""
    interval = 0.02
    spans.enable()
    ex = _gang(rt_s=0.002, period_s=0.05, n_jobs=6, rt_budget=1e3,
               be_bytes=1e3, be_s=0.001, interval_s=interval)
    ex.run(0.3)
    items = spans.drain()
    denied = [s for s in items if s.name == "executor.be_denied"]
    assert denied
    for s in denied:
        assert s.t0 == s.t1 and s.meta["job"] == "hog"
        end = s.meta["stalled_until"] - ex._t0
        k = round(end / interval)
        assert k >= 1 and end == pytest.approx(k * interval, abs=1e-9)
        assert end - interval <= s.t0 - ex._t0 < end
        if s.lane == 1:      # lane 0's stall lifts when the gang takes it
            nxt = [q.t0 for q in items if q.name == "executor.be_quantum"
                   and q.lane == 1 and q.t0 > s.t0]
            assert not nxt or min(nxt) >= s.meta["stalled_until"]
    assert len(denied) >= ex.reg.cores[1].throttle_events > 0
