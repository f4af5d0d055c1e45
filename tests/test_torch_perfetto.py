"""The port's copy of the Perfetto / Chrome-trace export
(``repro_torch.obs.perfetto``): the four Perfetto tests of
tests/test_obs.py run against the port, the port's export of a seeded
simulation byte for byte against the JAX package's, and a round trip of
an executor trace of the port.
"""
import json
import time

import pytest

from repro.core.gang import BETask as JaxBETask
from repro.core.gang import RTTask as JaxRTTask
from repro.core.sim import Simulator as JaxSimulator
from repro.core.sim import matrix_interference as jax_matrix_interference
from repro.obs.perfetto import export_sim as jax_export_sim

from repro_torch.core.executor import BEJob, GangExecutor, RTJob
from repro_torch.core.gang import BETask, RTTask
from repro_torch.core.sim import Simulator, matrix_interference
from repro_torch.core.tracing import Trace
from repro_torch.obs import (export_sim, export_trace, segments_from_json,
                             validate_chrome_trace)


def fig5_taskset(rt_task=RTTask, be_task=BETask, intf=matrix_interference):
    t1 = rt_task("tau1", wcet=3.5, period=20, cores=(0, 1), prio=2,
                 mem_budget=0.1)
    t2 = rt_task("tau2", wcet=6.5, period=30, cores=(2, 3), prio=1,
                 mem_budget=0.1)
    bem = be_task("be_mem", cores=(0, 1, 2, 3), mem_rate=1.0)
    bec = be_task("be_cpu", cores=(0, 1, 2, 3), mem_rate=0.01)
    return [t1, t2], [bem, bec], intf({
        ("tau1", "tau2"): 2.0, ("tau2", "tau1"): 2.0,
        ("tau1", "be_mem"): 1.5, ("tau2", "be_mem"): 1.5,
    })


def run(sim_cls=Simulator, horizon=120.0, **kw):
    kinds = {} if sim_cls is Simulator else dict(
        rt_task=JaxRTTask, be_task=JaxBETask, intf=jax_matrix_interference)
    rts, bes, intf = fig5_taskset(**kinds)
    sim = sim_cls(4, rts, be_tasks=bes, rt_gang_enabled=True, dt=None,
                  throttle_mode="reactive", interference=intf, **kw)
    return sim, sim.run(horizon)


def test_perfetto_roundtrip_exact():
    sim, r = run(record_counters=True)
    data = export_sim(sim, r, title="fig5")
    assert validate_chrome_trace(data) == []
    # through an actual JSON serialization, as a viewer would read it
    parsed = json.loads(json.dumps(data))
    got = segments_from_json(parsed)
    want = sorted(((s.core, s.label, s.t0, s.t1)
                   for s in r.trace.segments if s.label is not None),
                  key=lambda t: (t[0], t[2]))
    assert got == want


def test_perfetto_span_classification_and_counter_tracks():
    sim, r = run(record_counters=True)
    data = export_sim(sim, r, title="fig5")
    evs = data["traceEvents"]
    cats = {e["cat"] for e in evs if e["ph"] == "X"}
    assert "gang" in cats and "be" in cats
    # fig5's regulator stalls BE cores: throttled spans colored apart
    assert "throttle" in cats
    counters = {e["name"] for e in evs if e["ph"] == "C"}
    assert any(c.startswith("bw core") for c in counters)
    assert "glock held" in counters
    # per-core thread metadata for the viewer
    names = {e["args"]["name"] for e in evs
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert names == {f"core {c}" for c in range(4)}


def test_validate_chrome_trace_rejects_malformed():
    assert validate_chrome_trace([]) != []
    assert validate_chrome_trace({"traceEvents": [{"ph": "Z"}]}) != []
    bad_counter = {"traceEvents": [
        {"ph": "C", "pid": 2, "tid": 0, "name": "c", "ts": 1.0,
         "args": {"v": "high"}}]}
    assert validate_chrome_trace(bad_counter) != []


def test_export_trace_skips_idle_and_classifies_pathology():
    tr = Trace(2)
    tr.record(0, "g0", 0.0, 1.0)
    tr.record(0, None, 1.0, 2.0)
    tr.record(1, "throttled:be", 0.0, 0.5)
    tr.record(1, "dem:g1", 0.5, 1.0)
    tr.record(1, "aborted:g1#3", 1.0, 1.5)
    data = export_trace(tr, rt_names=["g0"])
    xs = [e for e in data["traceEvents"] if e["ph"] == "X"]
    assert {e["name"] for e in xs} == {"g0", "throttled:be", "dem:g1",
                                       "aborted:g1#3"}
    by_name = {e["name"]: e["cat"] for e in xs}
    assert by_name == {"g0": "gang", "throttled:be": "throttle",
                       "dem:g1": "dem", "aborted:g1#3": "aborted"}


@pytest.mark.parametrize("horizon", [120.0, 600.0])
def test_export_sim_equals_jax_byte_for_byte(horizon):
    """The same seeded Fig.5 simulation in both packages exports the same
    JSON text, counter tracks included."""
    sim, r = run(horizon=horizon, record_counters=True)
    jsim, jr = run(JaxSimulator, horizon=horizon, record_counters=True)
    got = json.dumps(export_sim(sim, r, title="fig5"))
    want = json.dumps(jax_export_sim(jsim, jr, title="fig5"))
    assert got == want
    assert len(got) > 10_000


def test_executor_trace_roundtrip():
    """An executor run of the port (sleeping quanta on the CPU) exports a
    valid trace whose core tracks invert to the trace's labeled
    segments."""
    def rt(lane, idx):
        time.sleep(0.002)

    def be(lane):
        time.sleep(0.0005)

    ex = GangExecutor(n_lanes=2, regulation_interval_s=0.01)
    ex.submit_rt(RTJob("dnn", rt, lanes=(0,), prio=10, period_s=0.01,
                       budget_bytes=1e9, n_jobs=15))
    ex.submit_be(BEJob("hog", be, lanes=(0, 1), bytes_per_quantum=1e3))
    ex.run(0.3)
    data = json.loads(json.dumps(export_trace(ex.trace, rt_names=["dnn"],
                                              title="executor")))
    assert validate_chrome_trace(data) == []
    want = sorted(((s.core, s.label, s.t0, s.t1)
                   for s in ex.trace.segments if s.label is not None),
                  key=lambda t: (t[0], t[2]))
    assert segments_from_json(data) == want
    cats = {e["name"]: e["cat"] for e in data["traceEvents"]
            if e["ph"] == "X"}
    assert cats.get("dnn") == "gang" and cats.get("hog") == "be"


def test_executor_host_spans_roundtrip():
    """The recorder's spans of an executor run export as the "host spans"
    group of the same trace (a thread a lane, nested "X" events), invert
    exactly, and a span that overlaps its lane's open span is refused."""
    from repro_torch.obs import spans, spans_from_json
    from repro_torch.obs.perfetto import PID_SPANS

    def rt(lane, idx):
        with spans.span("model.decode_fn"):
            time.sleep(0.002)

    def be(lane):
        time.sleep(0.0005)

    ex = GangExecutor(n_lanes=2, regulation_interval_s=0.01)
    ex.submit_rt(RTJob("dnn", rt, lanes=(0,), prio=10, period_s=0.01,
                       budget_bytes=1e3, n_jobs=15))
    ex.submit_be(BEJob("hog", be, lanes=(0, 1), bytes_per_quantum=1e3))
    spans.drain()
    spans.enable()
    try:
        ex.run(0.3)
    finally:
        spans.disable()
    items = spans.drain()
    assert {"executor.rt_quantum", "executor.be_quantum",
            "executor.be_denied", "model.decode_fn"} <= {s.name for s in items}
    data = json.loads(json.dumps(export_trace(
        ex.trace, rt_names=["dnn"], title="executor", spans=items,
        spans_origin=ex._t0)))
    assert validate_chrome_trace(data) == []
    assert spans_from_json(data) == items
    assert segments_from_json(data) == sorted(
        ((s.core, s.label, s.t0, s.t1)
         for s in ex.trace.segments if s.label is not None),
        key=lambda t: (t[0], t[2]))
    threads = {e["tid"]: e["args"]["name"] for e in data["traceEvents"]
               if e["ph"] == "M" and e["pid"] == PID_SPANS
               and e["name"] == "thread_name"}
    assert threads == {1: "lane 0", 2: "lane 1"}
    inner = next(e for e in data["traceEvents"]
                 if e.get("name") == "model.decode_fn")
    outer = next(e for e in data["traceEvents"]
                 if e.get("name") == "executor.rt_quantum"
                 and e["ts"] <= inner["ts"] < e["ts"] + e["dur"])
    assert inner["tid"] == outer["tid"] == 1
    bad = dict(inner, args=dict(inner["args"],
                                t1_s=outer["args"]["t1_s"] + 1.0))
    data["traceEvents"].append(bad)
    assert any("overlaps" in p for p in validate_chrome_trace(data))
