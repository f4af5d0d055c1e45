"""Tails and rates over every sample; the isolation check's arithmetic;
the device trace's interval sums."""
import math
import statistics

import numpy as np
import pytest

from gangbench.harness import checks, profile
from gangbench.harness.cell import RunData, end_to_end
from gangbench.harness.spans import Span, Spans
from gangbench.harness.stats import percentile, spread


def test_percentile_is_over_all_samples():
    v = list(np.random.default_rng(0).exponential(size=1001))
    assert percentile(v, 95) == pytest.approx(float(np.percentile(v, 95)))
    assert percentile([], 50) is None


def test_spread_uses_statistics_quartiles():
    v = [10.0, 11.0, 12.0, 13.0, 30.0, 9.0]
    q1, q2, q3 = statistics.quantiles(v, n=4)
    assert spread(v) == pytest.approx((q3 - q1) / q2)


def _run(spans, resp, requests=(), seconds=10.0, run_s=12.0, period=0.1):
    sp = Spans()
    sp.items.extend(spans)
    return RunData(cell="c", model={}, mix={"hog_declared_bytes": 1e9},
                   seconds=seconds, run_s=run_s, spans=sp,
                   response_s=list(resp), period_s=period,
                   requests=list(requests), leaf_spans=("decode",),
                   token_spans=("refill", "decode"), device_kind="cpu")


def test_rt_tail_counts_every_release_and_unfinished_ones():
    # 100 releases in a 10 s window; only 90 finished: the other 10 count
    # until the run's end (12 s - their release)
    resp = [0.01] * 90
    run = _run([], resp)
    v = end_to_end(run, ["rt_p95_ms"], 0.0)["rt_p95_ms"]
    tail = [12.0 - i * 0.1 for i in range(90, 100)]
    assert v == pytest.approx(1e3 * np.percentile([0.01] * 90 + tail, 95))


def test_ttft_tail_over_all_due_requests():
    reqs = [{"due": i * 0.1, "admit": i * 0.1 + 0.01,
             "first": i * 0.1 + 0.05} for i in range(95)]
    reqs += [{"due": 9.6 + i * 0.01, "admit": None, "first": None}
             for i in range(5)]
    reqs += [{"due": 11.0, "admit": None, "first": None}]  # after the window
    run = _run([], [0.0] * 100, reqs)
    v = end_to_end(run, ["ttft_p90_ms"], 0.0)["ttft_p90_ms"]
    ttft = [0.05] * 95 + [12.0 - (9.6 + i * 0.01) for i in range(5)]
    assert v == pytest.approx(1e3 * np.percentile(ttft, 90))


def test_rates_over_the_whole_window():
    spans = [Span("decode", 0, t, t + 0.05, {"tokens": 4})
             for t in np.arange(0.0, 12.0, 0.1)]
    spans += [Span("refill", 0, 1.0, 1.1, {"tokens": 1})]
    spans += [Span("hog", 1, t, t + 0.001, {})
              for t in np.arange(0.0, 12.0, 0.02)]
    run = _run(spans, [0.0] * 100)
    e = end_to_end(run, ["tokens_per_s", "be_gb_per_s", "setup_s"], 3.5)
    n_dec = sum(1 for t in np.arange(0.0, 12.0, 0.1) if t + 0.05 <= 10.0)
    n_hog = sum(1 for t in np.arange(0.0, 12.0, 0.02) if t + 0.001 <= 10.0)
    assert e["tokens_per_s"] == pytest.approx((4 * n_dec + 1) / 10.0)
    assert e["be_gb_per_s"] == pytest.approx(n_hog * 1e9 / 10.0 / 1e9)
    assert e["setup_s"] == 3.5


def _isolation_spans(per_window, interval=0.02, windows=200):
    spans = [Span("quantum", 0, 0.0, interval * windows, {"idx": 0})]
    for w in range(windows):
        for j in range(per_window):
            t = w * interval + 0.001 + j * 0.0001
            spans.append(Span("hog", 1, t, t + 0.00005, {}))
    return spans


def test_budget_ratio_holds_for_one_quantum_a_window():
    r = checks.budget_ratio(_isolation_spans(1), 1.0, 1.0, 0.02)
    assert 0.9 < r <= 1.0


def test_budget_ratio_fails_a_missing_throttle():
    assert checks.budget_ratio(_isolation_spans(2), 1.0, 1.0, 0.02) > 1.5
    assert checks.budget_ratio(_isolation_spans(40), 1.0, 1.0, 0.02) > 9


def test_budget_ratio_ignores_quanta_outside_the_gang():
    spans = [Span("quantum", 0, 0.0, 0.01, {"idx": 0})]
    spans += [Span("hog", 1, 0.02 + i * 1e-4, 0.02 + i * 1e-4, {})
              for i in range(50)]
    assert checks.budget_ratio(spans, 1.0, 1.0, 0.02) == 0.0


def test_rt_overlap():
    spans = [Span("quantum", 0, 0.0, 1.0, {}),
             Span("quantum", 0, 1.0, 2.0, {})]
    assert checks.rt_overlap_s(spans) == 0.0
    spans.append(Span("quantum", 0, 1.5, 2.5, {}))
    assert checks.rt_overlap_s(spans) == pytest.approx(0.5)


def test_checks_pass_and_fail():
    assert checks.passes({"value": 1.0, "limit": 1.0})
    assert not checks.passes({"value": None, "limit": 1.0})
    assert checks.passes({"value": 5, "limit": 3, "at_least": True})
    assert checks.finite(math.inf) is None
    assert checks.lines({"a": {"value": 2.0, "limit": 1.0}}) == \
        ["check a 2.0 <= limit 1.0 FAILED"]


def test_union_and_covered():
    s, e = profile.union(np.array([0.0, 0.5, 2.0, -1.0]),
                         np.array([1.0, 1.5, 3.0, -0.5]), 0.0, 2.5)
    assert list(s) == [0.0, 2.0] and list(e) == [1.5, 2.5]
    c = profile.covered(s, e, np.array([0.0, 1.0, 1.6, 0.0]),
                        np.array([2.5, 2.2, 1.9, 0.5]))
    np.testing.assert_allclose(c, [2.0, 0.7, 0.0, 0.5])


def test_token_gaps():
    import torch
    lg = [torch.tensor([[0.0, 2.0, 1.0], [3.0, 1.0, 2.9]])]
    assert list(checks.token_gaps(lg, [np.array([1, 0])])) == [0.0, 0.0]
    g = checks.token_gaps(lg, [np.array([2, 2])])
    np.testing.assert_allclose(g, [1.0, 0.1], rtol=1e-6)
    st = checks.gap_stats(g)
    assert st["max"] == pytest.approx(1.0)
    assert st["mean"] == pytest.approx(0.55)
    assert st["mismatch"] == 1.0
    c = checks.control_gaps(lg, [torch.tensor([[0, 0, 1.0], [0, 1.0, 0]])])
    np.testing.assert_allclose(c, [1.0, 2.0], rtol=1e-6)
    assert checks.gap_stats(np.zeros(0))["max"] is None
