"""The traffic generator: the same seed gives the same work, every seed
the same sizes and gaps, and each mix file states its period and sizes."""
import numpy as np
import pytest

from gangbench.harness import catalog
from gangbench.harness import traffic as T

MIXES = sorted(p.stem for p in (catalog.BENCH_DIR / "traffic").glob("*.json"))


def _mix():
    return catalog.load_data("traffic", "olmoe-1b-7b.serve.long_prompt")


def test_open_loop_same_seed_same_requests():
    a = T.open_loop(_mix(), 2**31 + 77, 40.0, 50304)
    b = T.open_loop(_mix(), 2**31 + 77, 40.0, 50304)
    assert [(r.due_s, r.max_new) for r in a] == \
        [(r.due_s, r.max_new) for r in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))


def test_open_loop_seeds_share_the_schedule_not_the_tokens():
    mix = _mix()
    a = T.open_loop(mix, 1, 40.0, 50304)
    b = T.open_loop(mix, 2**33 + 5, 40.0, 50304)
    assert len(a) == len(b) == round(mix["rate_per_s"] * 40.0)
    assert [(r.due_s, len(r.prompt), r.max_new) for r in a] == \
        [(r.due_s, len(r.prompt), r.max_new) for r in b]
    assert not any(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))
    c = T.open_loop(dict(mix, schedule_seed=mix["schedule_seed"] + 1), 1,
                    40.0, 50304)
    assert sorted(len(r.prompt) for r in a) == \
        sorted(len(r.prompt) for r in c)
    assert [len(r.prompt) for r in a] != [len(r.prompt) for r in c]


def test_open_loop_due_inside_the_window_and_sizes_in_range():
    mix = _mix()
    reqs = T.open_loop(mix, 9, 40.0, 50304)
    due = np.array([r.due_s for r in reqs])
    assert (np.diff(due) > 0).all() and due[0] > 0 and due[-1] < 40.0
    lens = np.array([len(r.prompt) for r in reqs])
    assert lens.min() >= mix["prompt"]["lo"]
    assert lens.max() <= mix["prompt"]["hi"]
    outs = np.array([r.max_new for r in reqs])
    assert outs.min() >= mix["output"]["lo"]
    assert outs.max() <= mix["output"]["hi"]
    assert (lens + outs <= mix["max_seq"]).all()
    assert all(r.prompt.dtype == np.int32 and r.prompt.max() < 50304
               for r in reqs)


def test_busy_slots_at_staggered_progress():
    mix = catalog.load_data("traffic", "olmoe-1b-7b.serve.long_output")
    a = T.busy_slots(mix, 3, 50304)
    b = T.busy_slots(mix, 2**31 + 3, 50304)
    n = mix["busy_slots"]
    assert len(a) == n <= mix["slots"]
    assert [(len(r.prompt), r.max_new) for r in a] == \
        [(len(r.prompt), r.max_new) for r in b]
    assert not np.array_equal(a[0].prompt, b[0].prompt)
    rng = T.rng_for(mix["schedule_seed"], 5)
    prompts = rng.permutation(T.quantiles(mix["prompt"], n))
    outs = rng.permutation(T.quantiles(mix["output"], n))
    for i, r in enumerate(a):
        served = int((i + 0.5) / n * outs[i])      # the share behind it
        assert len(r.prompt) == prompts[i] + served
        assert r.max_new == outs[i] - served >= 1
        assert len(r.prompt) + r.max_new <= mix["max_seq"]


def test_rounds_lengths_are_the_same_for_every_seed():
    mix = catalog.load_data("traffic", "mamba2-1.3b.gang.long_prompt")
    lens = [T.round_length(mix, r) for r in range(16)]
    assert lens[0] == round((mix["prompt"]["lo"] * mix["prompt"]["hi"])
                            ** 0.5)
    assert min(lens) >= mix["prompt"]["lo"]
    assert max(lens) <= mix["prompt"]["hi"]
    a = T.round_prompts(mix, 5, 3, 50288)
    b = T.round_prompts(mix, 5, 3, 50288)
    c = T.round_prompts(mix, 2**32 + 5, 3, 50288)
    assert a.shape == c.shape == (mix["batch"], lens[3])
    assert np.array_equal(a, b) and not np.array_equal(a, c)


def test_van_der_corput():
    assert [T.van_der_corput(i) for i in range(1, 6)] == \
        [0.5, 0.25, 0.75, 0.125, 0.625]


def test_quantiles():
    q = T.quantiles({"dist": "uniform", "lo": 16, "hi": 64}, 4)
    assert list(q) == [22, 34, 46, 58]


@pytest.mark.parametrize("name", MIXES)
def test_mix_files_state_period_and_sizes(name):
    mix = catalog.load_data("traffic", name)
    assert mix["period_ms"] > 0 and mix["period_ms"] % 10 == 0
    assert mix["hog_declared_bytes"] == 2 * mix["hog_buffer_bytes"]
    assert mix["hog_buffer_bytes"] > 50e6          # larger than the L2
    assert mix["regulation_ms"] > 0 and mix["drain_s"] >= 0
    assert {"sample", "min_tokens"} <= set(mix["check"])
    assert {"token_gap_max", "token_gap_mean"} & set(mix["check"])
    assert mix["prompt"]["lo"] <= mix["prompt"]["hi"]
    if mix["driver"] == "serve":
        assert mix["rate_per_s"] > 0 and mix["slots"] > 0
        assert isinstance(mix["schedule_seed"], int)
        assert mix["prompt"]["hi"] + mix["output"]["hi"] <= mix["max_seq"]
    else:
        assert mix["batch"] > 0 and mix["new_tokens"] > 1


class _Engine:
    """Stands in for the slot engine: slots fill as requests are added."""

    def __init__(self, slots):
        self.active = np.zeros(slots, dtype=bool)
        self.slot_req = [None] * slots

    def add_request(self, req):
        i = int(np.flatnonzero(~self.active)[0])
        self.active[i], self.slot_req[i] = True, req
        req.out = [0]

    def decode_step(self):
        pass


@pytest.mark.parametrize("budget,admitted", [
    (None, [[30, 20, 40, 10]]),
    (60, [[30, 20], [40, 10]]),
    (35, [[30], [20], [40], [10]])])
def test_serve_admits_within_the_prompt_token_budget(budget, admitted):
    """After the first, a quantum admits only prompts that keep its prompt
    tokens within ``prefill_tokens_per_quantum``; the rest wait, in order."""
    from types import SimpleNamespace

    from gangbench.drivers.serve import Driver
    from gangbench.harness.spans import Spans
    d = Driver.__new__(Driver)
    d.mix = {} if budget is None else {"prefill_tokens_per_quantum": budget}
    d.spans, d.engine, d.next = Spans(), _Engine(8), 0
    d.arrivals = [T.Arrival(rid=i, due_s=0.0, prompt=np.zeros(n, np.int32),
                            max_new=4)
                  for i, n in enumerate((30, 20, 40, 10))]
    d.reqs = [SimpleNamespace(prompt=a.prompt, out=[]) for a in d.arrivals]
    got = []
    for q in range(len(admitted)):
        n0 = len(d.spans.of("refill"))
        d.quantum(0, q)
        got.append([s.meta["length"] for s in d.spans.of("refill")[n0:]])
    assert got == admitted
