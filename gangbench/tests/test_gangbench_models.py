"""A tiny model of each family through the port on the CPU against the
plain reference, and a tiny run of each cell through the whole harness."""
import numpy as np
import pytest
import torch

from gangbench.harness import catalog
from gangbench.harness import model as M
from gangbench.tests import tiny

CELLS = [tiny.SERVE, tiny.ROUNDS, tiny.BUSY]


@pytest.mark.parametrize("cell", CELLS)
def test_port_prefill_and_decode_match_reference(cell):
    cfg = tiny.config(cell)
    m = cfg["model"]
    ref = catalog.load_module("reference", cfg["reference"])
    api, params = M.build(m, ref.param_spec(m), 11, torch.device("cpu"))
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, m["vocab_size"], size=(1, 21))
    served = rng.integers(0, m["vocab_size"], size=4)
    logits, caches = api.prefill_fn(
        params, {"tokens": torch.as_tensor(prompt)})
    got = [logits[0, -1]]
    if m["family"] == "moe":
        full = {}
        for n in ("k", "v"):
            c = caches[n]
            full[n] = torch.zeros(c.shape[:2] + (32,) + c.shape[3:],
                                  dtype=c.dtype)
            full[n][:, :, :c.shape[2]] = c
        caches = full
    for i, tok in enumerate(served[:-1]):
        pos = torch.tensor([prompt.shape[1] + i])
        logits, caches = api.decode_fn(params, caches,
                                       torch.tensor([[int(tok)]]), pos)
        got.append(logits[0, -1])
    got = torch.stack(got)
    ids = np.concatenate([prompt[0], served[:-1]])
    want = ref.forward(m, M.W.draw(ref.param_spec(m), 11, torch.device("cpu"),
                                   torch.float32),
                       [(ids, prompt.shape[1])])[0]
    assert want.shape == got.shape
    torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cell_runs_correct_and_the_control_reads_higher(cell):
    res = tiny.run(cell, control=True)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    bench = catalog.load_benchmark()
    assert set(res["metrics"]) == {
        x["name"] for x in catalog.metrics_of(bench, "end_to_end", cell)}
    r = res["readings"]
    for k in ("max", "mean"):
        assert r["control"][k] > res["checks"][f"token_gap_{k}"]["limit"] \
            >= r["program"][k]


def test_the_result_line_keys():
    res = tiny.run(tiny.SERVE, trace=True)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for v in res["metrics"].values():
        assert set(v) == {"value", "unit"}
    assert {"rt_blocking_ms", "queue_wait_ms", "decode_step_ms",
            "prefill_ms_per_ktok"} <= set(res["metrics"])
    for c in res["checks"].values():
        assert {"value", "limit"} <= set(c)
