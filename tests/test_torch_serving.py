"""The port's serving engine and launcher on the CPU: the port's versions
of ``test_engine_matches_stepwise_greedy`` and
``test_engine_concurrent_slots`` (tests/test_serving_executor.py), with the
tokens also held equal to the JAX engine's on the same parameters and
prompts (f32, reduced qwen2-7b: greedy ids must be equal)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JaxServingEngine  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from test_torch_model import jax_and_port_lm  # noqa: E402


@pytest.fixture(scope="module")
def lm():
    return jax_and_port_lm()


def _jax_tokens(japi, jparams, prompts, max_new):
    engine = JaxServingEngine(japi, jparams, max_batch=2, max_seq=64)
    reqs = [JaxRequest(rid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]
    engine.run_until_done(reqs, max_steps=100)
    return [r.out for r in reqs]


def test_engine_matches_stepwise_greedy(lm):
    """Engine generation == greedy rollout by repeated prefill, and ==
    the JAX engine's tokens."""
    japi, jparams, api, params = lm
    rng = np.random.default_rng(1)
    prompt = rng.integers(1, api.cfg.vocab_size, size=(12,)).astype(np.int32)
    n_new = 5

    engine = ServingEngine(api, params, max_batch=2, max_seq=64)
    req = Request(rid=0, prompt=prompt, max_new=n_new)
    engine.run_until_done([req], max_steps=50)
    assert req.done and len(req.out) == n_new

    toks = list(prompt)
    oracle = []
    for _ in range(n_new):
        logits, _ = api.prefill_fn(params,
                                   {"tokens": torch.as_tensor([toks])})
        nxt = int(torch.argmax(logits[0, -1]))
        oracle.append(nxt)
        toks.append(nxt)
    assert req.out == oracle, (req.out, oracle)
    assert req.out == _jax_tokens(japi, jparams, [prompt], n_new)[0]


def test_engine_concurrent_slots(lm):
    japi, jparams, api, params = lm
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, api.cfg.vocab_size, size=(8,))
               .astype(np.int32) for _ in range(4)]
    engine = ServingEngine(api, params, max_batch=2, max_seq=64)
    reqs = [Request(rid=i, prompt=p, max_new=4)
            for i, p in enumerate(prompts)]
    engine.run_until_done(reqs, max_steps=100)
    assert all(r.done for r in reqs)
    assert all(len(r.out) == 4 for r in reqs)
    assert [r.out for r in reqs] == _jax_tokens(japi, jparams, prompts, 4)


def test_engine_warmup_resets_state(lm):
    _, _, api, params = lm
    engine = ServingEngine(api, params, max_batch=2, max_seq=64)
    engine.warmup(prompt_len=6)
    assert not engine.active.any() and engine.decode_steps == 0
    assert int(engine.pos.abs().sum()) == 0
    assert float(engine.cache["k"].abs().sum()) == 0.0


def test_serve_run_on_cpu_finishes_requests():
    cfg = reduced(get_config("qwen2-7b"))
    parallel = ParallelConfig(param_dtype="float32", compute_dtype="float32")
    lines = []
    res = serve.run(cfg, parallel, device="cpu", n_requests=4, max_new=5,
                    prompt_lens=(8, 13, 21), max_seq=64, duration=2.0,
                    log=lines.append)
    assert all(r.done and len(r.out) == 5 for r in res["requests"])
    assert len(res["latency_ms"]) > 0
    assert "bg-batch" in res["stats"]["be_quanta"]
    assert lines[0].startswith("[serve] gang=on requests done 4/4")


def test_entry_points_default_to_cuda(monkeypatch):
    """Without a card, the default device raises instead of dropping to
    the CPU; the CPU is used only when asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_config("qwen2-7b"))
    parallel = ParallelConfig(param_dtype="float32", compute_dtype="float32")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg, parallel)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--duration", "0.1"])
    with pytest.raises(NotImplementedError):
        build_model(dataclasses.replace(cfg, family="audio"), parallel,
                    device="cpu")
    assert build_model(cfg, parallel, device="cpu").device.type == "cpu"
