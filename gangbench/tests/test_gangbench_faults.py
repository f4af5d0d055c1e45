"""A run with the timed path broken underneath comes out not correct:
a decode step that leaves its state unchanged, half of the batch served
the other half's tokens, a token altered where it is produced, and the
best-effort throttle switched off. (On one card there is no exchange
between chips to leave out.)"""
import pytest
import torch

from repro_torch.core.throttle import BandwidthRegulator
from repro_torch.models.model import ModelApi

from gangbench.tests import tiny

ORIGINAL = ModelApi.decode_fn


def state_unchanged(self, params, caches, tokens, pos):
    clone = {k: v.clone() for k, v in caches.items()}
    logits, _ = ORIGINAL(self, params, clone, tokens, pos)
    return logits, caches


def half_batch(self, params, caches, tokens, pos):
    logits, caches = ORIGINAL(self, params, caches, tokens, pos)
    h = logits.shape[0] // 2
    logits = logits.clone()
    logits[h:2 * h] = logits[:h]
    return logits, caches


def token_altered(self, params, caches, tokens, pos):
    logits, caches = ORIGINAL(self, params, caches, tokens, pos)
    logits = logits.clone()
    logits[..., 1] += 1e4
    return logits, caches


@pytest.mark.parametrize("cell", [tiny.SERVE, tiny.ROUNDS])
@pytest.mark.parametrize("fault", [state_unchanged, half_batch,
                                   token_altered])
def test_model_fault_is_not_correct(monkeypatch, cell, fault):
    monkeypatch.setattr(ModelApi, "decode_fn", fault)
    res = tiny.run(cell)
    assert not res["correct"]
    gap = [c for k, c in res["checks"].items() if k.startswith("token_gap")]
    assert gap and any(c["value"] > c["limit"] for c in gap)


def test_throttle_off_is_not_correct(monkeypatch):
    monkeypatch.setattr(BandwidthRegulator, "charge",
                        lambda self, core, amount, now: True)
    res = tiny.run(tiny.SERVE)
    assert not res["correct"]
    assert res["checks"]["be_budget"]["value"] > 1.0
