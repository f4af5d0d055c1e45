"""``scripts/torch_smoke_one.py`` (the port's counterpart of
``scripts/smoke_one.py``) on the CPU: one AdamW train step, a prefill and
a decode step of the reduced config of one arch of each of the six
families, everything finite. Without ``--device cpu`` it runs on the card,
and raises where there is none."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "torch_smoke_one.py"
FAMILIES = {"dense": "qwen2-7b", "moe": "olmoe-1b-7b", "ssm": "mamba2-1.3b",
            "hybrid": "recurrentgemma-9b", "vlm": "internvl2-1b",
            "audio": "whisper-base"}


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location("torch_smoke_one", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("family", list(FAMILIES))
def test_smoke_one_on_cpu(script, family, capsys):
    arch = FAMILIES[family]
    (rep,) = script.main([arch, "--device", "cpu"])
    assert rep["family"] == family and np.isfinite(rep["loss"])
    assert rep["prefill_logits"] == rep["decode_logits"] == (2, 1, 256)
    assert capsys.readouterr().out.startswith(f"{arch}: OK loss=")


def test_smoke_one_needs_a_card_by_default(script, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        script.main(["whisper-base"])
