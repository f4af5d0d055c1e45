"""On the card, at the cells' own sizes: the fp8 control fails the
token-gap limit on three seeds while the program passes it. Skips
without a card. Run: python -m pytest -q -m gpu gangbench/tests"""
import pytest

from gangbench.harness import catalog


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  catalog.load_benchmark()["workloads"]])
def test_control_fails_where_the_program_passes(card, cell):
    from gangbench.tools import calibrate
    rows = calibrate.run(cell, [2**31 + 101, 2**31 + 102, 2**31 + 103],
                         seconds=12.0)
    for row in rows:
        assert row["correct"], row["checks"]
        control = row["readings"]["control"]
        assert any(control[k[len("token_gap_"):]] > c["limit"]
                   for k, c in row["checks"].items()
                   if k.startswith("token_gap_"))
