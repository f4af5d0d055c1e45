"""The port's benchmark aggregator (``repro_torch.benchmarks.run``, the
counterpart of ``benchmarks/run.py``) on the CPU: every section's header,
Fig.6's three modes, the sweep hint over an empty dry-run directory and
the roofline rows of a directory that holds a cell. Without ``--device
cpu`` it runs on the card, and raises where there is none."""
import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch.benchmarks import run  # noqa: E402

HEADERS = ("== fig4, fig5, table3, sim engines", "== fig1 ", "== fig6 ",
           "== roofline ", "== done in ")
# a dry-run cell as launch.dryrun writes one (the keys roofline_row reads)
CELL = {"arch": "qwen2-7b", "shape": "decode_32k", "mesh": "16x16",
        "chips": 256, "tokens": 8, "dtype": "bfloat16", "n_params": 7e9,
        "flops_per_device": 989e9, "bytes_per_device": 6.7e9,
        "collectives_per_device": {"total_bytes": 0.0, "bytes_by_type": {}},
        "memory": {"argument_size_bytes": 2**30}}


def _cells_in(monkeypatch, path):
    """The roofline section reads its dry-run cells from ``path``."""
    real = run.roofline_bench.run
    monkeypatch.setattr(run.roofline_bench, "run", lambda: real(str(path)))


def test_aggregator_on_cpu_prints_every_section(tmp_path, capsys,
                                                monkeypatch):
    _cells_in(monkeypatch, tmp_path)
    rep = run.main(["--device", "cpu", "--duration", "0.5"])
    out = capsys.readouterr().out
    at = [out.find(h) for h in HEADERS]
    assert -1 not in at and at == sorted(at), out
    assert {r["bench"] for r in rep["fig1"]} == {"fig1a", "fig1b"}
    assert [r["cores"] for r in rep["fig1"][:3]] == [1, 2, 4]
    assert set(rep["fig6"]) == {"solo", "cosched", "rtgang"}
    for mode in ("solo", "cosched", "rtgang"):
        assert rep["fig6"][mode]["n"] >= 1, mode
        assert out.count(f"\n{mode} {{") == 1
    assert rep["roofline"] == []
    assert run.SWEEP_HINT in out


def test_aggregator_prints_the_roofline_of_each_cell(tmp_path, capsys,
                                                     monkeypatch):
    monkeypatch.setattr(run.fig1_parallelization, "run", lambda dev: [])
    monkeypatch.setattr(run.fig6_dnn_cdf, "run",
                        lambda duration, device: {"solo": {"n": 0}})
    (tmp_path / "qwen2-7b_decode_32k_16x16.json").write_text(
        json.dumps(CELL))
    (tmp_path / "skipped.json").write_text("{}")
    _cells_in(monkeypatch, tmp_path)
    rep = run.main(["--device", "cpu"])
    out = capsys.readouterr().out
    (row,) = rep["roofline"]
    assert (row["arch"], row["shape"], row["mesh"]) == \
        ("qwen2-7b", "decode_32k", "16x16")
    assert row["compute_s"] == pytest.approx(1e-3)
    assert run.SWEEP_HINT not in out and "'arch': 'qwen2-7b'" in out


def test_aggregator_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run.main(["--duration", "0.5"])
