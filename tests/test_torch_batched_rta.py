"""The port's batched RTA (``repro_torch.analysis.batched_rta``): its
numpy path is a copy of the JAX package's, and its ``torch`` backend (a
float64 lockstep fixed point over the whole shard, in place of JAX's
``jax`` backend) must give the numpy backend's verdicts and WCRTs within
a relative 1e-12 (bit parity is not promised). Run here on the CPU
(``device="cpu"``), on the seeded task sets of tests/test_batched_rta.py
and its degenerate shapes; chip_smoke.py phase (j) runs the same on the
card."""
import functools
import math
import random
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.analysis import batched_rta as jbat
from repro.launch.sweep import random_gang_taskset, taskset_seed
from repro.vgang.formation import HEURISTICS as JHEURISTICS
from repro.vgang.grid import n_tasks_for, random_vgang_taskset

from repro_torch.analysis import batched_rta as bat
from repro_torch.core.gang import RTTask
from repro_torch.vgang import rta as vrta
from repro_torch.vgang.formation import (HEURISTICS, assign_priorities,
                                         intensity_interference,
                                         singleton_vgangs)

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-12


def _rows(tasksets):
    """(name, C, P, prio) rows of tasksets from either package."""
    return [[(t.name, t.wcet, t.period, t.prio) for t in ts]
            for ts in tasksets]


def _random_rows(n_sets, seed=0, n_cores=4, max_tasks=8, max_util=2.2):
    """The shards of tests/test_batched_rta.py: varying sizes and
    utilizations, so converging, deadline-missing and divergent lanes
    mix."""
    sets = []
    for k in range(n_sets):
        rng = random.Random(taskset_seed(seed, k, 1.0))
        n = rng.randint(1, max_tasks)
        u = rng.uniform(0.1, max_util)
        sets.append(random_gang_taskset(rng, n_cores, n, u))
    return _rows(sets)


def _assert_agree(batch, **kw):
    """torch (CPU) vs numpy on one padded shard: the same lanes settle,
    finite WCRTs within RTOL, equal accept bits."""
    a = bat.fixed_point(batch, backend="numpy", **kw)
    b = bat.fixed_point(batch, backend="torch", device="cpu", **kw)
    assert a.shape == b.shape == batch.shape
    assert np.array_equal(np.isnan(a), np.isnan(b))
    fin = np.isfinite(a)
    np.testing.assert_allclose(b[fin], a[fin], rtol=RTOL, atol=0.0)
    assert np.array_equal(bat.accept_bits(batch, a),
                          bat.accept_bits(batch, b))
    return a, b


def test_torch_backend_matches_numpy_500_tasksets():
    rows = _random_rows(250, seed=0) + \
        _random_rows(150, seed=1, max_tasks=12, max_util=3.0) + \
        _random_rows(100, seed=2, n_cores=8, max_util=1.5)
    a, _ = _assert_agree(bat.pad_rows(rows))
    assert np.isfinite(a).sum() > 1000 and np.isnan(a[bat.pad_rows(
        rows).valid]).sum() > 100        # both kinds of lanes present


@pytest.mark.parametrize("kw", [
    {"blocking": 0.7}, {"crpd": 0.25}, {"blocking": 0.3, "crpd": 0.1},
    "per-set"])
def test_torch_backend_blocking_and_crpd(kw):
    rows = _random_rows(60, seed=3)
    batch = bat.pad_rows(rows)
    if kw == "per-set":                  # blocking per set, crpd per lane
        rng = np.random.default_rng(0)
        kw = {"blocking": rng.uniform(0, 1, batch.shape[0]),
              "crpd": rng.uniform(0, 0.2, batch.shape)}
    _assert_agree(batch, **kw)


def test_torch_backend_singletons():
    rows = [[("solo", w, 10.0, 1.0)] for w in (0.5, 9.999999, 10.0, 10.5)]
    a, b = _assert_agree(bat.pad_rows(rows))
    assert b[:, 0].tolist() == [0.5, 9.999999, 10.0, 10.5]
    assert bat.accept_bits(bat.pad_rows(rows), b).tolist() == \
        [True, True, True, False]


def test_torch_backend_all_divergent_shard():
    sets = []
    for k in range(20):
        rng = random.Random(k)
        sets.append(random_gang_taskset(rng, 4, 6, rng.uniform(4.0, 8.0)))
    a, b = _assert_agree(bat.pad_rows(_rows(sets)))
    assert np.isnan(b).any()
    assert not bat.accept_bits(bat.pad_rows(_rows(sets)), b).any()


def test_torch_backend_infinite_wcet_interferer():
    rows = [[("hi", float("inf"), 20.0, 3), ("mid", 1.0, 20.0, 2),
             ("lo", 1.0, 40.0, 1)],
            [("a", 2.0, 10.0, 2), ("b", 3.0, 30.0, 1)]]
    a, b = _assert_agree(bat.pad_rows(rows))
    assert np.isnan(b[0]).all()          # hi skipped, the rest diverge
    assert b[1, :2].tolist() == [2.0, 5.0]


def test_torch_backend_mixed_padding():
    rows = (_random_rows(1, seed=10, max_tasks=2)
            + _random_rows(1, seed=11, max_tasks=15, max_util=1.2)
            + _random_rows(1, seed=12, max_tasks=1))
    _assert_agree(bat.pad_rows(rows))


def test_torch_backend_empty_and_degenerate_shapes():
    assert bat.batched_schedulable([], backend="torch", device="cpu") == []
    for S, T in ((0, 0), (3, 0)):
        empty = bat.pad_rows([[]] * S)
        assert bat.fixed_point(empty, backend="torch",
                               device="cpu").shape == (S, T)
    batch = bat.pad_rows([[("x", 1.0, 10.0, 1.0)]])
    R = bat.fixed_point(batch, backend="torch", device="cpu")
    assert R.shape == (1, 1) and R[0, 0] == 1.0
    assert bat.accept_bits(batch, R).tolist() == [True]


def test_torch_backend_analyze_mask_and_max_iter():
    """Lanes left out of ``analyze`` stay NaN but still interfere; a
    ``max_iter`` that cuts the march leaves the same lanes unsettled as
    in the numpy path."""
    batch = bat.pad_rows(_random_rows(40, seed=13))
    rng = np.random.default_rng(1)
    analyze = batch.valid & (rng.random(batch.shape) < 0.5)
    a, b = _assert_agree(batch, analyze=analyze)
    assert np.isnan(b[~analyze]).all()
    for max_iter in (1, 3, 50):
        _assert_agree(batch, max_iter=max_iter)


def test_torch_backend_schedulable_wrappers():
    """The dict-level wrappers through the torch backend: the numpy
    path's verdicts and deadlines, WCRTs within RTOL."""
    sets = [[RTTask(n, wcet=c, period=p, cores=(0,), prio=int(pr))
             for n, c, p, pr in row] for row in _random_rows(40, seed=5)]
    want = bat.batched_schedulable(sets, backend="numpy")
    got = bat.batched_schedulable(sets, backend="torch", device="cpu")
    for w, g in zip(want, got):
        assert list(w) == list(g)
        for name in w:
            assert g[name]["ok"] == w[name]["ok"]
            assert g[name]["deadline"] == w[name]["deadline"]
            if w[name]["wcrt"] is None:
                assert g[name]["wcrt"] is None
            else:
                assert g[name]["wcrt"] == pytest.approx(w[name]["wcrt"],
                                                        rel=RTOL)
    assert bat.batched_accepts(sets, backend="torch", device="cpu") == \
        bat.batched_accepts(sets, backend="numpy")


def test_numpy_path_is_the_jax_packages():
    """The copied numpy path gives the JAX package's numpy results bit for
    bit (the same code)."""
    batch_rows = _random_rows(120, seed=7, max_tasks=10)
    a = bat.fixed_point(bat.pad_rows(batch_rows), blocking=0.4,
                        backend="numpy")
    b = jbat.fixed_point(jbat.pad_rows(batch_rows), blocking=0.4,
                         backend="numpy")
    assert np.array_equal(a, b, equal_nan=True)


def _vgang_work(n_sets, seed):
    out = []
    for k in range(n_sets):
        m = (4, 8, 16)[k % 3]
        rng = random.Random(taskset_seed(seed, k, 1.1))
        jt = random_vgang_taskset(rng, m, n_tasks_for(m),
                                  rng.uniform(0.3, 2.0), "mixed")
        tasks = [RTTask(t.name, wcet=t.wcet, period=t.period,
                        cores=t.cores, prio=t.prio,
                        mem_intensity=t.mem_intensity) for t in jt]
        out.append((m, tasks, intensity_interference(tasks, 0.5)))
    return out


def test_vgang_batched_verdicts_through_torch_backend(monkeypatch):
    """vgang/rta's shard-batched entry points with ``backend="torch"``
    (here on the CPU) give the numpy backend's verdicts: singleton vgangs
    (the rtgang column) and RTG-throttle with and without reclaim."""
    monkeypatch.setattr(bat, "fixed_point",
                        functools.partial(bat.fixed_point, device="cpu"))
    work = _vgang_work(45, seed=8)
    singles = [assign_priorities(singleton_vgangs(t)) for _, t, _ in work]
    packed = [assign_priorities(HEURISTICS["intfaware"](t, m, i))
              for m, t, i in work]
    intfs = [i for _, _, i in work]
    assert vrta.batched_accepts(singles, intfs, backend="torch") == \
        vrta.batched_accepts(singles, intfs, backend="numpy")
    for reclaim in (False, True):
        assert vrta.batched_accepts_rtg_throttle(
            packed, intfs, reclaim=reclaim, backend="torch") == \
            vrta.batched_accepts_rtg_throttle(
                packed, intfs, reclaim=reclaim, backend="numpy")
    assert sorted(HEURISTICS) == sorted(JHEURISTICS)


def test_default_backend_reads_the_environment(monkeypatch):
    for env, want in (("torch", "torch"), (" NumPy ", "numpy"),
                      ("jax", "numpy"), ("", "numpy")):
        monkeypatch.setenv("REPRO_RTA_BACKEND", env)
        assert bat.default_backend() == want
    batch = bat.pad_rows([[("x", 1.0, 10.0, 1.0)]])
    with pytest.raises(ValueError, match="unknown RTA backend"):
        bat.fixed_point(batch, backend="jax")


def test_torch_backend_defaults_to_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would run")
    batch = bat.pad_rows([[("x", 1.0, 10.0, 1.0)]])
    with pytest.raises(RuntimeError, match="CUDA"):
        bat.fixed_point(batch, backend="torch")


def test_chip_smoke_tasksets_are_the_jax_generators():
    """chip_smoke.py phase (j) draws its shards with its own copies of the
    sweep's and the grid's generators: they give the JAX package's task
    sets."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    for seed, k, u in ((0, 3, 1.0), (2, 17, 1.3), (1, 0, 2.0)):
        a = random_gang_taskset(random.Random(taskset_seed(seed, k, u)),
                                8, 6, u)
        b = chip_smoke.random_gang_taskset(
            random.Random(chip_smoke.taskset_seed(seed, k, u)), 8, 6, u)
        assert _rows([a]) == _rows([b])
        assert [(t.cores, t.release_offset) for t in a] == \
            [(t.cores, t.release_offset) for t in b]
        for m in (4, 8, 16):
            for dist in ("light", "mixed", "heavy"):
                assert chip_smoke.n_tasks_for(m) == n_tasks_for(m)
                a = random_vgang_taskset(random.Random(k), m,
                                         n_tasks_for(m), u, dist)
                b = chip_smoke.random_vgang_taskset(random.Random(k), m,
                                                    n_tasks_for(m), u, dist)
                assert [(t.name, t.wcet, t.period, t.cores, t.prio,
                         t.mem_intensity) for t in a] == \
                    [(t.name, t.wcet, t.period, t.cores, t.prio,
                      t.mem_intensity) for t in b]
    rows, grid = chip_smoke.rta_shards()
    assert len(rows) == 500 and len(grid) == 4050
    assert max(len(r) for r in grid) == 11
    assert math.isclose(sum(len(r) for r in grid),
                        50 * 9 * 3 * (5 + 7 + 11))
