"""sweep_roofline_pct's and iter_mfu's counts against hand-worked values
for the configuration at its full size, and for a tall matrix."""

from __future__ import annotations

import json

import pytest

from benchmark import work
from benchmark.tests.helpers import REPO

# K = 32: a rating costs 32 * 33 + 64 = 1120 operations, an item
# 32^3 / 3 + 2 * 32^2 = 12,970.67; 10% of the ratings are test ratings
ML25M = dict(train=22_500_086, test=2_500_009, users=162_541, movies=59_047,
             movies_ops=25_200_096_320 + 765_878_954.67,
             users_ops=25_200_096_320 + 2_108_265_130.67,
             iter_ops=53_434_337_301.33, iter_ms=0.797527,
             sweep_ms=0.795139, sweep_bytes=112_500_430 + 28_363_264)


def _shape(config: str, n: dict) -> work.Shape:
    conf = json.loads((REPO / "benchmark/configs" / f"{config}.json").read_text())
    n_test = int(conf["n_ratings"] * conf["test_frac"])
    assert (conf["n_ratings"] - n_test, n_test) == (n["train"], n["test"])
    assert (conf["n_rows"], conf["n_cols"]) == (n["users"], n["movies"])
    return work.Shape(32, n["users"], n["movies"], n["train"], n["test"])


def test_counts():
    n = ML25M
    s = _shape("movielens-25m", n)
    movies, users = work.sweeps(s)
    assert movies.ops == pytest.approx(n["movies_ops"], rel=1e-9)
    assert users.ops == pytest.approx(n["users_ops"], rel=1e-9)
    assert movies.bytes == users.bytes == pytest.approx(n["sweep_bytes"])
    assert work.iteration_ops(s) == pytest.approx(n["iter_ops"], rel=1e-9)
    # iter_mfu's denominator: the iteration at the float32 peak
    assert work.iteration_ops(s) / 67e12 * 1e3 == pytest.approx(
        n["iter_ms"], rel=1e-5)
    t, bound = work.sweep_bound(s)
    assert bound == "operations"
    assert t * 1e3 == pytest.approx(n["sweep_ms"], rel=1e-5)


def test_roofline_share_of_a_measured_time():
    # 42.5 ms of half-sweeps an iteration at ml-25M: 0.795 / 42.5 = 1.871%
    s = _shape("movielens-25m", ML25M)
    t, _ = work.sweep_bound(s)
    assert 100 * t * 1e3 / 42.5 == pytest.approx(1.87092, rel=1e-4)


def test_bytes_bound_when_operations_are_few():
    # K = 2: 10 operations and 5 bytes a rating; bytes bound the sweep
    s = work.Shape(2, 10, 10, 10**9, 0)
    t, bound = work.sweep_bound(s)
    assert bound == "bytes"
    assert t == pytest.approx(2 * (5e9 + 4 * 2 * 20) / 3.35e12)


def test_a_tall_matrix():
    # 800,000 x 360 at K = 32, 2,587,500 training and 287,500 test
    # ratings: the compounds' 800,000 solves (12,970.67 operations each)
    # outweigh their ratings' 2,898,000,000 operations
    s = work.Shape(32, 800_000, 360, 2_587_500, 287_500)
    cols, rows = work.sweeps(s)
    assert cols.ops == pytest.approx(2_898_000_000 + 4_669_440.0, rel=1e-9)
    assert rows.ops == pytest.approx(2_898_000_000 + 10_376_533_333.33,
                                     rel=1e-9)
    assert cols.bytes == pytest.approx(12_937_500 + 102_446_080)
    assert work.iteration_ops(s) == pytest.approx(16_195_602_773.33, rel=1e-9)
    t, bound = work.sweep_bound(s)
    assert bound == "operations"
    assert t * 1e3 == pytest.approx(0.241451, rel=1e-5)
