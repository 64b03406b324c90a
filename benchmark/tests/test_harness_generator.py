"""The generator at a small scale on the CPU: the same seed gives the same
matrices, every seed the configuration's counts, and each cell's value
model its grid; beside them a tall activity matrix on the Pareto law, with
pXC50 values to 0.01."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import generator as gen
from benchmark.tests.helpers import REPO


def _conf(name, **small):
    c = json.loads((REPO / "benchmark/configs" / f"{name}.json").read_text())
    c.update(small)
    return c


def _levels(vals):
    return int(torch.unique(vals).numel())


def _cell(name):
    return json.loads((REPO / "benchmark/cells" / f"{name}.json").read_text())


# a tall matrix: Zipf 1.1 over 90 targets, Pareto 2 over 20,000 compounds,
# pXC50 = 2 + 1.25 x score to 0.01 in [3, 11]
TALL = dict(n_rows=20_000, n_cols=90, n_ratings=50_000, test_frac=0.1,
            row_law={"law": "pareto", "a": 2.0, "floor": 0.1},
            col_law={"law": "zipf", "exponent": 1.1}, latent_rank=6,
            latent_sd=0.6, offset=3.6, noise_sd=0.4)
PIC50 = {"shift": 2.0, "scale": 1.25, "step": 0.01, "lo": 3.0, "hi": 11.0}

SMALL = {
    "ml25m.k32": (_conf("movielens-25m", n_rows=4000, n_cols=1500,
                        n_ratings=60_000), _cell("ml25m.k32")["values"]),
    "tall.pic50": (TALL, PIC50),
}


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_same_seed_same_data_and_counts(cell):
    conf, vm = SMALL[cell]
    a = gen.make_data(conf, vm, 2**31 + 7, "cpu")
    b = gen.make_data(conf, vm, 2**31 + 7, "cpu")
    c = gen.make_data(conf, vm, 2**31 + 8, "cpu")
    for x, y in zip(a.train + a.test, b.train + b.test):
        assert torch.equal(x, y)
    assert not torch.equal(a.train.rows, c.train.rows)
    n_test = int(conf["n_ratings"] * conf["test_frac"])
    for d in (a, c):
        assert d.shape == (conf["n_rows"], conf["n_cols"])
        assert d.test.rows.numel() == n_test
        assert d.train.rows.numel() == conf["n_ratings"] - n_test
        keys = torch.cat([d.train.rows * conf["n_cols"] + d.train.cols,
                          d.test.rows * conf["n_cols"] + d.test.cols])
        assert torch.unique(keys).numel() == conf["n_ratings"]
        assert int(keys.min()) >= 0
        assert int(keys.max()) < conf["n_rows"] * conf["n_cols"]


def test_half_star_grid():
    vals = gen.make_data(*SMALL["ml25m.k32"], 11, "cpu").train.vals
    assert set(torch.unique(vals).tolist()) <= {x / 2 for x in range(1, 11)}
    assert _levels(vals) == 10


def test_pic50_grid_is_off_dense8s_levels():
    vals = gen.make_data(*SMALL["tall.pic50"], 13, "cpu").train.vals
    assert float(vals.min()) >= 3.0 and float(vals.max()) <= 11.0
    hundredths = vals * 100
    assert torch.allclose(hundredths, torch.round(hundredths), atol=1e-6)
    # more levels than dense8's 255 codes: the buckets take both sides
    assert _levels(vals) > 255


def test_degree_laws_skew():
    d = gen.make_data(*SMALL["tall.pic50"], 14, "cpu")
    rows = torch.bincount(d.train.rows, minlength=d.shape[0]).numpy()
    cols = torch.bincount(d.train.cols, minlength=d.shape[1]).numpy()
    # Zipf 1.1 over the targets: the most-rated target holds a large share
    assert cols.max() > 0.1 * cols.sum()
    # Pareto over the compounds: most compounds have a handful of ratings
    assert (rows <= 3).mean() > 0.5


def test_to_csc_keeps_every_rating():
    d = gen.make_data(*SMALL["ml25m.k32"], 15, "cpu")
    m = gen.to_csc(d.train, d.shape).tocoo()
    got = sorted(zip(m.row.tolist(), m.col.tolist(), m.data.tolist()))
    want = sorted(zip(d.train.rows.tolist(), d.train.cols.tolist(),
                      d.train.vals.tolist()))
    assert got == want
