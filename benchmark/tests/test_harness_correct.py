"""What decides ``correct``, on the CPU at a size a test run holds: the
program passes; the control (the reference in float32 with TF32 matmul
operands, put in the program's place) fails each cell's limits; and a run
with the timed path broken underneath comes out not correct, once for
each fault a cell can have (its state returned unchanged, half of the
batch left out, an answer altered where it is produced: an item, a
prediction, one entry's M2, the drawn hyperprior mean).  The cells run on
one card, so no exchange between chips can be left out."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import run
from benchmark.tests.helpers import REPO, SEED, TINY, make_root
from bpmf_tpu_torch import sampler as smod
from bpmf_tpu_torch.models.bpmf import EvalData, EvalState

CELLS = [w["traffic"] for w in
         json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


def _limits(cell):
    return json.loads((REPO / "benchmark/cells" / f"{cell}.json").read_text())[
        "limits"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


def _run(root):
    return run.run_cell(TINY, SEED, 0.3, False, device="cpu", root=root)


def _failed(result) -> set:
    return {n for n, c in result["compared"].items() if c["value"] > c["limit"]}


def test_the_program_is_correct(root):
    r = _run(root)
    assert r["correct"] and not _failed(r)
    assert r["failed"] == 0 and r["attempted"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_cells_limits(tmp_path, cell):
    # the cell's own K, values and limits, on its configuration's laws at a
    # small size
    small = make_root(tmp_path, like=cell, k=32)
    r = run.run_cell(TINY, SEED + 1, 0.3, False, device="cpu", root=small,
                     with_control=True)
    assert r["correct"], r["compared"]
    got, limits = r["control"], _limits(cell)
    assert any(got[n] > lim for n, lim in limits.items()), (cell, got)


def _keep_half(orig):
    def sweep(self, side, state, *a, **kw):
        new = orig(self, side, state, *a, **kw)
        items = new.items.clone()
        half = items.shape[0] // 2
        items[half:] = state.items[half:]
        return new._replace(items=items)
    return sweep


def _alter_one(orig):
    def sweep(self, side, state, *a, **kw):
        new = orig(self, side, state, *a, **kw)
        items = new.items.clone()
        items[int(side.maps.orig_to_padded[0])] += 0.5
        return new._replace(items=items)
    return sweep


def _predict_half(orig):
    def predict(ev, est, users, movies, it, **kw):
        h = ev.t_val.shape[0] // 2
        new, rmse, rmse_avg = orig(
            EvalData(ev.t_user[:h], ev.t_item[:h], ev.t_val[:h]),
            EvalState(est.pavg[:h], est.pm2[:h]), users, movies, it, **kw)
        return EvalState(torch.cat([new.pavg, est.pavg[h:]]),
                         torch.cat([new.pm2, est.pm2[h:]])), rmse, rmse_avg
    return predict


def _predict_altered(orig):
    def predict(*a, **kw):
        est, rmse, rmse_avg = orig(*a, **kw)
        pavg = est.pavg.clone()
        pavg[0] += 0.5
        return est._replace(pavg=pavg), rmse, rmse_avg
    return predict


def _m2_altered(orig):
    def predict(*a, **kw):
        est, rmse, rmse_avg = orig(*a, **kw)
        pm2 = est.pm2.clone()
        pm2[0] += 1e-3
        return est._replace(pm2=pm2), rmse, rmse_avg
    return predict


def _hyper_mean_off(orig):
    # the movies' drawn mean 2% off
    def sample(*a, **kw):
        hp_m, hp_u = orig(*a, **kw)
        return hp_m._replace(mu=hp_m.mu * 1.02), hp_u
    return sample


FAULTS = {
    "state_unchanged": ("_sweep", lambda orig: (
        lambda self, side, state, *a, **kw: state), "items"),
    "half_of_the_items": ("_sweep", _keep_half, "items"),
    "half_of_the_test_set": ("predict", _predict_half, "eval"),
    "one_item_altered": ("_sweep", _alter_one, "items"),
    "one_prediction_altered": ("predict", _predict_altered, "eval"),
    "one_m2_entry_altered": ("predict", _m2_altered, "m2"),
    "hyper_mean_off": ("sample_hyper_pair", _hyper_mean_off, "hyper"),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, fault):
    attr, make, number = FAULTS[fault]
    if attr in ("predict", "sample_hyper_pair"):
        monkeypatch.setattr(smod, attr, make(getattr(smod, attr)))
    else:
        monkeypatch.setattr(smod.BPMF, attr, make(getattr(smod.BPMF, attr)))
    r = _run(root)
    assert not r["correct"]
    assert number in _failed(r)
