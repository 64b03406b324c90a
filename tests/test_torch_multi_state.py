"""State across rank counts on the CPU (gloo ranks): a checkpoint written at 2
ranks equals the one written at 1 and resumes at 1 and at 4 ranks on the
one-rank trajectory (tests/test_checkpoint.py:43); the six output files of
``-o`` at 2 ranks equal those of one rank (tests/test_spmd.py:107-119); and
a JAX state of 4 devices, loaded into 2 port ranks, takes the same step as
the JAX package."""

import os

import numpy as np
import pytest
import torch

import jax

from bpmf_tpu.config import Config as JaxConfig
from bpmf_tpu.io import read_matrix
from bpmf_tpu.sampler import BPMF as JaxBPMF
from bpmf_tpu_torch.parallel.launch import run_ranks
from tests.conftest import make_ratings
from tests.test_torch_multi import recorded_draws
from tests.torch_ranks import resumed_step, runs

torch.set_num_threads(1)

TOL = 2e-5
OUTPUTS = ("Pavg.sdm", "Pm2.sdm", "U-mu.ddm", "U-Lambda.ddm", "V-mu.ddm",
           "V-Lambda.ddm")
N_OUT = 12           # iterations of the -o -v run: 9 samples past burn-in
DUMPS = tuple(f"{p}-{i}.ddm" for p in "UV" for i in range(N_OUT))
KW = dict(num_latent=4, burnin=3, seed=11)


@pytest.fixture(scope="module")
def data():
    return make_ratings(seed=9)


@pytest.fixture(scope="module")
def state_runs(data, tmp_path_factory):
    """One rank: 10 iterations straight, 5 with a checkpoint, 12 with -o -v
    (9 samples past burn-in, more than K, so each item's posterior
    covariance can be inverted).  Two ranks: the same 5 and 12.  Then the
    resume to 10 at 1 rank (in this process) and at 4 ranks."""
    train, test = data
    tmp = tmp_path_factory.mktemp("state")
    path = {d: str(tmp / f"c{d}.npz") for d in (1, 2)}
    odir = {d: str(tmp / f"out{d}") for d in (1, 2)}
    jobs = {d: {"first": (train, test, dict(KW, nsims=5, checkpoint_path=path[d])),
                "outputs": (train, test, dict(KW, nsims=N_OUT, output_dir=odir[d],
                                              verbose=True))}
            for d in (1, 2)}
    resume = (train, test, dict(KW, nsims=10, resume=path[2], seed=0))
    out = {"path": path, "odir": odir}
    out[1] = runs(None, {"straight": (train, test, dict(KW, nsims=10)), **jobs[1]})
    out[2] = run_ranks(runs, 2, jobs[2], device="cpu", threads=1,
                       timeout_s=600)[0]
    out[1].update(runs(None, {"resumed": resume}))
    out[4] = run_ranks(runs, 4, {"resumed": resume}, device="cpu",
                       threads=1, timeout_s=600)[0]
    return out


def _close(got, want, what):
    assert got["rmse_avg"] == pytest.approx(want["rmse_avg"], abs=TOL), what
    for side in ("users", "movies"):
        np.testing.assert_allclose(got[side], want[side], rtol=TOL, atol=TOL,
                                   err_msg=f"{what}: {side}")


def test_checkpoint_at_two_ranks_matches_one(state_runs):
    """The file rank 0 writes at 2 ranks holds the one-rank checkpoint's
    keys and, within 2e-5, its values: state in original order, whatever
    the rank count."""
    one, two = (dict(np.load(state_runs["path"][d])) for d in (1, 2))
    assert sorted(one) == sorted(two)
    assert int(two["iter"]) == 4
    for name in one:
        np.testing.assert_allclose(two[name], one[name], rtol=TOL, atol=TOL,
                                   err_msg=name)
    _close(state_runs[2]["first"], state_runs[1]["first"], "5 iterations")


@pytest.mark.parametrize("d", [1, 4])
def test_resume_at_any_rank_count(state_runs, d):
    """The 2-rank checkpoint resumes at 1 and at 4 ranks (the seed read
    back from its key) on the one-rank 10-iteration trajectory."""
    got = state_runs[d]["resumed"]
    assert got["iter"] == 9
    _close(got, state_runs[1]["straight"], f"resumed at {d} ranks")


@pytest.mark.parametrize("name", OUTPUTS + ("U-11.ddm", "V-0.ddm"))
def test_outputs_at_two_ranks_match_one(state_runs, name):
    """-o -v at 2 ranks: rank 0 writes the six files and every sample's
    dump, equal to one rank's within 2e-5 (Pavg/Pm2 from the gathered
    Welford state, mu and Lambda from the gathered aggregates, the dumps
    from the gathered items).  Lambda, the inverse of each item's
    sample covariance of 9 draws, is held through that covariance (its
    inverse again, in float64): the inverse multiplies the f32 differences
    of the aggregates by the covariance's condition number."""
    one, two = (state_runs["odir"][d] for d in (1, 2))
    assert sorted(os.listdir(two)) == sorted(OUTPUTS + DUMPS)

    def read(path):
        m = read_matrix(path)
        m = m.toarray() if hasattr(m, "toarray") else np.asarray(m)
        if name.endswith("Lambda.ddm"):
            k = int(round(np.sqrt(m.shape[0])))
            lam = m.reshape(k, k, -1, order="F").transpose(2, 0, 1)
            return np.linalg.inv(lam)
        return m

    want = read(os.path.join(one, name))
    np.testing.assert_allclose(read(os.path.join(two, name)), want,
                               rtol=TOL, atol=TOL)
    _close(state_runs[2]["outputs"], state_runs[1]["outputs"], "-o run")


def test_jax_four_device_state_into_two_ranks(data, tmp_path):
    """A JAX run at n_devices 4 checkpoints after 3 iterations; 2 port
    ranks load it (convert.state_from_numpy gives each its shard) and take
    iteration 3 with the JAX draws: the same metrics and factor tables as
    the JAX package's own next step, within 2e-5."""
    train, test = data
    path = str(tmp_path / "jax4.npz")
    kw = dict(num_latent=6, burnin=1, gram_impl="dense", fuse_dense="off")
    ref = JaxBPMF(JaxConfig(n_devices=4, nsims=3, checkpoint_path=path,
                            solver="vpu", **kw),
                  train=train, test=test, out=open(os.devnull, "w"))
    ref.run()
    want = jax.device_get(ref.step())
    draws = recorded_draws(train, 6, 4)
    got = run_ranks(resumed_step, 2, train, test, dict(kw, nsims=4), path,
                    draws, device="cpu", threads=1, timeout_s=600)
    assert [g["items_rows"] for g in got] == [got[0]["items_rows"]] * 2
    assert got[0]["iter"] == 3
    np.testing.assert_allclose(got[0]["metrics"], np.asarray(want, np.float64),
                               rtol=TOL, atol=TOL)
    for side, state in (("users", ref.state_u), ("movies", ref.state_m)):
        np.testing.assert_allclose(
            got[0][side], ref.items_host(getattr(ref, side), state),
            rtol=TOL, atol=TOL, err_msg=side)
