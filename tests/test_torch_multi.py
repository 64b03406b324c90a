"""Multi-device chains: the port at 2 and 4 gloo ranks on the CPU against the
JAX package at n_devices 2 and 4 on the virtual CPU mesh, with the same
data, seed and injected draws, on every route this slice runs at D > 1.
Here dense8 (sharded, split pipeline) in gather and in reduce mode, and
plain and fused dense in gather mode; tests/test_torch_multi_routes.py
takes dense8 with a propagated posterior (#6) and the buckets, with the
helpers of this module.  rmse, rmse_avg and both factor tables of 4
iterations agree within the JAX package's own 2e-5
(tests/test_dense8.py:219-233); so do the port's chains at 1, 2 and 4
ranks, and gather and reduce mode on dense8.

Each group of ranks runs every case of a module in one spawn (module
fixtures), and each JAX reference runs once."""

import os

import numpy as np
import pytest
import torch

import jax

from bpmf_tpu.config import Config as JaxConfig
from bpmf_tpu.datasets import synth_movielens
from bpmf_tpu.ops import pallas_solve as jax_ps
from bpmf_tpu.sampler import BPMF as JaxBPMF
from bpmf_tpu_torch.parallel.launch import run_ranks
from tests.conftest import make_ratings
from tests.test_torch_prop import write_prop
from tests.test_torch_sampler import JaxDraws
from tests.torch_ranks import RecordedDraws, chain, chains

torch.set_num_threads(1)

TOL = 2e-5
N_ITERS = 4
SEED = 42


def _d8_data():
    return synth_movielens(n_users=300, n_movies=200, n_ratings=5000, seed=7)


def _sparse_data():
    return make_ratings(n_users=70, n_movies=45, density=0.3, seed=11)


def recorded_draws(train, k, n, seed=SEED) -> RecordedDraws:
    """The JAX sampler's draws of n iterations (``JaxDraws``), as arrays."""
    jd = JaxDraws(seed)
    ns = (train.shape[1], train.shape[0])
    hyper, noise = {}, {}
    for it in range(n):
        hyper[it] = tuple(x.numpy() for x in jd.hyper_pair(it, ns, k, torch.float32))
        noise[it] = {s: jd.noise(it, s, torch.arange(ns[s] + 1), ns[s], k,
                                 torch.float32).numpy() for s in (0, 1)}
    return RecordedDraws(hyper, noise)


def build_cases(names, tmp_path_factory) -> dict:
    """name -> (train, test, port Config kwargs, JAX Config kwargs, draws)
    for the named cases.  The JAX side forces its TPU routes off the TPU
    (dense8 as in tests/test_dense8.py:113-120, the fused dense kernel in
    interpret mode) and takes solver vpu where the port's smart runs #8's
    plain version (the same math)."""
    d8_kw = dict(num_latent=16, nsims=N_ITERS, burnin=1)
    sp_kw = dict(num_latent=6, nsims=N_ITERS, burnin=1)
    out = {}
    if any(n.startswith("dense8") for n in names):
        d8 = _d8_data()
        d8_draws = recorded_draws(d8[0], 16, N_ITERS)
        out["dense8_gather"] = (*d8, d8_kw, dict(gram_impl="dense8"), d8_draws)
        out["dense8_reduce"] = (*d8, dict(d8_kw, comm_mode="reduce"),
                                dict(gram_impl="dense8", comm_mode="reduce"), d8_draws)
        if "dense8_prop" in names:
            prop = write_prop(tmp_path_factory.mktemp("prop"), 16, 300, seed=1,
                              name="u")
            out["dense8_prop"] = (*d8, dict(d8_kw, prop_u=prop),
                                  dict(gram_impl="dense8", prop_u=prop), d8_draws)
    if {"dense", "fused", "bucketed"} & set(names):
        sparse = _sparse_data()
        sp_draws = recorded_draws(sparse[0], 6, N_ITERS)
        out["dense"] = (*sparse, dict(sp_kw, gram_impl="dense", fuse_dense="off"),
                        dict(gram_impl="dense", fuse_dense="off", solver="vpu"),
                        sp_draws)
        out["fused"] = (*sparse, dict(sp_kw, gram_impl="dense"),
                        dict(gram_impl="dense", fuse_dense="on", solver="pallas"),
                        sp_draws)
        out["bucketed"] = (*sparse, dict(sp_kw, gram_impl="bucketed"),
                           dict(gram_impl="bucketed", solver="vpu"), sp_draws)
    return {name: out[name] for name in names}


CASES = ("dense8_gather", "dense8_reduce", "dense", "fused")
ROUTES = {"dense8_gather": ("dense8", "inkernel"), "dense8_reduce": ("dense8", "inkernel"),
          "dense8_prop": ("dense8", "inkernel"), "dense": ("dense", "plain"),
          "fused": ("dense", "fused"), "bucketed": ("bucketed", None)}


@pytest.fixture(autouse=True)
def ungrouped(monkeypatch):
    for var in ("BPMF_TRI_GROUPED", "BPMF_D8_SOLVE", "BPMF_D8_PT",
                "BPMF_TRI_ALIGNED_MM"):
        monkeypatch.delenv(var, raising=False)
    jax_ps._tri_grouped_reset()
    yield
    jax_ps._tri_grouped_reset()


def port_results(cases) -> dict:
    """The port's results of every case at 1 (in this process), 2 and 4
    ranks (one spawn each), from rank 0."""
    jobs = {name: (train, test, kw, N_ITERS, draws)
            for name, (train, test, kw, _, draws) in cases.items()}
    out = {1: {name: chain(None, *job) for name, job in jobs.items()}}
    for d in (2, 4):
        out[d] = run_ranks(chains, d, jobs, device="cpu", threads=1,
                           timeout_s=600)[0]
    return out


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    return build_cases(CASES, tmp_path_factory)


@pytest.fixture(scope="module")
def port(cases):
    return port_results(cases)


_JAX = {}


def jax_chain(cases, name, d):
    """The JAX package's metrics [4, n] and factor tables for one case at
    n_devices d, computed once."""
    if (name, d) not in _JAX:
        train, test, kw, jkw, _ = cases[name]
        ref = JaxBPMF(JaxConfig(n_devices=d, **dict(kw, **jkw)), train=train,
                      test=test, out=open(os.devnull, "w"))
        ref.setup()
        mets = [jax.device_get(ref.step()) for _ in range(N_ITERS)]
        _JAX[name, d] = {
            "metrics": np.asarray([[float(getattr(m, f)) for m in mets]
                                   for f in ("rmse", "rmse_avg", "norm_users",
                                             "norm_movies")]),
            "users": ref.items_host(ref.users, ref.state_u),
            "movies": ref.items_host(ref.movies, ref.state_m),
            "impl": {"movs": ref.movies.impl, "users": ref.users.impl}}
    return _JAX[name, d]


def _agree(got, want, what):
    for side in ("users", "movies"):
        np.testing.assert_allclose(got[side], want[side], rtol=TOL, atol=TOL,
                                   err_msg=f"{what}: {side}")
    np.testing.assert_allclose(got["metrics"], want["metrics"], rtol=TOL,
                               atol=TOL, err_msg=f"{what}: metrics")


def check_port_matches_jax(cases, port, name, d):
    got, want = port[d][name], jax_chain(cases, name, d)
    assert got["n_devices"] == d
    assert {s: r[0] for s, r in got["routes"].items()} == want["impl"]
    assert got["routes"]["movs"] == got["routes"]["users"] == ROUTES[name]
    assert got["mode"] == ("reduce" if name == "dense8_reduce" else "gather")
    _agree(got, want, f"{name} at {d} ranks")


def check_rank_count_invariance(port, name):
    one = port[1][name]
    for d in (2, 4):
        _agree(port[d][name], one, f"{name}: {d} ranks against 1")
    if name.startswith("dense8") and name != "dense8_prop":
        assert one["routes"]["movs"] == ("dense8", "fused")


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("name", CASES)
def test_port_matches_jax(cases, port, name, d):
    """The port at d gloo ranks against the JAX package at n_devices d:
    per-iteration rmse, rmse_avg and norms, and both factor tables, within
    2e-5; both take the same routes."""
    check_port_matches_jax(cases, port, name, d)


@pytest.mark.parametrize("name", CASES)
def test_rank_count_invariance(port, name):
    """The same chain at 1, 2 and 4 ranks, within 2e-5: noise is keyed by
    original id and the stats are summed over ranks, so only the order of
    the sums differs.  At one rank dense8 takes the megakernel (#1), at
    more the split pipeline, as in the JAX package."""
    check_rank_count_invariance(port, name)


@pytest.mark.parametrize("d", [2, 4])
def test_gather_matches_reduce(port, d):
    """On dense8 data, reduce mode rides the sharded dense8 program: the
    same trajectory as gather mode, and the same collectives: per
    iteration one all_gather of the movies (users' sweep), one
    reduce_scatter of the Gram and rhs (movies' sweep), one all_reduce of
    the stats a sweep and of the errors, and the evaluation's two
    all_gathers; two more all_gathers for the tables read at the end."""
    g, r = port[d]["dense8_gather"], port[d]["dense8_reduce"]
    _agree(r, g, f"reduce against gather at {d} ranks")
    want = {"all_gather": 3 * N_ITERS + 2, "reduce_scatter": N_ITERS,
            "all_reduce": 3 * N_ITERS, "ppermute": 0}
    assert g["collectives"] == want
    assert r["collectives"] == want
