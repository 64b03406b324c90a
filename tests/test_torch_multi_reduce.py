"""Bucketed reduce mode, plain and chunked: the port at 1, 2 and 4 ranks (gloo
on the CPU) against the JAX package at n_devices 1, 2 and 4 in reduce
mode, with the same data, seed and injected draws, with and without a
propagated posterior on both sides (``-l/-m``, its own prior mean:
``strict_reference=False``, as tests/test_spmd.py:152); chunked against plain
(tests/test_spmd.py:204); and the chunked route's memory contract: no rank
holds a tensor of padded_num rows of K x K (tests/test_spmd.py:220).

Each group of ranks runs every case in one spawn (module fixtures), and
each JAX reference runs once (the helpers of tests/test_torch_multi.py)."""

import numpy as np
import pytest
import torch

from bpmf_tpu.ops import pallas_solve as jax_ps
from bpmf_tpu_torch.parallel.launch import run_ranks
from tests.conftest import make_ratings
from tests.test_torch_multi import (
    N_ITERS,
    _agree,
    jax_chain,
    port_results,
    recorded_draws,
)
from tests.test_torch_prop import write_prop
from tests.torch_ranks import collective_shapes

torch.set_num_threads(1)

CASES = ("reduce", "reduce_chunked", "reduce_prop", "reduce_chunked_prop")
CHUNKED_TOL = 1e-4   # tests/test_spmd.py:204: another order of the sums


@pytest.fixture(autouse=True)
def ungrouped(monkeypatch):
    for var in ("BPMF_TRI_GROUPED", "BPMF_D8_SOLVE", "BPMF_D8_PT",
                "BPMF_TRI_ALIGNED_MM"):
        monkeypatch.delenv(var, raising=False)
    jax_ps._tri_grouped_reset()
    yield
    jax_ps._tri_grouped_reset()


def _data():
    return make_ratings(n_users=70, n_movies=45, density=0.3, seed=11)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """name -> (train, test, port kwargs, JAX kwargs, draws).  The JAX side
    takes solver vpu where the port's smart runs #8's plain version."""
    train, test = _data()
    tmp = tmp_path_factory.mktemp("prop")
    prop = dict(prop_u=write_prop(tmp, 6, 70, seed=1, name="u"),
                prop_v=write_prop(tmp, 6, 45, seed=2, name="v"))
    draws = recorded_draws(train, 6, N_ITERS)
    base = dict(num_latent=6, nsims=N_ITERS, burnin=1, gram_impl="bucketed",
                comm_mode="reduce")
    kws = {"reduce": dict(base, reduce_chunked="off"),
           "reduce_chunked": dict(base, reduce_chunked="on"),
           "reduce_prop": dict(base, reduce_chunked="off", strict_reference=False,
                               **prop),
           "reduce_chunked_prop": dict(base, reduce_chunked="on",
                                       strict_reference=False, **prop)}
    return {name: (train, test, kw, dict(solver="vpu"), draws)
            for name, kw in kws.items()}


@pytest.fixture(scope="module")
def port(cases):
    return port_results(cases)


@pytest.mark.parametrize("d", [1, 2, 4])
@pytest.mark.parametrize("name", CASES)
def test_port_matches_jax(cases, port, name, d):
    """The port at d ranks against the JAX package at n_devices d, both in
    reduce mode on the buckets (chunked by destination where the name
    says): per-iteration rmse, rmse_avg and norms, and both factor tables,
    within 2e-5; both sides bucketed in both packages."""
    got, want = port[d][name], jax_chain(cases, name, d)
    assert got["n_devices"] == d and got["mode"] == "reduce"
    assert {s: r[0] for s, r in got["routes"].items()} == want["impl"] == {
        "movs": "bucketed", "users": "bucketed"}
    _agree(got, want, f"{name} at {d} ranks")


@pytest.mark.parametrize("name", CASES)
def test_rank_count_invariance(port, name):
    """The same chain at 1, 2 and 4 ranks, within 2e-5: noise is drawn per
    local slot by original id, so only the order of the sums differs."""
    for d in (2, 4):
        _agree(port[d][name], port[1][name], f"{name}: {d} ranks against 1")


@pytest.mark.parametrize("d", [1, 2, 4])
def test_chunked_matches_plain(port, d):
    """The chunked exchange (an all_reduce a destination) against the one
    reduce_scatter, with and without the propagated posterior, within
    1e-4; and the collectives each takes per iteration: plain, one
    reduce_scatter a sweep; chunked, D all_reduces a sweep; neither an
    all_gather of the frozen side (the evaluation's two all_gathers and
    its all_reduce, and the tables read at the end, as in gather mode)."""
    for plain, chunked in (("reduce", "reduce_chunked"),
                           ("reduce_prop", "reduce_chunked_prop")):
        a, b = port[d][plain], port[d][chunked]
        for side in ("users", "movies"):
            np.testing.assert_allclose(b[side], a[side], rtol=CHUNKED_TOL,
                                       atol=CHUNKED_TOL)
        np.testing.assert_allclose(b["metrics"], a["metrics"], rtol=CHUNKED_TOL,
                                   atol=CHUNKED_TOL)
        if d > 1:
            evals = {"all_gather": 2 * N_ITERS + 2, "ppermute": 0}
            assert a["collectives"] == dict(evals, reduce_scatter=2 * N_ITERS,
                                            all_reduce=3 * N_ITERS)
            assert b["collectives"] == dict(evals, reduce_scatter=0,
                                            all_reduce=(2 * d + 3) * N_ITERS)


@pytest.fixture(scope="module")
def shapes():
    """Every tensor one iteration makes on each of 4 ranks, with padded_num
    rows of at least K*K, plain and chunked (``collective_shapes``)."""
    train, test = _data()
    kw = dict(num_latent=6, nsims=1, gram_impl="bucketed", comm_mode="reduce")
    jobs = {c: (train, test, dict(kw, reduce_chunked=c)) for c in ("off", "on")}
    return run_ranks(collective_shapes, 4, jobs, device="cpu", threads=1,
                     timeout_s=600)


def test_chunked_holds_no_global_buffer(shapes):
    """At 4 ranks, the chunked route makes no tensor of padded_num rows of
    K x K (or of the packed K*K + K) on any rank, and its collectives carry
    [local_pad, K*K + K] at most; the plain route, watched the same way,
    does make its [padded_num, K*K + K] buffer and reduce-scatters it."""
    k = 6
    for rank, out in enumerate(shapes):
        pn = out["padded_num"]
        assert min(pn.values()) > max(out["local_pad"].values())
        assert out["on"]["big"] == [], (rank, out["on"]["big"])
        for name, shape in out["on"]["log"]:
            assert name != "reduce_scatter" and shape[0] not in pn.values(), shape
        assert ("reduce_scatter", (pn["movs"], k * k + k)) in out["off"]["log"]
        assert (pn["movs"], k * k + k) in out["off"]["big"]
        assert (pn["users"], k * k + k) in out["off"]["big"]
        assert sorted(out["on"]["log"]).count(
            ("all_reduce", (out["local_pad"]["users"], k * k + k))) == 4
