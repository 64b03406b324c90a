"""bf16 matmul inputs across ranks: the sharded dense8 sweep's operands
(``bpmf_tpu/parallel/spmd.py:1035-1060``: the frozen side rounded, and the
packed products of the float32 side, rounded, which is not one device's
rounding), and chains at 2 gloo ranks on the CPU.  The buckets in gather,
halo, reduce and chunked reduce mode against the JAX package at
n_devices 2 at bf16; the sharded dense8 chain, which the JAX package
cannot run at bf16 on XLA's CPU, against the port's one-device bf16 chain
within MULTI_BAND (chip_smoke.py's 0.005: the split pipeline against the
megakernel, the sharded operand's rounding against one device's)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bpmf_tpu.ops import dense8 as jax_d8
from bpmf_tpu.ops import pallas_solve as jax_ps
from bpmf_tpu_torch.models.bpmf import SideState
from bpmf_tpu_torch.ops import dense8 as d8
from bpmf_tpu_torch.ops.mvnormal import HyperParams
from bpmf_tpu_torch.parallel import spmd
from bpmf_tpu_torch.parallel.launch import run_ranks
from bpmf_tpu_torch.parallel.mesh import Mesh
from tests.test_torch_multi import (
    N_ITERS,
    _d8_data,
    _sparse_data,
    jax_chain,
    recorded_draws,
)
from tests.torch_ranks import chain, chains

torch.set_num_threads(1)

MULTI_BAND = 0.005
TOL = 1e-4   # the JAX package at bf16: the same roundings, f32 sums in other
             # orders over ranks, and a bf16 rounding that such a sum's last
             # bit can flip


@pytest.fixture(autouse=True)
def ungrouped(monkeypatch):
    for var in ("BPMF_TRI_GROUPED", "BPMF_D8_SOLVE", "BPMF_D8_PT",
                "BPMF_TRI_ALIGNED_MM"):
        monkeypatch.delenv(var, raising=False)
    jax_ps._tri_grouped_reset()
    yield
    jax_ps._tri_grouped_reset()


@pytest.mark.parametrize("orientation", ["rows", "cols"])
def test_sharded_operands_bf16(orientation, monkeypatch):
    """The sharded sweep on one rank (a group-less mesh) with the hoisted
    Gram: the Gram kernel receives the frozen side rounded to bf16 and the
    packed products of the float32 side rounded to bf16, bit for bit the
    JAX package's ``packed_tri_t(other.T).astype(bf16)``, which differs
    from one device's products of the rounded side."""
    rng = np.random.default_rng(5)
    k, n = 16, 512
    other = (0.5 * rng.normal(size=(n, k))).astype(np.float32)
    codes = np.where(rng.random((n, n)) < 0.1, rng.integers(1, 6, (n, n)), 0
                     ).astype(np.int8)
    seen = []
    name = "dense8_gram_rhs_" + orientation
    real = getattr(spmd, name)

    def keep(c, p_t, v_t, cs, cb, max_degree=None):
        seen.append((p_t, v_t))
        return real(c, p_t, v_t, cs, cb, max_degree=max_degree)

    monkeypatch.setattr(spmd, name, keep)
    items = torch.zeros((n, k))
    state = SideState(items=items, hp=None, sum=None, cov=None, norm=None,
                      aggr_mu=None, aggr_prod=None)
    w = rng.normal(size=(k, k))
    lam = torch.from_numpy((w @ w.T / k + np.eye(k)).astype(np.float32))
    hp = HyperParams(mu=torch.zeros(k), lambda_f=lam,
                     lambda_l=torch.linalg.cholesky(lam))
    out = spmd.dense8_half_sweep_sharded(
        Mesh(rank=0, size=1, device=torch.device("cpu")), state,
        torch.from_numpy(codes), torch.from_numpy(other), hp,
        torch.from_numpy(rng.normal(size=(n, k)).astype(np.float32)), 0, num=n,
        local_valid=torch.ones(n), alpha=2.0, burnin=1, cs=0.7, cb=-1.3,
        orientation=orientation, route="hoisted", matmul_dtype=torch.bfloat16)
    assert torch.isfinite(out.items).all()
    (p_t, v_t), = seen
    o_j = jnp.asarray(other)
    want_v = np.asarray(o_j.T.astype(jnp.bfloat16).astype(jnp.float32))
    want_p = np.asarray(jax_d8.packed_tri_t(o_j.T).astype(jnp.bfloat16)
                        .astype(jnp.float32))
    assert v_t.dtype == p_t.dtype == torch.bfloat16
    np.testing.assert_array_equal(v_t.float().numpy(), want_v)
    np.testing.assert_array_equal(p_t.float().numpy(), want_p)
    one_device = d8.packed_tri_t(v_t.float()).to(torch.bfloat16)
    assert not torch.equal(p_t, one_device)


def _cases():
    """name -> (train, test, port kwargs, JAX kwargs, draws), all at bf16
    (names of their own: tests.test_torch_multi.jax_chain caches by name)."""
    bf = dict(matmul_dtype="bfloat16", nsims=N_ITERS, burnin=1)
    d8_data, sp = _d8_data(), _sparse_data()
    d8_draws = recorded_draws(d8_data[0], 16, N_ITERS)
    sp_draws = recorded_draws(sp[0], 6, N_ITERS)
    bucketed = dict(bf, num_latent=6, gram_impl="bucketed")
    return {
        "bf16_dense8": (*d8_data, dict(bf, num_latent=16), None, d8_draws),
        "bf16_gather": (*sp, dict(bucketed, halo="off"), dict(solver="vpu"), sp_draws),
        "bf16_halo": (*sp, dict(bucketed, halo="on"), dict(solver="vpu"), sp_draws),
        "bf16_reduce": (*sp, dict(bucketed, comm_mode="reduce",
                                  reduce_chunked="off"), dict(solver="vpu"), sp_draws),
        "bf16_reduce_chunked": (*sp, dict(bucketed, comm_mode="reduce",
                                          reduce_chunked="on"),
                                dict(solver="vpu"), sp_draws),
    }


@pytest.fixture(scope="module")
def cases():
    return _cases()


@pytest.fixture(scope="module")
def two_ranks(cases):
    """Every case at 2 gloo ranks in one spawn, and at one device here."""
    jobs = {name: (train, test, kw, N_ITERS, draws)
            for name, (train, test, kw, _, draws) in cases.items()}
    return {2: run_ranks(chains, 2, jobs, device="cpu", threads=1,
                         timeout_s=600)[0],
            1: {name: chain(None, *job) for name, job in jobs.items()}}


@pytest.mark.parametrize("name", ["bf16_gather", "bf16_halo", "bf16_reduce",
                                  "bf16_reduce_chunked"])
def test_two_ranks_buckets_bf16_match_jax(cases, two_ranks, name):
    """The buckets at bf16 on 2 ranks in each exchange against the JAX
    package at n_devices 2 and bf16: per-iteration metrics and both tables
    within 1e-4."""
    got, want = two_ranks[2][name], jax_chain(cases, name, 2)
    assert got["n_devices"] == 2
    assert {s: r[0] for s, r in got["routes"].items()} == want["impl"]
    for side in ("users", "movies"):
        np.testing.assert_allclose(got[side], want[side], rtol=TOL, atol=TOL,
                                   err_msg=side)
    np.testing.assert_allclose(got["metrics"], want["metrics"], rtol=TOL, atol=TOL)


def test_two_ranks_dense8_bf16_near_one_device(two_ranks):
    """The sharded dense8 chain at bf16 on 2 ranks (#3 and #5 on each rank's
    user rows) against the one-device bf16 chain (#1): rmse_avg of every
    iteration within MULTI_BAND, both tables within chip_smoke.py's
    MULTI_TABLES (1e-3), and the routes each takes."""
    two, one = two_ranks[2]["bf16_dense8"], two_ranks[1]["bf16_dense8"]
    assert two["routes"] == {"movs": ("dense8", "inkernel"),
                             "users": ("dense8", "inkernel")}
    assert one["routes"] == {"movs": ("dense8", "fused"),
                             "users": ("dense8", "fused")}
    assert np.isfinite(two["metrics"]).all()
    np.testing.assert_allclose(two["metrics"][1], one["metrics"][1], rtol=0,
                               atol=MULTI_BAND)
    for side in ("users", "movies"):
        np.testing.assert_allclose(two[side], one[side], rtol=0, atol=1e-3)


@pytest.mark.parametrize("name,moves", [("bf16_gather", 1e-3), ("bf16_dense8", 1e-4)])
def test_bf16_chain_differs_from_float32(cases, two_ranks, name, moves):
    """The guard for the chains: at one device the bf16 chain is not the
    float32 chain; its tables move by more than the tolerance the chains
    above are held to (4 iterations: the buckets by 4.3e-3, dense8 by
    1.7e-4, measured)."""
    train, test, kw, _, draws = cases[name]
    f32 = chain(None, train, test, dict(kw, matmul_dtype="float32"), N_ITERS, draws)
    assert np.abs(two_ranks[1][name]["users"] - f32["users"]).max() > moves
