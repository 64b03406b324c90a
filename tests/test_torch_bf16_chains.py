"""bf16 matmul inputs, whole chains on one device: 3 iterations of the
dense, fused dense and bucketed (gather and reduce mode) chains against
the JAX sampler at bf16 with its draws injected; the dense8 chain, which
the JAX sampler cannot run at bf16 on XLA's CPU (its dot has no bf16 x
bf16 = f32), against the same chain whose half-sweeps are the JAX
package's eager ``dense8_half_sweep`` (interpret mode) on every route; and
the final all-items evaluation on bf16 tables, against the JAX package's
``predict`` and through ``run()``."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bpmf_tpu.config import Config as JaxConfig
from bpmf_tpu.models import bpmf as jax_model
from bpmf_tpu.models.bpmf import SideState as JaxSideState
from bpmf_tpu.ops import pallas_solve as jax_ps
from bpmf_tpu.ops.mvnormal import HyperParams as JaxHyperParams
from bpmf_tpu.parallel import spmd as jax_spmd
from bpmf_tpu.sampler import BPMF as JaxBPMF
from bpmf_tpu_torch import sampler as port_sampler
from bpmf_tpu_torch.config import Config
from bpmf_tpu_torch.models import bpmf as port_model
from bpmf_tpu_torch.models.bpmf import SideState
from bpmf_tpu_torch.sampler import BPMF
from tests.test_torch_routes import _ratings
from tests.test_torch_sampler import JaxDraws
from tests.test_torch_split import _chains_agree, _small_data

torch.set_num_threads(1)

K = 16
METRIC_TOL = 1e-4   # per-iteration metrics: the same roundings, f32 sums in
ITEMS_TOL = 1e-3    # other orders; the factor tables after 3 iterations


@pytest.fixture(autouse=True)
def knobs(monkeypatch):
    for var in ("BPMF_TRI_GROUPED", "BPMF_D8_SOLVE", "BPMF_D8_PT",
                "BPMF_D8_FOLD", "BPMF_TRI_ALIGNED_MM"):
        monkeypatch.delenv(var, raising=False)
    jax_ps._tri_grouped_reset()
    yield
    jax_ps._tri_grouped_reset()


@pytest.mark.parametrize("route", ["dense", "fused", "bucketed", "reduce"])
def test_chain_bf16_matches_jax(route):
    """3 iterations off the grid at K=16, burn-in 1, bf16 matmul inputs in
    both packages, JAX's draws injected: metrics within 1e-4, tables 1e-3.
    The JAX side forces its TPU route and a solver of the port's smart's
    math (vpu; the Pallas kernel in interpret mode on the fused route)."""
    train, test = _ratings(offgrid=True)
    kw = dict(num_latent=K, nsims=3, burnin=1, n_devices=1,
              matmul_dtype="bfloat16")
    jax_kw, port_kw = {
        "dense": (dict(gram_impl="dense", fuse_dense="off", solver="vpu"),
                  dict(fuse_dense="off")),
        "fused": (dict(gram_impl="dense", fuse_dense="on", solver="pallas"), {}),
        "bucketed": (dict(gram_impl="bucketed", solver="vpu"),
                     dict(gram_impl="bucketed")),
        "reduce": (dict(gram_impl="bucketed", comm_mode="reduce", solver="vpu"),
                   dict(gram_impl="bucketed", comm_mode="reduce")),
    }[route]
    ref = JaxBPMF(JaxConfig(**jax_kw, **kw), train=train, test=test,
                  out=open(os.devnull, "w"))
    port = BPMF(Config(**port_kw, **kw), train, test, out=open(os.devnull, "w"),
                device="cpu", draws=JaxDraws(42))
    ref.setup()
    port.setup()
    impl = "bucketed" if route in ("bucketed", "reduce") else "dense"
    assert ref.movies.impl == ref.users.impl == port.movies.impl == impl
    assert port._md == torch.bfloat16
    _chains_agree(ref, port, tol=METRIC_TOL, items_tol=ITEMS_TOL)


class JaxDense8Sweeps:
    """The port sampler's dense8 half-sweep replaced by the JAX package's
    eager ``dense8_half_sweep`` (interpret mode, bf16 matmul inputs): the
    port's state, hyperprior and frozen side in, the JAX package's new
    state out; its noise from the key that ``JaxDraws`` draws the port's
    from, so both chains see the same draws."""

    def __init__(self, sampler, seed):
        self.sampler = sampler
        self.draws = JaxDraws(seed)

    def __call__(self, state, codes, other_items, hp, noise, it, *, num,
                 local_valid, alpha, burnin, cs, cb, orientation, matmul_dtype,
                 **_):
        assert matmul_dtype == torch.bfloat16
        s = self.sampler
        side = s.movies if orientation == "cols" else s.users
        j = lambda x: None if x is None else jnp.asarray(x.numpy())  # noqa: E731
        new = jax_spmd.dense8_half_sweep(
            JaxSideState(items=j(state.items), hp=JaxHyperParams(*map(j, state.hp)),
                         sum=j(state.sum), cov=j(state.cov), norm=j(state.norm),
                         aggr_mu=j(state.aggr_mu), aggr_prod=j(state.aggr_prod)),
            j(codes), j(other_items),
            self.draws._side_key(it, 0 if side is s.movies else 1), it, num=num,
            local_orig=j(s._aux[side.name].local_orig)[None],
            local_valid=j(local_valid)[None], alpha=alpha, burnin=burnin,
            noise_scale=1.0, cs=cs, cb=cb, orientation=orientation,
            matmul_dtype=jnp.bfloat16, interpret=True,
            hp=JaxHyperParams(*map(j, hp)))
        t = lambda x: None if x is None else torch.from_numpy(np.array(x))  # noqa: E731
        return SideState(items=t(new.items), hp=hp, sum=t(new.sum), cov=t(new.cov),
                         norm=t(new.norm), aggr_mu=t(new.aggr_mu),
                         aggr_prod=t(new.aggr_prod))


D8_ROUTES = {
    "fused": {},
    "fused_hoisted": {"BPMF_D8_PT": "hoisted"},
    "fused_aligned": {"BPMF_D8_SOLVE": "fused_aligned"},
    "split": {"BPMF_D8_SOLVE": "split"},
    "split_hoisted": {"BPMF_D8_SOLVE": "split", "BPMF_D8_PT": "hoisted"},
}


@pytest.mark.parametrize("route", list(D8_ROUTES))
def test_dense8_chain_bf16_matches_jax_sweeps(route, monkeypatch):
    """3 iterations of the dense8 chain at bf16, K=16, on each route,
    against the same chain with the JAX package's half-sweeps composed
    into it (the same knobs route both): metrics within 1e-4, tables
    1e-3."""
    for var, value in D8_ROUTES[route].items():
        monkeypatch.setenv(var, value)
    train, test = _small_data()
    cfg = dict(num_latent=K, nsims=3, burnin=1, matmul_dtype="bfloat16")
    port = BPMF(Config(**cfg), train, test, out=open(os.devnull, "w"),
                device="cpu", draws=JaxDraws(42))
    ref = BPMF(Config(**cfg), train, test, out=open(os.devnull, "w"),
               device="cpu", draws=JaxDraws(42))
    port.setup()
    ref.setup()
    assert port.users.impl == port.movies.impl == "dense8"
    monkeypatch.setattr(port_sampler, "dense8_half_sweep", JaxDense8Sweeps(ref, 42))
    want = ref.run_chunk(3)
    monkeypatch.undo()
    got = port.run_chunk(3)
    for f in ("rmse", "rmse_avg", "norm_users", "norm_movies"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=0, atol=METRIC_TOL, err_msg=f)
    for side, state in (("users", "state_u"), ("movies", "state_m")):
        np.testing.assert_allclose(
            port.items_host(getattr(port, side), getattr(port, state)),
            ref.items_host(getattr(ref, side), getattr(ref, state)),
            rtol=ITEMS_TOL, atol=ITEMS_TOL)


def test_final_predict_bf16_matches_jax():
    """The final pass's evaluation on bf16 tables (``bpmf_tpu/sampler.py:
    1204-1210``): the JAX package's ``predict`` with ``gather_dtype``
    bfloat16 against the port's, Welford state and both RMSE, within 1e-6
    (each entry's products rounded alike, f32 sums in another order); the
    float32 evaluation sits further away."""
    rng = np.random.default_rng(3)
    nnz, nu, nm = 700, 60, 40
    tu, ti = rng.integers(0, nu, nnz), rng.integers(0, nm, nnz)
    tv = rng.uniform(1, 5, nnz).astype(np.float32)
    users = rng.normal(size=(nu, K)).astype(np.float32)
    movies = rng.normal(size=(nm, K)).astype(np.float32)
    pavg = rng.normal(size=nnz).astype(np.float32)
    pm2 = rng.random(nnz).astype(np.float32)
    mean = np.float32(3.5)
    want_est, want_rmse, want_avg = jax_model.predict(
        jax_model.EvalData(jnp.asarray(tu), jnp.asarray(ti), jnp.asarray(tv)),
        jax_model.EvalState(jnp.asarray(pavg), jnp.asarray(pm2)),
        jnp.asarray(users), jnp.asarray(movies), jnp.asarray(5, jnp.int32),
        mean_rating=jnp.asarray(mean), burnin=2, gather_dtype=jnp.bfloat16)
    t = torch.from_numpy
    ev = port_model.EvalData(t(tu), t(ti), t(tv))
    bf = torch.bfloat16
    args = (ev, port_model.EvalState(t(pavg), t(pm2)), t(users).to(bf),
            t(movies).to(bf), 5)
    kw = dict(mean_rating=torch.tensor(mean), burnin=2)
    est, rmse, avg = port_model.predict(*args, **kw)
    np.testing.assert_allclose(est.pavg.numpy(), np.asarray(want_est.pavg),
                               rtol=1e-6, atol=1e-6)
    assert float(rmse) == pytest.approx(float(want_rmse), abs=1e-6)
    assert float(avg) == pytest.approx(float(want_avg), abs=1e-6)
    _, rmse32, _ = port_model.predict(args[0], args[1], t(users), t(movies), 5, **kw)
    assert abs(float(rmse32) - float(want_rmse)) > 1e-5


def test_run_bf16_matches_jax():
    """``run()`` of the bucketed chain at bf16 in both packages, JAX's draws
    injected, 3 iterations and the final pass on bf16 tables: the Final Avg
    RMSE within 1e-4."""
    train, test = _ratings(offgrid=True)
    kw = dict(num_latent=K, nsims=3, burnin=1, n_devices=1,
              matmul_dtype="bfloat16", gram_impl="bucketed")
    ref = JaxBPMF(JaxConfig(solver="vpu", **kw), train=train, test=test,
                  out=open(os.devnull, "w"))
    port = BPMF(Config(**kw), train, test, out=open(os.devnull, "w"),
                device="cpu", draws=JaxDraws(42))
    want = ref.run()
    got = port.run()
    assert got == pytest.approx(want, abs=METRIC_TOL)
