"""The functional model API of the port (``bpmf_tpu_torch.models``:
``init_side_state``, ``half_sweep``, ``gibbs_iter``) against the JAX
package's on the CPU: the same data, the same initial state
(``convert.model_from_numpy``) and JAX's draws, the port taking them one
side at a time from its draw provider.  Metrics at 1e-4 in float32 and
1e-9 relative in float64; the state (items on the real rows, aggregates,
sum, cov, hyperprior) beside them.  Also the half-sweep over two gloo ranks
against one device, and the port's own chain sanity check
(``tests/test_model_api.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from bpmf_tpu.models import bpmf as jm
from bpmf_tpu.ops.update import BucketDev as JaxBucketDev
from bpmf_tpu.ops.update import item_noise as jax_item_noise
from bpmf_tpu.parallel import partition as jax_part
from bpmf_tpu_torch import models
from bpmf_tpu_torch.convert import model_from_numpy
from bpmf_tpu_torch.models import bpmf as pm
from bpmf_tpu_torch.ops.mvnormal import HyperDraws
from bpmf_tpu_torch.ops.update import BucketDev
from bpmf_tpu_torch.parallel import partition as part
from bpmf_tpu_torch.parallel.launch import run_ranks
from bpmf_tpu_torch.sampler import TorchDraws
from tests import torch_ranks
from tests.conftest import make_ratings
from tests.test_torch_mvnormal import jax_hyper_draws
from tests.test_torch_routes import JaxDraws64, spd
from tests.test_torch_sampler import JaxDraws

torch.set_num_threads(1)

K = 4
ITERS = 4
F32_METRICS = 1e-4   # abs, float32 in both packages, other sum orders
F32_STATE = 1e-4     # rtol and atol of the state after the iterations
F64_REL = 1e-9


def api_draws(seed, dtype):
    """JAX ``gibbs_iter``'s draws by (iteration, side) from its key
    ``PRNGKey(seed)``, as the port's ``hyper`` / ``noise`` provider: the
    sampler's (``JaxDraws``), in float64 for a float64 chain."""
    base = JaxDraws64 if dtype == torch.float64 else JaxDraws

    class Draws(base):
        def hyper(self, it, side, n, k, dtype):
            pair = self.hyper_pair(it, (n, n), k, dtype)
            return HyperDraws(*(x[side].to(dtype) for x in pair))

        def noise(self, it, side, orig_ids, num, k, dtype):
            return super().noise(it, side, orig_ids, num, k, dtype).to(dtype)

    return Draws(seed)


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@dataclasses.dataclass
class Problem:
    """Both packages' inputs of one chain, built once from the same data."""

    maps: dict          # side -> SideMaps (the same in both packages)
    jax_data: dict      # side -> (JAX SideData, splits)
    ev: object          # JAX EvalData
    num: dict
    mean: float


def _jax_side_data(m_csc, maps, other_maps, jdt, width, prior, seed):
    layout = jax_part.build_gather_layout(m_csc, maps, other_maps.orig_to_padded,
                                          width)
    buckets = tuple(JaxBucketDev(
        nbr=jnp.asarray(b.nbr[0]), val=jnp.asarray(b.val[0], jdt),
        mask=jnp.asarray(b.mask[0], jdt), row_slot=jnp.asarray(b.row_slot[0]),
        item_ids=jnp.asarray(b.item_ids[0]), orig_ids=jnp.asarray(b.orig_ids[0]),
        slot_valid=jnp.asarray(b.slot_valid[0], jdt)) for b in layout.buckets)
    pmu = plam = None
    if prior:
        # a propagated posterior in padded order, identity on the padding
        rng = np.random.default_rng(seed)
        pn, num = maps.padded_num, maps.num
        pmu = np.zeros((pn, K))
        plam = np.tile(np.eye(K), (pn, 1, 1))
        pmu[maps.orig_to_padded] = 0.3 * rng.normal(size=(num, K))
        plam[maps.orig_to_padded] = spd(rng, num, K, 2.0)
        pmu, plam = jnp.asarray(pmu, jdt), jnp.asarray(plam, jdt)
    return jm.SideData(buckets=buckets, prop_mu=pmu, prop_lambda=plam), layout.splits


def problem(jdt, width=4096, prior=False) -> Problem:
    """make_ratings(seed=3) (40 users x 25 movies), the maps and layouts of
    ``tests/test_model_api.py``; ``width`` 8 splits the movies' buckets."""
    train, test = make_ratings(seed=3)
    mats = {"movies": train, "users": sp.csc_matrix(train.T)}
    maps = {s: jax_part.make_maps(jax_part.assign_items(np.diff(m.indptr), 1),
                                  m.shape[1]) for s, m in mats.items()}
    other = {"movies": "users", "users": "movies"}
    jax_data = {s: _jax_side_data(mats[s], maps[s], maps[other[s]], jdt, width,
                                  prior, seed=i)
                for i, s in enumerate(mats)}
    tcoo = test.tocoo()
    ev = jm.EvalData(
        t_user=jnp.asarray(maps["users"].orig_to_padded[tcoo.row], jnp.int32),
        t_item=jnp.asarray(maps["movies"].orig_to_padded[tcoo.col], jnp.int32),
        t_val=jnp.asarray(tcoo.data, jdt))
    return Problem(maps=maps, jax_data=jax_data, ev=ev,
                   num={s: m.shape[1] for s, m in mats.items()},
                   mean=float(train.sum() / train.nnz))


def to_port(x, dtype, **kw):
    return model_from_numpy(jax.device_get(x), "cpu", dtype, **kw)


def assert_state_close(got, want, maps, **tol):
    """Items and aggregates on the real rows (the padding slots' draws go
    to the scratch row in both, by other means), sum, cov, norm and hp."""
    rows = maps.orig_to_padded
    for f in ("items", "aggr_mu", "aggr_prod"):
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f
        if g is not None:
            np.testing.assert_allclose(g.numpy()[rows], np.asarray(w)[rows],
                                       err_msg=f, **tol)
    for f in ("sum", "cov", "norm"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), err_msg=f, **tol)
    for f, g, w in zip(got.hp._fields, got.hp, want.hp):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=f"hp.{f}",
                                   **tol)


CASES = {
    # name: (dtype, aggregate, burnin, solver, diagonal_only, prior,
    #        strict_reference, noise_scale)
    "f32": ("float32", False, 1, "unrolled", False, False, True, 1.0),
    "f32_aggregate": ("float32", True, 2, "unrolled", False, False, True, 1.0),
    "f32_xla": ("float32", False, 1, "xla", False, False, True, 1.0),
    "f32_vpu": ("float32", True, 1, "vpu", False, False, True, 1.0),
    "f32_diagonal_only": ("float32", False, 1, "unrolled", True, False, True, 1.0),
    "f32_prior_strict": ("float32", True, 2, "unrolled", False, True, True, 1.0),
    "f32_prior_static": ("float32", False, 1, "vpu", False, True, False, 1.0),
    "f32_noise0": ("float32", False, 1, "unrolled", False, False, True, 0.0),
    "f64": ("float64", False, 1, "xla", False, False, True, 1.0),
    "f64_aggregate": ("float64", True, 2, "unrolled", False, False, True, 1.0),
    "f64_prior_static_diag": ("float64", True, 2, "vpu", True, True, False, 1.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_gibbs_iter_matches_jax(case, x64):
    """4 iterations of ``gibbs_iter`` from zero state in both packages,
    burn-in 1 or 2 (the aggregates start inside the run): per-iteration
    metrics, then the final state of both sides and the Welford state."""
    dtype_name, aggregate, burnin, solver, diag, prior, strict, scale = CASES[case]
    f64 = dtype_name == "float64"
    if not f64:
        jax.config.update("jax_enable_x64", False)
    jdt, dtype = getattr(jnp, dtype_name), getattr(torch, dtype_name)
    p = problem(jdt, prior=prior)
    (md, m_splits), (ud, u_splits) = p.jax_data["movies"], p.jax_data["users"]
    nnz_t = p.ev.t_val.shape[0]
    jstate = {s: jm.init_side_state(p.maps[s].padded_num, K, jdt, aggregate)
              for s in ("movies", "users")}
    jest = jm.EvalState(pavg=jnp.zeros(nnz_t, jdt), pm2=jnp.zeros(nnz_t, jdt))
    sm, su, est = (to_port(x, dtype) for x in (jstate["movies"],
                                               jstate["users"], jest))
    pmd, pud = to_port(md, dtype, splits=m_splits), to_port(ud, dtype, splits=u_splits)
    ev = to_port(p.ev, dtype)
    kw = dict(num_movies=p.num["movies"], num_users=p.num["users"], alpha=2.0,
              burnin=burnin, movies_splits=m_splits, users_splits=u_splits,
              diagonal_only=diag, strict_reference=strict, noise_scale=scale,
              solver=solver)
    jsm, jsu = jstate["movies"], jstate["users"]
    key, draws = jax.random.PRNGKey(11), api_draws(11, dtype)
    for it in range(ITERS):
        jsm, jsu, jest, want = jm.gibbs_iter(
            jsm, jsu, jest, md, ud, p.ev, key, jnp.asarray(it, jnp.int32),
            mean_rating=jnp.asarray(p.mean, jdt), **kw)
        sm, su, est, got = pm.gibbs_iter(sm, su, est, pmd, pud, ev, draws, it,
                                         mean_rating=p.mean, **kw)
        for f, g, w in zip(got._fields, got, want):
            if f64:
                assert float(g) == pytest.approx(float(w), rel=F64_REL), (it, f)
            else:
                assert float(g) == pytest.approx(float(w), abs=F32_METRICS), (it, f)
            assert np.isfinite(float(g)), (it, f)
    tol = (dict(rtol=F64_REL, atol=F64_REL) if f64
           else dict(rtol=F32_STATE, atol=F32_STATE))
    assert_state_close(sm, jsm, p.maps["movies"], **tol)
    assert_state_close(su, jsu, p.maps["users"], **tol)
    for g, w in zip(est, jest):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


def _random_state(jdt, num_pad, seed, aggregate=True):
    """A JAX SideState with random items, stats and aggregates."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(num_pad, K))
    lam = spd(rng, 1, K, 2.0)[0]
    return jm.SideState(
        items=jnp.asarray(x, jdt),
        hp=jm.HyperParams(jnp.asarray(0.1 * rng.normal(size=K), jdt),
                          jnp.asarray(lam, jdt),
                          jnp.asarray(np.linalg.cholesky(lam), jdt)),
        sum=jnp.asarray(x.sum(0), jdt), cov=jnp.asarray(np.cov(x.T), jdt),
        norm=jnp.asarray((x * x).sum(), jdt),
        aggr_mu=jnp.asarray(rng.normal(size=(num_pad, K)), jdt) if aggregate else None,
        aggr_prod=(jnp.asarray(rng.normal(size=(num_pad, K * (K + 1) // 2)), jdt)
                   if aggregate else None))


@pytest.mark.parametrize("width,prior,strict,it", [
    (4096, False, True, 3), (8, True, True, 3), (8, True, False, 0),
])
def test_half_sweep_matches_jax(width, prior, strict, it):
    """One movies half-sweep from a random state with JAX's key split as
    ``bpmf_tpu.models.bpmf.half_sweep`` splits it (hyperprior fold 0,
    noise fold 1): plain and split buckets (width 8), a per-item prior
    under both ``strict_reference`` settings, after and before burn-in."""
    jax.config.update("jax_enable_x64", False)
    p = problem(jnp.float32, width=width, prior=prior)
    data, splits = p.jax_data["movies"]
    assert any(splits) == (width == 8)
    state = _random_state(jnp.float32, p.maps["movies"].padded_num, seed=5)
    other = _random_state(jnp.float32, p.maps["users"].padded_num, seed=6).items
    num, key = p.num["movies"], jax.random.PRNGKey(4)
    kw = dict(num=num, alpha=2.0, burnin=1, splits=splits,
              strict_reference=strict, solver="unrolled")
    want = jm.half_sweep(state, data, other, key, jnp.asarray(it, jnp.int32),
                         mean_rating=jnp.float32(p.mean), **kw)
    hyper = jax_hyper_draws(jax.random.fold_in(key, 0), num, K)
    port_data = to_port(data, torch.float32, splits=splits)
    orig = np.concatenate([np.asarray(b.orig_ids) for b in data.buckets])
    noise = torch.from_numpy(np.array(jax_item_noise(
        jax.random.fold_in(key, 1), jnp.asarray(orig), K, jnp.float32, num=num)))
    got = pm.half_sweep(to_port(state, torch.float32), port_data,
                        torch.from_numpy(np.array(other)), hyper, noise, it,
                        mean_rating=p.mean, **kw)
    assert_state_close(got, want, p.maps["movies"], rtol=1e-4, atol=1e-4)


def test_half_sweep_over_ranks_matches_one_device():
    """``half_sweep(mesh=...)`` on two gloo ranks, each with its shard of
    the movies (items, buckets) and the whole users' table, against one
    device: the items of every rank's real rows and the stats summed over
    the ranks (the exact global covariance) at 1e-10 in float64."""
    train, _ = make_ratings(seed=3)
    rng = np.random.default_rng(8)
    other = rng.normal(size=(part.pad_count(41), K))
    outs = {}
    for d in (1, 2):
        ids = part.assign_items(np.diff(train.indptr), d)
        maps = part.make_maps(ids, train.shape[1])
        umaps = part.make_maps(part.assign_items(np.diff(train.tocsr().indptr), 1),
                               train.shape[0])
        layout = part.build_gather_layout(train, maps, umaps.orig_to_padded, 8)
        args = (layout.buckets, layout.splits, maps.local_pad, other,
                maps.num, train.sum() / train.nnz)
        if d == 1:
            res = [torch_ranks.api_half_sweep(None, *args)]
        else:
            res = run_ranks(torch_ranks.api_half_sweep, 2, *args, device="cpu",
                            threads=1, timeout_s=600)
        items = np.concatenate([r["items"] for r in res])[maps.orig_to_padded]
        outs[d] = (items, res[0]["stats"], [r["stats"] for r in res])
    np.testing.assert_allclose(outs[2][0], outs[1][0], rtol=1e-10, atol=1e-10)
    for f in ("sum", "cov", "norm"):
        np.testing.assert_allclose(outs[2][1][f], outs[1][1][f], rtol=1e-10,
                                   atol=1e-10, err_msg=f)
        np.testing.assert_array_equal(outs[2][2][0][f], outs[2][2][1][f])


@pytest.mark.parametrize("aggregate", [False, True])
def test_init_side_state_matches_jax(aggregate):
    want = jm.init_side_state(13, K, jnp.float32, aggregate)
    got = models.init_side_state(13, K, torch.float32, aggregate, device="cpu")
    assert type(got).__name__ == "SideState"
    for f in ("items", "sum", "cov", "norm", "aggr_mu", "aggr_prod"):
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f
        if g is not None:
            assert g.dtype == torch.float32 and g.device.type == "cpu"
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f)
    for g, w in zip(got.hp, want.hp):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the behaviour of a host without CUDA")
def test_init_side_state_defaults_to_cuda():
    """The default device is the card; without one it raises rather than
    place the state on the CPU."""
    with pytest.raises(RuntimeError, match="cuda"):
        models.init_side_state(8, K, torch.float32, False)


@pytest.mark.parametrize("lib", ["numpy", "torch"])
def test_aggr_prod_pack_inverts_full(lib):
    """``aggr_prod_pack`` against the JAX package's and as the inverse of
    ``aggr_prod_full``, on a numpy array and on a tensor."""
    rng = np.random.default_rng(1)
    packed = rng.normal(size=(6, K * (K + 1) // 2))
    full = pm.aggr_prod_full(packed, K)
    np.testing.assert_array_equal(full, jm.aggr_prod_full(packed, K))
    arg = full if lib == "numpy" else torch.from_numpy(full)
    got = np.asarray(pm.aggr_prod_pack(arg))
    np.testing.assert_array_equal(got, packed)
    np.testing.assert_array_equal(got, jm.aggr_prod_pack(full))


def _port_side_data(m_csc, maps, other_maps, dtype):
    layout = part.build_gather_layout(m_csc, maps, other_maps.orig_to_padded)
    arrays = [f.name for f in dataclasses.fields(layout.buckets[0])
              if f.name != "split"]
    buckets = tuple(BucketDev.from_bucket(
        dataclasses.replace(b, **{n: getattr(b, n)[0] for n in arrays}),
        dtype, "cpu") for b in layout.buckets)
    return models.SideData(buckets=buckets), layout.splits


def test_gibbs_iter_public_api():
    """The port's copy of ``tests/test_model_api.py``: the library-level
    chain from the port's own layout and draws stays finite and sane."""
    train, test = make_ratings(seed=3)
    users_csc = sp.csc_matrix(train.T)
    movies = part.make_maps(part.assign_items(np.diff(train.indptr), 1),
                            train.shape[1])
    users = part.make_maps(part.assign_items(np.diff(users_csc.indptr), 1),
                           users_csc.shape[1])
    m_data, m_splits = _port_side_data(train, movies, users, torch.float32)
    u_data, u_splits = _port_side_data(users_csc, users, movies, torch.float32)
    state_m = models.init_side_state(movies.padded_num, K, torch.float32,
                                     aggregate=False, device="cpu")
    state_u = models.init_side_state(users.padded_num, K, torch.float32,
                                     aggregate=False, device="cpu")
    tcoo = test.tocoo()
    ev = models.EvalData(
        t_user=torch.as_tensor(users.orig_to_padded[tcoo.row]),
        t_item=torch.as_tensor(movies.orig_to_padded[tcoo.col]),
        t_val=torch.as_tensor(tcoo.data, dtype=torch.float32))
    est = models.EvalState(pavg=torch.zeros(test.nnz), pm2=torch.zeros(test.nnz))
    draws = TorchDraws(0, torch.device("cpu"))
    rmses = []
    for it in range(4):
        state_m, state_u, est, metrics = models.gibbs_iter(
            state_m, state_u, est, m_data, u_data, ev, draws, it,
            num_movies=movies.num, num_users=users.num,
            mean_rating=float(train.sum() / train.nnz), alpha=2.0, burnin=1,
            movies_splits=m_splits, users_splits=u_splits)
        rmses.append(float(metrics.rmse_avg))
    assert all(np.isfinite(r) for r in rmses), rmses
    assert rmses[-1] < rmses[0] * 1.2  # chain is sane, not diverging
