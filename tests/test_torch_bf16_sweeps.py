"""bf16 matmul inputs, one half-sweep at a time: the port's half-sweeps at
bf16 against the JAX package's from the same state, hyperprior and noise.
The dense8 sweep on each of its routes (the megakernel with the products
built in it or a hoisted operand in either layout, the split pipeline with
the in-kernel or the hoisted Gram) against the JAX package's eager
``dense8_half_sweep`` in interpret mode (its sampler's dense8 route does
not run at bf16 on XLA's CPU, whose dot has no bf16 x bf16 = f32); then the
dense, fused dense, bucketed (plain and split buckets) and the reduce and
chunked reduce sweeps on one device.  Items, stats and aggregates within
1e-3: the same roundings, float32 sums in other orders (the float32 port
sits 7.7e-3 from the bf16 JAX sweep on the dense8 inputs)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bpmf_tpu.models.bpmf import SideData as JaxSideData
from bpmf_tpu.models.bpmf import SideState as JaxSideState
from bpmf_tpu.models.bpmf import aggr_prod_pack
from bpmf_tpu.ops import pallas_solve as jax_ps
from bpmf_tpu.ops import update as jax_up
from bpmf_tpu.ops.mvnormal import HyperParams as JaxHyperParams
from bpmf_tpu.parallel import partition as jax_part
from bpmf_tpu.parallel import spmd as jax_spmd
from bpmf_tpu.parallel.mesh import make_mesh
from bpmf_tpu_torch.convert import state_from_numpy
from bpmf_tpu_torch.models.bpmf import SideState
from bpmf_tpu_torch.ops.mvnormal import HyperParams
from bpmf_tpu_torch.parallel import partition as part
from bpmf_tpu_torch.parallel import spmd
from bpmf_tpu_torch.sampler import rank_buckets
from tests.test_torch_routes import _jax_buckets, _port_buckets, _ratings, spd
from tests.test_torch_sweep import NUM, _maps, _payload

torch.set_num_threads(1)

TOL = dict(rtol=1e-3, atol=1e-3)
FIELDS = ("items", "sum", "cov", "norm", "aggr_mu", "aggr_prod")
K = 16
BF16 = torch.bfloat16


@pytest.fixture(autouse=True)
def knobs(monkeypatch):
    for var in ("BPMF_TRI_GROUPED", "BPMF_D8_SOLVE", "BPMF_D8_PT",
                "BPMF_D8_FOLD", "BPMF_TRI_ALIGNED_MM"):
        monkeypatch.delenv(var, raising=False)
    jax_ps._tri_grouped_reset()
    yield
    jax_ps._tri_grouped_reset()


def _agree(got, want):
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), err_msg=f, **TOL)


# the port's route and the JAX package's knobs that take it there
D8_ROUTES = {
    "fused": {},
    "fused_hoisted": {"BPMF_D8_PT": "hoisted"},
    "fused_aligned": {"BPMF_D8_SOLVE": "fused_aligned"},
    "inkernel": {"BPMF_D8_SOLVE": "split"},
    "hoisted": {"BPMF_D8_SOLVE": "split", "BPMF_D8_PT": "hoisted"},
}


@pytest.mark.parametrize("route", list(D8_ROUTES))
@pytest.mark.parametrize("side", ["movies", "users"])
def test_dense8_half_sweep_bf16_matches_jax(side, route, monkeypatch):
    """tests/test_torch_sweep.py's harness at bf16, cs = 0.7, cb = -1.3
    (not bf16 values), on every dense8 route."""
    for var, value in D8_ROUTES[route].items():
        monkeypatch.setenv(var, value)
    rng = np.random.default_rng(12)
    payload = _payload(rng)
    maps = {s: _maps(n) for s, n in NUM.items()}
    codes = np.where(rng.random((512, 512)) < 0.1,
                     rng.integers(1, 6, size=(512, 512)), 0).astype(np.int8)
    other = "users" if side == "movies" else "movies"
    orientation = "cols" if side == "movies" else "rows"
    num, pn = NUM[side], maps[side].padded_num
    alpha, burnin, it = 2.0, 1, 3
    cs, cb = 0.7, -1.3
    key = jax.random.PRNGKey(6)

    def padded(a):
        out = np.zeros((pn,) + a.shape[1:], np.float32)
        out[:num] = a
        return out

    jax_state = JaxSideState(
        items=jnp.zeros((pn, K), jnp.float32), hp=JaxHyperParams.init(K),
        sum=jnp.zeros(K), cov=jnp.zeros((K, K)), norm=jnp.zeros(()),
        aggr_mu=jnp.asarray(padded(payload[f"{side}.aggr_mu"])),
        aggr_prod=jnp.asarray(padded(aggr_prod_pack(payload[f"{side}.aggr_prod"]))))
    other_items = np.zeros((512, K), np.float32)
    other_items[:NUM[other]] = payload[f"{other}.items"]
    jax_hp = JaxHyperParams(*(jnp.asarray(payload[f"{side}.hp.{f}"], jnp.float32)
                              for f in ("mu", "lambda_f", "lambda_l")))
    lo = maps[side].local_orig
    want = jax_spmd.dense8_half_sweep(
        jax_state, jnp.asarray(codes), jnp.asarray(other_items), key, it,
        num=num, local_orig=jnp.asarray(lo),
        local_valid=jnp.asarray(maps[side].local_valid), alpha=alpha,
        burnin=burnin, noise_scale=1.0, cs=cs, cb=cb, orientation=orientation,
        matmul_dtype=jnp.bfloat16, interpret=True, hp=jax_hp)

    state_m, state_u, _ = state_from_numpy(payload, maps["movies"],
                                           maps["users"], "cpu", torch.float32)
    state, frozen = (state_m, state_u) if side == "movies" else (state_u, state_m)
    noise = np.array(jax_up.item_noise(jax.random.fold_in(key, 1),
                                       jnp.asarray(lo[0]), K, jnp.float32, num=num))
    got = spmd.dense8_half_sweep(
        state, torch.from_numpy(codes), frozen.items, state.hp,
        torch.from_numpy(noise), it, num=num,
        local_valid=torch.from_numpy(maps[side].local_valid[0]), alpha=alpha,
        burnin=burnin, cs=cs, cb=cb, orientation=orientation, route=route,
        matmul_dtype=BF16)
    _agree(got, want)


def _bucket_rows(buckets, dtype=torch.float32):
    return rank_buckets(buckets, 0, dtype, "cpu")


@pytest.mark.parametrize("route", ["dense", "fused", "gather", "gather_split",
                                   "reduce", "reduce_chunked"])
def test_half_sweep_bf16_matches_jax(route):
    """The movies' half-sweep off the grid (ratings +-0.25, so the dense
    blocks' centred values round to bf16 too) with the shared prior: the
    dense blocks in bf16 (the outer products of the float32 side rounded),
    the fused dense route's packed products likewise, and the buckets'
    gathered table rounded, in gather mode (buckets of width 2048, and of 8
    so that items split) and in reduce mode, whole and chunked."""
    train, _ = _ratings(offgrid=True)
    side_m, num, other_num = train, 100, 150
    maps = part.make_maps([np.arange(num, dtype=np.int32)], num)
    omaps = part.make_maps([np.arange(other_num, dtype=np.int32)], other_num)
    pn, opn = maps.padded_num, omaps.padded_num
    rng = np.random.default_rng(8)
    alpha, burnin, it = 2.0, 1, 3
    key = jax.random.PRNGKey(10)
    mesh = make_mesh(1)
    mean = np.float32(train.data.mean())

    items = np.zeros((pn, K), np.float32)
    items[:num] = rng.normal(size=(num, K))
    other = np.zeros((opn, K), np.float32)
    other[:other_num] = 0.5 * rng.normal(size=(other_num, K))
    aggr_mu = rng.normal(size=(pn, K)).astype(np.float32)
    aggr_prod = rng.normal(size=(pn, K * (K + 1) // 2)).astype(np.float32)
    lam = spd(rng, 1, K, 2.0)[0].astype(np.float32)
    hp_np = ((0.1 * rng.normal(size=K)).astype(np.float32), lam,
             np.linalg.cholesky(lam).astype(np.float32))
    jstate = JaxSideState(items=jnp.asarray(items), hp=JaxHyperParams.init(K),
                          sum=jnp.zeros(K), cov=jnp.zeros((K, K)),
                          norm=jnp.zeros(()), aggr_mu=jnp.asarray(aggr_mu),
                          aggr_prod=jnp.asarray(aggr_prod))
    jhp = JaxHyperParams(*(jnp.asarray(a) for a in hp_np))
    t = torch.from_numpy
    state = SideState(items=t(items), hp=HyperParams.init(K, torch.float32, "cpu"),
                      sum=torch.zeros(K), cov=torch.zeros(K, K),
                      norm=torch.zeros(()), aggr_mu=t(aggr_mu),
                      aggr_prod=t(aggr_prod))
    hp = HyperParams(*(t(a) for a in hp_np))
    lo, lv = maps.local_orig, maps.local_valid
    side_key = jax.random.fold_in(key, 1)

    def jitted(fn, *arrays, **static):
        return jax.jit(lambda *a: fn(mesh, *a, **static))(*arrays)

    def noise_for(ids):
        return t(np.array(jax_up.item_noise(side_key, jnp.asarray(ids), K,
                                            jnp.float32, num=num)))

    bucket_kw = dict(mean_rating=jnp.float32(mean), alpha=alpha, burnin=burnin,
                     diagonal_only=False, strict_reference=True,
                     noise_scale=1.0, solver="vpu", matmul_dtype="bfloat16",
                     hp=jhp)
    port_kw = dict(num=num, mean_rating=float(mean), alpha=alpha, burnin=burnin,
                   solver="smart")
    if route in ("dense", "fused"):
        block = part.build_dense_layout(side_m, maps, omaps.orig_to_padded, opn)[0]
        ind = block != 0
        val = ((block - mean) * ind * np.float32(alpha)).astype(np.float32)
        ind_b, val_b = (jnp.asarray(a, jnp.bfloat16) for a in (ind, val))
        a_ind, a_val = t(ind).to(BF16), t(val).to(BF16)
        common = dict(num=num, local_valid=t(lv[0]), alpha=alpha, burnin=burnin)
        if route == "dense":
            want = jitted(
                jax_spmd.dense_half_sweep, jstate, ind_b, val_b, None, None,
                jnp.asarray(other), key, it, num=num, local_orig=jnp.asarray(lo),
                local_valid=jnp.asarray(lv), alpha=alpha, burnin=burnin,
                diagonal_only=False, strict_reference=True, noise_scale=1.0,
                solver="vpu", matmul_dtype="bfloat16", hp=jhp)
            got = spmd.dense_half_sweep(state, a_ind, a_val, t(other), hp,
                                        noise_for(lo[0]), it, solver="smart",
                                        **common)
        else:
            want = jitted(
                jax_spmd.dense_half_sweep_fused, jstate, ind_b.T, val_b,
                jnp.asarray(other), key, it, num=num, local_orig=jnp.asarray(lo),
                local_valid=jnp.asarray(lv), alpha=alpha, burnin=burnin,
                noise_scale=1.0, interpret=True, hp=jhp)
            got = spmd.dense_half_sweep_fused(state, a_ind.t().contiguous(), a_val,
                                              t(other), hp, noise_for(lo[0]), it,
                                              **common)
    elif route.startswith("gather"):
        width = 8 if route == "gather_split" else 2048
        layouts = [p.build_gather_layout(
            side_m, p.make_maps([np.arange(num, dtype=np.int32)], num),
            p.make_maps([np.arange(other_num, dtype=np.int32)], other_num).orig_to_padded,
            width, 2) for p in (jax_part, part)]
        assert any(layouts[1].splits) == (route == "gather_split")
        want = jitted(
            jax_spmd.gather_half_sweep, jstate,
            JaxSideData(buckets=_jax_buckets(layouts[0]), prop_mu=None,
                        prop_lambda=None),
            jnp.asarray(other), key, it, num=num, splits=layouts[0].splits,
            **bucket_kw)
        got = spmd.gather_half_sweep(
            state, _port_buckets(layouts[1]), t(other).to(BF16), hp,
            noise_for(np.concatenate([b.orig_ids[0] for b in layouts[0].buckets])),
            it, splits=layouts[1].splits, **port_kw)
    elif route == "reduce":
        layouts = [p.build_reduce_layout(side_m, maps.orig_to_padded, pn,
                                         omaps.ids_per_dev, 2048, 2)
                   for p in (jax_part, part)]
        want = jitted(
            jax_spmd.reduce_half_sweep, jstate,
            JaxSideData(buckets=_jax_buckets(layouts[0]), prop_mu=None,
                        prop_lambda=None),
            jnp.asarray(other), key, it, num=num, padded_num=pn,
            local_orig=jnp.asarray(lo), local_valid=jnp.asarray(lv),
            splits=layouts[0].splits, **bucket_kw)
        got = spmd.reduce_half_sweep(
            state, _bucket_rows(layouts[1].buckets), t(other).to(BF16), hp,
            noise_for(lo[0]), it, padded_num=pn, local_valid=t(lv[0]),
            splits=layouts[1].splits, **port_kw)
    else:
        layouts = [p.build_reduce_layout_chunked(side_m, maps, omaps.ids_per_dev,
                                                 2048, 2)
                   for p in (jax_part, part)]
        jdata = [JaxSideData(buckets=_jax_buckets(type("L", (), {"buckets": b})),
                             prop_mu=None, prop_lambda=None)
                 for b, _ in layouts[0].per_dest]
        want = jitted(
            jax_spmd.reduce_half_sweep_chunked, jstate, jdata, jnp.asarray(other),
            key, it, num=num, local_pad=maps.local_pad,
            splits_per_dest=tuple(s for _, s in layouts[0].per_dest),
            local_orig=jnp.asarray(lo), local_valid=jnp.asarray(lv), **bucket_kw)
        got = spmd.reduce_half_sweep_chunked(
            state, tuple((_bucket_rows(b), s) for b, s in layouts[1].per_dest),
            t(other).to(BF16), hp, noise_for(lo[0]), it, local_valid=t(lv[0]),
            **port_kw)
    _agree(got, want)
