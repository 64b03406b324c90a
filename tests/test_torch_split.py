"""The dense8 split pipeline of the port against the JAX package: the Gram
kernels (in-kernel and hoisted operand, against the JAX kernels with the
fold on and off), the combine-solve kernels (shared and per-item prior)
on the tight Gram, the prior rhs, the half-sweep, three sampler
iterations, and the routing decision.  The JAX package's Pallas kernels
run in interpret mode."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bpmf_tpu.config import Config
from bpmf_tpu.datasets import synth_movielens
from bpmf_tpu.models.bpmf import SideState as JaxSideState
from bpmf_tpu.models.bpmf import aggr_prod_pack
from bpmf_tpu.ops import dense8 as jax_d8
from bpmf_tpu.ops import pallas_solve as jax_ps
from bpmf_tpu.ops.mvnormal import HyperParams as JaxHyperParams
from bpmf_tpu.ops.update import item_noise as jax_item_noise
from bpmf_tpu.parallel import spmd as jax_spmd
from bpmf_tpu.sampler import BPMF as JaxBPMF
from bpmf_tpu_torch.convert import state_from_numpy
from bpmf_tpu_torch.ops import dense8 as d8
from bpmf_tpu_torch.ops import pallas_solve as ps
from bpmf_tpu_torch.parallel.spmd import dense8_half_sweep
from bpmf_tpu_torch.sampler import BPMF
from tests.test_torch_dense8 import case_ids
from tests.test_torch_kernel import ALPHA, CB, CS, CS16, pack_tight
from tests.test_torch_sampler import JaxDraws
from tests.test_torch_sweep import NUM, _maps, _payload

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)  # f32 on both sides, other summation orders


@pytest.fixture(autouse=True)
def ungrouped(monkeypatch):
    """The JAX package's default bottom-padded layout, unpinned."""
    monkeypatch.delenv("BPMF_TRI_GROUPED", raising=False)
    jax_ps._tri_grouped_reset()
    yield
    jax_ps._tri_grouped_reset()


def _codes_v(r, c, k, orientation, seed, density=0.1, code_dtype="int8",
             code_range=None):
    rng = np.random.default_rng(seed)
    lo, hi = code_range or ((1, 5) if code_dtype == "int8" else (1, 255))
    codes = np.where(rng.random((r, c)) < density,
                     rng.integers(lo, hi + 1, size=(r, c)), 0).astype(code_dtype)
    frozen = c if orientation == "rows" else r
    v_t = (0.5 * rng.normal(size=(k, frozen))).astype(np.float32)
    return codes, v_t


GRAM_CASES = [
    (16, "rows", "inkernel", "1", "int8"), (16, "cols", "inkernel", "1", "int8"),
    (16, "rows", "hoisted", "0", "int8"), (16, "rows", "hoisted", "1", "int8"),
    (16, "cols", "hoisted", "0", "int8"), (16, "cols", "hoisted", "1", "int8"),
    (64, "rows", "inkernel", "1", "int8"), (64, "cols", "hoisted", "1", "int8"),
    (16, "cols", "inkernel", "1", "int16"), (16, "rows", "hoisted", "1", "int16"),
]


def _gram_pair(codes, v_t, orientation, pt, cs):
    """The JAX Gram kernel (interpret mode) and the port's on the same
    codes and frozen items: (want, got), the port's on its plain version."""
    jax_fn = {"rows": jax_d8.dense8_gram_rhs_rows,
              "cols": jax_d8.dense8_gram_rhs_cols}[orientation]
    port_fn = {"rows": d8.dense8_gram_rhs_rows,
               "cols": d8.dense8_gram_rhs_cols}[orientation]
    jp = None if pt == "inkernel" else jax_d8.packed_tri_t(jnp.asarray(v_t))
    want = jax_fn(jnp.asarray(codes), jp, jnp.asarray(v_t), cs, CB,
                  interpret=True)
    v = torch.from_numpy(v_t)
    launches = dict(d8.gram_launches)
    got = port_fn(torch.from_numpy(codes),
                  None if pt == "inkernel" else d8.packed_tri_t(v), v, cs, CB)
    assert d8.gram_launches == launches  # CPU: plain version
    return want, got


@pytest.mark.parametrize("k,orientation,pt,fold,code_dtype", GRAM_CASES,
                         ids=case_ids(GRAM_CASES))
def test_gram_rhs_matches_jax(k, orientation, pt, fold, code_dtype, monkeypatch):
    """Kernels #3 (p_t None) and #4 (p_t given) against the JAX kernels,
    #4 with its BPMF_D8_FOLD 0 and 1 (the same sums, other rounding; the
    port has no fold), on int8 codes and on int16 codes 1..255: gram_t and
    rhs_t, padding rows included, at 1e-4."""
    monkeypatch.setenv("BPMF_D8_FOLD", fold)
    shape = (512, 512) if k == 64 else (512, 1024)
    codes, v_t = _codes_v(*shape, k, orientation, seed=k, code_dtype=code_dtype)
    want, got = _gram_pair(codes, v_t, orientation, pt,
                           CS if code_dtype == "int8" else CS16)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def _spd_batch(rng, b, k, ridge):
    w = rng.normal(size=(b, k, k))
    return w @ w.transpose(0, 2, 1) / k + ridge * np.eye(k)


def _solve_inputs(k, b, seed):
    """A Gram-like batch in the tight layout, a well-conditioned shared
    prior, a per-item prior (aligned layout), rhs and noise, all f32."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, 20, k)) / np.sqrt(20)
    gram = pack_tight(x.transpose(0, 2, 1) @ x, k)
    w = rng.normal(size=(k, k))
    lam = w @ w.T / k + np.eye(k)
    lam_tri = ps.pack_prior_tri(_spd_batch(rng, b, k, 1.0), k)
    rhs = rng.normal(size=(k, b))
    noise = rng.normal(size=(k, b))
    return [a.astype(np.float32) for a in (gram, lam, rhs, noise, lam_tri)]


@pytest.mark.parametrize("k,peritem", [(16, False), (16, True), (64, True)])
def test_tri_combine_solve_matches_jax(k, peritem):
    """Kernels #5 (shared prior) and #6 (per-item prior): u_t at 1e-4.  The
    port takes the tight Gram, the JAX function its tri_expand_rows.  K=64
    only with the per-item prior: the JAX kernel's unrolled K=64 tail takes
    most of a minute to trace in interpret mode, and #5 and #6 share it."""
    b = 512 if k == 64 else 200
    gram, lam, rhs, noise, lam_tri = _solve_inputs(k, b, seed=k)
    want = jax_ps.tri_combine_solve_sample(
        jax_ps.tri_expand_rows(jnp.asarray(gram), k), jnp.asarray(lam),
        jnp.asarray(rhs),
        jnp.asarray(noise), ALPHA, interpret=True,
        lam_tri_t=jnp.asarray(lam_tri) if peritem else None)
    t = [torch.from_numpy(a) for a in (gram, lam, rhs, noise, lam_tri)]
    launches = dict(ps.solve_launches)
    got = ps.tri_combine_solve_sample(*t[:4], ALPHA,
                                      lam_tri_t=t[4] if peritem else None)
    assert ps.solve_launches == launches
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("k", [10, 64])
def test_solve_reads_only_valid_rows(k):
    """NaN in the padding rows of the tight Gram (none at K=64) and of the
    aligned per-item prior changes nothing."""
    gram, lam, rhs, noise, lam_tri = (torch.from_numpy(a) for a in
                                      _solve_inputs(k, 30, seed=k + 1))
    want = ps.tri_combine_solve_sample(gram, lam, rhs, noise, ALPHA,
                                       lam_tri_t=lam_tri)
    offs, _ = ps.tri_offsets(k)
    valid = torch.zeros(lam_tri.shape[0], dtype=torch.bool)
    for j in range(k):
        valid[offs[j]: offs[j] + k - j] = True
    gram[k * (k + 1) // 2:] = float("nan")
    lam_tri[~valid] = float("nan")
    got = ps.tri_combine_solve_sample(gram, lam, rhs, noise, ALPHA,
                                      lam_tri_t=lam_tri)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_prior_rhs_and_packing_match_jax():
    """pack_prior_tri and prior_rhs_from_tri at 1e-5."""
    k, b = 16, 100
    rng = np.random.default_rng(5)
    lam = _spd_batch(rng, b, k, 2.0)
    packed = ps.pack_prior_tri(lam, k)
    np.testing.assert_allclose(packed, jax_ps.pack_prior_tri(lam, k),
                               rtol=1e-5, atol=1e-5)
    mu = rng.normal(size=k).astype(np.float32)
    p32 = packed.astype(np.float32)
    want = jax_ps.prior_rhs_from_tri(jnp.asarray(p32), jnp.asarray(mu))
    got = ps.prior_rhs_from_tri(torch.from_numpy(p32), torch.from_numpy(mu))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), (lam @ mu).T, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("side,pt,prior", [
    ("movies", "inkernel", None), ("users", "hoisted", None),
    ("users", "inkernel", "strict"), ("movies", "hoisted", "static"),
])
def test_split_half_sweep_matches_jax(side, pt, prior, monkeypatch):
    """The split half-sweep from one state, hyperprior and noise, with the
    shared prior or a per-item prior (rhs from the sampled mean, or
    static): the new items, stats and aggregates at 1e-4."""
    monkeypatch.setenv("BPMF_D8_SOLVE", "split")
    monkeypatch.setenv("BPMF_D8_PT", pt)
    k = 16
    rng = np.random.default_rng(11)
    payload = _payload(rng)
    maps = {s: _maps(n) for s, n in NUM.items()}
    codes = np.where(rng.random((512, 512)) < 0.1,
                     rng.integers(1, 6, size=(512, 512)), 0).astype(np.int8)
    other = "users" if side == "movies" else "movies"
    orientation = "cols" if side == "movies" else "rows"
    num, pn = NUM[side], maps[side].padded_num
    alpha, burnin, it = 2.0, 1, 3
    key = jax.random.PRNGKey(5)

    def padded(a):
        out = np.zeros((pn,) + a.shape[1:], np.float32)
        out[:num] = a
        return out

    prior_tri = prior_rhs = None
    if prior is not None:
        pl = _spd_batch(rng, pn, k, 2.0)
        pm = 0.1 * rng.normal(size=(pn, k))
        prior_tri = ps.pack_prior_tri(pl, k).astype(np.float32)
        if prior == "static":
            prior_rhs = np.einsum("skl,sl->sk", pl, pm).T.astype(np.float32)
    jax_state = JaxSideState(
        items=jnp.zeros((pn, k), jnp.float32),
        hp=JaxHyperParams.init(k),
        sum=jnp.zeros(k), cov=jnp.zeros((k, k)), norm=jnp.zeros(()),
        aggr_mu=jnp.asarray(padded(payload[f"{side}.aggr_mu"])),
        aggr_prod=jnp.asarray(padded(aggr_prod_pack(payload[f"{side}.aggr_prod"]))),
    )
    other_items = np.zeros((512, k), np.float32)
    other_items[:NUM[other]] = payload[f"{other}.items"]
    jax_hp = JaxHyperParams(*(jnp.asarray(payload[f"{side}.hp.{f}"], jnp.float32)
                              for f in ("mu", "lambda_f", "lambda_l")))
    lo = maps[side].local_orig

    def opt(a):
        return None if a is None else jnp.asarray(a)

    want = jax_spmd.dense8_half_sweep(
        jax_state, jnp.asarray(codes), jnp.asarray(other_items), key, it,
        num=num, local_orig=jnp.asarray(lo),
        local_valid=jnp.asarray(maps[side].local_valid), alpha=alpha,
        burnin=burnin, noise_scale=1.0, cs=CS, cb=CB, orientation=orientation,
        matmul_dtype=jnp.float32, interpret=True, hp=jax_hp,
        prior_tri_t=opt(prior_tri), prior_rhs_t=opt(prior_rhs),
    )

    state_m, state_u, _ = state_from_numpy(payload, maps["movies"],
                                           maps["users"], "cpu", torch.float32)
    state, frozen = ((state_m, state_u) if side == "movies"
                     else (state_u, state_m))
    noise = np.array(jax_item_noise(jax.random.fold_in(key, 1),
                                      jnp.asarray(lo[0]), k, jnp.float32,
                                      num=num))

    def topt(a):
        return None if a is None else torch.from_numpy(a)

    got = dense8_half_sweep(
        state, torch.from_numpy(codes), frozen.items, state.hp,
        torch.from_numpy(noise), it, num=num,
        local_valid=torch.from_numpy(maps[side].local_valid[0]), alpha=alpha,
        burnin=burnin, cs=CS, cb=CB, orientation=orientation, route=pt,
        prior_tri_t=topt(prior_tri), prior_rhs_t=topt(prior_rhs),
    )
    for f in ("items", "sum", "cov", "norm", "aggr_mu", "aggr_prod"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), err_msg=f,
                                   **TOL)


def _chains_agree(ref, port, n=3, tol=1e-4, items_tol=1e-3):
    for _ in range(n):
        want = jax.device_get(ref.step())
        got = port.step()
        for f in ("rmse", "rmse_avg", "norm_users", "norm_movies"):
            assert float(getattr(got, f)) == pytest.approx(
                float(getattr(want, f)), abs=tol), (port.iter, f)
    for side in ("users", "movies"):
        np.testing.assert_allclose(
            port.items_host(getattr(port, side), getattr(port, f"state_{side[0]}")),
            ref.items_host(getattr(ref, side), getattr(ref, f"state_{side[0]}")),
            rtol=items_tol, atol=items_tol)


def _small_data():
    return synth_movielens(n_users=300, n_movies=200, n_ratings=5000, seed=3)


def test_sampler_split_matches_jax(monkeypatch):
    """3 iterations at K=16 with BPMF_D8_SOLVE=split in both packages and
    JAX's draws injected: metrics at 1e-4.  (The hoisted operand is held
    to the JAX package by the half-sweep test.)"""
    monkeypatch.setenv("BPMF_D8_SOLVE", "split")
    train, test = _small_data()
    kw = dict(num_latent=16, nsims=3, burnin=1, n_devices=1)
    ref = JaxBPMF(Config(gram_impl="dense8", **kw), train=train, test=test,
                  out=open(os.devnull, "w"))
    port = BPMF(Config(**kw), train, test, out=open(os.devnull, "w"),
                device="cpu", draws=JaxDraws(42))
    ref.setup()
    port.setup()
    assert port.movies.route == port.users.route == "inkernel"
    _chains_agree(ref, port)


@pytest.mark.parametrize("k", [10, 24, 40])
def test_small_k_takes_megakernel(k):
    """K=10 (the Julia reference's default), K=24 and K=40 (past one row a
    lane, which the JAX package fuses up to 41) take the megakernel, as in
    the JAX package, and run."""
    train, test = _small_data()
    s = BPMF(Config(num_latent=k, nsims=2, burnin=1), train, test,
             device="cpu", out=open(os.devnull, "w"))
    mets = s.run_chunk(2)
    assert s.movies.route == s.users.route == "fused"
    assert np.isfinite(mets.rmse).all() and np.isfinite(mets.rmse_avg).all()


def _jax_route(k, items, frozen, orientation, peritem):
    """The JAX package's decision, spmd.py:846-892: (fused or split, the
    megakernel's layout, in-kernel or hoisted)."""
    mode = jax_d8.solve_fused_mode()
    fused = (jax_d8.solve_fused_enabled()
             and jax_d8.solve_fused_supported(k, mode) and not peritem)
    pt = jax_d8.pt_mode(items, frozen, k, fused, orientation)
    return ("fused" if fused else "split"), mode, pt


KNOBS = [{}, {"BPMF_D8_PT": "hoisted"}, {"BPMF_D8_SOLVE": "fused_aligned"}]


@pytest.mark.parametrize("k", [10, 16, 24, 32, 33, 36, 40, 41, 64])
@pytest.mark.parametrize("shape", [(6144, 4096), (167424, 512), (800256, 512)],
                         ids=["ml1m", "chembl", "tall"])
def test_route_matches_jax(k, shape, monkeypatch):
    """Per side, from the copied gates and no data, with no knob,
    BPMF_D8_PT=hoisted and BPMF_D8_SOLVE=fused_aligned: fused/split, the
    megakernel's operand (in-kernel, tight or aligned) and the split
    Gram's (in-kernel or hoisted) equal to the JAX package's at every K,
    the K 33-41 that the JAX package fuses past one row a lane among
    them."""
    for var in ("BPMF_D8_SOLVE", "BPMF_D8_PT", "BPMF_D8_BLOCKS"):
        monkeypatch.delenv(var, raising=False)
    r, c = shape
    for knob in KNOBS:
        with monkeypatch.context() as m:
            for var, value in knob.items():
                m.setenv(var, value)
            env = dict(solve=knob.get("BPMF_D8_SOLVE", "fused"),
                       pt=knob.get("BPMF_D8_PT", "auto"))
            for items, frozen, o in ((r, c, "rows"), (c, r, "cols")):
                for peritem in (False, True):
                    solve, mode, pt = _jax_route(k, items, frozen, o, peritem)
                    got = d8.d8_route(k, items, frozen, o, peritem=peritem, **env)
                    where = (knob, items, frozen, o, peritem)
                    if solve == "fused":
                        want = ("fused_aligned" if mode == "aligned"
                                else "fused_hoisted" if pt == "hoisted"
                                else "fused")
                    else:
                        want = pt
                    assert got == want, where
    want = {(64, (6144, 4096)): ("inkernel", "inkernel"),
            (64, (167424, 512)): ("hoisted", "inkernel"),
            (32, (800256, 512)): ("fused_hoisted", "fused"),
            (32, (167424, 512)): ("fused", "fused"),
            (16, (800256, 512)): ("fused", "fused"),
            (10, (6144, 4096)): ("fused", "fused"),
            (24, (800256, 512)): ("fused", "fused"),
            (40, (6144, 4096)): ("fused", "fused"),
            (40, (167424, 512)): ("fused_hoisted", "fused")}
    if (k, shape) in want:  # (rows side, cols side), no knob
        assert (d8.d8_route(k, r, c, "rows"),
                d8.d8_route(k, c, r, "cols")) == want[(k, shape)]


def test_route_refusals(monkeypatch):
    """The hoisted megakernel (#2) and the grouped layout (#7), which were
    refused until they were ported, are routes now: BPMF_D8_PT=hoisted and
    BPMF_D8_SOLVE=fused_aligned on a fused side, the first hoisted size at
    K=32 (759,808 padded items, 1,484 blocks of 512; 1,483 stay in-kernel),
    and BPMF_TRI_GROUPED=1 on a split side, which runs."""
    assert d8.d8_route(32, 6144, 4096, "rows", pt="hoisted") == "fused_hoisted"
    assert d8.d8_route(16, 6144, 4096, "cols", solve="fused_aligned") == "fused_aligned"
    assert d8.d8_route(64, 6144, 4096, "rows", solve="fused_aligned") == "inkernel"
    assert d8.d8_route(32, 1484 * 512, 512, "rows") == "fused_hoisted"
    assert d8.d8_route(32, 1483 * 512, 512, "rows") == "fused"
    assert d8.d8_route(32, 1484 * 512, 512, "rows", pt="inkernel") == "fused"
    train, test = _small_data()
    monkeypatch.setenv("BPMF_D8_SOLVE", "split")
    monkeypatch.setenv("BPMF_TRI_GROUPED", "1")
    s = BPMF(Config(num_latent=16, nsims=1), train, test, device="cpu",
             out=open(os.devnull, "w"))
    mets = s.run_chunk(1)
    assert s.grouped and s.movies.route == s.users.route == "inkernel"
    assert np.isfinite(mets.rmse).all()


def test_int16_codes_name_their_entry():
    """int16 codes, refused until they were ported, are decoded whole as the
    JAX kernels decode them (``codes.astype``): values from -32768 to 32767
    (0 absent) through the in-kernel Gram, against the JAX kernel at 1e-4."""
    codes, v_t = _codes_v(512, 512, 16, "cols", seed=4, code_dtype="int16",
                          code_range=(-32768, 32767))
    assert codes.min() < -255 and codes.max() > 255
    want, got = _gram_pair(codes, v_t, "cols", "inkernel", CS / 2 ** 14)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
