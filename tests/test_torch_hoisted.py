"""The megakernel with a hoisted packed operand (#2) and the grouped layout
of the packed-triangle solve (#7) in the port, against the JAX package:
the operand's layouts bit for bit, the kernel's plain version against the
JAX kernel (interpret mode, BPMF_D8_FOLD on and off), the grouped prior rhs
and per-item solve, and three sampler iterations under BPMF_D8_PT=hoisted,
BPMF_D8_SOLVE=fused_aligned and BPMF_TRI_GROUPED=1 with JAX's draws
injected."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bpmf_tpu.config import Config as JaxConfig
from bpmf_tpu.ops import dense8 as jax_d8
from bpmf_tpu.ops import pallas_solve as jax_ps
from bpmf_tpu.sampler import BPMF as JaxBPMF
from bpmf_tpu_torch.config import Config
from bpmf_tpu_torch.ops import dense8 as d8
from bpmf_tpu_torch.ops import pallas_solve as ps
from bpmf_tpu_torch.sampler import BPMF
from tests.test_torch_dense8 import case_ids
from tests.test_torch_kernel import ALPHA, CB, CS, CS16, _inputs, pack_tight
from tests.test_torch_prop import write_prop
from tests.test_torch_sampler import JaxDraws
from tests.test_torch_split import _chains_agree, _small_data

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)  # f32 on both sides, other summation orders


@pytest.fixture(autouse=True)
def knobs(monkeypatch):
    """No routing knob and the JAX package's layout pin unpinned."""
    for var in ("BPMF_TRI_GROUPED", "BPMF_D8_SOLVE", "BPMF_D8_PT",
                "BPMF_D8_FOLD", "BPMF_D8_BLOCKS"):
        monkeypatch.delenv(var, raising=False)
    jax_ps._tri_grouped_reset()
    yield
    jax_ps._tri_grouped_reset()


@pytest.mark.parametrize("k", [8, 10, 16, 32])
@pytest.mark.parametrize("aligned", [False, True])
def test_packed_tri_t_bit_equal(k, aligned):
    """Both layouts of the operand, padding rows included (the aligned
    layout's hold v[0]*v[0] in both packages)."""
    v_t = np.random.default_rng(k).normal(size=(k, 300)).astype(np.float32)
    want = np.asarray(jax_d8.packed_tri_t(jnp.asarray(v_t), aligned=aligned))
    got = d8.packed_tri_t(torch.from_numpy(v_t), aligned=aligned)
    assert tuple(got.shape) == want.shape
    assert got.shape[0] == (ps.tri_offsets(k)[1] if aligned else ps.tight_rows(k))
    np.testing.assert_array_equal(got.numpy(), want)


HOISTED_CASES = [
    (16, "rows", "tight", "1", "int8"), (16, "rows", "tight", "0", "int8"),
    (16, "cols", "tight", "1", "int8"), (16, "cols", "tight", "0", "int8"),
    (16, "rows", "aligned", "1", "int8"), (16, "rows", "aligned", "0", "int8"),
    (16, "cols", "aligned", "1", "int8"), (16, "cols", "aligned", "0", "int8"),
    (32, "rows", "tight", "1", "int8"), (32, "cols", "aligned", "1", "int8"),
    (16, "cols", "tight", "1", "int16"),
]


@pytest.mark.parametrize("k,orientation,layout,fold,code_dtype", HOISTED_CASES,
                         ids=case_ids(HOISTED_CASES))
def test_hoisted_sweep_solve_matches_jax(k, orientation, layout, fold,
                                         code_dtype, monkeypatch):
    """#2: the port's dense8_sweep_solve with a given p_t against the JAX
    kernel (_kernel_fused_solve) at 1e-4, with JAX's BPMF_D8_FOLD on and
    off (the port has no fold: the same sums, other rounding).  Every
    combination at K=16; two at K=32, whose interpret-mode trace takes
    12-14 s each; one on int16 codes 1..255."""
    monkeypatch.setenv("BPMF_D8_FOLD", fold)
    cs = CS if code_dtype == "int8" else CS16
    codes, v_t, lam, prior_rhs, noise_t = _inputs(512, 512, k, orientation,
                                                  seed=k + 1,
                                                  code_dtype=code_dtype)
    aligned = layout == "aligned"
    want = jax_d8.dense8_sweep_solve(
        jnp.asarray(codes), jax_d8.packed_tri_t(jnp.asarray(v_t), aligned=aligned),
        *(jnp.asarray(a) for a in (v_t, lam, prior_rhs, noise_t)),
        cs, CB, ALPHA, orientation, layout=layout, interpret=True)
    v = torch.from_numpy(v_t)
    launches = dict(d8.sweep_launches)
    got = d8.dense8_sweep_solve(
        torch.from_numpy(codes), d8.packed_tri_t(v, aligned=aligned), v,
        *(torch.from_numpy(a) for a in (lam, prior_rhs, noise_t)),
        cs, CB, ALPHA, orientation, layout=layout)
    assert d8.sweep_launches == launches  # CPU: plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("layout", ["tight", "aligned"])
def test_hoisted_plain_reads_valid_rows(layout):
    """NaN in every padding row of the operand changes nothing, and the
    result is the in-kernel route's (#1's plain version)."""
    codes, v_t, lam, prior_rhs, noise_t = (
        torch.from_numpy(a) for a in _inputs(512, 512, 16, "cols", seed=9))
    p_t = d8.packed_tri_t(v_t, aligned=layout == "aligned")
    pad = torch.ones(p_t.shape[0], dtype=torch.bool)
    pad[torch.as_tensor(d8._layout_rows(16, layout)[0])] = False
    assert pad.any()
    p_t[pad] = float("nan")
    rest = (lam, prior_rhs, noise_t, CS, CB, ALPHA, "cols")
    got = d8.dense8_sweep_solve(codes, p_t, v_t, *rest, layout=layout)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, d8.dense8_sweep_solve(codes, None, v_t, *rest),
                               rtol=1e-5, atol=1e-5)


def _grouped(monkeypatch):
    monkeypatch.setenv("BPMF_TRI_GROUPED", "1")
    jax_ps._tri_grouped_reset()


def test_grouped_prior_rhs_matches_jax(monkeypatch):
    """prior_rhs_from_tri on the top-aligned packed prior at 1e-5, and
    against Lambda @ mu."""
    _grouped(monkeypatch)
    k, b = 16, 100
    rng = np.random.default_rng(5)
    w = rng.normal(size=(b, k, k))
    lam = w @ w.transpose(0, 2, 1) / k + 2.0 * np.eye(k)
    packed = ps.pack_prior_tri(lam, k, grouped=True).astype(np.float32)
    mu = rng.normal(size=k).astype(np.float32)
    want = jax_ps.prior_rhs_from_tri(jnp.asarray(packed), jnp.asarray(mu))
    got = ps.prior_rhs_from_tri(torch.from_numpy(packed), torch.from_numpy(mu),
                                grouped=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), (lam @ mu).T, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("peritem", [False, True])
def test_grouped_solve_matches_jax(peritem, monkeypatch):
    """#7 at K=16: the JAX grouped kernel (interpret mode) fed
    tri_expand_rows of the tight Gram, the port's solve the tight Gram
    itself; per-item prior packed top-aligned.  u_t at 1e-4."""
    _grouped(monkeypatch)
    k, b = 16, 200
    rng = np.random.default_rng(17)
    x = rng.normal(size=(b, 20, k)) / np.sqrt(20)
    gram = pack_tight(x.transpose(0, 2, 1) @ x, k).astype(np.float32)
    w = rng.normal(size=(k, k))
    lam = (w @ w.T / k + np.eye(k)).astype(np.float32)
    wb = rng.normal(size=(b, k, k))
    lam_tri = ps.pack_prior_tri(wb @ wb.transpose(0, 2, 1) / k + np.eye(k), k,
                                grouped=True).astype(np.float32)
    rhs, noise = rng.normal(size=(2, k, b)).astype(np.float32)
    want = jax_ps.tri_combine_solve_sample(
        jax_ps.tri_expand_rows(jnp.asarray(gram), k), jnp.asarray(lam),
        jnp.asarray(rhs), jnp.asarray(noise), ALPHA, interpret=True,
        lam_tri_t=jnp.asarray(lam_tri) if peritem else None)
    assert jax_ps.tri_grouped(k)
    launches = dict(ps.solve_launches)
    got = ps.tri_combine_solve_sample(
        torch.from_numpy(gram), torch.from_numpy(lam), torch.from_numpy(rhs),
        torch.from_numpy(noise), ALPHA,
        lam_tri_t=torch.from_numpy(lam_tri) if peritem else None, grouped=True)
    assert ps.solve_launches == launches
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_grouped_needs_k_multiple_of_8():
    gram, lam, rhs, noise = (torch.zeros(s) for s in
                             ((ps.tight_rows(10), 4), (10, 10), (10, 4), (10, 4)))
    with pytest.raises(ValueError, match="K % 8"):
        ps.tri_combine_solve_sample(gram, lam, rhs, noise, ALPHA, grouped=True)


def _pair(train, test, **kw):
    kw = dict(num_latent=16, nsims=3, burnin=1, n_devices=1, **kw)
    ref = JaxBPMF(JaxConfig(gram_impl="dense8", **kw), train=train, test=test,
                  out=open(os.devnull, "w"))
    port = BPMF(Config(**kw), train, test, out=open(os.devnull, "w"),
                device="cpu", draws=JaxDraws(42))
    ref.setup()
    port.setup()
    return ref, port


@pytest.mark.parametrize("var,value,route", [
    ("BPMF_D8_PT", "hoisted", "fused_hoisted"),
    ("BPMF_D8_SOLVE", "fused_aligned", "fused_aligned"),
])
def test_sampler_hoisted_matches_jax(var, value, route, monkeypatch):
    """3 iterations at K=16 with the knob set for both packages (both sides
    on #2, the JAX package's _kernel_fused_solve in interpret mode, its
    fold on) and JAX's draws injected: metrics at 1e-4."""
    monkeypatch.setenv(var, value)
    ref, port = _pair(*_small_data())
    assert port.movies.route == port.users.route == route
    _chains_agree(ref, port)


def test_sampler_grouped_prop_matches_jax(tmp_path, monkeypatch):
    """BPMF_TRI_GROUPED=1 with -l on the users at K=16: their prior packed
    top-aligned in both packages (bit-equal), then 3 iterations through
    the grouped per-item solve (the movies on #1), metrics at 1e-4."""
    _grouped(monkeypatch)
    train, test = _small_data()
    ref, port = _pair(train, test, strict_reference=True,
                      prop_u=write_prop(tmp_path, 16, train.shape[0]))
    assert port.grouped and (port.users.route, port.movies.route) == (
        "inkernel", "fused")
    np.testing.assert_array_equal(port._aux["users"].prior_tri_t.numpy(),
                                  np.asarray(ref._aux["users"]["prior"][0]))
    _chains_agree(ref, port)
