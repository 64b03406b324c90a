"""bf16 matmul inputs (``Config.matmul_dtype="bfloat16"``), the kernels'
plain versions: the megakernel's (#1 with the products built in the kernel,
#2 on a hoisted operand in the tight and the aligned layout, at the
capacities' own K and at a runtime K) and the split Gram's (#3, #4)
against the JAX kernels on bf16 operands in interpret mode; a guard that
the bf16 Gram rounds; and the sampler's surface (``unsupported()``, the
auto dtype, the banner).

The constants cs = 0.7 and cb = -1.3 are not bf16 values, so the fold's
rounding of cs*v and cb*v shows (with cs = 0.5, cb = -1.0 every form agrees
bit for bit and a test proves nothing)."""

import io

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bpmf_tpu.ops import dense8 as jax_d8
from bpmf_tpu_torch import Config, synth_movielens
from bpmf_tpu_torch.ops import dense8 as d8
from bpmf_tpu_torch.sampler import BPMF, unsupported
from tests.test_torch_kernel import _inputs

torch.set_num_threads(1)

CS, CB, ALPHA = 0.7, -1.3, 2.0
DRAW_TOL = dict(rtol=1e-4, atol=1e-4)  # f32 sums in other orders; the f32
                                       # operands' draws sit 1.4e-3 to 1.4e-2
                                       # away (measured at these inputs)
GRAM_REL = 1e-5       # Gram and fold-1 rhs, relative to the largest entry
FOLD0_REL = 1e-2      # rhs against the JAX package's BPMF_D8_FOLD=0 (2e-3 to
                      # 4.5e-3 measured): it rounds cs*code + cb instead


@pytest.fixture(autouse=True)
def knobs(monkeypatch):
    for var in ("BPMF_D8_SOLVE", "BPMF_D8_PT", "BPMF_D8_FOLD", "BPMF_D8_BLOCKS",
                "BPMF_TRI_GROUPED"):
        monkeypatch.delenv(var, raising=False)


def _bf16(a: np.ndarray):
    """(the JAX bf16 array, the same values as a torch bf16 tensor)."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


def _packed(v_j, aligned):
    """The one-device hoisted operand at bf16 (``bpmf_tpu/parallel/
    spmd.py:866``): the products of the rounded side, rounded."""
    p = jax_d8.packed_tri_t(v_j.astype(jnp.float32), aligned=aligned)
    return _bf16(np.asarray(p))


# (K, operand, orientation, codes): every K class of the megakernel (8 and
# 40 run #2 at a runtime K on the capacities 8 and 40; 16 and 32 on their
# own instances), both layouts of #2 (the aligned one up to K = 39), rows
# and cols, and int16 codes 1..255 once
SWEEP_CASES = [
    (8, "inkernel", "rows", "int8"), (8, "tight", "cols", "int8"),
    (8, "aligned", "rows", "int8"),
    (16, "inkernel", "cols", "int8"), (16, "tight", "rows", "int8"),
    (16, "aligned", "cols", "int8"), (16, "inkernel", "rows", "int16"),
    (32, "inkernel", "rows", "int8"), (32, "tight", "cols", "int8"),
    (32, "aligned", "rows", "int8"),
    (40, "inkernel", "cols", "int8"), (40, "tight", "rows", "int8"),
]


@pytest.mark.parametrize("k,operand,orientation,code_dtype", SWEEP_CASES,
                         ids=["-".join(map(str, c)) for c in SWEEP_CASES])
def test_sweep_solve_bf16_matches_jax(k, operand, orientation, code_dtype):
    """#1 and #2 at bf16: the port's plain version against the JAX kernel
    (``_kernel_fused_solve_inpt``, ``_kernel_fused_solve`` with its default
    fold) in interpret mode, draws within 1e-4; and no launch counted."""
    codes, v_t, lam, prior_rhs, noise_t = _inputs(512, 512, k, orientation,
                                                  seed=k + 3, code_dtype=code_dtype)
    cs = CS if code_dtype == "int8" else CS / 64
    v_j, v = _bf16(v_t)
    p_j = p = None
    layout = "aligned" if operand == "inkernel" else operand
    if operand != "inkernel":
        p_j, p = _packed(v_j, operand == "aligned")
    rest = (lam, prior_rhs, noise_t)
    want = jax_d8.dense8_sweep_solve(
        jnp.asarray(codes), p_j, v_j, *(jnp.asarray(a) for a in rest),
        cs, CB, ALPHA, orientation, layout=layout, interpret=True)
    before = (dict(d8.sweep_launches), dict(d8.sweep_instance_launches))
    got = d8.dense8_sweep_solve(
        torch.from_numpy(codes), p, v, *(torch.from_numpy(a) for a in rest),
        cs, CB, ALPHA, orientation, layout=layout)
    assert (d8.sweep_launches, d8.sweep_instance_launches) == before  # CPU: plain
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **DRAW_TOL)


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


@pytest.mark.parametrize("k", [16, 32, 42, 64, 65, 79])
@pytest.mark.parametrize("orientation", ["rows", "cols"])
@pytest.mark.parametrize("pt", ["inkernel", "hoisted"])
def test_gram_rhs_bf16_matches_jax(k, orientation, pt, monkeypatch):
    """#3 and #4 at bf16 against the JAX kernels in interpret mode: the
    Gram's valid rows and the rhs within 1e-5 (relative to the largest
    entry) of the JAX default (fold 1); #4's rhs also within 1e-2 of the
    JAX package's fold 0, which rounds cs*code + cb and so differs in
    rounding only.  K 42, 65 and 79 are the split route's own (one rhs
    tile and the last Gram tile partial; two rhs tiles) on the card's
    tensor-core kernel."""
    codes, v_t, *_ = _inputs(512, 512, k, orientation, seed=40 + k)
    v_j, v = _bf16(v_t)
    p_j = p = None
    if pt == "hoisted":
        p_j, p = _packed(v_j, False)
    jax_fn = getattr(jax_d8, "dense8_gram_rhs_" + orientation)
    fn = getattr(d8, "dense8_gram_rhs_" + orientation)
    before = dict(d8.gram_launches)
    gram, rhs = fn(torch.from_numpy(codes), p, v, CS, CB)
    assert d8.gram_launches == before                  # CPU: the plain version
    tv = k * (k + 1) // 2
    want_g, want_r = jax_fn(jnp.asarray(codes), p_j, v_j, CS, CB, interpret=True)
    assert gram.dtype == rhs.dtype == torch.float32
    assert _rel(gram[:tv], want_g[:tv]) <= GRAM_REL
    assert _rel(rhs, want_r) <= GRAM_REL
    if pt == "hoisted":
        monkeypatch.setenv("BPMF_D8_FOLD", "0")
        _, want_r0 = jax_fn(jnp.asarray(codes), p_j, v_j, CS, CB, interpret=True)
        assert GRAM_REL < _rel(rhs, want_r0) <= FOLD0_REL


@pytest.mark.parametrize("k", [42, 79])
@pytest.mark.parametrize("orientation", ["rows", "cols"])
@pytest.mark.parametrize("pt", ["inkernel", "hoisted"])
def test_gram_rhs_bf16_int16_matches_jax(k, orientation, pt):
    """#3 and #4 at bf16 on int16 codes 1..255 (the codes of 128-255
    rating levels, exact in bf16) against the JAX kernels in interpret
    mode, within 1e-5 relative, as int8's."""
    codes, v_t, *_ = _inputs(512, 512, k, orientation, seed=50 + k,
                             code_dtype="int16")
    cs = CS / 64
    v_j, v = _bf16(v_t)
    p_j = p = None
    if pt == "hoisted":
        p_j, p = _packed(v_j, False)
    jax_fn = getattr(jax_d8, "dense8_gram_rhs_" + orientation)
    fn = getattr(d8, "dense8_gram_rhs_" + orientation)
    gram, rhs = fn(torch.from_numpy(codes), p, v, cs, CB)
    tv = k * (k + 1) // 2
    want_g, want_r = jax_fn(jnp.asarray(codes), p_j, v_j, cs, CB, interpret=True)
    assert _rel(gram[:tv], want_g[:tv]) <= GRAM_REL
    assert _rel(rhs, want_r) <= GRAM_REL


@pytest.mark.parametrize("orientation", ["rows", "cols"])
def test_bf16_gram_rounds(orientation):
    """The guard: the port's bf16 Gram (#3's plain version) differs from
    its float32 Gram of the same side by more than 1e-4 (relative), while
    it matches the JAX package's bf16 Gram within 1e-5: the bf16 path
    rounds, and where the JAX package rounds."""
    codes, v_t, *_ = _inputs(512, 512, 32, orientation, seed=77)
    v_j, v = _bf16(v_t)
    fn = getattr(d8, "dense8_gram_rhs_" + orientation)
    tv = 32 * 33 // 2
    bf, _ = fn(torch.from_numpy(codes), None, v, CS, CB)
    f32, _ = fn(torch.from_numpy(codes), None, torch.from_numpy(v_t), CS, CB)
    jax_fn = getattr(jax_d8, "dense8_gram_rhs_" + orientation)
    want, _ = jax_fn(jnp.asarray(codes), None, v_j, CS, CB, interpret=True)
    assert _rel(bf[:tv], f32[:tv]) > 1e-4
    assert _rel(bf[:tv], want[:tv]) <= GRAM_REL


def test_fold_weights_round_cs_first():
    """The fold's weights: cs and cb rounded to bf16, then each product of
    a bf16 entry rounded, as ``v_t * v_t.dtype.type(cs)`` in the JAX
    package."""
    v = np.random.default_rng(0).normal(size=(4, 50)).astype(np.float32)
    v_j, v_t = _bf16(v)
    ws, wb = d8.fold_weights(v_t, CS, CB)
    for got, c in ((ws, CS), (wb, CB)):
        want = np.asarray((v_j * v_j.dtype.type(c)).astype(jnp.float32))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kw", [
    dict(matmul_dtype="bfloat16"),
    dict(matmul_dtype="bfloat16", gram_impl="bucketed", comm_mode="reduce"),
    dict(matmul_dtype="bfloat16", dtype="float64", gram_impl="dense"),
])
def test_unsupported_is_empty(kw):
    """Every Config is ported: bf16 matmul inputs on any route or dtype."""
    assert unsupported(Config(**kw)) == []


def test_auto_stays_float32_on_the_card():
    """``auto`` resolves to float32 off a TPU (the JAX package's rule, kept
    by the port's copy of its Config), so no default route changes."""
    assert Config().resolve_matmul_dtype("cuda") == "float32"
    assert Config(matmul_dtype="bfloat16").resolve_matmul_dtype("cuda") == "bfloat16"
    train, test = synth_movielens(n_users=120, n_movies=80, n_ratings=1500, seed=2)
    s = BPMF(Config(num_latent=8, nsims=1), train, test, out=io.StringIO(),
             device="cpu")
    s.setup()
    assert s._md == torch.float32


def test_banner_names_bf16():
    """The banner says bf16 and counts the dense blocks' bytes at 2 a
    value (``bpmf_tpu/sampler.py:1031-1035``)."""
    train, test = synth_movielens(n_users=120, n_movies=80, n_ratings=1500, seed=2)
    out = io.StringIO()
    s = BPMF(Config(num_latent=8, nsims=1, matmul_dtype="bfloat16",
                    gram_impl="dense"), train, test, out=out, device="cpu")
    s.setup()
    text = out.getvalue()
    assert "dtype float32, matmul inputs bfloat16" in text
    for side in (s.movies, s.users):
        a_ind, a_val = s._aux[side.name].dense
        assert a_ind.dtype == a_val.dtype == torch.bfloat16
        lp, opn = a_val.shape
        assert (f"gram layout {side.name}: dense adjacency 1x{lp}x{opn} x2 blocks "
                f"({2 * lp * opn * 2 / 1e6:.0f} MB bfloat16)") in text
