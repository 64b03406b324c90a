"""The split pipeline's hoisted Gram (#4, ``dense8_gram_rhs_rows/cols``
with a packed operand p_t): how its kernel splits the frozen axis
(``ops.dense8.hoisted_plan``: the segment count from the shape, the side's
degree and the L2 budget for p's rows; every tile in one segment; the
scratch and counter shapes), the operand the wrapper hands the kernel and
what it refuses, the degree the sampler passes under
``BPMF_D8_PT=hoisted``, and the plain version against the JAX kernel
(``bpmf_tpu/ops/dense8.py:339 _kernel``) in interpret mode.  No card
needed."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bpmf_tpu.ops import dense8 as jax_d8
from bpmf_tpu_torch import Config, synth_movielens
from bpmf_tpu_torch.ops import dense8 as d8
from bpmf_tpu_torch.ops.dense8 import SweepPlan, hoisted_plan, sweep_plan
from bpmf_tpu_torch.ops.pallas_solve import tight_rows
from tests.test_torch_kernel import CB, CS, CS16

torch.set_num_threads(1)

TILE = d8.BLOCK_MULTIPLE
TOL = dict(rtol=1e-4, atol=1e-4)  # f32 on both sides, other summation orders

# (items, frozen, t, k, max_degree): the [6144, 4096] kernel inputs at K=64
# both ways, chembl synth's compounds (one tile) and proteins (the most
# rated with 61,253 of 167,424 compounds) at K=64, a K=79 side with an item
# rating every frozen entry, a K=16 one, and a side of one tile
SHAPES = [
    (6144, 4096, 2080, 64, None),
    (4096, 6144, 2080, 64, None),
    (167424, 512, 2080, 64, 163),
    (512, 167424, 2080, 64, 61253),
    (6144, 4096, 3168, 79, 4096),
    (4096, 6144, 144, 16, 6144),
    (512, 512, 528, 32, None),
]


@pytest.mark.parametrize("items,frozen,t,k,max_degree", SHAPES)
def test_hoisted_every_tile_in_one_segment(items, frozen, t, k, max_degree):
    tiles = frozen // TILE
    plan = hoisted_plan(items, frozen, t, k, max_degree)
    per = plan.tiles_per_segment
    ranges = [(s * per, min(tiles, (s + 1) * per)) for s in range(plan.segments)]
    assert [x for b, e in ranges for x in range(b, e)] == list(range(tiles))
    assert all(e > b for b, e in ranges)
    assert 1 <= plan.segments <= tiles


@pytest.mark.parametrize("items,frozen,t,k,max_degree", SHAPES)
def test_hoisted_scratch_and_counters(items, frozen, t, k, max_degree):
    """S > 1: a [S, items, t + roundup(K, 4)] f32 scratch (an item's packed
    Gram, padding rows included, and its rhs, each row on a float4
    boundary), one counter per block of 8 items; S = 1: neither."""
    plan = hoisted_plan(items, frozen, t, k, max_degree)
    if plan.segments == 1:
        assert plan == SweepPlan(1, frozen // TILE, (), 0)
    else:
        part = t + -(-k // 4) * 4
        assert plan.scratch_shape == (plan.segments, items, part)
        assert part % 4 == 0
        assert plan.counters == items // d8.ITEMS_PER_BLOCK
        assert 4 * np.prod(plan.scratch_shape) <= d8.SCRATCH_LIMIT_BYTES


@pytest.mark.parametrize("items,frozen,t,k,max_degree", SHAPES)
def test_hoisted_segments_fit_l2_budget(items, frozen, t, k, max_degree):
    """The rows of p (t floats each) of the segments whose blocks run at
    once (two blocks of 8 items an SM, 132 SMs) stay within the L2 budget
    where one tile a segment fits it, or the scratch cap forbids more
    segments; and S is never below #3's rule for the same side
    (sweep_plan), which the L2 budget only adds to."""
    plan = hoisted_plan(items, frozen, t, k, max_degree)
    at_once = -(-2 * 132 // (items // d8.ITEMS_PER_BLOCK))
    rows = at_once * plan.tiles_per_segment * TILE
    fit = max(1, d8.HOISTED_L2_BYTES // (4 * t * TILE * at_once))  # tiles
    capped = -(-(frozen // TILE) // fit) > d8.SCRATCH_LIMIT_BYTES // (
        4 * items * (t + -(-k // 4) * 4))
    assert 4 * t * rows <= d8.HOISTED_L2_BYTES or plan.tiles_per_segment == 1 or capped
    assert plan.segments >= sweep_plan(items, frozen, k, max_degree).segments


def test_hoisted_plan_of_the_sides():
    """[6144, 4096] at K=64: the rows' 768 item blocks fill the card, so
    one segment runs at a time and all of p (34 MB) fits the L2 budget: no
    split; the columns' 512 blocks take two segments for two waves.
    chembl synth's compounds whole (one tile); its proteins (64 blocks a
    segment, 5 segments at once) in 164 segments of 2 tiles, as many as
    the 1 GiB scratch allows, against the in-kernel Gram's 30
    (sweep_plan).  By degree: at most 512 of the most-rated item's
    ratings a segment (sweep_plan's rule allows 2048): ml-1m synth's
    users at K=64 (1832) in 4 segments where sweep_plan keeps them whole,
    a K=16 side with an item rating all 6144 frozen entries in 12."""
    assert hoisted_plan(6144, 4096, 2080, 64) == SweepPlan(1, 8, (), 0)
    assert hoisted_plan(4096, 6144, 2080, 64)[:2] == (2, 6)
    assert hoisted_plan(167424, 512, 2080, 64, 163) == SweepPlan(1, 1, (), 0)
    assert hoisted_plan(512, 167424, 2080, 64, 61253)[:2] == (164, 2)
    assert sweep_plan(512, 167424, 64, 61253).segments == 30
    assert hoisted_plan(6144, 4096, 2080, 64, 1832)[:2] == (4, 2)
    assert sweep_plan(6144, 4096, 64, 1832).segments == 1
    assert hoisted_plan(4096, 6144, 144, 16, 6144)[:2] == (12, 1)
    assert hoisted_plan(4096, 6144, 144, 16).segments == 2


def test_hoisted_plan_scratch_cap():
    """A wide side whose L2 budget asks for more segments than a 1 GiB
    scratch holds gets fewer, and its scratch stays under the limit."""
    items, frozen = 40960, 64 * TILE
    plan = hoisted_plan(items, frozen, 3168, 79)
    want = -(-64 // (d8.HOISTED_L2_BYTES // (4 * 3168 * TILE)))  # for L2
    assert 1 < plan.segments < want
    assert 4 * np.prod(plan.scratch_shape) <= d8.SCRATCH_LIMIT_BYTES


def _cpu_inputs(k=8, items=512, frozen=1024, seed=0):
    rng = np.random.default_rng(seed)
    codes = torch.from_numpy(np.where(rng.random((items, frozen)) < 0.05,
                                      rng.integers(1, 6, (items, frozen)),
                                      0).astype(np.int8))
    v_t = torch.from_numpy((0.5 * rng.normal(size=(k, frozen))).astype(np.float32))
    return codes, v_t


@pytest.mark.parametrize("k", [16, 64])
def test_packed_operand_reaches_the_kernel_uncopied(k):
    """packed_tri_t lays p item-major, so the rows #4 reads are p_t's own
    storage; a batch-last p_t of the same values is copied once."""
    _, v_t = _cpu_inputs(k=k)
    p_t = d8.packed_tri_t(v_t)
    p = d8._hoisted_rows(p_t)
    assert p.data_ptr() == p_t.data_ptr() and p.is_contiguous()
    assert tuple(p.shape) == (v_t.shape[1], tight_rows(k))
    batch_last = p_t.contiguous()
    q = d8._hoisted_rows(batch_last)
    assert q.data_ptr() != batch_last.data_ptr() and torch.equal(q, p)


@pytest.mark.parametrize("t", [530, d8.HOISTED_MAX_ROWS + 4])
def test_hoisted_rows_refused(t):
    """The kernel reads p's rows as float4s with at most 26 of them a
    lane: a T off a multiple of 4, or past HOISTED_MAX_ROWS, is refused."""
    with pytest.raises(ValueError, match="multiple of 4"):
        d8._hoisted_rows(torch.zeros((t, 512)).t().contiguous().t())


@pytest.mark.parametrize("max_degree", [-1, 1025])
def test_hoisted_wrapper_refuses_impossible_degree(max_degree):
    """The degree is checked before any plan is cut from it, p_t given or
    not, on any device."""
    codes, v_t = _cpu_inputs()
    with pytest.raises(ValueError, match="max_degree"):
        d8.dense8_gram_rhs_rows(codes, d8.packed_tri_t(v_t), v_t, CS, CB,
                                max_degree=max_degree)


def test_hoisted_wrapper_refuses_p_t_of_another_side():
    codes, v_t = _cpu_inputs()
    with pytest.raises(ValueError, match="p_t has shape"):
        d8.dense8_gram_rhs_cols(codes, d8.packed_tri_t(v_t), v_t[:, :512], CS, CB)


@pytest.mark.parametrize("k,knob", [
    (16, {"BPMF_D8_SOLVE": "split", "BPMF_D8_PT": "hoisted"}),
    (79, {"BPMF_D8_PT": "hoisted"}),
])
def test_sampler_passes_max_degree_to_hoisted_gram(k, knob, monkeypatch):
    """Under BPMF_D8_PT=hoisted each side hands #4 a p_t and the most
    ratings any of its items has, as it does #3 and the megakernel."""
    import bpmf_tpu_torch.parallel.spmd as spmd
    from bpmf_tpu_torch.sampler import BPMF

    for name, value in knob.items():
        monkeypatch.setenv(name, value)
    seen = []

    def spy(orientation, real):
        def fn(codes, p_t, *args, **kw):
            seen.append((orientation, p_t is not None, kw.get("max_degree")))
            return real(codes, p_t, *args, **kw)
        return fn

    monkeypatch.setattr(spmd, "dense8_gram_rhs_rows",
                        spy("rows", spmd.dense8_gram_rhs_rows))
    monkeypatch.setattr(spmd, "dense8_gram_rhs_cols",
                        spy("cols", spmd.dense8_gram_rhs_cols))
    train, test = synth_movielens(n_users=300, n_movies=200, n_ratings=5000,
                                  seed=4)
    s = BPMF(Config(num_latent=k, nsims=1, burnin=0), train, test,
             out=open(os.devnull, "w"), device="cpu")
    s.run_chunk(1)
    assert s.movies.route == s.users.route == "hoisted"
    want = {("cols", True, int(np.diff(train.tocsc().indptr).max())),
            ("rows", True, int(np.diff(train.tocsr().indptr).max()))}
    assert set(seen) == want and len(seen) == 2


# (k, orientation, BPMF_D8_FOLD, code dtype): every K instance class of the
# card kernel (t_out 144, 576, 2080, 3168 in the tight layout), both
# orientations, the JAX kernel's fold on and off, int8 and int16 codes
JAX_CASES = [(k, o, f, c) for k in (16, 33, 64, 79)
             for o, f, c in (("rows", "1", "int8"), ("cols", "0", "int8"),
                             ("rows", "0", "int16"), ("cols", "1", "int16"))]


@pytest.mark.parametrize("k,orientation,fold,code_dtype", JAX_CASES)
def test_hoisted_gram_matches_jax(k, orientation, fold, code_dtype, monkeypatch):
    """#4's plain version against the JAX kernel in interpret mode on the
    same seeded codes and frozen items: gram_t (padding rows included: both
    sum every row of p_t) and rhs_t at 1e-4 (f32 on both sides, other
    summation orders; the fold changes only rounding)."""
    monkeypatch.setenv("BPMF_D8_FOLD", fold)
    rng = np.random.default_rng(100 + k)
    r, c = (512, 1024) if orientation == "rows" else (1024, 512)
    hi = 5 if code_dtype == "int8" else 255
    codes = np.where(rng.random((r, c)) < 0.08, rng.integers(1, hi + 1, (r, c)),
                     0).astype(code_dtype)
    v_t = (0.3 * rng.normal(size=(k, 1024))).astype(np.float32)  # frozen: 1024
    cs = CS if code_dtype == "int8" else CS16
    jax_fn = {"rows": jax_d8.dense8_gram_rhs_rows,
              "cols": jax_d8.dense8_gram_rhs_cols}[orientation]
    want = jax_fn(jnp.asarray(codes), jax_d8.packed_tri_t(jnp.asarray(v_t)),
                  jnp.asarray(v_t), cs, CB, interpret=True)
    port_fn = {"rows": d8.dense8_gram_rhs_rows,
               "cols": d8.dense8_gram_rhs_cols}[orientation]
    v = torch.from_numpy(v_t)
    launches = dict(d8.gram_launches)
    got = port_fn(torch.from_numpy(codes), d8.packed_tri_t(v), v, cs, CB,
                  max_degree=1024)
    assert d8.gram_launches == launches  # CPU: the plain version
    assert tuple(got[0].shape) == (tight_rows(k), 512)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
