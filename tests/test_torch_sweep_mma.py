"""The tensor-core megakernel (#1/#2 on bf16 operands, K <= 32,
``csrc/dense8_sweep_solve_mma.cu``) launches on
``ops.dense8.sweep_mma_plan``: blocks of 128 items, each with a group of
column units (two 64-column Gram tiles, or the rhs), the frozen axis in
64-entry chunks split into segments; the item block's blocks wait for each
other, then solve a share of its items each.  The plan at the shapes the
sampler takes (ml-1m, chembl both ways, the tall chembl, ml-25M at half
scale, Jester's scale; K 8/16/24/32; int8 and int16 codes; #1 and #2 in
both layouts): every item in one block, every Gram column and the rhs in
one group, the segments covering the frozen axis once and in order, the
shared memory, the scratch and an item block's blocks within the card's
and the port's limits; and ``sweep_bf16_kernel``, which picks it or the
walk by their cost models, held to both kernels' times on the card.  Pure
host logic and CPU runs: no card needed."""

import os

import numpy as np
import pytest
import torch

from bpmf_tpu_torch import Config, synth_jester, synth_movielens
from bpmf_tpu_torch.ops import dense8 as d8
from bpmf_tpu_torch.ops.dense8 import sweep_bf16_kernel, sweep_mma_plan
from bpmf_tpu_torch.ops.pallas_solve import tight_rows, tri_offsets

SMS = 132                  # an H100's SMs
BLOCK_SMEM = 232448        # shared memory one block may use on an H100

# (items, frozen): ml-1m synth's padded users (the code rows) and movies
# (the columns); chembl synth's 167,424 padded compounds over 512 proteins
# and the proteins over the compounds; the tall chembl (ExCAPE-DB's
# scale); the ml-25M synth at half scale, padded, both ways; synth_jester's
# users and jokes
SHAPES = [(6144, 4096), (4096, 6144), (167424, 512), (512, 167424), (800256, 512),
          (81408, 29696), (29696, 81408), (73728, 512), (512, 73728)]
IDS = [f"{i}x{f}" for i, f in SHAPES]
KS = (8, 16, 24, 32)


def _plans(items, frozen):
    """(K, the Gram's columns, plan) of #1 and of #2 in both layouts, at
    every K and on int8 and int16 codes."""
    for k in KS:
        for t_in in (None, tight_rows(k), tri_offsets(k)[1]):
            for code_bytes in (1, 2):
                cols = k * (k + 1) // 2 if t_in is None else t_in
                yield k, cols, t_in, code_bytes, sweep_mma_plan(
                    items, frozen, k, t_in, SMS, code_bytes=code_bytes)


@pytest.mark.parametrize("items,frozen", SHAPES, ids=IDS)
def test_every_item_and_column_in_one_block(items, frozen):
    """Item blocks cover the items once; the groups but the last cover the
    Gram's 64-column tiles once, two at most and one at least each, and
    the last group is the rhs."""
    for _, cols, _, _, plan in _plans(items, frozen):
        assert plan.item_blocks * d8.MMA_SWEEP_ITEMS == items
        tp = -(-cols // 64)
        seen = np.zeros(tp, int)
        for g in range(plan.groups - 1):
            tiles = range(g * plan.units_per_group,
                          min(tp, (g + 1) * plan.units_per_group))
            assert len(tiles) >= 1
            seen[list(tiles)] += 1
        assert (seen == 1).all() and 64 * tp >= cols


@pytest.mark.parametrize("items,frozen", SHAPES, ids=IDS)
def test_segments_cover_the_frozen_axis_in_order(items, frozen):
    chunks = frozen // d8.MMA_CHUNK
    for *_, plan in _plans(items, frozen):
        per = plan.chunks_per_segment
        ranges = [(s * per, min(chunks, (s + 1) * per)) for s in range(plan.segments)]
        assert all(e > b for b, e in ranges)
        assert [c for b, e in ranges for c in range(b, e)] == list(range(chunks))


@pytest.mark.parametrize("items,frozen", SHAPES, ids=IDS)
def test_memory_and_blocks_within_limits(items, frozen):
    """A block's shared memory fits the card's; an item block's groups x S
    blocks fit the card at once (they wait for each other); the counters
    are the tickets, the blocks done and two an item block; the scratch
    fits SCRATCH_LIMIT_BYTES, or the choice sends the launch to the walk."""
    for k, _, t_in, code_bytes, plan in _plans(items, frozen):
        assert plan.smem_bytes <= BLOCK_SMEM
        assert plan.groups * plan.segments <= SMS
        assert plan.counters == 2 + 2 * plan.item_blocks
        part = k * (k + 1) // 2 + k
        assert plan.scratch_shape == (plan.segments, items, part)
        fits = 4 * plan.segments * items * part <= d8.SCRATCH_LIMIT_BYTES
        operand = "inkernel" if t_in is None else "tight"
        # every entry rated: the tensor-core kernel wherever it fits
        assert fits == (sweep_bf16_kernel(items, frozen, items * frozen, k, operand,
                                          t_in, code_bytes) == "mma")


def test_tall_compounds_stay_on_the_walk():
    """800,256 compounds at K=32 would need 1.79 GB of scratch: past the
    cap, so #2 on them keeps the walk whatever the density."""
    assert sweep_bf16_kernel(800256, 512, 800256 * 512, 32, "tight",
                             tight_rows(32)) == "walk"
    assert sweep_bf16_kernel(167424, 512, 167424 * 512, 32, "tight",
                             tight_rows(32)) == "mma"


def _t_in(k, operand):
    return None if operand == "inkernel" else (
        tight_rows(k) if operand == "tight" else tri_offsets(k)[1])


@pytest.mark.parametrize("operand", ["inkernel", "tight", "aligned"])
@pytest.mark.parametrize("k", KS)
def test_choice_by_density(operand, k):
    """At ml-1m's padded shape the walk's model grows with its work (the
    rated entries as its blocks see them) and the tensor-core kernel's
    does not: the walk below the work where the two cross, the tensor-core
    kernel from there on; the walk with the work unknown (None) and with
    none rated, the tensor cores with every entry rated."""
    kp = next(c for c in d8.MMA_SWEEP_CAPACITIES if c >= k)
    t_in = _t_in(k, operand)
    items, frozen = 6144, 4096
    mma_us = sweep_mma_plan(items, frozen, kp, t_in).us
    zero_us = d8.sweep_walk_us(items, frozen, 0, kp, operand, t_in)
    edge = int(np.floor((mma_us - zero_us) / d8.WALK_RATING_US[operand][kp])) + 1
    assert 0 < edge < items * frozen
    assert sweep_bf16_kernel(items, frozen, None, k, operand, t_in) == "walk"
    assert sweep_bf16_kernel(items, frozen, 0, k, operand, t_in) == "walk"
    assert sweep_bf16_kernel(items, frozen, edge, k, operand, t_in) == "mma"
    assert sweep_bf16_kernel(items, frozen, edge - 1, k, operand, t_in) == "walk"
    assert sweep_bf16_kernel(items, frozen, items * frozen, k, operand, t_in) == "mma"


@pytest.mark.parametrize("k", [33, 40, 41])
def test_past_the_capacities_the_walk(k):
    assert sweep_bf16_kernel(6144, 4096, None, k) == "walk"
    assert sweep_bf16_kernel(6144, 4096, 6144 * 4096, k) == "walk"


# Both kernels' times per launch on chains' own state at K=32 (H100 80GB
# HBM3, 700 W; sweep_times.py --legs bf16_choice): the launch's (items,
# frozen), its walk work (walk_work of the chain's codes: the synths'
# padded order is the sampler's, from their seeds), the operand, then the
# tensor-core and the walk's ms
MEASURED = {
    "ml1m-users-inkernel": ((6144, 4096), 2416464, "inkernel", 0.2983, 0.3085),
    "ml1m-users-tight": ((6144, 4096), 2416464, "tight", 0.2993, 0.4296),
    "ml1m-users-aligned": ((6144, 4096), 2416464, "aligned", 0.3112, 0.5819),
    "ml1m-movies-inkernel": ((4096, 6144), 2945056, "inkernel", 0.2233, 0.3418),
    "ml1m-movies-tight": ((4096, 6144), 2945056, "tight", 0.2338, 0.4864),
    "ml1m-movies-aligned": ((4096, 6144), 2945056, "aligned", 0.2456, 0.6556),
    "ml100k-users-inkernel": ((1024, 2048), 243168, "inkernel", 0.0461, 0.0518),
    "ml100k-users-tight": ((1024, 2048), 243168, "tight", 0.0487, 0.0672),
    "ml100k-users-aligned": ((1024, 2048), 243168, "aligned", 0.0525, 0.0873),
    "ml100k-movies-inkernel": ((2048, 1024), 279128, "inkernel", 0.0498, 0.0631),
    "ml100k-movies-tight": ((2048, 1024), 279128, "tight", 0.0528, 0.0847),
    "ml100k-movies-aligned": ((2048, 1024), 279128, "aligned", 0.0564, 0.1096),
    "dense3000-users-inkernel": ((3072, 2048), 2516040, "inkernel", 0.1245, 0.2664),
    "dense3000-users-tight": ((3072, 2048), 2516040, "tight", 0.1288, 0.3363),
    "dense3000-users-aligned": ((3072, 2048), 2516040, "aligned", 0.1348, 0.4670),
    "dense3000-movies-inkernel": ((2048, 3072), 2577728, "inkernel", 0.0838, 0.2713),
    "dense3000-movies-tight": ((2048, 3072), 2577728, "tight", 0.0870, 0.3448),
    "dense3000-movies-aligned": ((2048, 3072), 2577728, "aligned", 0.0907, 0.4834),
    "chembl-users-inkernel": ((167424, 512), 1815472, "inkernel", 1.8897, 0.7478),
    "chembl-users-tight": ((167424, 512), 1815472, "tight", 2.0318, 0.7995),
    "chembl-users-aligned": ((167424, 512), 1815472, "aligned", 2.2493, 0.8720),
    "chembl-movies-inkernel": ((512, 167424), 2643272, "inkernel", 0.5742, 0.4555),
    "chembl-movies-tight": ((512, 167424), 2643272, "tight", 0.5823, 0.9745),
    "chembl-movies-aligned": ((512, 167424), 2643272, "aligned", 0.5899, 1.1326),
    "jester-users-inkernel": ((73728, 512), 6078808, "inkernel", 0.8504, 0.7804),
    "jester-users-tight": ((73728, 512), 6078808, "tight", 0.9277, 0.8305),
    "jester-users-aligned": ((73728, 512), 6078808, "aligned", 1.0295, 1.0965),
    "jester-movies-inkernel": ((512, 73728), 4102032, "inkernel", 0.2787, 0.7673),
    "jester-movies-tight": ((512, 73728), 4102032, "tight", 0.2873, 0.8845),
    "jester-movies-aligned": ((512, 73728), 4102032, "aligned", 0.2970, 1.2585),
}


@pytest.mark.parametrize("name", list(MEASURED))
def test_cost_models_pick_the_faster_kernel_measured(name):
    """Where the card timed both kernels on a chain's state, the choice
    costs at most 15% over the faster one; the tensor-core kernel's model
    is within 20% of its time, the walk's within 35%."""
    (items, frozen), work, operand, mma_ms, walk_ms = MEASURED[name]
    t_in = _t_in(32, operand)
    mma_us = sweep_mma_plan(items, frozen, 32, t_in).us
    walk_us = d8.sweep_walk_us(items, frozen, work, 32, operand, t_in)
    assert abs(mma_us / 1e3 / mma_ms - 1) < 0.20
    assert abs(walk_us / 1e3 / walk_ms - 1) < 0.35
    kern = sweep_bf16_kernel(items, frozen, work, 32, operand, t_in)
    assert (mma_ms if kern == "mma" else walk_ms) <= 1.15 * min(mma_ms, walk_ms)


def test_walk_work_is_each_block_at_its_most_rated():
    """walk_work sums, for each block of 8 items and each segment of the
    frozen axis, 8 times the block's most ratings in the segment: the
    rated entries when a block's items are rated alike, more on skew, at
    most the array's size; both orientations."""
    rng = np.random.default_rng(7)
    codes = np.where(rng.random((1024, 1536)) < rng.random((1024, 1))[:, :1] * 0.2,
                     rng.integers(1, 6, (1024, 1536)), 0).astype(np.int8)
    t = torch.from_numpy(codes)
    for orientation, c in (("rows", codes), ("cols", codes.T)):
        items, frozen = c.shape
        plan = d8.sweep_plan(items, frozen, 32, None)
        seg = plan.tiles_per_segment * 512
        want = sum(8 * int((c[:, s0:s0 + seg] != 0).sum(1).reshape(-1, 8).max(1).sum())
                   for s0 in range(0, frozen, seg))
        got = d8.walk_work(t, orientation, 32)
        assert got == want
        assert (c != 0).sum() < got <= c.size
    alike = torch.zeros((512, 1024), dtype=torch.int8)
    alike[:, :100] = 3
    assert d8.walk_work(alike, "rows", 16) == 512 * 100
    assert d8.walk_work(torch.ones((512, 512), dtype=torch.int8), "cols", 8) == 512 * 512


def test_plan_time_is_its_cost_model():
    """``us`` is a launch plus the waves of blocks times a block's chunks
    and fixed work at the plan's own segment count."""
    for items, frozen in SHAPES:
        for k in KS:
            plan = sweep_mma_plan(items, frozen, k, None, SMS)
            tiles = min(2, -(-(k * (k + 1) // 2) // 64))
            waves = -(-plan.item_blocks * plan.groups * plan.segments // SMS)
            want = d8.MMA_SWEEP_LAUNCH_US + waves * (plan.chunks_per_segment * (
                d8.MMA_SWEEP_CHUNK_US + tiles * d8.MMA_SWEEP_TILE_US)
                + d8.MMA_SWEEP_BLOCK_US)
            assert plan.us == pytest.approx(want)


def test_jester_scale_sides_fall_on_both_kernels():
    """synth_jester's padded codes (73,728 users x 512 jokes) at K=32 on
    #1: the users keep the walk, the jokes (few items, each rated by tens
    of thousands) take the tensor cores (walk work from MEASURED)."""
    assert sweep_bf16_kernel(73728, 512, 6078808, 32) == "walk"
    assert sweep_bf16_kernel(512, 73728, 4102032, 32) == "mma"


def test_synth_jester_rates_like_jester():
    """Every user rates the gauge jokes and 15 to 100 jokes in all, the
    ratings add up to n_ratings, train and test are disjoint."""
    train, test = synth_jester(n_users=600, n_ratings=33_000, seed=3)
    both = (train + test).tocsr()
    assert train.nnz + test.nnz == both.nnz == 33_000
    per = np.diff(both.indptr)
    assert per.min() >= 15 and per.max() <= 100
    assert (np.diff(both.tocsc().indptr)[:10] == 600).all()
    assert set(np.unique(both.data)) <= {1.0, 2.0, 3.0, 4.0, 5.0}


def test_segment_count_minimizes_the_cost_model():
    """S is the count of the cost model's least time among those the caps
    allow (ml-1m's users: one segment, its movies: two; chembl's proteins:
    several)."""
    def cost(items, frozen, plan):
        chunks = frozen // d8.MMA_CHUNK
        waves = -(-plan.item_blocks * plan.groups * plan.segments // SMS)
        return waves * (plan.chunks_per_segment * (
            d8.MMA_SWEEP_CHUNK_US + 2 * d8.MMA_SWEEP_TILE_US)
            + d8.MMA_SWEEP_BLOCK_US), chunks

    for items, frozen in SHAPES:
        plan = sweep_mma_plan(items, frozen, 32, None, SMS)
        best, chunks = cost(items, frozen, plan)
        for s in range(1, min(chunks, SMS // plan.groups) + 1):
            per = -(-chunks // s)
            other = plan._replace(segments=-(-chunks // per), chunks_per_segment=per)
            if 4 * other.segments * items * 560 <= d8.SCRATCH_LIMIT_BYTES:
                assert best <= cost(items, frozen, other)[0] + 1e-9


def test_mma_instance_keys():
    assert d8.sweep_mma_key(10, "aligned") == "aligned_mma_c16_bf16"
    assert d8.sweep_mma_key(32, "inkernel") == "inkernel_mma_c32_bf16"
    assert d8.sweep_mma_key(17, "tight") == "tight_mma_c24_bf16"


def test_wrapper_refuses_impossible_nnz():
    """The walk work must lie in 0..codes.numel()."""
    rng = np.random.default_rng(0)
    k, items, frozen = 8, 512, 512
    codes = torch.from_numpy(rng.integers(0, 3, (items, frozen)).astype(np.int8))
    v_t = torch.randn(k, frozen).bfloat16()
    lam = torch.eye(k)
    for work in (-1, items * frozen + 1):
        with pytest.raises(ValueError, match="walk_work"):
            d8.dense8_sweep_solve(codes, None, v_t, lam, torch.zeros(k, 1),
                                  torch.zeros(k, items), 1.0, 0.0, 2.0, "rows",
                                  walk_work=work)


def test_cpu_takes_the_plain_version_whatever_nnz():
    """On CPU tensors the wrapper runs the plain version for either choice,
    and no kernel counter moves."""
    rng = np.random.default_rng(1)
    k, items, frozen = 16, 512, 512
    codes = torch.from_numpy(
        np.where(rng.random((items, frozen)) < 0.1, rng.integers(1, 6, (items, frozen)), 0)
        .astype(np.int8))
    v_t = torch.from_numpy(0.5 * rng.standard_normal((k, frozen))).float().bfloat16()
    lam = torch.eye(k) * 2
    prior = torch.from_numpy(rng.standard_normal((k, 1))).float()
    noise = torch.from_numpy(rng.standard_normal((k, items))).float()
    before = (dict(d8.sweep_launches), dict(d8.sweep_instance_launches))
    want = d8.dense8_sweep_solve_ref(codes, None, v_t, lam, prior, noise, 0.7, -1.3,
                                     2.0, "rows")
    for work in (None, 0, codes.numel()):
        got = d8.dense8_sweep_solve(codes, None, v_t, lam, prior, noise, 0.7, -1.3,
                                    2.0, "rows", walk_work=work)
        assert torch.equal(got, want)
    assert (d8.sweep_launches, d8.sweep_instance_launches) == before


@pytest.mark.parametrize("knob", [{}, {"BPMF_D8_PT": "hoisted"}])
def test_sampler_passes_nnz(knob, monkeypatch):
    """Each dense8 side's half-sweep on bf16 operands hands the megakernel
    that side's walk work (walk_work of the code array in its
    orientation), on #1 and #2 alike; on float32 none."""
    from bpmf_tpu_torch.sampler import BPMF
    import bpmf_tpu_torch.parallel.spmd as spmd

    for name, value in knob.items():
        monkeypatch.setenv(name, value)
    seen = []
    real = spmd.dense8_sweep_solve

    def spy(*args, **kw):
        seen.append(kw.get("walk_work"))
        return real(*args, **kw)

    monkeypatch.setattr(spmd, "dense8_sweep_solve", spy)
    train, test = synth_movielens(n_users=300, n_movies=200, n_ratings=5000, seed=4)
    s = BPMF(Config(num_latent=8, nsims=1, burnin=0, matmul_dtype="bfloat16"),
             train, test, out=open(os.devnull, "w"), device="cpu")
    s.run_chunk(1)
    assert s.movies.route == s.users.route == ("fused_hoisted" if knob else "fused")
    want = [d8.walk_work(s._codes, "cols", 8, s._d8_max_degree["movs"]),
            d8.walk_work(s._codes, "rows", 8, s._d8_max_degree["users"])]
    assert seen == want and train.nnz < min(want)
    seen.clear()
    s = BPMF(Config(num_latent=8, nsims=1, burnin=0), train, test,
             out=open(os.devnull, "w"), device="cpu")
    s.run_chunk(1)
    assert seen == [None, None]
