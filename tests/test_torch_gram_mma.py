"""The tensor-core Gram (bf16 #3/#4, ``csrc/dense8_gram_mma.cu``) launches
on ``ops.dense8.mma_plan``: blocks of 128 items x 128 Gram columns (or 64
rhs entries), the frozen axis in 64-entry chunks split into segments where
the tiles are too few to fill the card.  The plan at the shapes the split
route takes: every output element in one tile, the segments covering the
frozen axis once and in order, the shared memory and the scratch within
the card's and the port's limits, and enough blocks for two waves.  Pure
host logic: no card needed."""

import numpy as np
import pytest

from bpmf_tpu_torch.ops import dense8 as d8
from bpmf_tpu_torch.ops.dense8 import mma_plan
from bpmf_tpu_torch.ops.pallas_solve import tight_rows, tri_offsets

SMS = 132                     # an H100's SMs
BLOCK_SMEM = 227 * 1024       # shared memory one block may use on an H100
SM_SMEM = 228 * 1024          # ... and one SM holds, 1 KB of it reserved a block

# (items, frozen, K): ml-1m synth's padded users (the code rows) and movies
# (the columns) at every K class of the split route; chembl synth at K=64,
# its 167,424 padded compounds over 512 proteins and the proteins over the
# compounds; and the tall chembl (ExCAPE-DB's scale) at K=32 and 64
SHAPES = [(6144, 4096, k) for k in (42, 48, 64, 79)]
SHAPES += [(4096, 6144, k) for k in (42, 48, 64, 79)]
SHAPES += [(167424, 512, 64), (512, 167424, 64), (800256, 512, 32), (800256, 512, 64)]
IDS = [f"{i}x{f}-k{k}" for i, f, k in SHAPES]


def _plans(items, frozen, k):
    """The plan for #3's tight T and for #4 on an aligned operand, each on
    int8 and int16 codes."""
    for t in sorted({tight_rows(k), tri_offsets(k)[1]}):
        for code_bytes in (1, 2):
            yield t, mma_plan(items, frozen, t, k, SMS, code_bytes=code_bytes)


@pytest.mark.parametrize("items,frozen,k", SHAPES, ids=IDS)
def test_every_output_in_one_tile(items, frozen, k):
    """Item tiles x column tiles cover the Gram [items, T] and the rhs
    [items, K] once each, and no tile is empty."""
    for t, plan in _plans(items, frozen, k):
        assert plan.item_tiles * d8.MMA_ITEMS == items
        gram = np.zeros(t, int)
        rhs = np.zeros(k, int)
        for ct in range(plan.gram_tiles + plan.rhs_tiles):
            if ct < plan.gram_tiles:
                lo = ct * d8.MMA_COLS
                assert lo < t
                gram[lo: lo + d8.MMA_COLS] += 1
            else:
                lo = (ct - plan.gram_tiles) * d8.MMA_RHS
                assert lo < k
                rhs[lo: lo + d8.MMA_RHS] += 1
        assert (gram == 1).all() and (rhs == 1).all()


@pytest.mark.parametrize("items,frozen,k", SHAPES, ids=IDS)
def test_segments_cover_the_frozen_axis_in_order(items, frozen, k):
    chunks = frozen // d8.MMA_CHUNK
    for _, plan in _plans(items, frozen, k):
        per = plan.chunks_per_segment
        ranges = [(s * per, min(chunks, (s + 1) * per)) for s in range(plan.segments)]
        assert all(e > b for b, e in ranges)
        assert [c for b, e in ranges for c in range(b, e)] == list(range(chunks))


@pytest.mark.parametrize("items,frozen,k", SHAPES, ids=IDS)
def test_memory_within_limits(items, frozen, k):
    """A block's shared memory fits the card's 227 KB, two blocks fit an
    SM (the design's occupancy), and the segments' scratch fits
    SCRATCH_LIMIT_BYTES with one arrival counter a tile."""
    for t, plan in _plans(items, frozen, k):
        assert plan.smem_bytes <= BLOCK_SMEM
        assert d8.MMA_BLOCKS_PER_SM * (plan.smem_bytes + 1024) <= SM_SMEM
        if plan.segments == 1:
            assert plan.scratch_shape == () and plan.counters == 0
        else:
            part = t + -(-k // 4) * 4
            assert plan.scratch_shape == (plan.segments, items, part)
            assert 4 * int(np.prod(plan.scratch_shape)) <= d8.SCRATCH_LIMIT_BYTES
            assert plan.counters == plan.item_tiles * (plan.gram_tiles + plan.rhs_tiles)


@pytest.mark.parametrize("items,frozen,k", SHAPES, ids=IDS)
def test_two_waves_or_segments_at_their_cap(items, frozen, k):
    """The grid gives at least two waves of blocks (two an SM on 132 SMs),
    or S is at its cap: one chunk a segment, or the scratch limit."""
    chunks = frozen // d8.MMA_CHUNK
    for t, plan in _plans(items, frozen, k):
        blocks = plan.item_tiles * (plan.gram_tiles + plan.rhs_tiles) * plan.segments
        part = t + -(-k // 4) * 4
        cap = min(chunks, d8.SCRATCH_LIMIT_BYTES // (4 * items * part))
        assert blocks >= 2 * d8.MMA_BLOCKS_PER_SM * SMS or plan.segments >= cap


def test_plan_of_the_routes():
    """The launches the chains make: ml-1m at K=64 fills the card without
    segments; chembl's 512 proteins split their 167,424 compounds into 8
    segments of 327 chunks; its compounds take 1308 item tiles of 8
    chunks; a K of 65-79 takes two rhs tiles."""
    t64 = tight_rows(64)
    assert mma_plan(6144, 4096, t64, 64, code_bytes=1)[:5] == (48, 17, 1, 1, 64)
    assert mma_plan(512, 167424, t64, 64, code_bytes=1)[:5] == (4, 17, 1, 8, 327)
    assert mma_plan(167424, 512, t64, 64, code_bytes=1)[:5] == (1308, 17, 1, 1, 8)
    assert mma_plan(6144, 4096, tight_rows(79), 79).rhs_tiles == 2
