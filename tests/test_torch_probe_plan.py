"""The launch plans of the gather probes #9A, #9B and #9C on the CPU
(``bpmf_tpu_torch.scripts.gather_probe.probe_plan_rows``,
``probe_plan_lanes`` and ``probe_plan_copy``).  The kernels take their split of the work from these
plans, so each test checks that the split covers the work exactly once and
fits the card (an H100 SXM's 132 SMs unless a test names another count)."""

import numpy as np
import pytest

from bpmf_tpu_torch.scripts import gather_probe as gp

# (K, NV, R, W): the JAX script's shape, a larger R, B's chunked NV (the
# ml-25M half-scale user count, and one past it), a ragged W, one edge
SHAPES = [(32, 32768, 512, 512), (32, 32768, 8192, 512), (32, 81270, 64, 512),
          (64, 100000, 512, 33), (12, 300, 1, 1), (12, 300, 8192, 33)]
SMS = 132


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "K%d-NV%d-R%d-W%d" % s)
def test_probe_plan_rows_covers_neighbours(shape):
    """#9A: the split warps take every neighbour exactly once, a block's
    warps cover every item row, the split fills the card (16 warps a row at
    R = 512, one at R = 8192) and the partials fit shared memory."""
    k, nv, r, w = shape
    plan = gp.probe_plan_rows(r, w, k)
    split, per = plan["split"], plan["per_warp"]
    assert split in (1, 2, 4, 8, 16) and gp.ROWS_WARPS % split == 0
    assert plan["rows_per_block"] * split == gp.ROWS_WARPS
    assert plan["blocks"] * plan["rows_per_block"] >= r
    assert (plan["blocks"] - 1) * plan["rows_per_block"] < r
    assert r * split <= SMS * 64 or split == 1
    ranges = [range(min(w, s * per), min(w, s * per + per)) for s in range(split)]
    taken = np.concatenate([np.arange(w)[list(rg)] for rg in ranges])
    np.testing.assert_array_equal(np.sort(taken), np.arange(w))
    assert all(len(rg) >= 32 for rg in ranges) or split == 1
    assert plan["smem"] == (4 * gp.ROWS_WARPS * k if split > 1 else 0)
    assert plan["smem"] <= gp.SMEM_MAX
    if (r, w) == (512, 512):
        assert split == 16
    if r == 8192:
        assert split == 1


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "K%d-NV%d-R%d-W%d" % s)
def test_probe_plan_lanes_covers_table(shape):
    """#9B: the chunks cover [0, NV) exactly once (one chunk up to 58,108
    rows), each chunk with its 16-byte slack fits the 232,448 bytes of
    shared memory a block has, the row groups cover R once and the grid is
    one wave; W does not change the plan."""
    k, nv, r, w = shape
    plan = gp.probe_plan_lanes(r, w, nv, k)
    chunk, chunks = plan["chunk"], plan["chunks"]
    bounds = [(c * chunk, min(nv, (c + 1) * chunk)) for c in range(chunks)]
    assert all(lo < hi for lo, hi in bounds)
    assert bounds[0][0] == 0 and bounds[-1][1] == nv
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert chunks == (1 if nv <= 58108 else 2)
    assert 4 * (chunk + 3) <= plan["smem"] <= gp.SMEM_MAX
    assert plan["smem"] % 16 == 0
    rows, groups = plan["rows_per_block"], plan["groups"]
    assert groups * rows >= r and (groups - 1) * rows < r
    assert plan["blocks"] == k * groups
    assert plan["blocks"] <= 2 * SMS or groups == 1
    if nv == 32768:
        assert plan["blocks"] == 128
    assert all(gp.probe_plan_lanes(r, w2, nv, k) == plan for w2 in (1, 33, 512))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "K%d-NV%d-R%d-W%d" % s)
def test_probe_plan_copy_covers_rows(shape):
    """#9C: the blocks' strides take every item row exactly once, the slabs
    every column and the chunks every neighbour (a ragged last chunk); a
    slot is at most COPY_SLOT bytes of rows, and the ring, the consumers'
    partials and the mbarriers fit a block.  The plan does not change with
    W, and at every K two rings an SM reach ~48 KB in flight but at K = 1."""
    k, nv, r, w = shape
    plan = gp.probe_plan_copy(r, w, k)
    blocks, cols, chunk, stages = (plan[key] for key in
                                   ("blocks", "cols", "chunk", "stages"))
    per = -(-r // (2 * SMS))
    taken = np.concatenate([np.arange(b, r, blocks) for b in range(blocks)])
    np.testing.assert_array_equal(np.sort(taken), np.arange(r))
    assert {len(range(b, r, blocks)) for b in range(blocks)} <= {per - 1, per}
    assert (blocks - 1) * per < r <= blocks * per
    slabs = -(-k // cols)
    assert cols == min(k, gp.COPY_MAX_COLS) and cols * (slabs - 1) < k
    chunks = -(-w // chunk)
    bounds = [(c * chunk, min(w, (c + 1) * chunk)) for c in range(chunks)]
    assert bounds[0][0] == 0 and bounds[-1][1] == w
    assert all(lo < hi for lo, hi in bounds)
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert all(hi - lo == chunk for lo, hi in bounds[:-1])
    slot = 4 * chunk * cols
    assert 1 <= chunk <= gp.COPY_MAX_CHUNK and slot <= gp.COPY_SLOT
    assert 3 <= stages <= gp.COPY_MAX_STAGES
    ring = stages * slot
    # the kernel's layout: the ring, two sets of four consumer warps' [cols]
    # partials (8-byte aligned), a "full" and an "empty" mbarrier a slot
    assert ring + 2 * 4 * 4 * cols + 4 + 16 * stages <= gp.SMEM_MAX
    assert all(gp.probe_plan_copy(r, w2, k) == plan
               for w2 in (1, 33, 512, 2000, 100000))
    if k == 32:
        assert (chunk, stages) == (256, 3)
    for k2 in range(1, 2049):
        p2 = gp.probe_plan_copy(r, w, k2)
        ring2 = 4 * p2["stages"] * p2["chunk"] * p2["cols"]
        assert ring2 >= (gp.COPY_RING if k2 >= 6 else 16 * 1024 * k2)
        assert 2 * ring2 >= 48 * 1024 or k2 == 1


def test_probe_plans_follow_sm_count():
    """The plans size the grid to the card they are given: a 114-SM card
    holds fewer warps, so #9A splits R = 512 rows over 8 warps, not 16,
    #9B's one wave at NV = 32768 is 3 row groups a k-row, not 4, and #9C's
    two blocks an SM take R = 512 rows 3 a block, not 2."""
    assert gp.probe_plan_rows(512, 512, 32)["split"] == 16
    assert gp.probe_plan_rows(512, 512, 32, sms=114)["split"] == 8
    assert gp.probe_plan_lanes(512, 512, 32768, 32)["blocks"] == 128
    assert gp.probe_plan_lanes(512, 512, 32768, 32, sms=114)["blocks"] == 96
    assert gp.probe_plan_copy(512, 512, 32)["blocks"] == 256
    assert gp.probe_plan_copy(512, 512, 32, sms=114)["blocks"] == 171
