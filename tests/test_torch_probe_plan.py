"""The launch plans of the gather probes #9A and #9B on the CPU
(``bpmf_tpu_torch.scripts.gather_probe.probe_plan_rows`` and
``probe_plan_lanes``).  The kernels take their split of the work from these
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


def test_probe_plans_follow_sm_count():
    """The plans size the grid to the card they are given: a 114-SM card
    holds fewer warps, so #9A splits R = 512 rows over 8 warps, not 16, and
    #9B's one wave at NV = 32768 is 3 row groups a k-row, not 4."""
    assert gp.probe_plan_rows(512, 512, 32)["split"] == 16
    assert gp.probe_plan_rows(512, 512, 32, sms=114)["split"] == 8
    assert gp.probe_plan_lanes(512, 512, 32768, 32)["blocks"] == 128
    assert gp.probe_plan_lanes(512, 512, 32768, 32, sms=114)["blocks"] == 96
