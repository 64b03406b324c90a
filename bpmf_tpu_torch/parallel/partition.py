"""Item-to-device assignment and device-uniform bucket layouts.

The reference assigns items to MPI ranks with a greedy cost pass over
work = 10 + nnz (Sys::assign, c++/assign.cpp:52-209; comm-cost weight is 0
in practice, c++/assign.cpp:178) and physically permutes columns into
contiguous per-rank domains.  Here assignment is a greedy LPT balance on the
same work model, kept as per-device index lists (no physical permutation of
the ratings matrix; the inverse map lives in ``orig_to_padded``), and the
``-k`` flag falls back to contiguous equal blocks (c++/assign.cpp:60-65).

Because one SPMD program runs on every device, each device's bucket pytree
must have identical shapes: buckets are built per device and then padded to
the union of widths and the per-width maxima, stacked with a leading device
axis that shard_map splits.

Copy of ``bpmf_tpu/parallel/partition.py`` with the layouts of gather mode
at any device count: :class:`GatherLayout` (each device owns a shard of
this side's items and the neighbor indices point into the OTHER side's
padded global index space) and the dense adjacency blocks.  Every rank of a
multi-device run builds the same maps and keeps only its own row of the
stacked [D, ...] layouts on its device (``sampler.BPMF``; a dense block is
built for that row alone, :func:`build_dense_block`).  The halo layout and
the reduce layouts are still to port (ROADMAP.md Queue 1 #6, the rest).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

from bpmf_tpu_torch.sparse import Bucket, bucketize, pad_count

__all__ = [
    "assign_items",
    "SideMaps",
    "make_maps",
    "GatherLayout",
    "build_gather_layout",
    "build_dense_layout",
    "build_dense_block",
    "stack_buckets",
]


def assign_items(degrees: np.ndarray, n_devices: int, balance: bool = True):
    """Return per-device arrays of item ids.

    balance=True: greedy LPT on work = 10 + nnz (c++/assign.cpp:109-120).
    balance=False: contiguous equal blocks (the -k path, c++/assign.cpp:60-65).
    """
    num = len(degrees)
    if n_devices == 1:
        return [np.arange(num, dtype=np.int32)]
    if not balance:
        bounds = np.linspace(0, num, n_devices + 1).astype(np.int64)
        return [
            np.arange(bounds[d], bounds[d + 1], dtype=np.int32)
            for d in range(n_devices)
        ]
    work = 10 + degrees.astype(np.int64)
    order = np.argsort(-work, kind="stable")
    loads = np.zeros(n_devices, dtype=np.int64)
    assign: list[list[int]] = [[] for _ in range(n_devices)]
    for i in order:
        d = int(np.argmin(loads))
        assign[d].append(int(i))
        loads[d] += work[i]
    return [np.asarray(sorted(a), dtype=np.int32) for a in assign]


def _pad_bucket(b: Bucket, n_rows: int, n_slots: int, scratch_id: int,
                orig_scratch: int) -> Bucket:
    """Pad a bucket to (n_rows, n_slots); padding rows are fully masked and
    target the last (padding) slot."""
    r, w = b.nbr.shape
    s = b.item_ids.shape[0]
    if r == n_rows and s == n_slots:
        return b
    nbr = np.zeros((n_rows, w), b.nbr.dtype)
    val = np.zeros((n_rows, w), b.val.dtype)
    mask = np.zeros((n_rows, w), b.mask.dtype)
    row_slot = np.full((n_rows,), n_slots - 1, b.row_slot.dtype)
    item_ids = np.full((n_slots,), scratch_id, b.item_ids.dtype)
    orig_ids = np.full((n_slots,), orig_scratch, b.orig_ids.dtype)
    slot_valid = np.zeros((n_slots,), b.slot_valid.dtype)
    nbr[:r] = b.nbr
    val[:r] = b.val
    mask[:r] = b.mask
    row_slot[:r] = b.row_slot
    item_ids[:s] = b.item_ids
    orig_ids[:s] = b.orig_ids
    slot_valid[:s] = b.slot_valid
    return Bucket(nbr, val, mask, row_slot, item_ids, orig_ids, slot_valid, b.split)


def _empty_bucket(width: int, scratch_id: int, orig_scratch: int) -> Bucket:
    return Bucket(
        nbr=np.zeros((8, width), np.int32),
        val=np.zeros((8, width), np.float64),
        mask=np.zeros((8, width), np.float32),
        row_slot=np.full((8,), 7, np.int32),
        item_ids=np.full((8,), scratch_id, np.int32),
        orig_ids=np.full((8,), orig_scratch, np.int32),
        slot_valid=np.zeros((8,), np.float32),
        split=False,
    )


def stack_buckets(per_dev: list[list[Bucket]], scratch_ids: list[int],
                  orig_scratch: int):
    """Unify bucket shapes across devices and stack with a leading device
    axis.  Returns (list of stacked Buckets, splits tuple)."""
    n_dev = len(per_dev)
    widths = sorted({b.width for bs in per_dev for b in bs})
    stacked: list[Bucket] = []
    splits: list[bool] = []
    for w in widths:
        per_w = []
        for d in range(n_dev):
            found = [b for b in per_dev[d] if b.width == w]
            per_w.append(found[0] if found else
                         _empty_bucket(w, scratch_ids[d], orig_scratch))
        n_rows = pad_count(max(b.n_rows for b in per_w))
        n_slots = pad_count(max(b.n_slots for b in per_w))
        padded = [
            _pad_bucket(b, n_rows, n_slots, scratch_ids[d], orig_scratch)
            for d, b in enumerate(per_w)
        ]
        split = any(b.split for b in per_w)
        stacked.append(
            Bucket(
                nbr=np.stack([b.nbr for b in padded]),
                val=np.stack([b.val for b in padded]),
                mask=np.stack([b.mask for b in padded]),
                row_slot=np.stack([b.row_slot for b in padded]),
                item_ids=np.stack([b.item_ids for b in padded]),
                orig_ids=np.stack([b.orig_ids for b in padded]),
                slot_valid=np.stack([b.slot_valid for b in padded]),
                split=split,
            )
        )
        splits.append(split)
    return stacked, tuple(splits)


@dataclasses.dataclass
class SideMaps:
    """Original-index <-> (device, slot) maps for one side's item shards."""

    n_devices: int
    num: int                    # true item count
    local_pad: int              # per-device padded item count
    ids_per_dev: list[np.ndarray]
    orig_to_padded: np.ndarray  # [num] -> d*local_pad + slot
    local_orig: np.ndarray      # [D, local_pad] -> original id (scratch -> num)
    local_valid: np.ndarray     # [D, local_pad] float 1/0

    @property
    def padded_num(self) -> int:
        return self.n_devices * self.local_pad


def make_maps(ids_per_dev: list[np.ndarray], num: int,
              multiple: int | None = None) -> SideMaps:
    """``multiple`` overrides the per-device padding granularity (the int8
    dense-stream kernels need padded_num to be a block multiple)."""
    n_dev = len(ids_per_dev)
    local_pad = pad_count(
        max(len(ids) for ids in ids_per_dev) + 1,
        *(() if multiple is None else (multiple,)),
    )
    orig_to_padded = np.zeros((num,), np.int64)
    local_orig = np.full((n_dev, local_pad), num, np.int32)
    local_valid = np.zeros((n_dev, local_pad), np.float32)
    for d, ids in enumerate(ids_per_dev):
        orig_to_padded[ids] = d * local_pad + np.arange(len(ids))
        local_orig[d, : len(ids)] = ids
        local_valid[d, : len(ids)] = 1.0
    return SideMaps(
        n_devices=n_dev,
        num=num,
        local_pad=local_pad,
        ids_per_dev=ids_per_dev,
        orig_to_padded=orig_to_padded,
        local_orig=local_orig,
        local_valid=local_valid,
    )


@dataclasses.dataclass
class GatherLayout:
    """Value-exchange layout for one side over D devices."""

    maps: SideMaps
    buckets: list[Bucket]       # stacked, leading dim D; item_ids are LOCAL
    splits: tuple


def build_gather_layout(
    m_csc: sp.csc_matrix,
    maps: SideMaps,
    other_orig_to_padded: np.ndarray,
    max_bucket_width: int = 4096,
    growth: int = 4,
) -> GatherLayout:
    """m_csc: [num_other, num] ratings with this side's items as columns.
    Neighbor (row) indices are remapped into the other side's padded global
    space; item slots are LOCAL indices into the device's items shard."""
    num = m_csc.shape[1]
    ids_per_dev = maps.ids_per_dev

    # remap other-side neighbor ids once on the host
    other_map = np.asarray(other_orig_to_padded, np.int32)

    per_dev: list[list[Bucket]] = []
    for d, ids in enumerate(ids_per_dev):
        side = bucketize(
            m_csc, ids, scratch_id=-1, max_bucket_width=max_bucket_width,
            growth=growth,
        )
        local_index = np.zeros((num + 1,), np.int32)
        local_index[ids] = np.arange(len(ids))
        bs = []
        for b in side.buckets:
            real = b.slot_valid > 0
            item_ids = np.where(real, local_index[np.abs(b.item_ids)], len(ids))
            orig_ids = np.where(real, b.orig_ids, num)
            nbr = other_map[b.nbr] * (b.mask > 0)  # masked entries -> 0
            bs.append(
                Bucket(
                    nbr=nbr.astype(np.int32),
                    val=b.val,
                    mask=b.mask,
                    row_slot=b.row_slot,
                    item_ids=item_ids.astype(np.int32),
                    orig_ids=orig_ids.astype(np.int32),
                    slot_valid=b.slot_valid,
                    split=b.split,
                )
            )
        per_dev.append(bs)

    scratch_ids = [len(ids) for ids in ids_per_dev]  # local scratch slot
    buckets, splits = stack_buckets(per_dev, scratch_ids, orig_scratch=num)
    return GatherLayout(maps=maps, buckets=buckets, splits=splits)


def build_dense_layout(
    m_csc: sp.csc_matrix,
    maps: SideMaps,
    other_orig_to_padded: np.ndarray,
    other_padded_num: int,
) -> np.ndarray:
    """Dense-adjacency layout: raw ratings as a dense [D, local_pad,
    other_padded_num] float32 block per device (this side's items are rows
    in LOCAL slot order, columns are the other side's PADDED GLOBAL order).

    The TPU-native reformulation of computeMuLambda
    (c++/sample.cpp:248-258): with A_ind = (A != 0) and
    A_val = (A - mean) * alpha * A_ind,

        Gram_i(flat) = (A_ind @ rowwise_outer(V))_i        # [I, K*K]
        rhs_i        = (A_val @ V)_i                        # [I, K]

    — two plain MXU matmuls with zero gathers/scatters.  Only viable while
    I * N fits memory (~<=1 GB); the degree-bucketed gather layout covers
    the rest.  Absent ratings are exactly 0.0 (valid ratings are nonzero in
    every supported dataset, like Eigen sparse semantics in the reference).
    """
    return np.stack([
        build_dense_block(m_csc, maps, other_orig_to_padded, other_padded_num, d)
        for d in range(maps.n_devices)])


def build_dense_block(
    m_csc: sp.csc_matrix,
    maps: SideMaps,
    other_orig_to_padded: np.ndarray,
    other_padded_num: int,
    d: int,
) -> np.ndarray:
    """Device ``d``'s row of :func:`build_dense_layout`, [local_pad,
    other_padded_num] float32, built alone."""
    out = np.zeros((maps.local_pad, other_padded_num), np.float32)
    other_map = np.asarray(other_orig_to_padded, np.int64)
    sub = m_csc[:, maps.ids_per_dev[d]].tocoo()  # rows: other orig, cols: local slot
    out[sub.col, other_map[sub.row]] = sub.data.astype(np.float32)
    return out
