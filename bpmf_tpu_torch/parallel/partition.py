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

Copy of ``bpmf_tpu/parallel/partition.py``.  Its layouts mirror the
reference's two exchange families (SURVEY.md §2):

* :class:`GatherLayout` — value exchange: each device owns a shard of this
  side's items and the neighbor indices point into the OTHER side's padded
  global index space (consumed after an all_gather, or after the halo ring
  of :class:`HaloLayout`); and the dense adjacency blocks.
* :class:`ReduceLayout` — statistic exchange (ENABLE_REDUCE,
  c++/sample.cpp:234-258): each device holds the edges whose OTHER-side
  endpoint it owns, grouped by this side's items in padded global order, so
  per-item (Gram, rhs) partials reduce-scatter straight onto the owner
  shard; :class:`ReduceLayoutChunked` groups them by destination shard.

Every rank of a multi-device run builds the same maps and keeps only its
own row of the stacked [D, ...] layouts on its device (``sampler.BPMF``; a
dense block is built for that row alone, :func:`build_dense_block`).
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
    "HaloLayout",
    "build_halo_layout",
    "ReduceLayout",
    "ReduceLayoutChunked",
    "build_reduce_layout",
    "build_reduce_layout_chunked",
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


@dataclasses.dataclass
class HaloLayout:
    """Connectivity-aware value exchange for one side's sweep (the
    TPU-native analog of the reference's opt_conn connectivity
    optimization, c++/assign.cpp:215-286, which the reference itself ships
    disabled).

    Instead of all_gather-ing the whole frozen other side ((D-1)/D · N
    rows per device), each device receives only the other-side rows its
    local ratings actually reference, exchanged pairwise over D-1
    ``ppermute`` rounds (ring schedule on the ICI/DCN mesh axis).  The
    received rows are scattered into a buffer in the same padded global
    layout the bucket ``nbr`` indices already use, so the sweep downstream
    is untouched; rows nobody references stay zero and only ever meet
    mask-zeroed reads (ops/update.gram_rhs).  Pure comm-volume
    optimization — the trajectory is bitwise the one all_gather produces.

    Worth it only when connectivity is sparse (per-pair halo ≪ shard
    size): MovieLens-style dense connectivity needs nearly every row
    everywhere and the plain all_gather collective is strictly better
    (``volume_ratio`` ≈ 1, and the auto mode keeps all_gather)."""

    send_rows: tuple        # per ring round r=1..D-1: [D, H_r] int32 —
                            # row s: local row indices of src s's other-side
                            # shard needed by dst (s+r)%D
    recv_pos: tuple         # per round: [D, H_r] int32 — row t: padded
                            # global positions where rows from (t-r)%D land
                            # on t; padding entries -> N (a dump slot)
    pair_counts: np.ndarray  # [D, D] int64 — TRUE (unpadded) rows src needs
                             # to send to dst; the per-pair message-count
                             # matrix (assign.cpp:238-250 analog)
    halo_rows: int          # max_r H_r (banner; per-round widths vary)
    volume_ratio: float     # padded halo volume / all_gather volume


def build_halo_layout(
    m_csc: sp.csc_matrix,
    maps: SideMaps,
    other_maps: SideMaps,
) -> HaloLayout:
    """For the sweep updating THIS side (``maps``): which OTHER-side rows
    each device's local ratings reference.  ``m_csc``: [num_other, num_this]
    with this side's items as columns (same orientation as
    :func:`build_gather_layout`).

    Payload widths are padded PER RING ROUND (H_r = max over the pairs at
    ring distance r, 8-aligned) rather than one global max: SPMD needs a
    uniform shape within a round, but skewed connectivity — one heavy pair
    — then inflates only its own round's payload, not all D-1 of them."""
    n_dev = maps.n_devices
    lp = other_maps.local_pad
    other_map = np.asarray(other_maps.orig_to_padded, np.int64)

    # per-destination-device needed other-side padded ids
    need = []
    for ids in maps.ids_per_dev:
        if len(ids) == 0:
            need.append(np.zeros((0,), np.int64))
            continue
        sub = m_csc[:, ids]
        need.append(np.unique(other_map[np.unique(sub.indices)]))

    lists: list[list[np.ndarray]] = [
        [np.zeros((0,), np.int32)] * n_dev for _ in range(n_dev)
    ]
    pair_counts = np.zeros((n_dev, n_dev), np.int64)
    for t in range(n_dev):
        src = need[t] // lp
        loc = (need[t] % lp).astype(np.int32)
        for s in range(n_dev):
            if s == t:
                continue
            sel = loc[src == s]
            lists[s][t] = sel
            pair_counts[s, t] = len(sel)

    n_global = other_maps.padded_num
    send_rows, recv_pos, h_max, h_sum = [], [], 0, 0
    for r in range(1, n_dev):
        h_r = max(len(lists[s][(s + r) % n_dev]) for s in range(n_dev))
        h_r = max(8, -(-h_r // 8) * 8)  # 8-sublane-aligned [H, K] payloads
        h_max, h_sum = max(h_max, h_r), h_sum + h_r
        sr = np.zeros((n_dev, h_r), np.int32)
        rp = np.full((n_dev, h_r), n_global, np.int32)  # pad -> dump slot
        for s in range(n_dev):
            t = (s + r) % n_dev
            sel = lists[s][t]
            sr[s, : len(sel)] = sel
            rp[t, : len(sel)] = s * lp + sel
        send_rows.append(sr)
        recv_pos.append(rp)
    ratio = h_sum / ((n_dev - 1) * lp) if lp and n_dev > 1 else 1.0
    return HaloLayout(
        send_rows=tuple(send_rows),
        recv_pos=tuple(recv_pos),
        pair_counts=pair_counts,
        halo_rows=h_max,
        volume_ratio=ratio,
    )


@dataclasses.dataclass
class ReduceLayout:
    """Statistic-exchange layout for updating one side (ENABLE_REDUCE).

    Device d holds the edges whose other-side endpoint d owns; bucket
    ``item_ids`` are THIS side's padded global indices (segment ids for the
    psum_scatter), ``nbr`` are LOCAL other-side slots."""

    buckets: list[Bucket]  # stacked, leading dim D
    splits: tuple


@dataclasses.dataclass
class ReduceLayoutChunked:
    """Memory-scaling variant of :class:`ReduceLayout`: edges are grouped by
    the DESTINATION shard of this side's items, so the sweep accumulates one
    [local_pad, K, K] partial per destination device instead of a
    [padded_num, K, K] buffer (O(global) per device — 667 MB/device at
    ml-25M users K=32, impossible at 10M-item sides).  The reference's
    REDUCE mode has the same owner-slice structure (c++/mpi_reduce.h:29-45
    reduces one rank's slice at a time).

    ``per_dest[d']`` holds the stacked buckets (leading axis = source
    device) whose items live on destination shard d'; bucket ``item_ids``
    are LOCAL slots on d'."""

    per_dest: list          # [D] of (buckets list, splits tuple)


def build_reduce_layout_chunked(
    m_csc: sp.csc_matrix,
    this_maps: SideMaps,
    other_ids_per_dev: list[np.ndarray],
    max_bucket_width: int = 4096,
    growth: int = 4,
) -> ReduceLayoutChunked:
    """m_csc: [num_other, num_this].  For each destination shard d' of this
    side, bucketize the edges (other-owner device x d'-owned columns); slot
    indices are d'-local, noise ids stay global."""
    num = m_csc.shape[1]
    local_pad = this_maps.local_pad
    per_dest = []
    for ids_dst in this_maps.ids_per_dev:
        if len(ids_dst) == 0:
            # a destination shard can own zero items (fewer items than
            # devices); its chunk contributes no buckets at all
            per_dest.append(([], ()))
            continue
        m_dest = m_csc[:, ids_dst].tocsc()  # columns renumbered 0..len-1
        per_dev: list[list[Bucket]] = []
        for ids_v in other_ids_per_dev:
            m_local = m_dest[ids_v, :].tocsc()
            cols = np.flatnonzero(np.diff(m_local.indptr) > 0).astype(np.int32)
            if len(cols) == 0:
                cols = np.asarray([0], np.int32)
            side = bucketize(
                m_local, cols, scratch_id=-1,
                max_bucket_width=max_bucket_width, growth=growth,
            )
            bs = []
            for b in side.buckets:
                real = b.slot_valid > 0
                # restricted column index IS the local slot on d' (slots
                # are assigned in ids order by make_maps); padding slots
                # aim at the last local slot, which is always dead
                # padding slots carry scratch_id=-1; clip before the fancy
                # index (the value is masked out by `real` anyway)
                safe = np.clip(np.abs(b.orig_ids), 0, len(ids_dst) - 1)
                item_ids = np.where(real, np.abs(b.item_ids), local_pad - 1)
                orig_ids = np.where(real, ids_dst[safe], num)
                bs.append(
                    Bucket(
                        nbr=b.nbr,
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
        scratch_ids = [local_pad - 1] * len(other_ids_per_dev)
        per_dest.append(stack_buckets(per_dev, scratch_ids, orig_scratch=num))
    return ReduceLayoutChunked(per_dest=per_dest)


def build_reduce_layout(
    m_csc: sp.csc_matrix,
    this_orig_to_padded: np.ndarray,
    this_padded_num: int,
    other_ids_per_dev: list[np.ndarray],
    max_bucket_width: int = 4096,
    growth: int = 4,
) -> ReduceLayout:
    """m_csc: [num_other, num_this]; rows are split by other-side ownership
    (preComputeMuLambda's local_only filter, c++/sample.cpp:248-258)."""
    num = m_csc.shape[1]
    this_map = np.asarray(this_orig_to_padded, np.int64)
    per_dev: list[list[Bucket]] = []
    for ids_v in other_ids_per_dev:
        m_local = m_csc[ids_v, :].tocsc()  # rows renumbered 0..len(ids_v)-1
        cols = np.flatnonzero(np.diff(m_local.indptr) > 0).astype(np.int32)
        if len(cols) == 0:
            cols = np.asarray([0], np.int32)
        side = bucketize(
            m_local, cols, scratch_id=-1, max_bucket_width=max_bucket_width,
            growth=growth,
        )
        bs = []
        for b in side.buckets:
            real = b.slot_valid > 0
            # segment target: padded global id of this side's item; padding
            # slots aim at the last padded position (a dead slot on the last
            # shard: this_padded_num-1 is always >= its shard's local num).
            item_ids = np.where(
                real, this_map[np.abs(b.item_ids)], this_padded_num - 1
            )
            orig_ids = np.where(real, b.orig_ids, num)
            bs.append(
                Bucket(
                    nbr=b.nbr,
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
    scratch_ids = [this_padded_num - 1] * len(other_ids_per_dev)
    buckets, splits = stack_buckets(per_dev, scratch_ids, orig_scratch=num)
    return ReduceLayout(buckets=buckets, splits=splits)
