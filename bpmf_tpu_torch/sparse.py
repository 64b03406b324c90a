"""Host-side sparse layout: degree-bucketed padded CSR.

The reference iterates Eigen CSC columns item-by-item inside OpenMP tasks
(c++/sample.cpp:341-373).  On TPU the per-item conditional updates are
batched: all items of one side are conditionally independent given the other
side, so the whole half-sweep is one batched program.  To make the sparse
neighbor gather MXU-friendly we lay ratings out as *degree-bucketed padded
CSR*:

* items are grouped into buckets by degree; bucket ``b`` has a fixed padded
  width ``W_b`` (power of two) and holds ``R_b`` rows of
  ``(neighbor_index, rating, mask)``;
* items whose degree exceeds ``max_bucket_width`` are *row-split*: their
  neighbor list occupies several rows that share one output slot, and the
  per-row partial Gram/rhs contributions are combined with a segment-sum
  before the solve.  This bounds padding waste on power-law degree
  distributions (the chembl case: median degree tiny, max > 10500 — see
  breakpoint2, c++/bpmf.h:255-256 and c++/sample.cpp:203-218).

Each bucket yields per-item ``(Lambda_i [K,K], rhs_i [K])`` statistics;
everything downstream (Cholesky, solves, sampling) is bucket-independent.

This module is pure numpy and runs once at setup time (the analog of the
reference's Sys::init + assign, minus inter-node assignment which lives in
``parallel/partition.py``).  Copy of ``bpmf_tpu/sparse.py``: the buckets
are filled by the native library's ``fill_bucket``
(:mod:`bpmf_tpu_torch.io.native`) where it builds, item by item in Python
otherwise, with the same arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

from bpmf_tpu_torch.io import native

__all__ = ["Bucket", "BucketedSide", "bucketize", "pad_count"]

_ROW_PAD = 8  # pad bucket row counts to a multiple of the f32 sublane count


def pad_count(n: int, multiple: int = _ROW_PAD) -> int:
    return ((n + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One degree bucket (all arrays host numpy, copied to device once).

    rows:   ``nbr``/``val``/``mask`` are [R, W]; each row contributes a
            partial Gram/rhs for the item in slot ``row_slot[r]``.
    slots:  ``item_ids`` [S] maps slot -> index in the (possibly local)
            items array this bucket scatters into (padded slots point at the
            side's scratch item); ``orig_ids`` [S] is the item's ORIGINAL
            global index, used only to derive the per-item noise key so that
            sampled trajectories are independent of sharding and bucketing —
            the analog of the reference's rng_set_pos((idx+1)*K*(iter+1))
            (c++/sample.cpp:266); ``slot_valid`` [S] is 0 for padding slots.
    ``split`` is True when R != S (row-split items present) and the update
    kernel must segment-sum row partials into slots.
    """

    nbr: np.ndarray        # [R, W] int32 — indices into other side's items
    val: np.ndarray        # [R, W] float64 — raw ratings (centered on device)
    mask: np.ndarray       # [R, W] float32 — 1 for real entries
    row_slot: np.ndarray   # [R] int32 — output slot per row (sorted)
    item_ids: np.ndarray   # [S] int32 — scatter index per slot
    orig_ids: np.ndarray   # [S] int32 — original global item index per slot
    slot_valid: np.ndarray # [S] float32
    split: bool

    @property
    def width(self) -> int:
        return self.nbr.shape[1]

    @property
    def n_rows(self) -> int:
        return self.nbr.shape[0]

    @property
    def n_slots(self) -> int:
        return self.item_ids.shape[0]


@dataclasses.dataclass(frozen=True)
class BucketedSide:
    """Bucketed ratings for one side's items (one partition thereof)."""

    buckets: list[Bucket]
    num: int          # true number of items in this partition
    num_nnz: int      # ratings covered by this partition

    def padded_ratio(self) -> float:
        """Padding overhead: padded cells / real nnz (diagnostic)."""
        padded = sum(b.n_rows * b.width for b in self.buckets)
        return padded / max(self.num_nnz, 1)


def _choose_widths(degrees: np.ndarray, min_width: int, max_width: int,
                   growth: int = 4) -> list[int]:
    """Geometric widths covering the degree distribution (capped).

    growth=4 keeps the bucket count (and therefore compiled program size)
    half of a power-of-two ladder at the cost of <= 4x padding per item —
    the Gram stage is cheap enough that fewer, fatter kernels win on TPU."""
    dmax = int(degrees.max(initial=0))
    w = min_width
    widths = [w]
    while w < dmax and w < max_width:
        w = min(w * growth, max_width)
        widths.append(w)
    return widths


def bucketize(
    m_csc: sp.csc_matrix,
    item_ids: np.ndarray,
    scratch_id: int,
    min_width: int = 8,
    max_bucket_width: int = 2048,
    row_pad: int = _ROW_PAD,
    growth: int = 4,
) -> BucketedSide:
    """Build degree buckets for the given items (columns of ``m_csc``).

    m_csc:       [num_other, num_items] CSC ratings matrix for this side
                 (items are columns, as in the reference where
                 Sys::M.col(i) lists item i's rated neighbors).
    item_ids:    global item indices belonging to this partition.
    scratch_id:  item index used by padding slots (a dead row of the padded
                 items array).
    """
    item_ids = np.asarray(item_ids, dtype=np.int32)
    indptr, indices, data = m_csc.indptr, m_csc.indices, m_csc.data
    degrees = np.asarray(indptr[item_ids + 1] - indptr[item_ids])

    widths = _choose_widths(degrees, min_width, max_bucket_width, growth)
    # per item: smallest width >= degree; degree > max width -> last bucket
    # (row-split there)
    which = np.searchsorted(np.asarray(widths), degrees, side="left")
    which = np.minimum(which, len(widths) - 1)

    buckets: list[Bucket] = []
    total_nnz = 0

    fill_native = native.get_lib() is not None
    if fill_native:
        indptr64 = np.ascontiguousarray(indptr, dtype=np.int64)
        indices32 = np.ascontiguousarray(indices, dtype=np.int32)
        data64 = np.ascontiguousarray(data, dtype=np.float64)

    for wi, w in enumerate(widths):
        in_b = which == wi
        ids = item_ids[in_b]
        if ids.size == 0 and wi > 0:
            continue
        degs_b = degrees[in_b]
        total_nnz += int(degs_b.sum())
        rows_needed = int(np.maximum(1, -(-degs_b // w)).sum()) if ids.size else 0
        n_real_slots = max(len(ids), 1)

        n_slots = pad_count(n_real_slots, row_pad)
        n_rows = pad_count(max(rows_needed, 1), row_pad)
        split = rows_needed != len(ids)

        nbr = np.zeros((n_rows, w), dtype=np.int32)
        val = np.zeros((n_rows, w), dtype=np.float64)
        mask = np.zeros((n_rows, w), dtype=np.float32)
        # padding rows must target a padding slot so they never pollute a
        # real item's statistics; when there is no padding slot the padding
        # rows are all-masked anyway (their Gram/rhs partials are zero).
        rslot = np.full((n_rows,), n_slots - 1, dtype=np.int32)

        if fill_native and ids.size:
            native.fill_bucket(indptr64, indices32, data64,
                               np.ascontiguousarray(ids, np.int32), w,
                               nbr, val, mask, rslot)
        else:
            r = 0
            for slot, gid in enumerate(ids):
                s, e = indptr[gid], indptr[gid + 1]
                # row-split neighbor lists wider than the bucket width
                for off in range(0, max(e - s, 1), w):
                    a = s + off
                    b = min(s + off + w, e)
                    ln = b - a
                    nbr[r, :ln] = indices[a:b]
                    val[r, :ln] = data[a:b]
                    mask[r, :ln] = 1.0
                    rslot[r] = slot
                    r += 1

        # sort real rows by first neighbor id: gathers then touch the
        # neighbor table in roughly ascending order, which improves HBM
        # locality of the dominant row-gather (~15% at ml-25M scale).
        # Trajectory-invariant: the slot arrays are permuted along, so each
        # item keeps its ratings and its id-keyed noise.  Non-split buckets
        # only — the update kernel relies on row r == slot r there; split
        # buckets' wide rows already have good intra-row locality.
        ids = np.asarray(ids)
        nreal = min(rows_needed, n_rows)
        if not split and nreal > 1:
            order = np.argsort(nbr[:nreal, 0], kind="stable")
            nbr[:nreal] = nbr[order]
            val[:nreal] = val[order]
            mask[:nreal] = mask[order]
            ids = ids[order]  # slot r still owns row r's ratings

        ids_arr = np.full((n_slots,), scratch_id, dtype=np.int32)
        ids_arr[: len(ids)] = ids
        valid = np.zeros((n_slots,), dtype=np.float32)
        valid[: len(ids)] = 1.0

        buckets.append(
            Bucket(
                nbr=nbr,
                val=val,
                mask=mask,
                row_slot=rslot,
                item_ids=ids_arr,
                orig_ids=ids_arr.copy(),
                slot_valid=valid,
                split=split,
            )
        )

    side = BucketedSide(
        buckets=buckets, num=int(item_ids.size), num_nnz=int(total_nnz)
    )
    n_slots_real = sum(int(b.slot_valid.sum()) for b in buckets)
    assert n_slots_real == item_ids.size, (n_slots_real, item_ids.size)
    assert total_nnz == int(degrees.sum()), (total_nnz, int(degrees.sum()))
    return side
