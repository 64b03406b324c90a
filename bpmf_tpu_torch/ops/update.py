"""Batched per-item conditional Gibbs update (port of
``bpmf_tpu/ops/update.py``).

Per item i with rated neighbour vectors {v_j} and centered ratings
{r_ij - mean}:

    Lambda*_i = Lambda_hp + alpha * sum_j v_j v_j'
    rhs_i     = Lambda_hp @ mu_hp + alpha * sum_j v_j (r_ij - mean)
    L L'      = Lambda*_i                      (Cholesky)
    u_i       = L'^-1 ( N(0,I) + L^-1 rhs_i )  (posterior MVN draw)

Over a degree bucket the Gram is one batched matmul of the gathered
neighbour rows (``torch.bmm``, where the JAX package has an einsum that XLA
runs on the MXU); split buckets (items wider than the bucket) sum their
rows' partials into slots with a deterministic segment sum.

The noise for item ``idx`` depends only on (seed, iteration, side, idx) and
not on the padded slot that processes it, so trajectories do not depend on
the layout: one [num + 1, K] N(0, I) table per (iteration, side), row
``orig_id`` for item ``orig_id`` and row ``num`` for every padding slot.

Reference quirk kept under ``Config.strict_reference`` (default): with a
propagated posterior the per-item prior term is ``propLambda_i @ hp.mu``,
the shared sampled hyper-mean (c++/sample.cpp:285).

bf16 matmul inputs (``Config.matmul_dtype="bfloat16"``): the frozen table
comes rounded to bf16 and is gathered so, and every product and sum of the
Gram and rhs is in the compute dtype (:func:`matmul_acc`), as the JAX
package's ``gather_dtype`` and ``preferred_element_type`` do.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from bpmf_tpu_torch.ops.mvnormal import HyperParams, cholesky_or_nan

__all__ = [
    "BucketDev",
    "matmul_acc",
    "UpdateOut",
    "gram_rhs",
    "segment_sum",
    "posterior_precision_rhs",
    "chol_solve_sample",
    "noise_table",
    "item_noise",
    "sample_bucket",
]


class BucketDev(NamedTuple):
    """Device tensors of one degree bucket (see ``bpmf_tpu_torch.sparse``).

    ``segments`` is the split bucket's row-to-slot sum, precomputed on the
    host: one (rows, slots) pair per rank q, the q-th row of every slot
    that has one, so each pair's slots are distinct (empty when the bucket
    is not split)."""

    nbr: torch.Tensor         # [R, W] int64
    val: torch.Tensor         # [R, W] compute dtype (raw ratings)
    mask: torch.Tensor        # [R, W] int8
    row_slot: torch.Tensor    # [R] int64
    item_ids: torch.Tensor    # [S] int64: scatter index into the items
    orig_ids: torch.Tensor    # [S] int64: original id (noise keying)
    slot_valid: torch.Tensor  # [S] compute dtype
    segments: tuple = ()      # ((rows [n_q], slots [n_q]), ...) if split

    @classmethod
    def from_bucket(cls, b, dtype, device) -> "BucketDev":
        """Upload a host :class:`~bpmf_tpu_torch.sparse.Bucket` (one
        device's slice; the mask as int8, ``bpmf_tpu/sampler.py:106-118``)."""

        def dev(x, dt=torch.long):
            return torch.as_tensor(np.asarray(x), dtype=dt, device=device)

        segs = ()
        if b.split:
            segs = tuple((dev(rows), dev(slots))
                         for rows, slots in _segments_by_rank(b.row_slot))
        return cls(nbr=dev(b.nbr), val=dev(b.val, dtype),
                   mask=dev(b.mask, torch.int8), row_slot=dev(b.row_slot),
                   item_ids=dev(b.item_ids), orig_ids=dev(b.orig_ids),
                   slot_valid=dev(b.slot_valid, dtype), segments=segs)


def matmul_acc(a: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """a @ b (2-D, or batched 3-D) with every product and sum in ``dtype``:
    the JAX package's matmul of matmul-dtype operands with
    ``preferred_element_type`` the compute dtype.  Two bf16 operands on the
    card into float32 take ``torch.mm``/``torch.bmm`` with ``out_dtype``
    (cuBLAS's bf16 product with float32 sums: probed on an H100 with torch
    2.11, 14x faster than converting the operands at [4096, 6144] x [6144,
    1024]; PERF.md section 6).  Otherwise, and on the CPU, which has no
    kernel for it, operands of another type are converted to ``dtype``
    first, which is exact, so each product of two bf16 values is exact and
    only the sums round.  float32 products on the card run without TF32
    (PyTorch's default)."""
    if (a.is_cuda and a.dtype == b.dtype == torch.bfloat16
            and dtype == torch.float32):
        return (torch.mm if a.dim() == 2 else torch.bmm)(a, b, out_dtype=dtype)
    if a.dtype != dtype:
        a = a.to(dtype)
    if b.dtype != dtype:
        b = b.to(dtype)
    return a @ b


class UpdateOut(NamedTuple):
    u: torch.Tensor           # [S, K] new item vectors (padding slots too)
    item_ids: torch.Tensor    # [S]
    slot_valid: torch.Tensor  # [S]


def _segments_by_rank(row_slot: np.ndarray):
    """[(rows, slots)] with the rows of rank q within their slot: the same
    grouping for any row order."""
    row_slot = np.asarray(row_slot)
    order = np.argsort(row_slot, kind="stable")
    sorted_slots = row_slot[order]
    starts = np.r_[0, np.flatnonzero(np.diff(sorted_slots)) + 1]
    first = np.repeat(starts, np.diff(np.r_[starts, len(order)]))
    rank = np.arange(len(order)) - first
    return [(order[rank == q], sorted_slots[rank == q])
            for q in range(int(rank.max(initial=-1)) + 1)]


def segment_sum(x: torch.Tensor, segments, n_slots: int) -> torch.Tensor:
    """Rows of ``x`` summed into ``n_slots`` slots, one ``index_add_`` per
    rank: its slots are distinct, so no two adds meet and the sum is the
    same on every run (``jax.ops.segment_sum`` in the JAX package)."""
    out = x.new_zeros((n_slots,) + tuple(x.shape[1:]))
    for rows, slots in segments:
        out.index_add_(0, slots, x.index_select(0, rows))
    return out


def gram_rhs(
    bucket: BucketDev,
    other_items: torch.Tensor,  # [num_other_pad, K]
    mean_rating,                # scalar
    alpha: float,
    *,
    split: bool,
    n_slots: int,
    ablate: str = "",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-slot Gram [S, K, K] and rhs [S, K] over the rated neighbours of
    one bucket (``bpmf_tpu.ops.update.gram_rhs``; computeMuLambda,
    c++/sample.cpp:248-258).  Masked entries point at row 0 of the other
    side and are zeroed by the mask.  A bf16 ``other_items`` (bf16 matmul
    inputs: the sampler rounds the frozen table before the gather) is
    gathered as it is; the weights stay in the ratings' dtype, and the Gram
    and rhs are summed in it.

    ``ablate`` is the perf-debug knob (``Config.ablate``): 'nogather' takes
    row 0 of the other side for every neighbour instead of gathering,
    'nogram' keeps the gather and skips the contraction (a Gram of each
    row's first gathered value, the rhs the sum of its gathered rows).  The
    JAX package's 'nogram' broadcasts that value to [R, R, K, K], which no
    later step accepts; here it is the [R, K, K] its code means."""
    ablates = ablate.split(",")
    r_rows, width = bucket.nbr.shape
    k = other_items.shape[-1]
    dtype = bucket.val.dtype
    mask = bucket.mask.to(dtype)
    if "nogather" in ablates:
        vg = other_items[:1, None, :].expand(r_rows, width, k)
    else:
        vg = other_items.index_select(0, bucket.nbr.reshape(-1))
        vg = vg.reshape(r_rows, width, k)
    vg = vg * bucket.mask.to(vg.dtype)[..., None]            # [R, W, K]
    wts = (bucket.val - mean_rating) * mask * alpha          # [R, W]
    if "nogram" in ablates:
        gram = mask.new_zeros((r_rows, k, k)) + vg[:, 0, 0, None, None].to(dtype)
        rhs = vg.sum(1).to(dtype)
    else:
        vg_t = vg.transpose(1, 2)                            # [R, K, W]
        gram = matmul_acc(vg_t, vg, dtype)
        rhs = matmul_acc(vg_t, wts[..., None], dtype)[..., 0]
    if split:
        return (segment_sum(gram, bucket.segments, n_slots),
                segment_sum(rhs, bucket.segments, n_slots))
    return gram[:n_slots], rhs[:n_slots]


def posterior_precision_rhs(
    gram: torch.Tensor,      # [S, K, K]
    rhs: torch.Tensor,       # [S, K]
    item_ids: torch.Tensor,  # [S] index into the prop arrays when present
    hp: HyperParams,
    alpha: float,
    *,
    prop_mu: Optional[torch.Tensor] = None,      # [num_pad, K]
    prop_lambda: Optional[torch.Tensor] = None,  # [num_pad, K, K]
    diagonal_only: bool = False,
    strict_reference: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Combine the data statistics with the shared or per-item propagated
    prior into the posterior precision and rhs (c++/sample.cpp:272-304;
    ``bpmf_tpu.ops.update.posterior_precision_rhs``)."""
    if prop_lambda is not None:
        lam_hp = prop_lambda[item_ids]                     # [S, K, K]
        if strict_reference:
            # c++/sample.cpp:285 quirk: shared hp.mu with per-item propLambda
            prior_rhs = lam_hp @ hp.mu
        else:
            prior_rhs = (lam_hp @ prop_mu[item_ids][..., None])[..., 0]
    else:
        lam_hp = hp.lambda_f
        prior_rhs = lam_hp @ hp.mu
    precision = lam_hp + alpha * gram
    if diagonal_only:
        # BPMF_NO_COVARIANCE / ONLY_VARIANCE (c++/sample.cpp:300-304)
        precision = precision * torch.eye(precision.shape[-1],
                                          dtype=precision.dtype,
                                          device=precision.device)
    return precision, rhs + prior_rhs


def chol_solve_sample(precision: torch.Tensor, rhs: torch.Tensor,
                      noise: torch.Tensor) -> torch.Tensor:
    """u = L' \\ (noise + L \\ rhs) with L L' = precision
    (c++/sample.cpp:306-324): the ``xla`` solver, whose JAX counterpart is
    ``lax.linalg``, as ``torch.linalg`` calls.  A system that is not
    positive definite gives NaN, as in the JAX package."""
    chol = cholesky_or_nan(precision)
    y = torch.linalg.solve_triangular(chol, rhs[..., None], upper=False)
    u = torch.linalg.solve_triangular(chol.mT, y + noise[..., None], upper=True)
    return u[..., 0]


def noise_table(generator: torch.Generator, num: int, k: int, dtype,
                device) -> torch.Tensor:
    """N(0, I_K) noise for every item of a side, [num + 1, K]."""
    return torch.randn((num + 1, k), generator=generator, dtype=dtype,
                       device=device)


def item_noise(generator: torch.Generator, orig_ids: torch.Tensor, num: int,
               k: int, dtype) -> torch.Tensor:
    """Noise rows for the given original item ids; ``num`` is the side's
    item count, and padding slots carry id ``num``."""
    return noise_table(generator, num, k, dtype, orig_ids.device)[orig_ids]


def sample_bucket(
    bucket: BucketDev,
    other_items: torch.Tensor,
    hp: HyperParams,
    mean_rating,
    alpha: float,
    noise: torch.Tensor,  # [S, K] N(0, I) rows of the bucket's slots
    *,
    split: bool,
    prop_mu: Optional[torch.Tensor] = None,
    prop_lambda: Optional[torch.Tensor] = None,
    diagonal_only: bool = False,
    strict_reference: bool = True,
) -> UpdateOut:
    """Draw new vectors for every slot of one degree bucket
    (``bpmf_tpu.ops.update.sample_bucket``; the noise comes from the
    caller's draw provider)."""
    gram, rhs = gram_rhs(bucket, other_items, mean_rating, alpha, split=split,
                         n_slots=bucket.item_ids.shape[0])
    precision, full_rhs = posterior_precision_rhs(
        gram, rhs, bucket.item_ids, hp, alpha, prop_mu=prop_mu,
        prop_lambda=prop_lambda, diagonal_only=diagonal_only,
        strict_reference=strict_reference)
    u = chol_solve_sample(precision, full_rhs, noise)
    return UpdateOut(u=u, item_ids=bucket.item_ids, slot_valid=bucket.slot_valid)
