"""BPMF model: per-side state, half-sweep, prediction, full Gibbs iteration
(port of ``bpmf_tpu/models/bpmf.py``).

State is NamedTuples of tensors, updated functionally like the JAX package:
a half-sweep returns a new :class:`SideState`.  No autograd is involved.
:func:`gibbs_iter` is the library-level way to run one Gibbs iteration on
the degree buckets without :class:`~bpmf_tpu_torch.sampler.BPMF`: the
caller builds each side's :class:`SideData` and hands in a draw provider
(``sampler.TorchDraws`` or ``HostDraws``) where the JAX package takes a
key.  Tensors live on the caller's device; :func:`init_side_state`
defaults to ``cuda``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from bpmf_tpu_torch.device import resolve_device
from bpmf_tpu_torch.ops.cholsolve import get_solver
from bpmf_tpu_torch.ops.mvnormal import HyperDraws, HyperParams, sample_hyper
from bpmf_tpu_torch.ops.update import (
    BucketDev,
    gram_rhs,
    posterior_precision_rhs,
)
from bpmf_tpu_torch.utils.counters import span

__all__ = [
    "SideState",
    "SideData",
    "EvalData",
    "EvalState",
    "Metrics",
    "aggr_pair_indices",
    "aggr_prod_full",
    "aggr_prod_pack",
    "aggr_prod_update",
    "init_side_state",
    "bucket_systems",
    "sweep_core",
    "half_sweep",
    "predict",
    "predict_deferred",
    "gibbs_iter",
]


class SideState(NamedTuple):
    """Per-side sampler state (Sys fields, c++/bpmf.h:193-226).

    ``aggr_prod`` holds the packed lower triangle of the running sum of
    u u', pairs ordered as :func:`aggr_pair_indices`."""

    items: torch.Tensor                    # [num_pad, K]
    hp: HyperParams
    sum: torch.Tensor                      # [K]
    cov: torch.Tensor                      # [K, K]
    norm: torch.Tensor                     # scalar, sum of squared norms
    aggr_mu: Optional[torch.Tensor] = None    # [num_pad, K]
    aggr_prod: Optional[torch.Tensor] = None  # [num_pad, K(K+1)/2]


class SideData(NamedTuple):
    """One side's constant device data: its degree buckets and, with a
    propagated posterior, the per-item prior in padded order."""

    buckets: tuple[BucketDev, ...]
    prop_mu: Optional[torch.Tensor] = None      # [num_pad, K]
    prop_lambda: Optional[torch.Tensor] = None  # [num_pad, K, K]


class EvalData(NamedTuple):
    """Test ratings as COO triples, indices in padded order.  ``valid``
    marks the real entries when the triples are padded: the entry-sharded
    evaluation of a multi-device run pads nnz_t to a multiple of the rank
    count (``bpmf_tpu.models.bpmf.EvalData``)."""

    t_user: torch.Tensor  # [nnz_t] int64
    t_item: torch.Tensor  # [nnz_t] int64
    t_val: torch.Tensor   # [nnz_t]
    valid: Optional[torch.Tensor] = None  # [nnz_t] 1 / 0


class EvalState(NamedTuple):
    """Welford running mean / M2 of each test prediction (Pavg / Pm2,
    c++/bpmf.h:229-230)."""

    pavg: torch.Tensor
    pm2: torch.Tensor


class Metrics(NamedTuple):
    rmse: torch.Tensor
    rmse_avg: torch.Tensor
    norm_users: torch.Tensor   # ||U||_F
    norm_movies: torch.Tensor  # ||V||_F


def aggr_pair_indices(k: int) -> tuple[np.ndarray, np.ndarray]:
    """(ii, jj) index pairs of the packed aggr_prod layout: column-major
    lower triangle, length k(k+1)/2."""
    pairs = [(i, j) for j in range(k) for i in range(j, k)]
    ii = np.asarray([p[0] for p in pairs], np.int32)
    jj = np.asarray([p[1] for p in pairs], np.int32)
    return ii, jj


@functools.cache
def _pair_index(k: int, device: torch.device):
    return tuple(torch.as_tensor(x, dtype=torch.long, device=device)
                 for x in aggr_pair_indices(k))


def aggr_prod_full(packed: np.ndarray, k: int) -> np.ndarray:
    """Packed aggregates [..., K(K+1)/2] -> the symmetric [..., K, K] of the
    output and checkpoint formats (``bpmf_tpu.models.bpmf.aggr_prod_full``)."""
    ii, jj = aggr_pair_indices(k)
    full = np.zeros(packed.shape[:-1] + (k, k), packed.dtype)
    full[..., ii, jj] = packed
    full[..., jj, ii] = packed
    return full


def aggr_prod_pack(full):
    """Inverse of :func:`aggr_prod_full`: the packed [..., K(K+1)/2] of a
    symmetric [..., K, K] (numpy array or tensor)."""
    ii, jj = aggr_pair_indices(full.shape[-1])
    return full[..., ii, jj]


def init_side_state(num_pad: int, num_latent: int, dtype, aggregate: bool,
                    device="cuda") -> SideState:
    """Zero-init (Sys::init, c++/sample.cpp:179-201) on ``device``, which
    must exist (``device.resolve_device``)."""
    k, dev = num_latent, resolve_device(device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return SideState(
        items=zeros(num_pad, k),
        hp=HyperParams.init(k, dtype, dev),
        sum=zeros(k),
        cov=zeros(k, k),
        norm=zeros(),
        aggr_mu=zeros(num_pad, k) if aggregate else None,
        aggr_prod=zeros(num_pad, k * (k + 1) // 2) if aggregate else None,
    )


def aggr_prod_update(uv: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Packed outer-product batch [S, k(k+1)/2]: entry (i, j), i >= j, is
    uv[:, i] * u[:, j]."""
    ii, jj = _pair_index(u.shape[-1], u.device)
    return uv[:, ii] * u[:, jj]


def bucket_systems(
    buckets: Sequence[BucketDev],
    other_items: torch.Tensor,          # [num_other_pad, K]
    hp: HyperParams,
    *,
    mean_rating,
    alpha: float,
    splits: Sequence[bool],
    diagonal_only: bool = False,
    strict_reference: bool = True,
    prop_mu: Optional[torch.Tensor] = None,      # [num_pad, K]
    prop_lambda: Optional[torch.Tensor] = None,  # [num_pad, K, K]
    ablate: str = "",                            # perf-debug (gram_rhs)
):
    """The systems one bucketed half-sweep solves: per degree bucket the
    Gram and rhs, then all buckets concatenated into one prior combine.
    Returns (precision [S, K, K], rhs [S, K], item_ids [S], slot_valid [S])
    over the concatenated slots."""
    grams, rhss = [], []
    for b, bucket in enumerate(buckets):
        g, r = gram_rhs(bucket, other_items, mean_rating, alpha,
                        split=splits[b], n_slots=bucket.item_ids.shape[0],
                        ablate=ablate)
        grams.append(g)
        rhss.append(r)
    item_ids = torch.cat([b.item_ids for b in buckets])
    precision, rhs = posterior_precision_rhs(
        torch.cat(grams), torch.cat(rhss), item_ids, hp, alpha,
        prop_mu=prop_mu, prop_lambda=prop_lambda,
        diagonal_only=diagonal_only, strict_reference=strict_reference)
    return precision, rhs, item_ids, torch.cat([b.slot_valid for b in buckets])


def sweep_core(
    items: torch.Tensor,                # [num_pad, K]
    aggr_mu: Optional[torch.Tensor],
    aggr_prod: Optional[torch.Tensor],
    buckets: Sequence[BucketDev],
    other_items: torch.Tensor,          # [num_other_pad, K]
    hp: HyperParams,
    noise: torch.Tensor,                # [sum of slots, K] by orig id
    it: int,
    *,
    burnin: int,
    solver: str = "xla",
    solve_span: str = "bpmf.solve",
    **systems,
):
    """Resample the items covered by ``buckets`` and return (items, sum,
    prod, norm, aggr_mu, aggr_prod) (``bpmf_tpu.models.bpmf.sweep_core``):
    the systems of :func:`bucket_systems` (``systems`` are its keyword
    arguments), one batched solve, one scatter and the stats.  ``noise``
    holds the rows of the concatenated slots.  Padding slots scatter to
    the side's scratch row (a padding row of ``items``); they have no
    ratings, so their draw is finite, and ``slot_valid`` keeps them out of
    the stats and aggregates.  Spans (``utils.counters.span``):
    ``solve_span`` up to the scattered items, then ``bpmf.stats``."""
    with span(solve_span):
        precision, rhs, item_ids, slot_valid = bucket_systems(
            buckets, other_items, hp, **systems)
        u = get_solver(solver)(precision, rhs, noise)
        del precision
        # every padding slot writes the same draw (no ratings, the noise row
        # of id num) to the scratch row, so the duplicate indices are
        # harmless
        items = items.index_copy(0, item_ids, u)

    with span("bpmf.stats"):
        uv = u * slot_valid[:, None]
        s = uv.sum(0)
        prod = uv.t() @ u
        norm = (uv * u).sum()
        if aggr_mu is not None and it >= burnin:
            # aggrMu/aggrLambda post-burnin (c++/sample.cpp:364-368); padding
            # slots add zeros
            aggr_mu = aggr_mu.index_add(0, item_ids, uv)
            aggr_prod = aggr_prod.index_add(0, item_ids,
                                            aggr_prod_update(uv, u))
    return items, s, prod, norm, aggr_mu, aggr_prod


def half_sweep(
    state: SideState,
    data: SideData,
    other_items: torch.Tensor,          # [num_other_pad, K], whole
    hyper: HyperDraws,                  # this side's Normal-Wishart draws
    noise: torch.Tensor,                # [sum of slots, K] by orig id
    it: int,
    *,
    num: int,
    mean_rating,
    alpha: float,
    burnin: int,
    splits: Sequence[bool],
    diagonal_only: bool = False,
    strict_reference: bool = True,
    noise_scale: float = 1.0,
    solver: str = "unrolled",
    mesh=None,
) -> SideState:
    """Resample every item of one side given the other side's items
    (Sys::sample(Sys&), c++/sample.cpp:341-385;
    ``bpmf_tpu.models.bpmf.half_sweep``): the hyperprior from the previous
    sweep's stats and ``hyper`` (drawn with df = K + ``num``), then
    :func:`~bpmf_tpu_torch.parallel.spmd.sweep_buckets`.  ``num`` is the
    side's GLOBAL item count, for the hyperprior and the covariance.  With
    a ``mesh`` (the JAX package's ``psum_axis``) ``state`` and ``data`` are
    this rank's shard and the stats are summed over the ranks, so the
    covariance is the exact global one; ``other_items`` is whole on every
    rank.  ``noise_scale`` scales the noise (0: the posterior mean)."""
    # spmd imports this module
    from bpmf_tpu_torch.parallel.spmd import sweep_buckets

    hp = sample_hyper(hyper, num, state.sum, state.cov)
    if noise_scale != 1.0:
        noise = noise * noise_scale
    return sweep_buckets(
        state, data.buckets, other_items, hp, noise, it, num=num,
        mean_rating=mean_rating, alpha=alpha, burnin=burnin, splits=splits,
        diagonal_only=diagonal_only, strict_reference=strict_reference,
        solver=solver, prop_mu=data.prop_mu, prop_lambda=data.prop_lambda,
        mesh=mesh)


def predict(ev: EvalData, est: EvalState, user_items: torch.Tensor,
            movie_items: torch.Tensor, it: int, *, mean_rating: torch.Tensor,
            burnin: int, mesh=None, nnz_true: Optional[int] = None
            ) -> tuple[EvalState, torch.Tensor, torch.Tensor]:
    """RMSE of the current sample and of the running posterior-mean
    prediction (Welford), Sys::predict (c++/sample.cpp:48-96).  With
    n = max(0, it - burnin), n == 0 overwrites the average with the current
    prediction and resets M2 (c++/sample.cpp:84-86).  With a ``mesh``
    (``parallel.spmd.predict_sharded``) ``ev`` and ``est`` are this rank's
    entries, the error sums are summed over ranks and divided by
    ``nnz_true``, the entry count of the whole test set.  Tables in bf16
    (the sampler's final pass under bf16 matmul inputs) give each entry's
    products rounded to bf16, summed in the ratings' dtype, as the JAX
    package's ``gather_dtype`` does."""
    dtype = ev.t_val.dtype
    pred = (user_items[ev.t_user] * movie_items[ev.t_item]).to(dtype).sum(-1) \
        + mean_rating
    return _welford(ev, est, pred, it, burnin, mesh, nnz_true)


def _welford(ev: EvalData, est: EvalState, pred: torch.Tensor, it: int,
             burnin: int, mesh=None, nnz_true: Optional[int] = None
             ) -> tuple[EvalState, torch.Tensor, torch.Tensor]:
    """The Welford step of :func:`predict` for one iteration's predictions."""
    n = max(it - burnin, 0)
    if n == 0:
        avg = pred
        m2 = torch.zeros_like(pred)
    else:
        delta = pred - est.pavg
        avg = est.pavg + delta / n
        m2 = est.pm2 + delta * (pred - avg)
    if ev.valid is None and mesh is None:
        nump = ev.t_val.shape[0]
        rmse = torch.sqrt(((ev.t_val - pred) ** 2).sum() / nump)
        rmse_avg = torch.sqrt(((ev.t_val - avg) ** 2).sum() / nump)
        return EvalState(pavg=avg, pm2=m2), rmse, rmse_avg
    valid = 1.0 if ev.valid is None else ev.valid
    se = torch.stack([(valid * (ev.t_val - pred) ** 2).sum(),
                      (valid * (ev.t_val - avg) ** 2).sum()])
    if mesh is not None:
        se = mesh.all_reduce(se)
    nump = nnz_true if nnz_true is not None else ev.t_val.shape[0]
    rmse, rmse_avg = torch.sqrt(se / nump).unbind()
    return EvalState(pavg=avg, pm2=m2), rmse, rmse_avg


def predict_deferred(ev: EvalData, est: EvalState, users_stack: torch.Tensor,
                     movies_stack: torch.Tensor, it0: int, *,
                     mean_rating: torch.Tensor, burnin: int
                     ) -> tuple[EvalState, torch.Tensor, torch.Tensor]:
    """:func:`predict` over n iterations at once (``bpmf_tpu.models.bpmf.
    predict_deferred``): ``users_stack`` [n, pn_u, K] and ``movies_stack``
    [n, pn_m, K] hold iteration it0 + c's tables in slot c.  One pair of
    gathers of n x nnz_t rows replaces the n per-iteration pairs; the
    Welford steps then run in order over the gathered predictions, so the
    states and both RMSE series [n] are those of n calls of
    :func:`predict`."""
    n, pn_u, k = users_stack.shape
    pn_m = movies_stack.shape[1]
    steps = torch.arange(n, dtype=ev.t_user.dtype, device=ev.t_user.device)
    iu = (steps[:, None] * pn_u + ev.t_user[None, :]).reshape(-1)
    im = (steps[:, None] * pn_m + ev.t_item[None, :]).reshape(-1)
    gu = users_stack.reshape(n * pn_u, k)[iu]
    gm = movies_stack.reshape(n * pn_m, k)[im]
    preds = (gu * gm).sum(-1).reshape(n, -1) + mean_rating
    rmse, rmse_avg = [], []
    for c in range(n):
        est, r, ra = _welford(ev, est, preds[c], it0 + c, burnin)
        rmse.append(r)
        rmse_avg.append(ra)
    return est, torch.stack(rmse), torch.stack(rmse_avg)


def gibbs_iter(
    movies: SideState,
    users: SideState,
    est: EvalState,
    movies_data: SideData,
    users_data: SideData,
    ev: EvalData,
    draws,
    it: int,
    *,
    num_movies: int,
    num_users: int,
    mean_rating,
    alpha: float,
    burnin: int,
    movies_splits: Sequence[bool],
    users_splits: Sequence[bool],
    diagonal_only: bool = False,
    strict_reference: bool = True,
    noise_scale: float = 1.0,
    solver: str = "unrolled",
) -> tuple[SideState, SideState, EvalState, Metrics]:
    """One full Gibbs iteration (c++/bpmf.cpp:184-196;
    ``bpmf_tpu.models.bpmf.gibbs_iter``): movies given users, users given
    movies, then evaluation.  ``draws`` is a draw provider
    (``sampler.TorchDraws``, ``HostDraws``): side s of iteration ``it``
    takes ``draws.hyper(it, s, num, K, dtype)`` and the noise rows of its
    bucket slots' original ids, movies s = 0, users s = 1.  The users'
    hyperprior conditions on their stats from before this iteration, as
    the sampler's pair draw does."""
    k, dtype = users.items.shape[-1], users.items.dtype
    common = dict(mean_rating=mean_rating, alpha=alpha, burnin=burnin,
                  diagonal_only=diagonal_only,
                  strict_reference=strict_reference, noise_scale=noise_scale,
                  solver=solver)

    def sweep(state, data, other_items, side, num, splits):
        orig = torch.cat([b.orig_ids for b in data.buckets])
        return half_sweep(state, data, other_items,
                          draws.hyper(it, side, num, k, dtype),
                          draws.noise(it, side, orig, num, k, dtype), it,
                          num=num, splits=splits, **common)

    movies = sweep(movies, movies_data, users.items, 0, num_movies, movies_splits)
    users = sweep(users, users_data, movies.items, 1, num_users, users_splits)
    est, rmse, rmse_avg = predict(ev, est, users.items, movies.items, it,
                                  mean_rating=mean_rating, burnin=burnin)
    metrics = Metrics(rmse=rmse, rmse_avg=rmse_avg,
                      norm_users=torch.sqrt(users.norm),
                      norm_movies=torch.sqrt(movies.norm))
    return movies, users, est, metrics
