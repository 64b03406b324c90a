"""Half-sweeps of the Gibbs chain (port of ``bpmf_tpu/parallel/spmd.py``).

The half-sweeps of every Gram route: the int8 dense stream on one device
(:func:`dense8_half_sweep`) and sharded over ranks
(:func:`dense8_half_sweep_sharded`), the dense adjacency
(:func:`dense_half_sweep`, :func:`dense_half_sweep_fused`), the degree
buckets in gather mode (:func:`gather_half_sweep`, with the halo ring
:func:`halo_gather`) and in reduce mode (:func:`reduce_half_sweep`,
:func:`reduce_half_sweep_chunked`), and the sharded evaluation
(:func:`predict_sharded`).  They keep their JAX names.

Multi-device (``mesh``, a :class:`~bpmf_tpu_torch.parallel.mesh.Mesh` of
one process per rank): each rank holds its shard of both sides' items.
Gather mode all-gathers the frozen side in front of the one-device body
(``spmd.py:205``, ``:339``, ``:519``), or on the buckets receives only the
rows its ratings reference over the halo ring; reduce mode on the buckets
never moves the frozen side: each rank sums the partial Gram and rhs of
the ratings whose frozen item it owns, and the partials meet on their
item's owner (``spmd.py:616``, ``:1106``).  The sharded dense8 sweep
gathers the frozen movies on the users' sweep and reduce-scatters the
partial Gram and rhs of its user rows on the movies' sweep
(``spmd.py:934``).  Every sweep
then sums (sum, prod, norm) over ranks in one ``all_reduce`` of one packed
buffer, so the covariance is the exact global one, not the reference
C++'s per-rank form.  With ``mesh=None`` (one device) there is no
collective, as the JAX package's ``all_gather`` and ``psum`` are
identities on one device.  Noise rows are keyed by original id, so a chain
is the same at any rank count up to reduction order.

bf16 matmul inputs (``Config.matmul_dtype="bfloat16"``): the dense8 sweeps
take ``matmul_dtype`` (``torch.bfloat16``), the dense routes read it off
the dense blocks, which the sampler keeps in it, the bucketed routes off
the frozen table, which the sampler rounds; each rounds where the JAX
package's sweep rounds: the frozen side (one device: its packed products
too, formed from the rounded side; sharded dense8: the packed products of
the float32 side, rounded), the dense blocks and the outer products of
the float32 side, the bucketed table before its gather.  Every product
and sum is in the compute dtype (``ops.update.matmul_acc``, the kernels'
bf16 instances).  The bucketed gathers and halo rings, and the final
evaluation's gathers, move the bf16 tables; every other exchange moves
float32.

``ablate`` is the perf-debug knob (``Config.ablate``, comma-separated):
``nomatmul`` replaces the Gram and rhs by constants of the same shape,
``nosolve`` the solve by a sum of its inputs, as the JAX package's sweeps
do (``bpmf_tpu/parallel/spmd.py:343-376, 523-550, 874-908``); ``nogather``
and ``nogram`` act in the bucket Gram (:func:`~bpmf_tpu_torch.ops.update.
gram_rhs`).  ``nohyper`` and ``nonoise`` act where the port draws: the
sampler hands the sweeps ``HyperParams.init`` and zero noise.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch

from bpmf_tpu_torch.models.bpmf import (
    EvalData,
    EvalState,
    SideState,
    aggr_prod_update,
    predict,
    sweep_core,
)
from bpmf_tpu_torch.ops.cholsolve import get_solver
from bpmf_tpu_torch.ops.dense8 import (
    FUSED_ROUTES,
    SWEEP_LAYOUT,
    dense8_gram_rhs_cols,
    dense8_gram_rhs_rows,
    dense8_sweep_solve,
    packed_tri_t,
)
from bpmf_tpu_torch.ops.mvnormal import HyperParams
from bpmf_tpu_torch.ops.pallas_solve import (
    prior_rhs_from_tri,
    tight_rows,
    tri_combine_solve_sample,
    tri_tight_pairs,
)
from bpmf_tpu_torch.ops.update import (
    BucketDev,
    gram_rhs,
    matmul_acc,
    posterior_precision_rhs,
)
from bpmf_tpu_torch.parallel.mesh import Mesh
from bpmf_tpu_torch.utils.counters import span

__all__ = [
    "dense8_half_sweep",
    "dense8_half_sweep_sharded",
    "dense_half_sweep",
    "dense_half_sweep_fused",
    "exchange_stats",
    "gather_half_sweep",
    "halo_gather",
    "predict_sharded",
    "reduce_half_sweep",
    "reduce_half_sweep_chunked",
    "sweep_buckets",
]


def _combine_prior_rhs(rhs_t, hp, prior_tri_t, prior_rhs_t, grouped=False):
    """rhs + prior contribution, [K, I] (c++/sample.cpp:272-285;
    ``spmd._combine_prior_rhs``): with a per-item propagated prior (packed
    in the layout ``grouped`` names), its static rhs when given
    (strict_reference=False), else the reference's quirk Lambda_i @ hp.mu
    with the shared sampled mean; with the shared prior, Lambda @ mu."""
    if prior_tri_t is not None:
        prior_rhs = (prior_rhs_t if prior_rhs_t is not None
                     else prior_rhs_from_tri(prior_tri_t, hp.mu, grouped))
        return rhs_t + prior_rhs
    return rhs_t + (hp.lambda_f @ hp.mu)[:, None]


def dense8_half_sweep(
    state: SideState,
    codes: torch.Tensor,        # [users_pad, movies_pad] int8 rating codes
    other_items: torch.Tensor,  # [num_other_pad, K] the frozen side
    hp: HyperParams,            # this side's hyperprior draw
    noise: torch.Tensor,        # [padded_num, K] N(0, I) rows, by orig id
    it: int,
    *,
    num: int,
    local_valid: torch.Tensor,  # [padded_num] 1 for real items, 0 for padding
    alpha: float,
    burnin: int,
    cs: float,                  # scale * alpha    (value = offset + scale*code)
    cb: float,                  # (offset - mean) * alpha
    orientation: str,           # 'rows' (users sweep) | 'cols' (movies sweep)
    route: str = "fused",       # ops.dense8.d8_route: fused|fused_hoisted|
                                # fused_aligned|inkernel|hoisted
    prior_tri_t: Optional[torch.Tensor] = None,  # [T, padded_num] per-item
                                                 # prior (pack_prior_tri)
    prior_rhs_t: Optional[torch.Tensor] = None,  # [K, padded_num] static rhs
                                                 # (strict_reference=False)
    grouped: bool = False,      # the packed-triangle solve's layout pin
    ablate: str = "",           # perf-debug (Config.ablate)
    max_degree: Optional[int] = None,  # the side's most-rated item's ratings
    walk_work: Optional[int] = None,  # the walk's work (ops.dense8.walk_work)
    matmul_dtype=None,          # the kernels' operand dtype (torch.bfloat16:
                                # bf16 matmul inputs); None: the frozen side's
    solve_span: str = "bpmf.solve",  # the span of the solve (utils.counters)
) -> SideState:
    """Resample every item of one side from the int8 code array
    (``bpmf_tpu.parallel.spmd.dense8_half_sweep``, single device), then the
    side's stats, covariance, norm and, after burn-in, the posterior
    aggregates.  ``route`` is decided once at setup: the megakernel, its
    packed operand built in the kernel ('fused') or hoisted, built here
    once per half-sweep in the tight ('fused_hoisted') or the 8-aligned
    layout ('fused_aligned'); or the split pipeline (Gram kernel, prior
    combine, solve kernel), which alone takes a per-item prior.  The solve
    reads the Gram kernel's tight layout directly, where the JAX package
    runs ``tri_expand_rows`` between them; ``grouped`` (the JAX package's
    ``BPMF_TRI_GROUPED`` pin) names the per-item prior's layout and the
    solve kernel's variant.  The ``nomatmul`` and ``nosolve`` ablations
    run on the split pipeline only, where the JAX package also sends them:
    ``nomatmul`` launches no Gram kernel, ``nosolve`` no solve kernel.
    ``max_degree`` sets how far the megakernel and the in-kernel Gram
    split the frozen axis (``ops.dense8.sweep_plan``); ``walk_work`` picks
    the megakernel on bf16 operands (``ops.dense8.sweep_bf16_kernel``).  With a bf16
    ``matmul_dtype`` the kernels take the frozen side rounded to bf16 and
    the packed products of the rounded side, rounded
    (``bpmf_tpu/parallel/spmd.py:834-866``)."""
    with span(solve_span):
        ablates = ablate.split(",")
        dtype = other_items.dtype
        v_t = other_items.t()
        if matmul_dtype is not None:
            v_t = v_t.to(matmul_dtype)
        if route in FUSED_ROUTES:
            if prior_tri_t is not None:
                raise ValueError("a per-item prior needs the split route")
            if "nomatmul" in ablates or "nosolve" in ablates:
                raise ValueError("the nomatmul/nosolve ablations need the split route")
            layout = SWEEP_LAYOUT.get(route, "tight")
            p_t = (packed_tri_t(v_t.to(dtype), aligned=layout == "aligned").to(v_t.dtype)
                   if route != "fused" else None)
            prior_rhs = (hp.lambda_f @ hp.mu)[:, None]
            u = dense8_sweep_solve(codes, p_t, v_t, hp.lambda_f, prior_rhs,
                                   noise.t(), cs, cb, alpha, orientation,
                                   layout=layout, max_degree=max_degree,
                                   walk_work=walk_work).t()
        elif route in ("inkernel", "hoisted"):
            n_items = noise.shape[0]
            if "nomatmul" in ablates:
                # a constant Gram that still depends on the frozen side
                gram_t = noise.new_zeros((tight_rows(v_t.shape[0]), n_items)) \
                    + v_t[0, 0].to(dtype) * 1e-12
                rhs_t = noise.new_zeros((v_t.shape[0], n_items))
            else:
                p_t = (packed_tri_t(v_t.to(dtype)).to(v_t.dtype) if route == "hoisted"
                       else None)
                gram_rhs = (dense8_gram_rhs_rows if orientation == "rows"
                            else dense8_gram_rhs_cols)
                gram_t, rhs_t = gram_rhs(codes, p_t, v_t, cs, cb,
                                         max_degree=max_degree)
            rhs_t = _combine_prior_rhs(rhs_t, hp, prior_tri_t, prior_rhs_t, grouped)
            if "nosolve" in ablates:
                u = (rhs_t + noise.t() + _aligned_head(gram_t, v_t.shape[0])).t()
            else:
                u = tri_combine_solve_sample(gram_t, hp.lambda_f, rhs_t, noise.t(),
                                             alpha, lam_tri_t=prior_tri_t,
                                             grouped=grouped).t()
        else:
            raise ValueError(f"unknown dense8 route {route!r}")

    return _finish(state, u, local_valid, hp, num, it, burnin)


def dense8_half_sweep_sharded(
    mesh: Mesh,
    state: SideState,
    codes: torch.Tensor,        # [R/D, C] this rank's user rows of the codes
    other_items: torch.Tensor,  # [other local_pad, K] this rank's frozen shard
    hp: HyperParams,
    noise: torch.Tensor,        # [local_pad, K] N(0, I) rows, by orig id
    it: int,
    *,
    num: int,
    local_valid: torch.Tensor,  # [local_pad]
    alpha: float,
    burnin: int,
    cs: float,
    cb: float,
    orientation: str,           # 'rows' (users sweep) | 'cols' (movies sweep)
    route: str = "inkernel",    # the split route of the local shapes:
                                # inkernel | hoisted (ops.dense8.d8_route)
    prior_tri_t: Optional[torch.Tensor] = None,  # [T, local_pad]
    prior_rhs_t: Optional[torch.Tensor] = None,  # [K, local_pad]
    grouped: bool = False,
    max_degree: Optional[int] = None,  # the most ratings an item has within
                                       # this rank's codes
    matmul_dtype=None,          # as dense8_half_sweep's
    solve_span: str = "bpmf.solve",
) -> SideState:
    """The int8 dense-stream half-sweep over ranks (``bpmf_tpu.parallel.
    spmd.dense8_half_sweep_sharded``): the code array is sharded by user
    rows, each rank streaming only its [R/D, C] shard.

    * users (``rows``): the all_gather of the frozen movies, [C/D, K] to
      [C, K], then the Gram kernel (#3, or #4 on a hoisted operand) on the
      rank's rows;
    * movies (``cols``): the Gram kernel over the rank's user rows gives
      every movie's PARTIAL Gram and rhs, [T+K, C]; laid out as [D, T+K,
      C/D], one reduce_scatter leaves each movie owner the sums of its
      [T+K, C/D].

    Then the split pipeline's tail: the prior combine and the packed-
    triangle solve (#5; #6 with a per-item prior; #7 when ``grouped``), and
    the stats summed over ranks.  The megakernels (#1/#2) do not run here:
    the JAX package takes the split pipeline at D > 1 whatever
    ``BPMF_D8_SOLVE`` says.  ``route`` is decided on the local shapes,
    (R/D, C) for rows and (C, R/D) for cols, as the JAX package's
    ``pt_mode`` sees them.  With a bf16 ``matmul_dtype`` the kernels take
    the frozen side rounded to bf16 and the packed products of the float32
    side, rounded (``bpmf_tpu/parallel/spmd.py:1035-1060``): another
    rounding than one device's, so two ranks at bf16 are one device up to
    the products' rounding."""
    if route not in ("inkernel", "hoisted"):
        raise ValueError(f"the sharded dense8 sweep runs the split pipeline, "
                         f"not route {route!r}")
    with span(solve_span):
        md = matmul_dtype or other_items.dtype

        def operands(v32):
            p_t = packed_tri_t(v32).to(md) if route == "hoisted" else None
            return p_t, v32.to(md)

        if orientation == "rows":
            p_t, v_t = operands(mesh.all_gather(other_items).t())   # [K, C]
            gram_t, rhs_t = dense8_gram_rhs_rows(codes, p_t, v_t, cs, cb,
                                                 max_degree=max_degree)
        elif orientation == "cols":
            p_t, v_t = operands(other_items.t())                    # [K, R/D]
            gram_t, rhs_t = dense8_gram_rhs_cols(codes, p_t, v_t, cs, cb,
                                                 max_degree=max_degree)
            t_rows, k, cols = gram_t.shape[0], rhs_t.shape[0], gram_t.shape[1]
            lp = cols // mesh.size
            both = torch.cat([gram_t, rhs_t])                    # [T+K, C] partial
            both = mesh.reduce_scatter(
                both.reshape(t_rows + k, mesh.size, lp).transpose(0, 1)
                .reshape(mesh.size * (t_rows + k), lp))          # [T+K, C/D]
            gram_t, rhs_t = both[:t_rows], both[t_rows:]
        else:
            raise ValueError(f"bad orientation {orientation!r}")
        rhs_t = _combine_prior_rhs(rhs_t, hp, prior_tri_t, prior_rhs_t, grouped)
        u = tri_combine_solve_sample(gram_t, hp.lambda_f, rhs_t, noise.t(), alpha,
                                     lam_tri_t=prior_tri_t, grouped=grouped).t()
    return _finish(state, u, local_valid, hp, num, it, burnin, mesh)


def _aligned_head(gram_t: torch.Tensor, k: int) -> torch.Tensor:
    """Rows 0..K-1 of the 8-aligned packed layout, [K, I], taken from a
    tight packed Gram: the entries the JAX package's ``nosolve`` reads as
    ``gram_t[:K]`` after ``tri_expand_rows`` (its ``row_map`` sends each
    aligned row to the tight row of the same entry)."""
    return gram_t[_aligned_head_rows(k, gram_t.device)]


@functools.cache
def _aligned_head_rows(k: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(tri_tight_pairs(k)[2][:k], dtype=torch.long,
                           device=device)


def exchange_stats(mesh: Optional[Mesh], s, prod, norm):
    """(sum [K], prod [K, K], norm []) summed over the ranks of ``mesh`` in
    one ``all_reduce`` of one packed buffer (``reduce_sum_cov_norm``,
    c++/mpi_common.h:44-50; the JAX package's three ``lax.psum``); unchanged
    without a mesh."""
    if mesh is None:
        return s, prod, norm
    k = s.shape[0]
    buf = mesh.all_reduce(torch.cat([s, prod.reshape(-1), norm.reshape(1)]))
    return buf[:k], buf[k:k + k * k].reshape(k, k), buf[k + k * k]


def _finish(state: SideState, u, local_valid, hp, num, it, burnin,
            mesh: Optional[Mesh] = None) -> SideState:
    """The side's new state from its new items [local items, K]: sum, prod,
    norm over the real items (over every rank's items with a mesh), the
    covariance, and after burn-in the posterior aggregates (``spmd.py``
    after each shard_map body); span ``bpmf.stats``."""
    with span("bpmf.stats"):
        uv = u * local_valid[:, None]
        s, prod, norm = exchange_stats(mesh, uv.sum(0), uv.t() @ u,
                                       (uv * u).sum())
        aggr_mu, aggr_prod = state.aggr_mu, state.aggr_prod
        if aggr_mu is not None and it >= burnin:
            aggr_mu = aggr_mu + uv
            aggr_prod = aggr_prod + aggr_prod_update(uv, u)
        return _with_stats(u, hp, s, prod, norm, num, aggr_mu, aggr_prod)


def _with_stats(items, hp, s, prod, norm, num, aggr_mu, aggr_prod) -> SideState:
    cov = (prod - torch.outer(s, s) / num) / (num - 1.0)
    return SideState(items=items, hp=hp, sum=s, cov=cov, norm=norm,
                     aggr_mu=aggr_mu, aggr_prod=aggr_prod)


def gather_half_sweep(
    state: SideState,
    buckets: Sequence[BucketDev],  # this side's degree buckets (this rank's)
    other_items: torch.Tensor,     # [num_other_pad, K] the frozen side (this
                                   # rank's shard with a mesh)
    hp: HyperParams,
    noise: torch.Tensor,           # [sum of slots, K] N(0, I) by orig id
    it: int,
    *,
    num: int,
    mean_rating,
    alpha: float,
    burnin: int,
    splits: Sequence[bool],
    diagonal_only: bool = False,
    strict_reference: bool = True,
    solver: str = "smart",
    prop_mu: Optional[torch.Tensor] = None,      # [num_pad, K]
    prop_lambda: Optional[torch.Tensor] = None,  # [num_pad, K, K]
    ablate: str = "",                            # perf-debug (Config.ablate)
    mesh: Optional[Mesh] = None,
    halo: Optional[tuple] = None,  # (send_rows, recv_pos): this rank's row
                                   # of each ring round (HaloLayout)
    solve_span: str = "bpmf.solve",
) -> SideState:
    """Value-exchange half-sweep over the degree buckets
    (``bpmf_tpu.parallel.spmd.gather_half_sweep``): with a mesh, the
    all_gather of the frozen side, or with ``halo`` the ring of
    :func:`halo_gather`, which moves only the referenced rows (the same
    values on every row a bucket reads); then the per-bucket Gram, one
    combine and solve (:func:`~bpmf_tpu_torch.models.bpmf.sweep_core`), the
    scatter, and the stats summed over ranks.  The exchange is in the
    solve's span (a span of its own before the one :func:`sweep_buckets`
    opens)."""
    if mesh is not None:
        with span(solve_span):
            other_items = (halo_gather(mesh, other_items, *halo)
                           if halo is not None
                           else mesh.all_gather(other_items))
    return sweep_buckets(
        state, buckets, other_items, hp, noise, it, num=num,
        mean_rating=mean_rating, alpha=alpha, burnin=burnin, splits=splits,
        diagonal_only=diagonal_only, strict_reference=strict_reference,
        solver=solver, prop_mu=prop_mu, prop_lambda=prop_lambda,
        ablate=ablate, mesh=mesh, solve_span=solve_span)


def sweep_buckets(state: SideState, buckets: Sequence[BucketDev],
                  other_items: torch.Tensor, hp: HyperParams,
                  noise: torch.Tensor, it: int, *, num: int, burnin: int,
                  mesh: Optional[Mesh] = None, solve_span: str = "bpmf.solve",
                  **systems) -> SideState:
    """The body of :func:`gather_half_sweep` once the frozen side is whole
    on this rank: the per-bucket Gram, one combine and solve
    (:func:`~bpmf_tpu_torch.models.bpmf.sweep_core`, ``systems`` its
    keyword arguments), the scatter, the stats summed over the ranks of
    ``mesh``, and the covariance with the global ``num``.  Also the body of
    :func:`~bpmf_tpu_torch.models.bpmf.half_sweep`.  Spans: ``solve_span``
    and ``bpmf.stats`` (opened by ``sweep_core``)."""
    items, s, prod, norm, aggr_mu, aggr_prod = sweep_core(
        state.items, state.aggr_mu, state.aggr_prod, buckets, other_items,
        hp, noise, it, burnin=burnin, solve_span=solve_span, **systems)
    with span("bpmf.stats"):
        s, prod, norm = exchange_stats(mesh, s, prod, norm)
        return _with_stats(items, hp, s, prod, norm, num, aggr_mu, aggr_prod)


def halo_gather(mesh: Mesh, other_l: torch.Tensor, send_rows: Sequence,
                recv_pos: Sequence) -> torch.Tensor:
    """The frozen side's rows that this rank's buckets reference, in the
    padded global layout ``[D * lp, K]`` (``bpmf_tpu.parallel.spmd.
    halo_gather``; the reference's opt_conn, c++/assign.cpp:215-286).
    ``other_l`` [lp, K] is this rank's shard; round r = 1..D-1 sends its
    rows ``send_rows[r-1]`` to rank (me+r) % D (:meth:`Mesh.ppermute`) and
    writes the rows received from (me-r) % D at ``recv_pos[r-1]``, padding
    entries at the dump slot ``D * lp``.  Every row a bucket reads equals
    the all_gather's, and so does the own shard; the others stay zero and
    are read only under a zero mask (``ops.update.gram_rhs``)."""
    lp, k = other_l.shape
    n_global = mesh.size * lp
    buf = other_l.new_zeros((n_global + 1, k))
    buf[mesh.rank * lp:(mesh.rank + 1) * lp] = other_l
    for r in range(1, mesh.size):
        recv = mesh.ppermute(other_l.index_select(0, send_rows[r - 1]), r)
        buf.index_copy_(0, recv_pos[r - 1], recv)
    return buf[:n_global]


def _reduce_draw(packed, hp, noise, *, alpha, diagonal_only, strict_reference,
                 solver, prop_mu, prop_lambda):
    """The solve of both reduce sweeps: the owner's summed [lp, K*K + K]
    Gram and rhs, the prior combine per local slot, the side's solver;
    returns the drawn items."""
    k = noise.shape[-1]
    lp = packed.shape[0]
    precision, rhs = posterior_precision_rhs(
        packed[:, :k * k].reshape(lp, k, k), packed[:, k * k:],
        torch.arange(lp, device=packed.device), hp, alpha, prop_mu=prop_mu,
        prop_lambda=prop_lambda, diagonal_only=diagonal_only,
        strict_reference=strict_reference)
    del packed
    return get_solver(solver)(precision, rhs, noise)


def _partials(buckets, splits, other_l, mean_rating, alpha, ablate, rows,
              dtype):
    """The partial Gram and rhs of ``buckets`` against this rank's frozen
    shard ``other_l`` (the buckets' ``nbr`` are its local slots), summed by
    their slots' ``item_ids`` into ``rows`` rows of [K*K + K] in ``dtype``,
    Gram first; padding slots add zeros (``slot_valid``)."""
    k = other_l.shape[-1]
    out = other_l.new_zeros((rows, k * k + k), dtype=dtype)
    for b, split in zip(buckets, splits):
        g, r = gram_rhs(b, other_l, mean_rating, alpha, split=split,
                        n_slots=b.item_ids.shape[0], ablate=ablate)
        out.index_add_(0, b.item_ids,
                       torch.cat([g.reshape(-1, k * k), r], 1)
                       * b.slot_valid[:, None])
    return out


def reduce_half_sweep(
    state: SideState,
    buckets: Sequence[BucketDev],  # this rank's row of the ReduceLayout
    other_items: torch.Tensor,     # [other lp, K] this rank's frozen shard
    hp: HyperParams,
    noise: torch.Tensor,           # [lp, K] N(0, I) by orig id (local slots)
    it: int,
    *,
    num: int,
    padded_num: int,               # D * lp of THIS side
    local_valid: torch.Tensor,     # [lp]
    mean_rating,
    alpha: float,
    burnin: int,
    splits: Sequence[bool],
    diagonal_only: bool = False,
    strict_reference: bool = True,
    solver: str = "smart",
    prop_mu: Optional[torch.Tensor] = None,      # [lp, K]
    prop_lambda: Optional[torch.Tensor] = None,  # [lp, K, K]
    ablate: str = "",
    mesh: Optional[Mesh] = None,
    solve_span: str = "bpmf.solve",
) -> SideState:
    """Statistic-exchange half-sweep over the degree buckets (``bpmf_tpu.
    parallel.spmd.reduce_half_sweep``; ENABLE_REDUCE): the partial Gram
    and rhs of the ratings whose frozen item this rank owns, against its
    own shard, which is never gathered, summed by padded global item id
    into one [padded_num, K*K + K] buffer; one ``reduce_scatter`` leaves
    each owner the sums of its [lp, K*K + K] (the JAX package's two
    ``psum_scatter``, packed into one).  Then the prior combine over the
    rank's slots, the side's solver (#8 under smart/pallas) and the stats
    summed over ranks."""
    with span(solve_span):
        packed = _partials(buckets, splits, other_items, mean_rating, alpha,
                           ablate, padded_num, state.items.dtype)
        if mesh is not None:
            packed = mesh.reduce_scatter(packed)
        u = _reduce_draw(packed, hp, noise, alpha=alpha,
                         diagonal_only=diagonal_only,
                         strict_reference=strict_reference, solver=solver,
                         prop_mu=prop_mu, prop_lambda=prop_lambda)
    return _finish(state, u, local_valid, hp, num, it, burnin, mesh)


def reduce_half_sweep_chunked(
    state: SideState,
    per_dest: Sequence[tuple],     # [D] of (buckets, splits): this rank's
                                   # row of each destination's buckets
    other_items: torch.Tensor,     # [other lp, K] this rank's frozen shard
    hp: HyperParams,
    noise: torch.Tensor,           # [lp, K] N(0, I) by orig id (local slots)
    it: int,
    *,
    num: int,
    local_valid: torch.Tensor,     # [lp]
    mean_rating,
    alpha: float,
    burnin: int,
    diagonal_only: bool = False,
    strict_reference: bool = True,
    solver: str = "smart",
    prop_mu: Optional[torch.Tensor] = None,      # [lp, K]
    prop_lambda: Optional[torch.Tensor] = None,  # [lp, K, K]
    ablate: str = "",
    mesh: Optional[Mesh] = None,
    solve_span: str = "bpmf.solve",
) -> SideState:
    """:func:`reduce_half_sweep` in O(lp * K^2) memory a rank (``bpmf_tpu.
    parallel.spmd.reduce_half_sweep_chunked``; the reference reduces one
    owner's slice at a time, c++/mpi_reduce.h:29-45): one destination
    shard at a time, the partial [lp, K*K + K] of the buckets whose items
    it owns (``item_ids`` its local slots), one ``all_reduce`` (the JAX
    package's ``psum``), and only the owner keeps the sum.  No tensor of
    padded_num rows exists.  Every rank enters every destination's
    all_reduce in the same order, an empty destination's too."""
    lp = local_valid.shape[0]
    rank = 0 if mesh is None else mesh.rank
    mine = None
    with span(solve_span):
        for dest, (buckets, splits) in enumerate(per_dest):
            part = _partials(buckets, splits, other_items, mean_rating, alpha,
                             ablate, lp, state.items.dtype)
            if mesh is not None:
                part = mesh.all_reduce(part)
            if dest == rank:
                mine = part
            del part
        u = _reduce_draw(mine, hp, noise, alpha=alpha,
                         diagonal_only=diagonal_only,
                         strict_reference=strict_reference, solver=solver,
                         prop_mu=prop_mu, prop_lambda=prop_lambda)
    return _finish(state, u, local_valid, hp, num, it, burnin, mesh)


def dense_half_sweep(
    state: SideState,
    a_ind: torch.Tensor,        # [local items, other_pad] 0/1 indicator
    a_val: torch.Tensor,        # [local items, other_pad] (r - mean) * alpha
    other_items: torch.Tensor,  # [other_pad, K] (this rank's shard with a mesh)
    hp: HyperParams,
    noise: torch.Tensor,        # [padded_num, K] N(0, I) by orig id
    it: int,
    *,
    num: int,
    local_valid: torch.Tensor,  # [padded_num]
    alpha: float,
    burnin: int,
    diagonal_only: bool = False,
    strict_reference: bool = True,
    solver: str = "smart",
    prop_mu: Optional[torch.Tensor] = None,      # [local items, K]
    prop_lambda: Optional[torch.Tensor] = None,  # [local items, K, K]
    ablate: str = "",                            # perf-debug (Config.ablate)
    mesh: Optional[Mesh] = None,
    solve_span: str = "bpmf.solve",
) -> SideState:
    """Dense-adjacency half-sweep (``bpmf_tpu.parallel.spmd.
    dense_half_sweep``): with a mesh, the all_gather of the frozen side;
    computeMuLambda as two matmuls, the Gram against the frozen side's
    row-wise outer products [N, K*K] and the rhs against the frozen side
    itself; then the combine, the batched solve of the configured solver,
    the stats.  Every item of the shard is recomputed in place.  bf16 blocks
    (bf16 matmul inputs) take the outer products of the float32 side and
    the side itself rounded to bf16 (``bpmf_tpu/parallel/spmd.py:349-356``)."""
    with span(solve_span):
        ablates = ablate.split(",")
        if mesh is not None:
            other_items = mesh.all_gather(other_items)
        dtype, md = other_items.dtype, a_ind.dtype
        k = other_items.shape[-1]
        n = other_items.shape[0]
        items = a_val.shape[0]
        if "nomatmul" in ablates:
            eye = torch.eye(k, dtype=other_items.dtype, device=other_items.device)
            gram = other_items.new_zeros((items, k, k)) \
                + eye * (1.0 + other_items[0, 0] * 1e-12)
            rhs = other_items.new_zeros((items, k)) + a_val[:, :1].to(dtype)
        else:
            p = (other_items[:, :, None] * other_items[:, None, :]).reshape(n, k * k)
            gram = matmul_acc(a_ind, p.to(md), dtype).reshape(-1, k, k)
            del p
            rhs = matmul_acc(a_val, other_items.to(md), dtype)
        precision, full_rhs = posterior_precision_rhs(
            gram, rhs, torch.arange(gram.shape[0], device=gram.device), hp, alpha,
            prop_mu=prop_mu, prop_lambda=prop_lambda,
            diagonal_only=diagonal_only, strict_reference=strict_reference)
        del gram
        if "nosolve" in ablates:
            u = full_rhs + noise + precision[:, 0, :]
        else:
            u = get_solver(solver)(precision, full_rhs, noise)
    return _finish(state, u, local_valid, hp, num, it, burnin, mesh)


@functools.cache
def _tight_pair_index(k: int, device: torch.device):
    ii, jj, _ = tri_tight_pairs(k)
    return (torch.as_tensor(ii, dtype=torch.long, device=device),
            torch.as_tensor(jj, dtype=torch.long, device=device))


def dense_half_sweep_fused(
    state: SideState,
    a_ind_t: torch.Tensor,      # [other_pad, local items] indicator, TRANSPOSED
    a_val: torch.Tensor,        # [local items, other_pad] centered values
    other_items: torch.Tensor,  # [other_pad, K] (this rank's shard with a mesh)
    hp: HyperParams,
    noise: torch.Tensor,        # [padded_num, K] N(0, I) by orig id
    it: int,
    *,
    num: int,
    local_valid: torch.Tensor,  # [padded_num]
    alpha: float,
    burnin: int,
    prior_tri_t: Optional[torch.Tensor] = None,  # [T, padded_num] per-item
                                                 # prior (pack_prior_tri)
    prior_rhs_t: Optional[torch.Tensor] = None,  # [K, padded_num] static rhs
    grouped: bool = False,      # the packed-triangle solve's layout pin
    ablate: str = "",           # perf-debug (Config.ablate)
    mesh: Optional[Mesh] = None,
    solve_span: str = "bpmf.solve",
) -> SideState:
    """Dense half-sweep with the packed-triangle solve (``bpmf_tpu.
    parallel.spmd.dense_half_sweep_fused``), after the all_gather of the
    frozen side when there is a mesh.  The Gram is one matmul of
    the frozen side's packed outer products [T_tight, N] with the
    transposed indicator, a plain large product the JAX package also
    leaves to XLA; it comes out in the tight layout that the combine-solve
    kernel (Queue 2 #5/#6) reads.  The JAX function's ``tri_expand_rows``
    and ``BPMF_TRI_ALIGNED_MM`` choose between the tight and the aligned
    layout for the TPU's sublanes; they change only layout and rounding,
    so, like ``BPMF_D8_FOLD``, they have no counterpart here.  bf16 blocks
    take the packed products of the float32 side and the side itself
    rounded to bf16 (``bpmf_tpu/parallel/spmd.py:527-536``)."""
    with span(solve_span):
        ablates = ablate.split(",")
        if mesh is not None:
            other_items = mesh.all_gather(other_items)
        dtype, md = other_items.dtype, a_ind_t.dtype
        v_t = other_items.t()
        k, items = v_t.shape[0], a_val.shape[0]
        if "nomatmul" in ablates:
            gram_t = v_t.new_zeros((tight_rows(k), items)) + v_t[0, 0] * 1e-12
            rhs = other_items.new_zeros((items, k)) + a_val[:, :1].to(dtype)
        else:
            ii, jj = _tight_pair_index(k, v_t.device)
            gram_t = matmul_acc((v_t[ii] * v_t[jj]).to(md), a_ind_t,
                                dtype)                           # [T_tight, I]
            rhs = matmul_acc(a_val, other_items.to(md), dtype)
        rhs_t = _combine_prior_rhs(rhs.t(), hp, prior_tri_t, prior_rhs_t, grouped)
        if "nosolve" in ablates:
            u = (rhs_t + noise.t() + _aligned_head(gram_t, k)).t()
        else:
            u = tri_combine_solve_sample(gram_t, hp.lambda_f, rhs_t, noise.t(),
                                         alpha, lam_tri_t=prior_tri_t,
                                         grouped=grouped).t()
    return _finish(state, u, local_valid, hp, num, it, burnin, mesh)


def predict_sharded(mesh: Mesh, ev: EvalData, est: EvalState,
                    user_items: torch.Tensor, movie_items: torch.Tensor,
                    it: int, *, mean_rating, burnin: int, nnz_true: int
                    ) -> tuple[EvalState, torch.Tensor, torch.Tensor]:
    """The entry-sharded evaluation (``bpmf_tpu.parallel.spmd.
    predict_sharded``): ``ev`` and ``est`` hold this rank's share of the
    test entries and their Welford state (padded to a multiple of the rank
    count, ``ev.valid`` hiding the padding); both factor tables are
    all-gathered from their shards, and one all_reduce makes the error sums
    global.  Each entry's Welford values are those of one device."""
    return predict(ev, est, mesh.all_gather(user_items),
                   mesh.all_gather(movie_items), it, mean_rating=mean_rating,
                   burnin=burnin, mesh=mesh, nnz_true=nnz_true)
