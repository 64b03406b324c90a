"""Host-side Gibbs sampling loop (port of ``bpmf_tpu/sampler.py``).

One device, or one rank of a multi-device run (``mesh``: one process per
rank over ``torch.distributed``, :mod:`bpmf_tpu_torch.parallel.mesh`), in
which each rank holds its shard of both sides' items, of the Gram layouts
and of the test entries.  Every iteration draws both hyperpriors, sweeps
the movies then the users, and evaluates on the test set.  Each side's
Gram route is decided once at setup, as the JAX package decides it on a
TPU (the card takes the TPU's part): the dense code stream ("dense8": int8
codes, int16 past 127 rating levels; with the megakernel
or the split pipeline, :func:`~bpmf_tpu_torch.ops.dense8.d8_route`) for
float32 ratings on an exact grid; else the dense adjacency while it fits
``dense_limit_bytes`` (fused with the packed-triangle solve where that is
eligible), and the degree buckets beyond.  Iterations run as a Python loop
with one host sync per chunk, each through :meth:`BPMF.iter_fn`, the
iteration as a function of explicit state (the JAX package's ``_iter``).
At D > 1 ranks a dense8 side takes the sharded sweep (the split pipeline,
in gather and in reduce mode), the dense routes run in gather mode, and
the buckets in gather mode (an all_gather of the frozen side, or the halo
ring) or in reduce mode (the partial statistics reduce-scattered onto
their owners, or all-reduced one destination at a time in the chunked
form); the evaluation is entry-sharded.

bf16 matmul inputs (``Config.matmul_dtype="bfloat16"``; ``auto`` stays
float32 here, as the JAX package resolves it off a TPU) run on every route
with the JAX package's rounding: the dense8 kernels' bf16 instances, the
dense blocks and the bucketed gathers in bf16 with float32 sums, and the
final all-items evaluation on bf16 tables (``bpmf_tpu/sampler.py:1204-
1210``); the routes are those of float32.

Beside the chain: the aggregated posterior and the six output files (``-o``)
with the per-iteration dumps (``-v``), checkpoints and resume
(:mod:`bpmf_tpu_torch.checkpoint`), and the perf-debug surfaces: the
ablations (``Config.ablate``), ``--profile`` (phase counters, then
:meth:`BPMF.profile_phases`) and the chunk-batched evaluation
(``defer_predict="on"``).
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import NamedTuple, Optional

import numpy as np
import scipy.sparse as sp
import torch

from bpmf_tpu_torch import checkpoint
from bpmf_tpu_torch.config import Config
from bpmf_tpu_torch.device import resolve_device
from bpmf_tpu_torch.io import native, read_matrix, write_matrix
from bpmf_tpu_torch.models.bpmf import (
    EvalData,
    EvalState,
    Metrics,
    SideState,
    aggr_prod_full,
    init_side_state,
    predict,
    predict_deferred,
)
from bpmf_tpu_torch.ops.dense8 import (
    BLOCK_MULTIPLE,
    build_code_array,
    d8_route,
    quantize_values,
    walk_work,
)
from bpmf_tpu_torch.ops.mvnormal import (
    HyperDraws,
    HyperParams,
    draw_hyper,
    sample_hyper_pair,
)
from bpmf_tpu_torch.ops.pallas_solve import pack_prior_tri, tri_fused_supported
from bpmf_tpu_torch.ops.update import BucketDev, item_noise
from bpmf_tpu_torch.parallel import partition as part
from bpmf_tpu_torch.parallel.mesh import Mesh, resolve_n_devices
from bpmf_tpu_torch.parallel.spmd import (
    dense8_half_sweep,
    dense8_half_sweep_sharded,
    dense_half_sweep,
    dense_half_sweep_fused,
    gather_half_sweep,
    predict_sharded,
    reduce_half_sweep,
    reduce_half_sweep_chunked,
)
from bpmf_tpu_torch.utils.counters import (
    Counters,
    count_sync,
    event_counts,
    setup_clock,
    span,
    tick,
)

__all__ = ["BPMF", "HostDraws", "Side", "TorchDraws", "rank_buckets",
           "unsupported"]

# the ablations that keep a side on its dense8 or fused dense route
# (bpmf_tpu/sampler.py:296-297, :486-487: Config.ablate as a whole string);
# any other value sends dense8 data to the dense or bucketed route
FAST_ROUTE_ABLATIONS = ("", "nopredict", "nomatmul", "nosolve", "nohyper",
                        "nonoise")
# those the sharded dense8 sweep takes at D > 1 (bpmf_tpu/sampler.py:296-300)
SHARDED_D8_ABLATIONS = ("", "nopredict", "nohyper", "nonoise")
PHASE_NAMES = {
    "nopredict": "predict/eval",
    "nosolve": "cholesky-solve-sample",
    "nomatmul": "gram matmul",
    "nogather": "neighbor gather",
    "nohyper": "hyperprior resample",
    "nonoise": "noise tables",
}
# each side's name in spans and set-up parts (utils.counters), and its
# spans: its half-sweep, its noise draw, and its solve, from the frozen
# side's operand to the drawn items
SIDE_LABELS = {"movs": "movies", "users": "users"}
SIDE_SPANS = {name: tuple(f"bpmf.{kind}.{label}"
                          for kind in ("sweep", "noise", "solve"))
              for name, label in SIDE_LABELS.items()}


def unsupported(cfg: Config) -> list[str]:
    """Why ``cfg`` asks for something outside the ported slices, one line
    per feature, each naming its ROADMAP.md entry: empty, since every
    Config of the JAX package is ported."""
    return []


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


class TorchDraws:
    """The chain's random numbers from ``torch.Generator``s: one stream per
    (seed, iteration, side, purpose), so no draw depends on the order in
    which they are taken or on the padded layout.  Side 0 is the movies,
    side 1 the users.  Tests swap in a provider that reproduces the JAX
    package's draws."""

    def __init__(self, seed: int, device: torch.device):
        self.seed = seed
        self.device = device

    def _generator(self, it: int, side: int, purpose: int) -> torch.Generator:
        h = self.seed
        for w in (it, side, purpose):
            h = _splitmix64(h ^ _splitmix64(w))
        return torch.Generator(device=self.device).manual_seed(h)

    def hyper(self, it: int, side: int, n: int, k: int, dtype) -> HyperDraws:
        """One side's Normal-Wishart draws, with df = K + n."""
        return draw_hyper(self._generator(it, side, 0), k + n, k, dtype,
                          self.device)

    def hyper_pair(self, it: int, ns: tuple[int, int], k: int, dtype) -> HyperDraws:
        """Both sides' :meth:`hyper` draws, stacked [2, ...]."""
        d = [self.hyper(it, s, ns[s], k, dtype) for s in (0, 1)]
        return HyperDraws(*(torch.stack(x) for x in zip(*d)))

    def noise(self, it: int, side: int, orig_ids: torch.Tensor, num: int,
              k: int, dtype) -> torch.Tensor:
        """N(0, I) rows for the slots whose original ids are ``orig_ids``."""
        return item_noise(self._generator(it, side, 1), orig_ids, num, k, dtype)


class HostDraws(TorchDraws):
    """The draws of ``TorchDraws(seed, "cpu")``, moved to ``device``: the
    same numbers whatever device the chain runs on, so that a chain on the
    card can be held to the same chain on the CPU."""

    def __init__(self, seed: int, device):
        super().__init__(seed, torch.device("cpu"))
        self.target = torch.device(device)

    def hyper(self, it, side, n, k, dtype) -> HyperDraws:
        d = super().hyper(it, side, n, k, dtype)
        return HyperDraws(*(x.to(self.target) for x in d))

    def noise(self, it, side, orig_ids, num, k, dtype) -> torch.Tensor:
        return super().noise(it, side, orig_ids.cpu(), num, k,
                             dtype).to(self.target)


class Side:
    """Host metadata for one side (movies = columns of the train matrix,
    users = rows; ``bpmf_tpu.sampler.Side``).  The padding is the JAX
    package's: to a multiple of 8, or of the dense8 block when some side
    takes dense8 (set by :meth:`BPMF.setup`)."""

    def __init__(self, name: str, m_csc: sp.csc_matrix, cfg: Config,
                 n_devices: int = 1):
        self.name = name
        self.m = m_csc  # [num_other, num]: items are columns
        self.num = m_csc.shape[1]
        self.degrees = np.diff(m_csc.indptr)
        self.max_degree = int(self.degrees.max(initial=0))
        ids = part.assign_items(self.degrees, n_devices, balance=cfg.permute)
        self.maps = part.make_maps(ids, self.num)
        # set by BPMF.setup: the Gram route (dense8 | dense | bucketed), and
        # the solve route of a dense8 side (ops.dense8.d8_route: fused |
        # fused_hoisted | fused_aligned | inkernel | hoisted) or of a dense
        # side (fused | plain)
        self.impl: Optional[str] = None
        self.route: Optional[str] = None
        self.prop_mu: Optional[np.ndarray] = None      # [num, K]
        self.prop_lambda: Optional[np.ndarray] = None  # [num, K, K]
        # set by BPMF.setup on a bucketed side: how its sweep meets the
        # other ranks (gather | halo | reduce | reduce_chunked), and the
        # halo layout it took
        self.exchange: Optional[str] = None
        self.halo: Optional[part.HaloLayout] = None

    def add_prop_posterior(self, fnames: str, num_latent: int) -> None:
        """Load the propagated posterior '-m/-l mu.ddm,Lambda.ddm'
        (Sys::add_prop_posterior, c++/sample.cpp:157-174; ``bpmf_tpu.
        sampler.Side.add_prop_posterior``): mu is K x num, Lambda is
        K^2 x num, column i reshaping to K x K column-major."""
        if not fnames:
            return
        if "," not in fnames:
            raise ValueError("propagated posterior needs two files "
                             f"'mu.ddm,Lambda.ddm', got {fnames!r}")
        mu_name, lambda_name = fnames.split(",", 1)
        mu = read_matrix(mu_name)
        lam = read_matrix(lambda_name)
        k = num_latent
        if mu.shape != (k, self.num) or lam.shape != (k * k, self.num):
            raise ValueError(
                f"propagated posterior for {self.name}: mu is {mu.shape} and "
                f"Lambda {lam.shape}, expected {(k, self.num)} and "
                f"{(k * k, self.num)}")
        self.prop_mu = np.ascontiguousarray(mu.T)
        self.prop_lambda = np.ascontiguousarray(
            lam.reshape((k, k, self.num), order="F").transpose(2, 0, 1))

    def prop_padded_np(self, num_latent: int):
        """The propagated posterior in padded order; padding slots get an
        identity precision and zero mean (``Side.prop_padded_np``)."""
        k, pn = num_latent, self.maps.padded_num
        pm = np.zeros((pn, k), self.prop_mu.dtype)
        pl = np.tile(np.eye(k), (pn, 1, 1))
        pm[self.maps.orig_to_padded] = self.prop_mu
        pl[self.maps.orig_to_padded] = self.prop_lambda
        return pm, pl


class _SideAux(NamedTuple):
    """A side's device data on this rank: every [local_pad, ...] array is
    the rank's rows of the padded layout (all of it on one device)."""

    local_orig: torch.Tensor   # [local_pad] original id, num for padding
    local_valid: torch.Tensor  # [local_pad] 1 / 0
    # the per-item prior packed (dense8 and fused dense sides) ...
    prior_tri_t: Optional[torch.Tensor] = None  # [T, local_pad]
    prior_rhs_t: Optional[torch.Tensor] = None  # [K, local_pad] static rhs
    # ... or whole (plain dense and bucketed sides)
    prop_mu: Optional[torch.Tensor] = None      # [local_pad, K]
    prop_lambda: Optional[torch.Tensor] = None  # [local_pad, K, K]
    # dense sides: (indicator, centered values) [local_pad, other_pad],
    # the indicator transposed on a fused side
    dense: Optional[tuple] = None
    # bucketed sides: the buckets, their split flags, their slots' ids
    # (gather mode: the noise is drawn per bucket slot); in reduce mode the
    # reduce layout's, and in its chunked form (buckets, splits) per
    # destination instead
    buckets: tuple = ()
    splits: tuple = ()
    bucket_orig: Optional[torch.Tensor] = None  # [sum of slots]
    per_dest: tuple = ()
    # the halo ring's (send_rows, recv_pos), this rank's row of each round
    halo: Optional[tuple] = None


def rank_buckets(buckets, rank: int, dtype, device) -> tuple:
    """Rank ``rank``'s row of stacked [D, ...] host buckets
    (``parallel.partition.stack_buckets``), on ``device``."""
    if not buckets:
        return ()
    arrays = [f.name for f in dataclasses.fields(buckets[0]) if f.name != "split"]
    return tuple(
        BucketDev.from_bucket(
            dataclasses.replace(b, **{n: getattr(b, n)[rank] for n in arrays}),
            dtype, device)
        for b in buckets)


class BPMF:
    """End-to-end sampler on one device (``cuda`` unless ``device`` says
    otherwise), or one rank of ``mesh.size`` ranks.

    ``mesh``: this rank's :class:`~bpmf_tpu_torch.parallel.mesh.Mesh`
    (``parallel.launch.run_ranks``, or the CLI's ``--devices N``); its
    device replaces ``device``.  Every rank builds the same maps and routes
    from the whole data and keeps only its shard; only rank 0 prints and
    writes files.  Without a mesh ``cfg.n_devices`` must resolve to one
    device: more ranks need their processes."""

    def __init__(
        self,
        cfg: Config,
        train: Optional[sp.spmatrix] = None,
        test: Optional[sp.spmatrix] = None,
        out=None,
        *,
        device="cuda",
        draws=None,
        mesh: Optional[Mesh] = None,
    ):
        # the set-up's parts in host seconds, here and in setup()
        # (utils.counters.event_counts reports the last sampler's)
        clock = self._setup_clock = setup_clock()
        self.setup_parts = clock.parts
        problems = unsupported(cfg)
        if problems:
            raise NotImplementedError("; ".join(problems))
        self.cfg = cfg
        self.counters = Counters(cfg.profile)
        if mesh is None:
            self.device = resolve_device(device)
            n = resolve_n_devices(cfg.n_devices, self.device)
            if n > 1:
                raise ValueError(
                    f"n_devices={n} needs one process per rank: start them "
                    f"with python -m bpmf_tpu_torch --devices {n}, torchrun, "
                    "or bpmf_tpu_torch.parallel.launch.run_ranks")
        else:
            if cfg.n_devices not in (0, mesh.size):
                raise ValueError(f"n_devices={cfg.n_devices} on a mesh of "
                                 f"{mesh.size} ranks")
            self.device = resolve_device(mesh.device)
        self._mesh_in = mesh
        # the sweeps' collectives: none on one device
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.n_devices = 1 if self.mesh is None else mesh.size
        self.rank = 0 if self.mesh is None else mesh.rank
        self.mode = "gather" if cfg.comm_mode == "auto" else cfg.comm_mode
        if self.rank != 0:
            out = open(os.devnull, "w")
        self.out = out if out is not None else sys.stdout

        with clock.part("inputs"):
            if train is None:
                train = read_matrix(cfg.train_file)
            if test is None:
                test = read_matrix(cfg.test_file)
            train = sp.csc_matrix(train)
            test = sp.csc_matrix(test)
            # conservativeResize to the common bounding shape
            # (c++/sample.cpp:119-122)
            rows = max(train.shape[0], test.shape[0])
            cols = max(train.shape[1], test.shape[1])
            train.resize((rows, cols))
            test.resize((rows, cols))
            self.train = train
            self.test = test
            self.mean_rating = train.sum() / train.nnz

        with clock.part("side_maps"):
            # movies: columns of R; users: rows of R (c++/bpmf.cpp:131-132)
            self.movies = Side("movs", train, cfg, self.n_devices)
            self.users = Side("users", sp.csc_matrix(train.T), cfg,
                              self.n_devices)
            self.movies.add_prop_posterior(cfg.prop_v, cfg.num_latent)
            self.users.add_prop_posterior(cfg.prop_u, cfg.num_latent)

        with clock.part("test_entries"):
            tcoo = test.tocoo()
            order = np.lexsort((tcoo.row, tcoo.col))  # column-major like Eigen
            self.t_user = tcoo.row[order].astype(np.int32)
            self.t_item = tcoo.col[order].astype(np.int32)
            self.t_val = tcoo.data[order]

        self.seed = cfg.seed
        self.draws = draws if draws is not None else TorchDraws(cfg.seed, self.device)
        self._ablates = cfg.ablate.split(",")
        self.iter = -1
        self.rmse = float("nan")
        self.rmse_avg = float("nan")
        self.average_items_sec = 0.0
        self.average_ratings_sec = 0.0
        self._setup_done = False

    # -- setup ------------------------------------------------------------

    def _route(self):
        """Each side's Gram route (``Side.impl``) and solve route
        (``Side.route``), as the JAX package decides them on a TPU
        (``bpmf_tpu/sampler.py:289-375``, ``:480-496``): dense8 where its
        gates pass and the solver is ``smart``/``pallas``; else dense while
        the side's [padded_num, other_pad] float32 block fits
        ``dense_limit_bytes``, bucketed beyond it or when asked; a dense
        side fuses its solve with the packed-triangle kernel where
        ``fuse_ok`` holds.  When some side is dense8, both sides are padded
        to the dense8 block.  Returns the dense8 code quantization, or None.
        The ablations decide routes too, as in the JAX package: dense8 and
        the fused dense route take only ``FAST_ROUTE_ABLATIONS``, and a
        dense8 side under ``nomatmul`` or ``nosolve`` takes the split
        pipeline.  ``BPMF_D8_SOLVE``, ``BPMF_D8_PT`` and ``BPMF_TRI_GROUPED``
        are read here, once, as the JAX package reads them (``ops/dense8.py:215,
        464``, ``ops/pallas_solve.py:198-220``, which pins the last at first
        consult): ``self.grouped`` then names the layout of every per-item
        prior packed at setup and every packed-triangle solve of the run,
        so the two never disagree.  Its ``BPMF_D8_FOLD`` changes only
        rounding and has no counterpart (``ops.dense8.dense8_gram_rhs_rows``).

        At D > 1 ranks (``bpmf_tpu/sampler.py:289-375``) the dense8 budget
        is per device and dense8 takes only ``SHARDED_D8_ABLATIONS``; a
        dense8 side runs the split pipeline (the sharded sweep), its route
        decided on the local shapes.  ``--mode reduce`` rides the dense8
        program on dense8 sides and sends the others to the buckets, at
        any rank count, D = 1 included (``bpmf_tpu/sampler.py:362-368``)."""
        cfg = self.cfg
        k = cfg.num_latent
        d = self.n_devices
        sides = (self.movies, self.users)
        q = None
        fast_ablation = cfg.ablate in FAST_ROUTE_ABLATIONS
        d8_ok = (cfg.gram_impl in ("auto", "dense8")
                 and cfg.dtype == "float32" and not cfg.diagonal_only
                 and cfg.ablate in (FAST_ROUTE_ABLATIONS if d == 1
                                    else SHARDED_D8_ABLATIONS)
                 and tri_fused_supported(k))
        if d8_ok:
            q = quantize_values(self.train.data)
            rp, cp = (-(-s.maps.padded_num // BLOCK_MULTIPLE) * BLOCK_MULTIPLE
                      for s in (self.users, self.movies))
            # the budget is per device: the user rows shard over the ranks
            d8_ok = q is not None and rp * cp // d <= cfg.dense8_limit_bytes
        if cfg.gram_impl == "dense8" and not d8_ok:
            raise ValueError(
                "gram_impl='dense8' needs float32, grid-quantizable ratings, "
                "and K within the fused tri kernel's gate (K <= 79)")

        def impl(side, other) -> str:
            if d8_ok and (side.prop_mu is None or tri_fused_supported(k, True)) \
                    and (cfg.gram_impl == "dense8"
                         or self.solver in ("smart", "pallas")):
                return "dense8"
            if cfg.gram_impl == "dense8":  # side excluded (prop posterior)
                return "dense" if self.mode == "gather" else "bucketed"
            if cfg.gram_impl != "auto":
                return cfg.gram_impl
            if self.mode != "gather":
                return "bucketed"
            a_bytes = side.maps.padded_num * other.maps.padded_num * 4
            return "bucketed" if a_bytes > cfg.dense_limit_bytes else "dense"

        self.movies.impl = impl(self.movies, self.users)
        self.users.impl = impl(self.users, self.movies)
        if any(s.impl == "dense8" for s in sides):
            for side in sides:
                side.maps = part.make_maps(side.maps.ids_per_dev, side.num,
                                           multiple=BLOCK_MULTIPLE)
            env = os.environ
            solve = env.get("BPMF_D8_SOLVE", "fused")
            if cfg.ablate in ("nomatmul", "nosolve") or d > 1:
                # spmd.py:846-853: these keep the split pipeline; the sharded
                # sweep runs only the split pipeline (spmd.py:998-1103)
                solve = "split"
            pt = env.get("BPMF_D8_PT", "auto")
            # the shapes each rank's kernels see: (R/D, C) on the users'
            # sweep, (C, R/D) on the movies' (spmd.py:1036-1037, :1056-1057)
            lp_u, cp = self.users.maps.local_pad, self.movies.maps.padded_num
            for side, orientation, items, frozen in (
                    (self.movies, "cols", cp, lp_u),
                    (self.users, "rows", lp_u, cp)):
                if side.impl == "dense8":
                    side.route = d8_route(k, items, frozen, orientation,
                                          peritem=side.prop_mu is not None,
                                          solve=solve, pt=pt)
        for side in sides:
            if side.impl == "dense":
                fuse = (cfg.fuse_dense != "off" and tri_fused_supported(k)
                        and not cfg.diagonal_only and fast_ablation
                        and (side.prop_mu is None
                             or tri_fused_supported(k, True))
                        and self.solver in ("smart", "pallas"))
                side.route = "fused" if fuse else "plain"
        # the JAX package's layout pin (pallas_solve.tri_grouped): every
        # packed-triangle solve (a split dense8 side, a fused dense side)
        # takes the grouped kernel (#7) and every per-item prior is packed
        # top-aligned; the megakernel routes do not consult it
        self.grouped = (os.environ.get("BPMF_TRI_GROUPED", "0") == "1"
                        and k % 8 == 0)
        return q

    def setup(self) -> None:
        """The routes, the device data and the initial state, once; each
        part clocked in ``setup_parts`` (host seconds; device work a part
        enqueues without waiting is clocked where the host next waits)."""
        if self._setup_done:
            return
        clock = self._setup_clock
        with clock.part("route"):
            cfg = self.cfg
            min_side = min(self.train.shape)
            # float64 when the smaller side has fewer than 2K items
            self.dtype = getattr(torch, cfg.resolve_dtype(min_side))
            if cfg.dtype == "auto" and self.dtype == torch.float64:
                self._log(
                    f"dtype auto -> float64: min side {min_side} < "
                    f"2*K={2 * cfg.num_latent} (f32's Cholesky headroom is not "
                    "enough when the Normal-Wishart df barely exceeds K; the "
                    "all-double reference never faces this)")
            cfg.dtype = "float64" if self.dtype == torch.float64 else "float32"
            # the TPU's solver policy: auto -> smart, float64 -> xla
            self.solver = cfg.resolve_solver("tpu")
            # the Gram matmuls' input dtype (bpmf_tpu/sampler.py:471-473): auto
            # resolves off a TPU, to float32; sums stay in the compute dtype
            self.matmul_dtype = cfg.resolve_matmul_dtype("cuda")
            self._md = (torch.bfloat16 if self.matmul_dtype == "bfloat16"
                        else self.dtype)
            q = self._route()
        dev, dtype = self.device, self.dtype

        self._codes = None
        if "dense8" in (self.movies.impl, self.users.impl):
            with clock.part("codes_host"):
                # this rank's user rows of the code array, [R/D, C] (all of
                # it on one device): the COO is filtered by row range
                # first, so no rank holds the whole array
                coo = self.train.tocoo()
                rows = self.users.maps.orig_to_padded[coo.row]
                lp = self.users.maps.local_pad
                keep = (rows >= self.rank * lp) & (rows < (self.rank + 1) * lp)
                codes_np = build_code_array(
                    rows[keep] - self.rank * lp,
                    self.movies.maps.orig_to_padded[coo.col[keep]],
                    coo.data[keep], q, lp, self.movies.maps.padded_num,
                )
            with clock.part("codes_copy"):
                self._codes = torch.from_numpy(codes_np).to(dev)
                del codes_np
            with clock.part("codes_degrees"):
                self._d8_cs = float(q.scale * cfg.alpha)
                self._d8_cb = float((q.offset - self.mean_rating) * cfg.alpha)
                # the most ratings an item has within this rank's codes: it
                # bounds the frozen axis's segments (ops.dense8.sweep_plan)
                self._d8_max_degree = {
                    "users": int(self.users.degrees[
                        self.users.maps.ids_per_dev[self.rank]].max(initial=0)),
                    "movs": int(np.bincount(coo.col[keep], minlength=1).max()),
                }
                # on bf16 operands, each side's walk work
                # (ops.dense8.walk_work): sweep_bf16_kernel picks the tensor
                # cores or the walk by it
                self._d8_walk = dict.fromkeys(self._d8_max_degree)
                if self._md == torch.bfloat16:
                    sms = (torch.cuda.get_device_properties(dev)
                           .multi_processor_count if dev.type == "cuda" else 132)
                    for name, orientation in (("users", "rows"),
                                              ("movs", "cols")):
                        self._d8_walk[name] = walk_work(
                            self._codes, orientation, cfg.num_latent,
                            self._d8_max_degree[name], sms)

        self._aux = {}
        for side, other in ((self.movies, self.users),
                            (self.users, self.movies)):
            with clock.part(f"aux.{SIDE_LABELS[side.name]}"):
                self._aux[side.name] = self._side_aux(side, other)
        with clock.part("eval_data"):
            self.ev = self._eval_data()
            self._mean_rating = torch.as_tensor(self.mean_rating, dtype=dtype,
                                                device=dev)
            # item counts on the device: a per-iteration host-to-device copy
            # would sync the host with the card every iteration
            self._ns = torch.tensor([self.movies.num, self.users.num],
                                    dtype=dtype, device=dev)

        with clock.part("state"):
            # the posterior aggregates only when they are written out (-o),
            # as in the JAX package
            aggregate = bool(cfg.output_dir)
            self.state_m, self.state_u = (
                init_side_state(side.maps.local_pad, cfg.num_latent, dtype,
                                aggregate, dev)
                for side in (self.movies, self.users))
            nnz_t = self.ev.t_val.shape[0]
            self.est = EvalState(
                pavg=torch.zeros(nnz_t, dtype=dtype, device=dev),
                pm2=torch.zeros(nnz_t, dtype=dtype, device=dev),
            )
            self._setup_done = True
        with clock.part("banner"):
            self._log_banner()

    def _eval_data(self) -> EvalData:
        """The test entries in padded index order on the device.  At D > 1
        ranks they are padded to a multiple of D, ``valid`` hiding the
        padding, and each rank keeps its 1/D of them by position
        (``bpmf_tpu/sampler.py:600-618``)."""
        dev, d = self.device, self.n_devices
        arrays = [self.users.maps.orig_to_padded[self.t_user],
                  self.movies.maps.orig_to_padded[self.t_item],
                  np.asarray(self.t_val, np.float64)]
        valid = None
        if d > 1:
            nnz = len(self.t_val)
            per = -(-nnz // d)
            mine = slice(self.rank * per, (self.rank + 1) * per)
            arrays = [np.pad(a, (0, per * d - nnz))[mine] for a in arrays]
            valid = torch.as_tensor((np.arange(per * d) < nnz)[mine],
                                    dtype=self.dtype, device=dev)
        tu, ti, tv = arrays
        return EvalData(
            t_user=torch.as_tensor(tu, dtype=torch.long, device=dev),
            t_item=torch.as_tensor(ti, dtype=torch.long, device=dev),
            t_val=torch.as_tensor(tv, dtype=self.dtype, device=dev),
            valid=valid)

    def _mine(self, side: Side) -> slice:
        """This rank's rows of a side's padded layout."""
        lp = side.maps.local_pad
        return slice(self.rank * lp, (self.rank + 1) * lp)

    def _side_aux(self, side: Side, other: Side) -> _SideAux:
        """A side's device data (``bpmf_tpu/sampler.py:510-599``), this
        rank's rows of each: its maps, its propagated posterior (packed on
        dense8 and fused sides, whole elsewhere), and its Gram layout: the
        dense block, precomputed once in the matmul dtype from float32
        values as the JAX package does (the indicator transposed on a fused
        side), or the degree buckets (``Side._buckets_dev``)."""
        cfg, dev, dtype = self.cfg, self.device, self.dtype
        aux = dict(
            local_orig=torch.as_tensor(side.maps.local_orig[self.rank],
                                       dtype=torch.long, device=dev),
            local_valid=torch.as_tensor(side.maps.local_valid[self.rank],
                                        dtype=dtype, device=dev))
        if side.prop_mu is not None:
            if side.impl == "dense8" or side.route == "fused":
                aux.update(self._prior(side))
            else:
                pm, pl = (a[self._mine(side)]
                          for a in side.prop_padded_np(cfg.num_latent))
                aux.update(prop_mu=torch.as_tensor(pm, dtype=dtype, device=dev),
                           prop_lambda=torch.as_tensor(pl, dtype=dtype, device=dev))
        if side.impl == "dense":
            block = part.build_dense_block(side.m, side.maps,
                                           other.maps.orig_to_padded,
                                           other.maps.padded_num, self.rank)
            ind = block != 0
            val = ((block - np.float32(self.mean_rating)) * ind
                   * np.float32(cfg.alpha)).astype(np.float32)
            del block
            md = self._md
            a_ind = torch.as_tensor(ind, dtype=md, device=dev)
            if side.route == "fused":
                a_ind = a_ind.t().contiguous()
            aux["dense"] = (a_ind, torch.as_tensor(val, device=dev).to(md))
        elif side.impl == "bucketed":
            aux.update(self._bucket_aux(side, other))
        return _SideAux(**aux)

    def _bucket_aux(self, side: Side, other: Side) -> dict:
        """A bucketed side's layout, this rank's row of it
        (``bpmf_tpu/sampler.py:398-438``): in reduce mode the reduce
        layout, chunked by destination under ``--reduce-chunked on`` or,
        at D > 1 under ``auto``, when the [padded_num, K, K] stat buffer
        would pass ``reduce_chunk_limit_bytes``; in gather mode the gather
        layout, with the halo ring under ``--halo on`` or, at D > 1 under
        ``auto``, when it at most halves the all_gather's volume."""
        cfg, d = self.cfg, self.n_devices

        def row(buckets) -> tuple:
            return rank_buckets(buckets, self.rank, self.dtype, self.device)

        if self.mode == "reduce":
            full_buf = (side.maps.padded_num * cfg.num_latent ** 2
                        * torch.finfo(self.dtype).bits // 8)
            if cfg.reduce_chunked == "on" or (
                    cfg.reduce_chunked == "auto" and d > 1
                    and full_buf > cfg.reduce_chunk_limit_bytes):
                layout = part.build_reduce_layout_chunked(
                    side.m, side.maps, other.maps.ids_per_dev,
                    cfg.max_bucket_width, cfg.bucket_growth)
                side.exchange = "reduce_chunked"
                return dict(per_dest=tuple((row(b), s)
                                           for b, s in layout.per_dest))
            layout = part.build_reduce_layout(
                side.m, side.maps.orig_to_padded, side.maps.padded_num,
                other.maps.ids_per_dev, cfg.max_bucket_width,
                cfg.bucket_growth)
            side.exchange = "reduce"
            return dict(buckets=row(layout.buckets), splits=layout.splits)
        layout = part.build_gather_layout(
            side.m, side.maps, other.maps.orig_to_padded,
            cfg.max_bucket_width, cfg.bucket_growth)
        buckets = row(layout.buckets)
        out = dict(buckets=buckets, splits=layout.splits,
                   bucket_orig=torch.cat([b.orig_ids for b in buckets]))
        side.exchange = "gather"
        if d > 1 and cfg.halo != "off":
            hl = part.build_halo_layout(side.m, side.maps, other.maps)
            if cfg.halo == "on" or hl.volume_ratio <= 0.5:
                side.exchange, side.halo = "halo", hl

                def rows(tables):
                    return tuple(torch.as_tensor(t[self.rank], dtype=torch.long,
                                                 device=self.device)
                                 for t in tables)
                out["halo"] = (rows(hl.send_rows), rows(hl.recv_pos))
        return out

    def _prior(self, side: Side) -> dict:
        """The per-item prior of a dense8 or fused dense side, packed once
        (``bpmf_tpu/sampler.py:538-563``): the aligned packed precision
        [T, padded_num] and, when strict_reference is off, the static rhs
        Lambda_i @ propMu_i [K, padded_num].  Under strict_reference the rhs
        uses the sampled hyper-mean and is formed in every sweep.  Both are
        transposed views of item-major tensors, the layout the solve kernel
        reads."""
        k = self.cfg.num_latent
        pm, pl = (a[self._mine(side)] for a in side.prop_padded_np(k))

        def dev(batch_last):
            return torch.as_tensor(np.ascontiguousarray(batch_last.T),
                                   dtype=self.dtype, device=self.device).t()

        rhs = None
        if not self.cfg.strict_reference:
            rhs = dev(np.einsum("skl,sl->sk", pl, pm).T)
        return dict(prior_tri_t=dev(pack_prior_tri(pl, k, self.grouped)),
                    prior_rhs_t=rhs)

    def _log(self, msg: str) -> None:
        print(msg, file=self.out, flush=True)

    def _log_banner(self) -> None:
        cfg = self.cfg
        # dataset statistics banner (Sys::init, c++/sample.cpp:203-219)
        bp1, bp2 = 24, 10500  # breakpoint1/2 (c++/bpmf.h:255-256)
        self._log(f"mean rating: {self.mean_rating:.6g}")
        self._log(f"total number of ratings in train: {self.train.nnz}")
        self._log(f"total number of ratings in test: {self.test.nnz}")
        for side in (self.movies, self.users):
            degs = side.degrees
            self._log(f"{side.name}: average ratings per row: {degs.mean():.6g}")
            self._log(f"{side.name}: rows > break_point1: "
                      f"{100.0 * (degs > bp1).mean():.6g}")
            self._log(f"{side.name}: rows > break_point2: "
                      f"{100.0 * (degs > bp2).mean():.6g}")
        self._log(f"num movs: {self.movies.num}")
        self._log(f"num users: {self.users.num}")
        self._log(f"num_latent: {cfg.num_latent}")
        d = self.n_devices
        self._log(f"ndevices: {d} (mode: {self.mode})")
        if self._mesh_in is not None and self._mesh_in.group is not None:
            self._log(f"process group: {self._mesh_in.backend}, "
                      f"{self._mesh_in.size} rank(s)")
        self._log(f"nsims: {cfg.nsims}")
        self._log(f"burnin: {cfg.burnin}")
        self._log(f"alpha: {cfg.alpha}")
        self._log(f"update_freq: {cfg.update_freq}")
        name = (torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else "cpu")
        md = str(self._md).removeprefix("torch.")
        self._log(f"device: {self.device} ({name}), dtype {cfg.dtype}"
                  + (f", matmul inputs {md}" if self._md != self.dtype else ""))
        self._log(f"solver: {self.solver}")
        self._log(f"matrix I/O: {native.status()}")
        if d > 1:
            # assignment unbalance (Sys::assign prints the same idea,
            # c++/assign.cpp:140-173)
            for side in (self.movies, self.users):
                work = np.array([(10 + side.degrees[ids]).sum()
                                 for ids in side.maps.ids_per_dev])
                self._log(f"assign {side.name}: work/device min {work.min()} "
                          f"max {work.max()} unbalance "
                          f"{work.max() / max(work.mean(), 1):.3f}")
        for side in (self.movies, self.users):
            aux = self._aux[side.name]
            prior = ", per-item prior" if side.prop_mu is not None else ""
            packed_solve = (side.route in ("inkernel", "hoisted")
                            or (side.impl, side.route) == ("dense", "fused"))
            if self.grouped and packed_solve:
                prior += ", grouped layout"
            if side.impl == "dense8":
                r, c = self._codes.shape
                nbytes = d * r * c * self._codes.element_size()
                code = str(self._codes.dtype).removeprefix("torch.")
                shard = f", {r}x{c} a rank (user rows)" if d > 1 else ""
                self._log(f"gram layout {side.name}: {code} dense-stream "
                          f"{d * r}x{c} shared code array ({nbytes / 1e6:.0f} MB"
                          f"{shard}), route {side.route}{prior}")
                if self.mode == "reduce":
                    # spmd.py:1041-1077: the users' stats exchange on the
                    # movies' sweep is the reduce-scatter already
                    self._log(f"gram layout {side.name}: reduce mode via "
                              "dense-stream hybrid (stat exchange on the "
                              "sharded sweep, small-side value exchange)")
            elif side.impl == "dense":
                lp, opn = aux.dense[1].shape
                nbytes = aux.dense[1].element_size()
                self._log(f"gram layout {side.name}: dense adjacency "
                          f"{d}x{lp}x{opn} x2 blocks "
                          f"({2 * d * lp * opn * nbytes / 1e6:.0f} MB {md}), "
                          f"route {side.route}{prior}")
            elif side.exchange == "reduce_chunked":
                n_b = sum(len(s) for _, s in aux.per_dest)
                self._log(f"gram layout {side.name}: reduce-chunked, "
                          f"{len(aux.per_dest)} destination shards, "
                          f"{n_b} buckets (peak stat buffer "
                          f"{side.maps.local_pad}x{cfg.num_latent}^2 per "
                          f"device){prior}")
            else:
                self._log(f"gram layout {side.name}: buckets "
                          + ", ".join(f"{d}x{b.nbr.shape[0]}x{b.nbr.shape[1]}"
                                      for b in aux.buckets)
                          + f"  (devices x rows x width){prior}")
                if side.halo is not None:
                    hl = side.halo
                    self._log(f"halo {side.name}: <= {hl.halo_rows} rows/pair "
                              f"(per-round widths; volume "
                              f"{hl.volume_ratio:.2f}x of all_gather)")
                    # per-pair message-count matrix (assign.cpp:238-250 analog)
                    self._log(f"halo {side.name} rows from -> to:")
                    for row in hl.pair_counts:
                        self._log("  " + " ".join(f"{int(c):7d}" for c in row))

    # -- Gibbs loop --------------------------------------------------------

    def set_seed(self, seed: int) -> None:
        """Key the chain's draws by ``seed`` from here on (a resumed
        checkpoint's); a draw provider passed in by the caller is kept."""
        self.seed = seed
        if type(self.draws) is TorchDraws:
            self.draws = TorchDraws(seed, self.device)

    def _sweep(self, side: Side, state: SideState, other_items, hp, draws, it):
        """One half-sweep on the side's route (over the ranks of the mesh at
        D > 1: the sharded dense8 sweep, gather mode, or reduce mode on the
        buckets).  Noise rows come from ``draws``, keyed by original id: the
        rank's padded slots of a dense8 or dense side and of a bucketed side
        in reduce mode, its concatenated bucket slots of a bucketed side in
        gather mode (``bpmf_tpu/parallel/spmd.py:712``, ``:1180``); zeros
        under ``ablate="nonoise"``.  Spans: ``bpmf.sweep.<side>``, and in
        it ``bpmf.noise.<side>``, then the route's ``bpmf.solve.<side>``
        and ``bpmf.stats``."""
        cfg = self.cfg
        sweep_span, noise_span, solve_span = SIDE_SPANS[side.name]
        with span(sweep_span):
            aux = self._aux[side.name]
            bucketed = side.exchange in ("gather", "halo")
            ids = aux.bucket_orig if bucketed else aux.local_orig
            with span(noise_span):
                if "nonoise" in self._ablates:
                    noise = torch.zeros((ids.shape[0], cfg.num_latent),
                                        dtype=self.dtype, device=self.device)
                else:
                    noise = draws.noise(it, 0 if side is self.movies else 1,
                                        ids, side.num, cfg.num_latent,
                                        self.dtype)
            return self._sweep_route(side, state, other_items, hp, noise, it,
                                     solve_span)

    def _sweep_route(self, side: Side, state: SideState, other_items, hp,
                     noise, it, solve_span: str):
        """The half-sweep of :meth:`_sweep` on the side's route, once its
        noise is drawn."""
        cfg = self.cfg
        aux = self._aux[side.name]
        md = self._md
        if side.impl == "bucketed":
            common = dict(
                num=side.num, mean_rating=self._mean_rating, alpha=cfg.alpha,
                burnin=cfg.burnin, diagonal_only=cfg.diagonal_only,
                strict_reference=cfg.strict_reference, solver=self.solver,
                prop_mu=aux.prop_mu, prop_lambda=aux.prop_lambda,
                ablate=cfg.ablate, mesh=self.mesh, solve_span=solve_span)
            # bf16 matmul inputs: the frozen table rounded once, before
            # any exchange or gather (bpmf_tpu/ops/update.py:78-82)
            other_items = other_items.to(md)
            if side.exchange == "reduce_chunked":
                return reduce_half_sweep_chunked(
                    state, aux.per_dest, other_items, hp, noise, it,
                    local_valid=aux.local_valid, **common)
            if side.exchange == "reduce":
                return reduce_half_sweep(
                    state, aux.buckets, other_items, hp, noise, it,
                    padded_num=side.maps.padded_num,
                    local_valid=aux.local_valid, splits=aux.splits, **common)
            return gather_half_sweep(
                state, aux.buckets, other_items, hp, noise, it,
                splits=aux.splits, halo=aux.halo, **common)
        orientation = "rows" if side is self.users else "cols"
        if side.impl == "dense8" and self.mesh is not None:
            return dense8_half_sweep_sharded(
                self.mesh, state, self._codes, other_items, hp, noise, it,
                num=side.num, local_valid=aux.local_valid, alpha=cfg.alpha,
                burnin=cfg.burnin, cs=self._d8_cs, cb=self._d8_cb,
                orientation=orientation, route=side.route,
                prior_tri_t=aux.prior_tri_t, prior_rhs_t=aux.prior_rhs_t,
                grouped=self.grouped, max_degree=self._d8_max_degree[side.name],
                matmul_dtype=md, solve_span=solve_span)
        common = dict(num=side.num, local_valid=aux.local_valid,
                      alpha=cfg.alpha, burnin=cfg.burnin, ablate=cfg.ablate,
                      solve_span=solve_span)
        if side.impl == "dense8":
            return dense8_half_sweep(
                state, self._codes, other_items, hp, noise, it,
                cs=self._d8_cs, cb=self._d8_cb,
                orientation=orientation, route=side.route,
                prior_tri_t=aux.prior_tri_t, prior_rhs_t=aux.prior_rhs_t,
                grouped=self.grouped, max_degree=self._d8_max_degree[side.name],
                walk_work=self._d8_walk[side.name], matmul_dtype=md, **common)
        if side.route == "fused":
            return dense_half_sweep_fused(
                state, *aux.dense, other_items, hp, noise, it,
                prior_tri_t=aux.prior_tri_t, prior_rhs_t=aux.prior_rhs_t,
                grouped=self.grouped, mesh=self.mesh, **common)
        return dense_half_sweep(
            state, *aux.dense, other_items, hp, noise, it,
            diagonal_only=cfg.diagonal_only,
            strict_reference=cfg.strict_reference, solver=self.solver,
            prop_mu=aux.prop_mu, prop_lambda=aux.prop_lambda, mesh=self.mesh,
            **common)

    def _predict(self, est: EvalState, users: torch.Tensor,
                 movies: torch.Tensor, it: int, dtype=None):
        """The evaluation of iteration ``it`` on the factor tables ``users``
        and ``movies`` from the Welford state ``est``, the tables taken in
        ``dtype`` (the final pass: the matmul dtype): entry-sharded at D > 1
        (``bpmf_tpu/sampler.py:762-778``).  Returns (est, rmse, rmse_avg)."""
        kw = dict(mean_rating=self._mean_rating, burnin=self.cfg.burnin)
        with span("bpmf.predict"):
            users = users.to(dtype or self.dtype)
            movies = movies.to(dtype or self.dtype)
            if self.mesh is not None:
                return predict_sharded(self.mesh, self.ev, est, users, movies,
                                       it, nnz_true=len(self.t_val), **kw)
            return predict(self.ev, est, users, movies, it, **kw)

    def iter_fn(self, state_m: SideState, state_u: SideState, est: EvalState,
                draws, it: int, skip_predict: bool = False
                ) -> tuple[SideState, SideState, EvalState, Metrics]:
        """One full Gibbs iteration as a function of explicit state, the JAX
        package's ``_iter`` (``bpmf_tpu/sampler.py:783-832``; c++/bpmf.cpp:
        184-196): both hyperprior draws first (each conditions on its side's
        previous stats), then movies given users, users given movies, then
        evaluation.  ``draws`` (a draw provider: :class:`TorchDraws`,
        :class:`HostDraws`) takes the place of the JAX key.  Under
        ``ablate="nohyper"`` both sides take ``HyperParams.init`` (mu = 0,
        Lambda = I) and no pair is drawn; under ``nopredict`` (or with
        ``skip_predict``, the deferred evaluation) ``est`` is returned as it
        came and both RMSE read 0.

        Bound only to what :meth:`setup` fixed (routes, device data, codes,
        maps, priors, halo layouts, the test entries, the mesh): it reads
        and writes none of ``state_m``/``state_u``/``est``/``iter`` of the
        sampler, and reads no result back (no ``.item()``, no ``.cpu()``),
        so the caller decides when to sync (the host syncs it makes are
        counted by ``chip_smoke.py`` phase 28).  It consumes none of its
        inputs: every state
        it returns is new tensors and none of its arguments is written (the
        JAX package donates them; here nothing is copied to spare them).
        Returns (state_m, state_u, est, metrics), the metrics 0-d tensors
        on the device.  Spans: ``bpmf.iter`` around it all, and in it
        ``bpmf.hyper.draws``, ``bpmf.hyper.sample``, each side's
        :meth:`_sweep` and ``bpmf.predict``."""
        cfg = self.cfg
        with span("bpmf.iter"):
            if "nohyper" in self._ablates:
                hp_m = hp_u = HyperParams.init(cfg.num_latent, self.dtype,
                                               self.device)
            else:
                with span("bpmf.hyper.draws"):
                    d = draws.hyper_pair(it, (self.movies.num, self.users.num),
                                         cfg.num_latent, self.dtype)
                with span("bpmf.hyper.sample"):
                    hp_m, hp_u = sample_hyper_pair(
                        d, self._ns, torch.stack([state_m.sum, state_u.sum]),
                        torch.stack([state_m.cov, state_u.cov]))
            state_m = self._sweep(self.movies, state_m, state_u.items, hp_m,
                                  draws, it)
            state_u = self._sweep(self.users, state_u, state_m.items, hp_u,
                                  draws, it)
            if skip_predict or "nopredict" in self._ablates:
                rmse = rmse_avg = torch.zeros((), dtype=self.dtype,
                                              device=self.device)
            else:
                est, rmse, rmse_avg = self._predict(est, state_u.items,
                                                    state_m.items, it)
            return state_m, state_u, est, Metrics(
                rmse=rmse, rmse_avg=rmse_avg,
                norm_users=torch.sqrt(state_u.norm),
                norm_movies=torch.sqrt(state_m.norm))

    def defer_group(self, n: int) -> int:
        """Iterations per deferred evaluation in a chunk of ``n``
        (``bpmf_tpu/sampler.py:861-882``): 1 (no deferral) unless
        ``defer_predict="on"`` and predict runs; else as many as the
        per-group footprint (2 gathers of nnz_t rows and both tables per
        iteration) lets ``defer_predict_limit_bytes`` hold, at most 32.
        ``auto`` stays off, as in the JAX package, and so does every run of
        more than one device (``bpmf_tpu/sampler.py:879``)."""
        cfg = self.cfg
        if (cfg.defer_predict != "on" or "nopredict" in self._ablates
                or self.n_devices > 1):
            return 1
        per_iter_bytes = 4 * cfg.num_latent * (
            2 * len(self.t_val) + self.users.maps.padded_num
            + self.movies.maps.padded_num)
        return min(n, max(1, cfg.defer_predict_limit_bytes // per_iter_bytes),
                   32)

    def run_chunk(self, n: int) -> Metrics:
        """Advance the chain n iterations; one host sync at the end (span
        ``bpmf.sync``, counted as ``host_sync`` site ``run_chunk``).
        Returns per-iteration Metrics as numpy arrays of length n.  With a
        deferral group g > 1 each group of g iterations keeps copies of its
        factor tables and evaluates them at once (:func:`~bpmf_tpu_torch.
        models.bpmf.predict_deferred`): the same metrics and Welford state
        as evaluating each iteration."""
        self.setup()
        g = self.defer_group(n)
        mets = []
        done = 0
        while done < n:
            m = min(g, n - done)
            it0 = self.iter + 1
            tables, group = [], []
            for _ in range(m):
                self.iter += 1
                self.state_m, self.state_u, self.est, met = self.iter_fn(
                    self.state_m, self.state_u, self.est, self.draws, self.iter,
                    skip_predict=g > 1)
                group.append(met)
                if g > 1:
                    tables.append((self.state_u.items, self.state_m.items))
            if g > 1:
                with span("bpmf.predict"):
                    self.est, rmse, rmse_avg = predict_deferred(
                        self.ev, self.est, torch.stack([t[0] for t in tables]),
                        torch.stack([t[1] for t in tables]), it0,
                        mean_rating=self._mean_rating, burnin=self.cfg.burnin)
                group = [met._replace(rmse=rmse[j], rmse_avg=rmse_avg[j])
                         for j, met in enumerate(group)]
            mets.extend(torch.stack(met) for met in group)
            done += m
        stacked = torch.stack(mets)
        with span("bpmf.sync"):
            count_sync("run_chunk")
            host = stacked.cpu().numpy()  # [n, 4]
        return Metrics(*(host[:, j] for j in range(4)))

    def step(self) -> Metrics:
        """One full Gibbs iteration; returns its metrics as numpy scalars."""
        return Metrics(*(x[0] for x in self.run_chunk(1)))

    def gathered(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of a row-sharded tensor, in padded order (the
        JAX package's ``to_host`` gather; collective at D > 1: every rank
        calls it); ``x`` itself on one device."""
        return x if self.mesh is None else self.mesh.all_gather(x)

    def items_host(self, side: Side, state: SideState) -> np.ndarray:
        """Items in original order, [num, K] float64 (collective at D > 1;
        a host sync, site ``items_host``)."""
        count_sync("items_host")
        arr = self.gathered(state.items).detach().to("cpu", torch.float64).numpy()
        return arr[side.maps.orig_to_padded]

    def state_host(self) -> tuple[SideState, SideState, EvalState]:
        """(movies, users, eval) state with every rank's rows, in padded
        order, the eval state cut to the real test entries (collective at
        D > 1).  The tensors stay on the device: where they come to the
        host (:meth:`write_output`, ``checkpoint.save``) the host sync is
        counted."""
        def side(state: SideState) -> SideState:
            return state._replace(
                items=self.gathered(state.items),
                aggr_mu=None if state.aggr_mu is None else self.gathered(state.aggr_mu),
                aggr_prod=(None if state.aggr_prod is None
                           else self.gathered(state.aggr_prod)))
        nnz = len(self.t_val)
        est = EvalState(*(self.gathered(x)[:nnz] for x in self.est))
        return side(self.state_m), side(self.state_u), est

    def _sync(self) -> None:
        if self.device.type == "cuda":
            count_sync("run")
            torch.cuda.synchronize(self.device)

    def run(self) -> float:
        """Full run with the reference's per-iteration log line
        (c++/bpmf.cpp:180-210, format c++/sample.cpp:101-107), resuming
        from ``cfg.resume``, with the checkpoints, the ``-v`` dumps, the
        output files and the ``--profile`` report of the JAX package's
        ``BPMF.run``.  Returns the Final Avg RMSE."""
        self.setup()
        cfg = self.cfg
        if cfg.resume:
            checkpoint.load(cfg.resume, self)
            self._log(f"resumed from {cfg.resume} at iteration {self.iter}")
        begin = tick()
        num_items = self.users.num + self.movies.num
        nnz = self.train.nnz
        chunk = max(1, cfg.chunk) if not cfg.verbose else 1
        if cfg.verbose and cfg.output_dir:
            os.makedirs(cfg.output_dir, exist_ok=True)
        done = self.iter + 1
        last_ckpt = done
        while done < cfg.nsims:
            n = min(chunk, cfg.nsims - done)
            start = tick()
            with self.counters.scope("main", sync=self._sync):
                mets = self.run_chunk(n)
            stop = tick()
            if not np.isfinite(mets.rmse[-1]):
                # the reference aborts on Cholesky failure (c++/sample.cpp:308)
                raise FloatingPointError(
                    f"non-finite RMSE at iteration {done + n - 1}: "
                    "Cholesky failure or numerical overflow")
            per_iter = (stop - start) / n
            items_per_sec = num_items / per_iter
            ratings_per_sec = nnz / per_iter
            for j in range(n):
                it = done + j
                self.rmse = float(mets.rmse[j])
                self.rmse_avg = float(mets.rmse_avg[j])
                self.average_items_sec += items_per_sec
                self.average_ratings_sec += ratings_per_sec
                phase = "Burnin" if it < cfg.burnin else "Sampling"
                self._log(
                    f"0: {phase} iteration {it}:\t RMSE: {self.rmse:3.4f}\t"
                    f"avg RMSE: {self.rmse_avg:3.4f}\t"
                    f"FU({float(mets.norm_users[j]):6.2f})\t"
                    f"FM({float(mets.norm_movies[j]):6.2f})\t"
                    f"items/sec: {items_per_sec:6.2f}\t"
                    f"ratings/sec: {ratings_per_sec / 1e6:6.2f}M"
                )
            if cfg.verbose and cfg.output_dir:
                # per-iteration model dump (-v, c++/bpmf.cpp:200-209)
                for prefix, side, state in (("U", self.users, self.state_u),
                                            ("V", self.movies, self.state_m)):
                    items = self.items_host(side, state)
                    if self.rank == 0:
                        write_matrix(os.path.join(cfg.output_dir,
                                                  f"{prefix}-{done}.ddm"), items.T)
            done += n
            # boundary-crossing trigger: `done` advances in steps of `chunk`,
            # so a modulo test would never fire when the frequency is not a
            # multiple of the chunk (bpmf_tpu/sampler.py:1186-1198)
            if (cfg.checkpoint_path and cfg.checkpoint_freq
                    and done < cfg.nsims
                    and done - last_ckpt >= cfg.checkpoint_freq):
                checkpoint.save(cfg.checkpoint_path, self)
                last_ckpt = done
        elapsed = tick() - begin

        # final prediction pass (c++/bpmf.cpp:225,242): one more Welford
        # update with the last sample, its tables in the matmul dtype
        # (bpmf_tpu/sampler.py:1204-1210)
        self.est, rmse, rmse_avg = self._predict(
            self.est, self.state_u.items, self.state_m.items, self.iter, self._md)
        count_sync("run_final")
        self.rmse = float(rmse)
        self.rmse_avg = float(rmse_avg)

        if cfg.checkpoint_path:
            checkpoint.save(cfg.checkpoint_path, self)
        if cfg.output_dir:
            with self.counters.scope("output"):
                self.write_output()

        niter = max(self.iter + 1, 1)
        self._log(f"Total time: {elapsed:.6g}")
        self._log(f"Final Avg RMSE: {self.rmse_avg:.6g}")
        self._log(f"  computed on {len(self.t_val)} items "
                  f"(100% of total items in test set)")
        self._log(f"Average items/sec: {self.average_items_sec / niter:.6g}")
        self._log(f"Average ratings/sec: {self.average_ratings_sec / niter:.6g}")
        rep = self.counters.report()
        if rep:
            self._log(rep)
            self._log(f"matrix I/O: {native.status()}")
            self._log(self.events_report())
        if cfg.profile:
            self._log(self.profile_phases())
        return self.rmse_avg

    def events_report(self) -> str:
        """This sampler's set-up parts and the process's event counters
        (``utils.counters.event_counts``), for ``--profile``."""
        ev = event_counts()
        total = sum(self.setup_parts.values())
        lines = [f"set-up parts (host seconds, {total:.4f}s in all):"]
        for name, t in sorted(self.setup_parts.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {name:<28} {t:10.4f}s "
                         f"{100.0 * t / total if total else 0.0:5.1f}%")
        b = ev["kernel_build"]
        lines.append(f"kernel builds: {b['count']} ({b['seconds']:.2f}s nvcc)")
        lines.append("host syncs: " + (", ".join(
            f"{site} {n}" for site, n in sorted(ev["host_sync"].items()))
            or "none"))
        return "\n".join(lines)

    def profile_phases(self, iters: int = 25) -> str:
        """Phase attribution by whole-sampler differencing (--profile;
        ``bpmf_tpu/sampler.py:1240-1315``): the iteration time of this
        sampler (best of 3 chunks of ``iters`` after one warm chunk, each
        ending in a host sync), then of a fresh sampler of the same data
        with one phase ablated, for each of nopredict, nosolve, nomatmul,
        nohyper, nonoise (and nogather when a side is bucketed).  Each
        ablated sampler is routed as the JAX package routes it (nomatmul
        and nosolve send a dense8 side to the split pipeline) and keeps
        ``output_dir``, so it carries the same aggregates; it is freed
        before the next is built.  Its extra iterations advance this chain."""
        def timed(sampler) -> float:
            sampler.run_chunk(iters)
            best = float("inf")
            for _ in range(3):
                t0 = tick()
                sampler.run_chunk(iters)
                best = min(best, tick() - t0)
            return best / iters

        full = timed(self)
        variants = ["nopredict", "nosolve", "nomatmul", "nohyper", "nonoise"]
        if "bucketed" in (self.users.impl, self.movies.impl):
            variants.append("nogather")
        lines = [
            f"sweep phase attribution (device-synced, {iters}-iter chunks):",
            f"  full iteration           {full * 1e3:9.4f} ms",
        ]
        with open(os.devnull, "w") as devnull:
            for v in variants:
                cfg2 = dataclasses.replace(self.cfg, ablate=v, profile=False,
                                           checkpoint_path="", resume="")
                s = BPMF(cfg2, train=self.train, test=self.test, out=devnull,
                         device=self.device, mesh=self._mesh_in)
                s.setup()
                t = timed(s)
                del s
                lines.append(
                    f"  {PHASE_NAMES[v]:<24} {max(full - t, 0.0) * 1e3:9.4f} ms"
                    f"  (iteration without it: {t * 1e3:.4f})")
        lines.append("  (residual = gram/exchange + hyper + noise + stats)")
        return "\n".join(lines)

    # -- outputs -----------------------------------------------------------

    def write_output(self) -> None:
        """Write the Pavg/Pm2 predictions and the aggregated posterior
        (c++/bpmf.cpp:221-240; ``bpmf_tpu/sampler.py:1319-1347``): Pavg.sdm,
        Pm2.sdm, U-mu.ddm, U-Lambda.ddm, V-mu.ddm, V-Lambda.ddm.  At D > 1
        every rank takes part in the gathers and rank 0 writes."""
        odir = self.cfg.output_dir
        state_m, state_u, est = self.state_host()
        if self.rank != 0:
            return
        count_sync("write_output")
        os.makedirs(odir, exist_ok=True)
        shape = self.test.shape
        for name, values in (("Pavg", est.pavg), ("Pm2", est.pm2)):
            host = values.detach().to("cpu", torch.float64).numpy()
            write_matrix(os.path.join(odir, f"{name}.sdm"),
                         sp.csc_matrix((host, (self.t_user, self.t_item)),
                                       shape=shape))
        for prefix, side, state in (("U", self.users, state_u),
                                    ("V", self.movies, state_m)):
            mu, lam = self._finalize_mu_lambda(side, state)
            write_matrix(os.path.join(odir, f"{prefix}-mu.ddm"), mu)
            write_matrix(os.path.join(odir, f"{prefix}-Lambda.ddm"), lam)

    def _finalize_mu_lambda(self, side: Side, state: SideState):
        """Aggregate sums -> posterior mean (K x num) and per-item precision
        (K^2 x num, column i = vec(prec_i) column-major) (Sys::
        finalize_mu_lambda, c++/bpmf.cpp:281-295).  The aggregates (every
        rank's rows, :meth:`state_host`) move to float64 on the host before
        the inverse, as in the JAX package."""
        cfg = self.cfg
        nsamples = cfg.nsims - cfg.burnin
        idx = side.maps.orig_to_padded

        def host(t):
            return t.detach().to("cpu", torch.float64).numpy()[idx]

        aggr_mu = host(state.aggr_mu)                              # [num, K]
        k = aggr_mu.shape[1]
        aggr_prod = aggr_prod_full(host(state.aggr_prod), k)      # [num, K, K]
        outer = np.einsum("nk,nl->nkl", aggr_mu, aggr_mu) / nsamples
        cov = (aggr_prod - outer) / (nsamples - 1)
        prec = np.linalg.inv(cov)
        mu = (aggr_mu / nsamples).T                                # [K, num]
        lam = prec.transpose(1, 2, 0).reshape(k * k, side.num, order="F")
        return mu, lam
