"""Rank workers of the port's multi-device tests (gloo on the CPU).

The ranks are processes started with the spawn method
(``bpmf_tpu_torch.parallel.launch.run_ranks``), which import the module of
their function afresh: so this module imports neither jax, nor the JAX
package, nor ``tests/conftest.py``.  The parent test computes the JAX
package's draws and hands them over as numpy arrays (:class:`RecordedDraws`).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from bpmf_tpu_torch.config import Config
from bpmf_tpu_torch.models import SideData, half_sweep, init_side_state
from bpmf_tpu_torch.ops.mvnormal import HyperDraws, draw_hyper
from bpmf_tpu_torch.ops.update import item_noise
from bpmf_tpu_torch.sampler import BPMF, rank_buckets


class RecordedDraws:
    """A draw provider from recorded arrays: ``hyper[it]`` the (gamma,
    normals, z) of both sides, stacked [2, ...], and ``noise[it][side]`` the
    side's whole noise table [num + 1, K], looked up by original id as the
    JAX package's ``item_noise`` does."""

    def __init__(self, hyper: dict, noise: dict):
        self.hyper, self.noise_tables = hyper, noise

    def hyper_pair(self, it, ns, k, dtype):
        return HyperDraws(*(torch.from_numpy(a).to(dtype) for a in self.hyper[it]))

    def noise(self, it, side, orig_ids, num, k, dtype):
        table = torch.from_numpy(self.noise_tables[it][side]).to(dtype)
        return table[orig_ids.cpu()].to(orig_ids.device)


def sampler(mesh, train, test, cfg_kw, draws=None):
    """The port's sampler of one case on this rank (``mesh`` None: one
    device), set up."""
    s = BPMF(Config(**cfg_kw), train, test, device="cpu", mesh=mesh,
             draws=draws, out=open(os.devnull, "w"))
    s.setup()
    return s


def chain(mesh, train, test, cfg_kw, n, draws=None) -> dict:
    """n iterations of one case: per-iteration metrics [4, n], both factor
    tables in original order, the routes and the collectives."""
    s = sampler(mesh, train, test, cfg_kw, draws)
    before = None if s.mesh is None else dict(s.mesh.collectives)
    mets = np.stack(s.run_chunk(n))          # [4, n]: rmse, rmse_avg, norms
    users, movies = s.items_host(s.users, s.state_u), s.items_host(s.movies, s.state_m)
    return {"metrics": mets, "users": users, "movies": movies,
            "routes": {side.name: (side.impl, side.route)
                       for side in (s.movies, s.users)},
            "mode": s.mode, "n_devices": s.n_devices,
            "collectives": None if s.mesh is None else {
                c: v - before[c] for c, v in s.mesh.collectives.items()}}


def chains(mesh, cases: dict) -> dict:
    """:func:`chain` of every case, {name: (train, test, cfg_kw, n, draws)},
    in one group of ranks."""
    return {name: chain(mesh, *case) for name, case in cases.items()}


def runs(mesh, jobs: dict) -> dict:
    """``BPMF.run`` of every job, {name: (train, test, cfg_kw)}, in one group
    of ranks: the Final Avg RMSE and both factor tables in original order."""
    out = {}
    for name, (train, test, cfg_kw) in jobs.items():
        s = BPMF(Config(**cfg_kw), train, test, device="cpu", mesh=mesh,
                 out=open(os.devnull, "w"))
        rmse_avg = s.run()
        out[name] = {"rmse_avg": rmse_avg, "iter": s.iter,
                     "users": s.items_host(s.users, s.state_u),
                     "movies": s.items_host(s.movies, s.state_m)}
    return out


def resumed_step(mesh, train, test, cfg_kw, path, draws) -> dict:
    """Load the checkpoint at ``path`` (any package, any device count) into
    this rank's shard and take one step with ``draws``."""
    from bpmf_tpu_torch import checkpoint

    s = sampler(mesh, train, test, cfg_kw, draws)
    checkpoint.load(path, s)
    met = s.step()
    return {"metrics": np.asarray(met), "iter": s.iter,
            "users": s.items_host(s.users, s.state_u),
            "movies": s.items_host(s.movies, s.state_m),
            "items_rows": (tuple(s.state_u.items.shape), tuple(s.state_m.items.shape))}


def sharded_parts(mesh, seed: int = 0) -> dict:
    """Each sharded function against its one-device function on the same
    inputs (the same on every rank, from ``seed``): the sharded dense8
    half-sweep in both orientations and both Gram operands, the
    entry-sharded evaluation, and the all_reduce of the stats.  Returns
    this rank's largest differences, each relative to the largest magnitude
    of what it is held to (at least 1)."""
    from bpmf_tpu_torch.models.bpmf import EvalData, EvalState, SideState, predict
    from bpmf_tpu_torch.ops.mvnormal import HyperParams
    from bpmf_tpu_torch.parallel import spmd

    d, r = mesh.size, mesh.rank
    g = torch.Generator().manual_seed(seed)
    k, lp_u, lp_m = 8, 512, 256
    n_u, n_m = d * lp_u, d * lp_m                # R and C (C/D = 256 a rank)
    codes = torch.where(torch.rand((n_u, n_m), generator=g) < 0.05,
                        torch.randint(1, 6, (n_u, n_m), generator=g),
                        0).to(torch.int8)
    users = 0.5 * torch.randn((n_u, k), generator=g)
    movies = 0.5 * torch.randn((n_m, k), generator=g)
    w = torch.randn((k, k), generator=g)
    lam = w @ w.T / k + torch.eye(k)
    hp = HyperParams(mu=0.1 * torch.randn(k, generator=g), lambda_f=lam,
                     lambda_l=torch.linalg.cholesky(lam))
    noise = {"rows": torch.randn((n_u, k), generator=g),
             "cols": torch.randn((n_m, k), generator=g)}
    valid = {"rows": (torch.rand(n_u, generator=g) < 0.9).float(),
             "cols": (torch.rand(n_m, generator=g) < 0.9).float()}
    mine = {"rows": slice(r * lp_u, (r + 1) * lp_u),
            "cols": slice(r * lp_m, (r + 1) * lp_m)}

    def state(n):
        return SideState(items=torch.zeros((n, k)), hp=hp, sum=torch.zeros(k),
                         cov=torch.zeros((k, k)), norm=torch.zeros(()),
                         aggr_mu=torch.ones((n, k)),
                         aggr_prod=torch.ones((n, k * (k + 1) // 2)))

    def rel(a, b) -> float:
        """The largest difference relative to b's largest magnitude (at
        least 1)."""
        return float((a - b).abs().max() / max(1.0, float(b.abs().max())))

    def diff(a: SideState, b: SideState, rows: slice) -> float:
        return max(rel(a.items, b.items[rows]), rel(a.aggr_mu, b.aggr_mu[rows]),
                   rel(a.aggr_prod, b.aggr_prod[rows]), rel(a.sum, b.sum),
                   rel(a.cov, b.cov), rel(a.norm, b.norm))

    out = {}
    kw = dict(num=1000, alpha=2.0, burnin=0, cs=2.0, cb=-7.2)
    for orientation, other in (("rows", movies), ("cols", users)):
        n = n_u if orientation == "rows" else n_m
        other_mine = mine["cols" if orientation == "rows" else "rows"]
        for route in ("inkernel", "hoisted"):
            want = spmd.dense8_half_sweep(
                state(n), codes, other, hp, noise[orientation], 3,
                local_valid=valid[orientation], orientation=orientation,
                route=route, **kw)
            got = spmd.dense8_half_sweep_sharded(
                mesh, state(n // d), codes[mine["rows"]], other[other_mine],
                hp, noise[orientation][mine[orientation]], 3,
                local_valid=valid[orientation][mine[orientation]],
                orientation=orientation, route=route, **kw)
            out[f"dense8_{orientation}_{route}"] = diff(got, want, mine[orientation])

    nnz = 1001                                   # not a multiple of d
    tu = torch.randint(0, n_u, (nnz,), generator=g)
    ti = torch.randint(0, n_m, (nnz,), generator=g)
    tv = 3.0 + torch.randn(nnz, generator=g)
    est = EvalState(pavg=torch.randn(nnz, generator=g), pm2=torch.rand(nnz, generator=g))
    want_est, want_rmse, want_avg = predict(
        EvalData(tu, ti, tv), est, users, movies, 5, mean_rating=3.0, burnin=2)
    per = -(-nnz // d)
    sl = slice(r * per, (r + 1) * per)

    def shard(x):
        return torch.nn.functional.pad(x, (0, per * d - nnz))[sl]

    ev = EvalData(shard(tu), shard(ti), shard(tv),
                  valid=shard(torch.ones(nnz)))
    got_est, got_rmse, got_avg = spmd.predict_sharded(
        mesh, ev, EvalState(shard(est.pavg), shard(est.pm2)), users[mine["rows"]],
        movies[mine["cols"]], 5, mean_rating=3.0, burnin=2, nnz_true=nnz)
    real = int(ev.valid.sum())
    out["predict"] = max(
        rel(got_rmse, want_rmse), rel(got_avg, want_avg),
        rel(got_est.pavg[:real], shard(want_est.pavg)[:real]),
        rel(got_est.pm2[:real], shard(want_est.pm2)[:real]))

    parts = [torch.randn(k + k * k + 1, generator=g) for _ in range(d)]
    s, prod, norm = spmd.exchange_stats(
        mesh, parts[r][:k], parts[r][k:k + k * k].reshape(k, k), parts[r][-1])
    total = torch.stack(parts).sum(0)
    out["stats"] = max(rel(s, total[:k]),
                       rel(prod, total[k:k + k * k].reshape(k, k)),
                       rel(norm, total[-1]))
    out.update(bucket_parts(mesh))
    return out


def _max_abs(x: torch.Tensor) -> float:
    """The largest magnitude in ``x``; 0 when it is empty."""
    return float(x.abs().max()) if x.numel() else 0.0


def halo_data(d: int):
    """The halo test's matrix (tests/test_spmd.py:337): [41 other, 26 this]
    ratings, each side's maps over d devices, and the halo layout of the
    sweep updating this side."""
    import scipy.sparse as sps

    from bpmf_tpu_torch.parallel import partition as part

    m = sps.random(41, 26, density=0.12, random_state=3, format="csc")
    m.data = 1.0 + 4.0 * m.data
    maps = part.make_maps(part.assign_items(np.diff(m.indptr), d), 26)
    omaps = part.make_maps(part.assign_items(np.diff(m.tocsr().indptr), d), 41)
    return m, maps, omaps, part.build_halo_layout(m, maps, omaps)


def halo_check(mesh) -> dict:
    """:func:`~bpmf_tpu_torch.parallel.spmd.halo_gather` against the
    all_gather of the same table on this rank: the largest difference on
    the rows its buckets reference and on its own shard (both must be 0),
    the rows it received, and the collectives it took."""
    from bpmf_tpu_torch.parallel import spmd

    d, r = mesh.size, mesh.rank
    m, maps, omaps, hl = halo_data(d)
    lp = omaps.local_pad
    table = torch.randn((d * lp, 4), generator=torch.Generator().manual_seed(5))
    before = dict(mesh.collectives)
    got = spmd.halo_gather(mesh, table[r * lp:(r + 1) * lp],
                           [torch.as_tensor(x[r], dtype=torch.long) for x in hl.send_rows],
                           [torch.as_tensor(x[r], dtype=torch.long) for x in hl.recv_pos])
    needed = np.unique(omaps.orig_to_padded[
        np.unique(m[:, maps.ids_per_dev[r]].tocoo().row)])
    own = slice(r * lp, (r + 1) * lp)
    return {"needed": _max_abs(got[needed] - table[needed]),
            "own": _max_abs(got[own] - table[own]),
            "shape": tuple(got.shape), "received": int((got.abs().sum(1) > 0).sum()),
            "collectives": {c: v - before[c] for c, v in mesh.collectives.items()}}


def bucket_parts(mesh, seed: int = 5) -> dict:
    """The bucketed sweeps of reduce mode, plain and chunked, and the halo
    ring at ``mesh.size`` ranks against the one-device gather sweep of the
    same side on the same inputs (float64, the xla solver, noise by
    original id): the largest relative differences of this rank's items
    and aggregates and of the global stats; and ``halo_check``'s."""
    from bpmf_tpu_torch.models.bpmf import SideState
    from bpmf_tpu_torch.ops.mvnormal import HyperParams
    from bpmf_tpu_torch.parallel import partition as part
    from bpmf_tpu_torch.parallel import spmd
    from bpmf_tpu_torch.sampler import rank_buckets

    d, r = mesh.size, mesh.rank
    k, dt = 4, torch.float64
    m, maps, omaps, _ = halo_data(d)
    maps1 = part.make_maps(part.assign_items(np.diff(m.indptr), 1), 26)
    omaps1 = part.make_maps(part.assign_items(np.diff(m.tocsr().indptr), 1), 41)
    g = torch.Generator().manual_seed(seed)
    other = torch.randn((41, k), generator=g, dtype=dt)
    table = torch.randn((27, k), generator=g, dtype=dt)    # noise by orig id
    w = torch.randn((k, k), generator=g, dtype=dt)
    lam = w @ w.T / k + torch.eye(k, dtype=dt)
    hp = HyperParams(mu=0.1 * torch.randn(k, generator=g, dtype=dt),
                     lambda_f=lam, lambda_l=torch.linalg.cholesky(lam))

    def padded(mp, x):
        out = x.new_zeros((mp.padded_num, k))
        out[torch.as_tensor(mp.orig_to_padded)] = x
        return out

    def state(n):
        return SideState(items=torch.zeros((n, k), dtype=dt), hp=hp,
                         sum=torch.zeros(k, dtype=dt), cov=torch.zeros((k, k), dtype=dt),
                         norm=torch.zeros((), dtype=dt),
                         aggr_mu=torch.zeros((n, k), dtype=dt),
                         aggr_prod=torch.zeros((n, k * (k + 1) // 2), dtype=dt))

    kw = dict(num=26, mean_rating=3.0, alpha=2.0, burnin=0, solver="xla")
    gl = part.build_gather_layout(m, maps1, omaps1.orig_to_padded)
    b1 = rank_buckets(gl.buckets, 0, dt, "cpu")
    want = spmd.gather_half_sweep(
        state(maps1.local_pad), b1, padded(omaps1, other), hp,
        table[torch.cat([b.orig_ids for b in b1])], 3, splits=gl.splits, **kw)
    olp, lp = omaps.local_pad, maps.local_pad
    shard = padded(omaps, other)[r * olp:(r + 1) * olp]
    valid = torch.as_tensor(maps.local_valid[r], dtype=dt)
    noise = table[torch.as_tensor(maps.local_orig[r], dtype=torch.long)]
    rl = part.build_reduce_layout(m, maps.orig_to_padded, maps.padded_num,
                                  omaps.ids_per_dev)
    rc = part.build_reduce_layout_chunked(m, maps, omaps.ids_per_dev)
    got = {
        "reduce": spmd.reduce_half_sweep(
            state(lp), rank_buckets(rl.buckets, r, dt, "cpu"), shard, hp, noise,
            3, padded_num=maps.padded_num, local_valid=valid, splits=rl.splits,
            mesh=mesh, **kw),
        "reduce_chunked": spmd.reduce_half_sweep_chunked(
            state(lp), [(rank_buckets(b, r, dt, "cpu"), s) for b, s in rc.per_dest],
            shard, hp, noise, 3, local_valid=valid, mesh=mesh, **kw)}
    gd = part.build_gather_layout(m, maps, omaps.orig_to_padded)
    hl = part.build_halo_layout(m, maps, omaps)
    bd = rank_buckets(gd.buckets, r, dt, "cpu")
    got["halo_sweep"] = spmd.gather_half_sweep(
        state(lp + 1), bd, shard, hp, table[torch.cat([b.orig_ids for b in bd])],
        3, splits=gd.splits, mesh=mesh,
        halo=tuple([torch.as_tensor(x[r], dtype=torch.long) for x in t]
                   for t in (hl.send_rows, hl.recv_pos)), **kw)
    ids = maps.ids_per_dev[r]
    at = torch.as_tensor(maps1.orig_to_padded[ids], dtype=torch.long)

    def rel(a, b) -> float:
        return _max_abs(a - b) / max(1.0, _max_abs(b))

    out = {}
    for name, st in got.items():
        n = len(ids)
        out[name] = max(rel(st.items[:n], want.items[at]),
                        rel(st.aggr_mu[:n], want.aggr_mu[at]),
                        rel(st.aggr_prod[:n], want.aggr_prod[at]),
                        rel(st.sum, want.sum), rel(st.cov, want.cov),
                        rel(st.norm, want.norm))
    check = halo_check(mesh)
    out["halo"] = max(check["needed"], check["own"])
    return out


def rank_device(mesh):
    """This rank's device, as a string."""
    return str(mesh.device)


def sleeper(mesh, seconds):
    """A rank that outlasts a short deadline."""
    import time

    time.sleep(seconds)


def collective_shapes(mesh, jobs: dict) -> dict:
    """One iteration of each job, {name: (train, test, cfg_kw)}, on this
    rank, watched by a ``TorchFunctionMode``: the shapes of every tensor it
    makes with as many rows as a side's padded_num and at least K*K
    columns (``big``), and the collectives it calls with their shapes
    (``Mesh.log``)."""
    from torch.overrides import TorchFunctionMode

    out = {}
    for name, (train, test, cfg_kw) in jobs.items():
        s = sampler(mesh, train, test, cfg_kw)
        k = s.cfg.num_latent
        pn = {side.name: side.maps.padded_num for side in (s.movies, s.users)}
        big = []

        class Watch(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                res = func(*args, **(kwargs or {}))
                for t in (res if isinstance(res, (tuple, list)) else (res,)):
                    if (isinstance(t, torch.Tensor) and t.dim() >= 2
                            and t.shape[0] in pn.values()
                            and t[0].numel() >= k * k):
                        big.append(tuple(t.shape))
                return res

        mesh.log = []
        with Watch():
            s.run_chunk(1)
        out[name] = {"big": sorted(set(big)), "log": mesh.log}
        mesh.log = None
        out["padded_num"] = pn
        out["local_pad"] = {side.name: side.maps.local_pad
                            for side in (s.movies, s.users)}
    return out


def api_half_sweep(mesh, buckets, splits, local_pad, other, num, mean) -> dict:
    """One movies ``half_sweep`` in float64 on this rank's shard (``mesh``
    None: one device) of stacked host buckets, from zero state, the whole
    frozen table ``other`` and draws from fixed seeds: this rank's items
    and the side's stats."""
    rank = 0 if mesh is None else mesh.rank
    dtype, k = torch.float64, other.shape[1]
    data = SideData(buckets=rank_buckets(buckets, rank, dtype, "cpu"))
    orig = torch.cat([b.orig_ids for b in data.buckets])
    out = half_sweep(
        init_side_state(local_pad, k, dtype, False, device="cpu"), data,
        torch.from_numpy(other),
        draw_hyper(torch.Generator().manual_seed(3), k + num, k, dtype, "cpu"),
        item_noise(torch.Generator().manual_seed(4), orig, num, k, dtype), 1,
        num=num, mean_rating=mean, alpha=2.0, burnin=0, splits=splits,
        solver="xla", mesh=mesh)
    return {"items": out.items.numpy(),
            "stats": {f: getattr(out, f).numpy() for f in ("sum", "cov", "norm")}}
