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
from bpmf_tpu_torch.ops.mvnormal import HyperDraws
from bpmf_tpu_torch.sampler import BPMF


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
    return out


def rank_device(mesh):
    """This rank's device, as a string."""
    return str(mesh.device)


def sleeper(mesh, seconds):
    """A rank that outlasts a short deadline."""
    import time

    time.sleep(seconds)
