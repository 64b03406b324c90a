"""What decides ``correct``: iterations that the timed entry
(``BPMF.run_chunk``) ran on the window's sampler, at the timed sizes, held
to the plain reference (``benchmark.reference``).

A Gibbs chain is a sequence of steps, each a function of the previous
state and the draws of its iteration, and a chain started anywhere else
would not reach the state the window leaves, so the reference follows the
program from the program's own state:

- the start, checked by itself: the program's initial item vectors (all
  zero, held exactly) and iteration 0, which set-up runs as
  ``run_chunk(1)`` and the reference computes from its own zeros;
- the chunk after the window: once the window has closed, the harness
  takes the program's state and calls ``run_chunk(chunk)`` once more, the
  window's call on the window's sampler, and the reference runs the same
  ``chunk`` iterations from that state.  This skips the window's own
  iterations, whose states no one keeps; the chunk after them starts from
  the state they left, a chain hundreds of iterations in.

Over ``chunk`` iterations the reference's trajectory and the program's
part by the rounding of each step, amplified as the chain mixes; the
limits are set from readings of that spread (PERF.md).  The compared
numbers, each the worse of the start and the chunk:

- ``hyper``: both sides' last hyperprior draw, the worse of the drawn
  mean's gap against its own size, |mu - mu_ref| / |mu_ref|, and the
  drawn covariance's, |S - S_ref|_F / |S_ref|_F with S = Lambda^-1 (not
  Lambda itself: at K = 32 on data of a lower latent rank its largest
  eigenvalues invert directions of little item variance);
- ``items``: both half-sweeps, the widest gap of an item vector,
  |u_i - u_ref,i| / max(|u_ref,i|, the median |u_ref,j|);
- ``eval``: the evaluation, the worst of each iteration's RMSE and
  running-mean RMSE (|x - x_ref| / x_ref) and the widest gap of a test
  prediction's Welford mean, as ``items``;
- ``m2``: the widest gap of an entry of the Welford M2, as ``items`` (its
  own number: sound runs read it ~5x higher than ``eval``'s parts);
- ``start``: the largest |entry| of the program's initial item vectors
  (limit 0).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from benchmark import reference as ref

__all__ = ["Snapshot", "capture", "compare", "components", "drive_start",
           "drive_chunk", "judge", "NAMES"]

NAMES = ("hyper", "items", "eval", "m2", "start")


class Snapshot(NamedTuple):
    """The program's chain after an iteration, on the host, in the
    reference's order: items in original order, the Welford state in the
    order of the reference's test triples."""

    it: int
    movies: torch.Tensor
    users: torch.Tensor
    hyper_m: Optional[ref.Hyper]
    hyper_u: Optional[ref.Hyper]
    pavg: torch.Tensor
    pm2: torch.Tensor
    rmse: float = float("nan")
    rmse_avg: float = float("nan")


def _test_order(t_user, t_item, n_movies) -> torch.Tensor:
    key = torch.as_tensor(np.asarray(t_user), dtype=torch.int64) * n_movies \
        + torch.as_tensor(np.asarray(t_item), dtype=torch.int64)
    return torch.argsort(key)


def capture(sampler, ref_order: torch.Tensor, metrics=None) -> Snapshot:
    """The program's state after its last iteration, through its own
    output surfaces: ``items_host`` (original order), each side's drawn
    hyperprior, the Welford state at its test coordinates
    (``t_user``/``t_item``), and the last RMSE that ``run_chunk`` returned.
    ``ref_order`` sorts the reference's test triples by (user, movie)."""
    mine = _test_order(sampler.t_user, sampler.t_item, sampler.movies.num)
    # the program's entry at sorted position j goes to the reference's
    # entry at sorted position j
    to_ref = torch.empty_like(mine)
    to_ref[ref_order] = mine

    def host(x):
        return x.detach().to("cpu", torch.float64)

    def hyp(state):
        return ref.Hyper(host(state.hp.mu), host(state.hp.lambda_f))

    est = sampler.est
    rmse = rmse_avg = float("nan")
    if metrics is not None:
        rmse, rmse_avg = float(metrics.rmse[-1]), float(metrics.rmse_avg[-1])
    return Snapshot(
        it=sampler.iter,
        movies=torch.as_tensor(sampler.items_host(sampler.movies,
                                                  sampler.state_m)),
        users=torch.as_tensor(sampler.items_host(sampler.users,
                                                 sampler.state_u)),
        hyper_m=hyp(sampler.state_m), hyper_u=hyp(sampler.state_u),
        pavg=host(est.pavg)[to_ref], pm2=host(est.pm2)[to_ref],
        rmse=rmse, rmse_avg=rmse_avg)


def drive_start(sampler, ref_order) -> dict:
    """Set-up's first iteration through ``run_chunk(1)``: the program's
    initial item vectors and a snapshot after iteration 0."""
    init = (sampler.items_host(sampler.movies, sampler.state_m),
            sampler.items_host(sampler.users, sampler.state_u))
    met = sampler.run_chunk(1)
    return {"init": init, "after": capture(sampler, ref_order, met)}


def drive_chunk(sampler, ref_order, chunk: int) -> dict:
    """One more ``run_chunk(chunk)`` after the window: the state before it,
    the state after it and each of its iterations' RMSE."""
    before = capture(sampler, ref_order)
    met = sampler.run_chunk(chunk)
    return {"before": before, "after": capture(sampler, ref_order, met),
            "rmse": np.asarray(met.rmse, np.float64),
            "rmse_avg": np.asarray(met.rmse_avg, np.float64)}


def _widest(x: torch.Tensor, r: torch.Tensor) -> float:
    """max_i |x_i - r_i| / max(|r_i|, median_j |r_j|), over rows (vectors)
    or entries."""
    if r.dim() == 1:
        x, r = x[:, None], r[:, None]
    gap = torch.linalg.vector_norm(x - r, dim=1)
    mag = torch.linalg.vector_norm(r, dim=1)
    floor = mag.median().clamp_min(torch.finfo(r.dtype).tiny)
    return float((gap / torch.maximum(mag, floor)).max())


def _rel(x: torch.Tensor, r: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x - r)
                 / torch.linalg.vector_norm(r).clamp_min(1e-300))


def _rmse_gap(x: float, r: float) -> float:
    return abs(x - r) / r


def components(snap: Snapshot, r: ref.State) -> dict:
    """Each part of the compared numbers of one state (program or control
    against the reference)."""
    def f64(x):
        return x.detach().to("cpu", torch.float64)

    out = {}
    for side, s, q in (("m", snap.hyper_m, r.hyper_m),
                       ("u", snap.hyper_u, r.hyper_u)):
        cov_s, cov_q = torch.linalg.inv(f64(s.lam)), torch.linalg.inv(f64(q.lam))
        out[f"hyper_mu_{side}"] = _rel(f64(s.mu), f64(q.mu))
        out[f"hyper_cov_{side}"] = _rel(cov_s, cov_q)
    out["items_m"] = _widest(f64(snap.movies), f64(r.movies))
    out["items_u"] = _widest(f64(snap.users), f64(r.users))
    out["rmse"] = max(_rmse_gap(snap.rmse, r.rmse),
                      _rmse_gap(snap.rmse_avg, r.rmse_avg))
    out["pavg"] = _widest(f64(snap.pavg), f64(r.pavg))
    out["pm2"] = _widest(f64(snap.pm2), f64(r.pm2))
    return out


def compare(c: dict) -> dict:
    """The compared numbers from :func:`components`."""
    return {"hyper": max(c[k] for k in ("hyper_mu_m", "hyper_mu_u",
                                        "hyper_cov_m", "hyper_cov_u")),
            "items": max(c["items_m"], c["items_u"]),
            "eval": max(c["rmse"], c["pavg"]),
            "m2": c["pm2"]}


def as_state(s: Snapshot, dtype, device) -> ref.State:
    """A program snapshot as the reference's input state."""
    def d(x):
        return x.to(device, dtype)

    return ref.State(d(s.movies), d(s.users), None, None, d(s.pavg), d(s.pm2),
                     s.rmse, s.rmse_avg)


def _snapshot_of(r: ref.State, it: int) -> Snapshot:
    return Snapshot(it, r.movies, r.users, r.hyper_m, r.hyper_u, r.pavg,
                    r.pm2, r.rmse, r.rmse_avg)


def _worst(out: dict, got: dict) -> None:
    for name, v in got.items():
        v = v if np.isfinite(v) else float("inf")
        out[name] = max(out.get(name, 0.0), v)


def judge(start: dict, chunk: dict, p: ref.Problem, seed: int, device,
          control: bool = False) -> tuple[dict, dict]:
    """The compared numbers and their parts: the program against the
    reference, or (``control``) the reference's float32-with-TF32 twin put
    in the program's place, from the same inputs."""
    draws = ref.Draws(seed, device)
    plain = ref.PLAIN
    parts = {}
    want = ref.iterate(p, ref.initial_state(p, plain.dtype, device), 0, draws,
                       plain)
    got = start["after"]
    if control:
        got = _snapshot_of(ref.iterate(
            p, ref.initial_state(p, ref.CONTROL.dtype, device), 0, draws,
            ref.CONTROL), 0)
    _worst(parts, components(got, want))

    before = chunk["before"]
    want = as_state(before, plain.dtype, device)
    ctl = as_state(before, ref.CONTROL.dtype, device)
    for j in range(len(chunk["rmse"])):
        it = before.it + 1 + j
        want = ref.iterate(p, want, it, draws, plain)
        if control:
            ctl = ref.iterate(p, ctl, it, draws, ref.CONTROL)
            rmse, rmse_avg = ctl.rmse, ctl.rmse_avg
        else:
            rmse, rmse_avg = chunk["rmse"][j], chunk["rmse_avg"][j]
        _worst(parts, {"rmse": max(_rmse_gap(rmse, want.rmse),
                                   _rmse_gap(rmse_avg, want.rmse_avg))})
    got = _snapshot_of(ctl, it) if control else chunk["after"]
    _worst(parts, components(got, want))
    out = compare(parts)
    init = max(float(np.abs(x).max(initial=0.0)) for x in start["init"])
    out["start"] = 0.0 if control else init
    return out, parts
