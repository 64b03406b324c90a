"""The plain reference of one Gibbs iteration of BPMF (Salakhutdinov and Mnih,
ICML 2008), in plain PyTorch, from the ratings alone.

It imports nothing of the program under test and takes nothing the program
derived from the data: no rating codes, scales, item maps, padding or
buckets.  It works on the ratings as the generator made them, in original
item order, in float64 (or, as the control, in float32 with every matrix
product's operands rounded to TF32).

One iteration (c++/bpmf.cpp:184-196 of the reference C++ program):

1. both sides' hyperpriors (mu, Lambda) drawn from their Normal-Wishart
   posteriors given the previous iteration's item statistics (prior b0 = 2,
   df0 = K, W0 = I, mu0 = 0; Bartlett's construction);
2. every movie (column) drawn from N(Lambda*^-1 b, Lambda*^-1) with
   Lambda* = Lambda + alpha sum_j u_j u_j' over its raters and
   b = Lambda mu + alpha sum_j (r_ij - mean) u_j, through the Cholesky
   factor: v = L'^-1 (z + L^-1 b);
3. every user (row) the same, given the new movies;
4. the test predictions u'v + mean, their Welford running mean and M2
   after burn-in, and the RMSE of both.

The random numbers follow the chain's stated draw protocol: one
``torch.Generator`` on the device per (seed, iteration, side, purpose),
keyed by SplitMix64; the hyperprior takes Gamma(0.5 (df - i)) variates, a
K x K and a K-vector of N(0, 1); the noise is a [num + 1, K] N(0, 1) table
whose row i belongs to item i.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Optional

import torch

from benchmark.generator import MASK64, splitmix64

__all__ = ["Draws", "Problem", "State", "Hyper", "iterate", "initial_state",
           "tf32_round"]


class Draws:
    """The chain's random numbers for ``seed``, made in ``dtype`` on
    ``device``; side 0 is the movies, side 1 the users."""

    def __init__(self, seed: int, device, dtype=torch.float32):
        self.seed, self.device, self.dtype = seed, torch.device(device), dtype

    def generator(self, it: int, side: int, purpose: int) -> torch.Generator:
        h = self.seed
        for w in (it, side, purpose):
            h = splitmix64(h ^ splitmix64(w)) & MASK64
        return torch.Generator(device=self.device).manual_seed(h)

    def hyper(self, it: int, side: int, num: int, k: int):
        """(gamma [K], normals [K, K], z [K]) with df = K + num."""
        g = self.generator(it, side, 0)
        kw = dict(dtype=self.dtype, device=self.device)
        conc = 0.5 * ((k + num) - torch.arange(k, **kw))
        return (torch._standard_gamma(conc, generator=g),
                torch.randn((k, k), generator=g, **kw),
                torch.randn((k,), generator=g, **kw))

    def noise(self, it: int, side: int, num: int, k: int) -> torch.Tensor:
        """[num, K]: row i is item i's N(0, I) draw."""
        g = self.generator(it, side, 1)
        return torch.randn((num + 1, k), generator=g, dtype=self.dtype,
                           device=self.device)[:num]


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 explicit mantissa bits (nearest,
    ties to even), as the tensor cores read a TF32 matmul's operands."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


class Side(NamedTuple):
    """One side's ratings as a CSR over its items: items are rows here."""

    crow: torch.Tensor  # [num + 1] int64
    col: torch.Tensor   # [nnz] int64: the other side's item
    val: torch.Tensor   # [nnz] float64: the rating
    num: int


class Problem(NamedTuple):
    movies: Side        # columns of the rating matrix
    users: Side         # rows
    t_user: torch.Tensor
    t_item: torch.Tensor
    t_val: torch.Tensor
    mean: float
    k: int
    alpha: float
    burnin: int


def _csr(items: torch.Tensor, others: torch.Tensor, vals: torch.Tensor,
         num: int) -> Side:
    order = torch.argsort(items * (int(others.max()) + 1) + others)
    crow = torch.zeros(num + 1, dtype=torch.int64, device=items.device)
    crow[1:] = torch.cumsum(torch.bincount(items, minlength=num), 0)
    return Side(crow, others[order], vals[order], num)


def problem(shape, train, test, k: int, alpha: float, burnin: int,
            device) -> Problem:
    """The reference's view of the generated ratings (``benchmark.generator
    .Ratings``): both sides' CSR, the test triples and the mean rating."""
    rows, cols, vals = (x.to(device) for x in train)
    n_users, n_movies = shape
    vals = vals.to(torch.float64)
    t = [x.to(device) for x in test]
    return Problem(movies=_csr(cols, rows, vals, n_movies),
                   users=_csr(rows, cols, vals, n_users),
                   t_user=t[0], t_item=t[1], t_val=t[2].to(torch.float64),
                   mean=float(vals.sum()) / vals.numel(), k=k, alpha=alpha,
                   burnin=burnin)


class Hyper(NamedTuple):
    mu: torch.Tensor      # [K]
    lam: torch.Tensor     # [K, K] precision


class State(NamedTuple):
    """The chain after an iteration, in original item order."""

    movies: torch.Tensor  # [num_movies, K]
    users: torch.Tensor   # [num_users, K]
    hyper_m: Optional[Hyper]
    hyper_u: Optional[Hyper]
    pavg: torch.Tensor    # [nnz_test] Welford mean of the predictions
    pm2: torch.Tensor     # [nnz_test] Welford M2
    rmse: float
    rmse_avg: float


def initial_state(p: Problem, dtype, device) -> State:
    """Sys::init (c++/sample.cpp:179-201): every item vector zero."""
    z = dict(dtype=dtype, device=device)
    n = p.t_val.numel()
    return State(torch.zeros((p.movies.num, p.k), **z),
                 torch.zeros((p.users.num, p.k), **z), None, None,
                 torch.zeros(n, **z), torch.zeros(n, **z), float("nan"),
                 float("nan"))


class Arith:
    """The arithmetic of one precision: float64 plain, or the control's
    float32 with TF32 matmul operands."""

    def __init__(self, dtype, tf32: bool = False):
        self.dtype, self.tf32 = dtype, tf32

    def op(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        return tf32_round(x) if self.tf32 else x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.op(a) @ self.op(b)


def hyper_draw(ar: Arith, items: torch.Tensor, draws, k: int) -> Hyper:
    """Normal-Wishart posterior draw of (mu, Lambda) from the side's item
    vectors (HyperParams::sample, c++/bpmf.h:98-103; CondNormalWishart and
    NormalWishart, c++/mvnormal.cpp:96-135)."""
    gamma, normals, z = (x.to(ar.dtype) for x in draws)
    n = items.shape[0]
    x = items.to(ar.dtype)
    s = x.sum(0)
    cov = (ar.mm(x.t(), x) - torch.outer(s, s) / n) / (n - 1.0)
    um = s / n
    eye = torch.eye(k, dtype=ar.dtype, device=x.device)
    kappa_c = 2.0 + n
    mu_c = n * um / kappa_c
    w = eye + n * cov + (2.0 * n / kappa_c) * torch.outer(um, um)
    l_w = torch.linalg.cholesky(w)
    inv_l = torch.linalg.solve_triangular(l_w, eye, upper=False)
    t_c = ar.mm(inv_l.t(), inv_l)                 # W*^-1
    # Bartlett: A upper with sqrt(chi^2) on the diagonal, U = A chol(T)'
    a = torch.triu(normals, 1) + torch.diag(torch.sqrt(2.0 * gamma))
    u = torch.triu(ar.mm(a, torch.linalg.cholesky(t_c).t()))
    mu = torch.linalg.solve_triangular(u, z[:, None], upper=True)[:, 0] \
        / kappa_c ** 0.5 + mu_c
    return Hyper(mu, ar.mm(u.t(), u))


def sweep(ar: Arith, side: Side, other: torch.Tensor, hp: Hyper,
          noise: torch.Tensor, mean: float, alpha: float,
          block: int = 1 << 16) -> torch.Tensor:
    """Every item of ``side`` drawn given the other side's vectors
    ``other`` [n_other, K] (Sys::sample, c++/sample.cpp:248-324): the
    Gram and rhs of each item's ratings as sparse products over its CSR
    rows, blocks of ``block`` items at a time."""
    k = other.shape[1]
    dev = other.device
    ii, jj = torch.tril_indices(k, k, device=dev)
    o = ar.op(other)
    outer = o[:, ii] * o[:, jj]                    # [n_other, K(K+1)/2]
    prior_b = ar.mm(hp.lam, hp.mu[:, None])[:, 0]
    out = torch.empty((side.num, k), dtype=ar.dtype, device=dev)
    crow = side.crow.cpu()
    for s in range(0, side.num, block):
        e = min(s + block, side.num)
        lo, hi = int(crow[s]), int(crow[e])
        c = (side.crow[s:e + 1] - lo)
        col = side.col[lo:hi]
        w = ar.op((side.val[lo:hi] - mean))
        ind = torch.ones_like(w)

        def spmm(values, dense):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # "beta" and the invariants
                a = torch.sparse_csr_tensor(c, col, values,
                                            (e - s, other.shape[0]),
                                            check_invariants=False)
            return a @ dense

        g_packed = spmm(ind, outer)
        rhs = spmm(w, o)
        gram = torch.zeros((e - s, k, k), dtype=ar.dtype, device=dev)
        gram[:, ii, jj] = g_packed
        gram[:, jj, ii] = g_packed
        prec = hp.lam + alpha * gram
        b = prior_b + alpha * rhs
        chol = torch.linalg.cholesky(prec)
        y = torch.linalg.solve_triangular(chol, b[..., None], upper=False)
        z = noise[s:e].to(ar.dtype)[..., None]
        out[s:e] = torch.linalg.solve_triangular(chol.mT, y + z,
                                                 upper=True)[..., 0]
    return out


def predict(p: Problem, users: torch.Tensor, movies: torch.Tensor,
            prev: State, it: int):
    """Sys::predict (c++/sample.cpp:48-96): the predictions, their Welford
    mean and M2 (n = it - burnin; n <= 0 restarts the mean), both RMSE."""
    pred = (users[p.t_user] * movies[p.t_item]).sum(-1) + p.mean
    n = max(it - p.burnin, 0)
    if n == 0:
        avg, m2 = pred, torch.zeros_like(pred)
    else:
        delta = pred - prev.pavg
        avg = prev.pavg + delta / n
        m2 = prev.pm2 + delta * (pred - avg)
    t = p.t_val.to(pred.dtype)
    rmse = float(torch.sqrt(((t - pred) ** 2).mean()))
    rmse_avg = float(torch.sqrt(((t - avg) ** 2).mean()))
    return avg, m2, rmse, rmse_avg


def iterate(p: Problem, prev: State, it: int, draws: Draws,
            ar: Arith) -> State:
    """Iteration ``it`` from the state after iteration ``it - 1``."""
    k = p.k
    hm = hyper_draw(ar, prev.movies, draws.hyper(it, 0, p.movies.num, k), k)
    hu = hyper_draw(ar, prev.users, draws.hyper(it, 1, p.users.num, k), k)
    movies = sweep(ar, p.movies, prev.users, hm,
                   draws.noise(it, 0, p.movies.num, k), p.mean, p.alpha)
    users = sweep(ar, p.users, movies, hu,
                  draws.noise(it, 1, p.users.num, k), p.mean, p.alpha)
    avg, m2, rmse, rmse_avg = predict(p, users, movies, prev, it)
    return State(movies, users, hm, hu, avg, m2, rmse, rmse_avg)


PLAIN = Arith(torch.float64)
CONTROL = Arith(torch.float32, tf32=True)
