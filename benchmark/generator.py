"""The one data generator of the benchmark: a sparse rating matrix made on
the device from ``--seed``, its shape and degree laws read from a
configuration file and its values from a cell's value model.

A frozen copy of the laws of ``bpmf_tpu_torch.datasets`` (``synth_movielens``'s,
and ``synth_chembl``'s Pareto law for a tall activity matrix), rewritten in
PyTorch so that tens of millions of ratings are made on the card in seconds:

- each side's item weights follow a named law (``zipf``: 1 / rank^exponent,
  the ranks shuffled; ``lognormal``: exp(sigma N(0, 1)); ``pareto``: a Lomax
  variate of shape ``a`` plus ``floor``);
- distinct (row, column) pairs are drawn by those weights with replacement
  and deduplicated until there are enough, and a uniform subset of exactly
  ``n_ratings`` is kept;
- each rating is a latent score: the dot product of rank ``latent_rank``
  factors drawn N(0, latent_sd), plus ``offset`` and N(0, noise_sd) noise;
  the cell's value model maps it onto a grid (``shift + scale * score``,
  rounded to ``step``, clipped to [lo, hi]);
- ``test_frac`` of the ratings, by a random permutation, are the test set.

Every random number comes from one ``torch.Generator`` on the device seeded
from the seed, so the same seed on the same device gives the same matrices.
The sizes (rows, columns, ratings, test ratings) are the configuration's on
every seed; only which pairs are rated, and their values, change.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["Ratings", "Data", "make_data", "splitmix64", "item_weights"]

MASK64 = (1 << 64) - 1


def splitmix64(x: int) -> int:
    """One step of SplitMix64 (Steele et al. 2014) on a 64-bit integer."""
    x = (x + 0x9E3779B97F4A7C15) & MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & MASK64
    return x ^ (x >> 31)


class Ratings(NamedTuple):
    """COO triples on the device: row, column (int64), value (float64)."""

    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor

    def to(self, device) -> "Ratings":
        return Ratings(*(x.to(device) for x in self))


class Data(NamedTuple):
    shape: tuple[int, int]  # (rows, columns): users x movies, compounds x targets
    train: Ratings
    test: Ratings


def item_weights(law: dict, n: int, g: torch.Generator, device) -> torch.Tensor:
    """The sampling weights of ``n`` items under ``law``, float64, summing
    to 1."""
    kind = law["law"]
    if kind == "zipf":
        w = 1.0 / torch.arange(1, n + 1, dtype=torch.float64,
                               device=device) ** law["exponent"]
        w = w[torch.randperm(n, generator=g, device=device)]
    elif kind == "lognormal":
        w = torch.exp(law["sigma"] * torch.randn(n, generator=g,
                                                 dtype=torch.float64,
                                                 device=device))
    elif kind == "pareto":
        u = torch.rand(n, generator=g, dtype=torch.float64, device=device)
        # Lomax (numpy's ``pareto``): U^(-1/a) - 1, U uniform on (0, 1]
        w = (1.0 - u) ** (-1.0 / law["a"]) - 1.0 + law.get("floor", 0.0)
    else:
        raise ValueError(f"unknown degree law {kind!r}")
    return w / w.sum()


def _draw(cdf: torch.Tensor, m: int, g: torch.Generator) -> torch.Tensor:
    u = torch.rand(m, generator=g, dtype=torch.float64, device=cdf.device)
    return torch.searchsorted(cdf, u * cdf[-1]).clamp_(max=cdf.numel() - 1)


def sample_pairs(n_rows: int, n_cols: int, n: int, row_w, col_w,
                 g: torch.Generator) -> tuple[torch.Tensor, torch.Tensor]:
    """``n`` distinct (row, column) pairs drawn by the weights, in a random
    order."""
    device = row_w.device
    row_cdf, col_cdf = torch.cumsum(row_w, 0), torch.cumsum(col_w, 0)
    keys = torch.empty(0, dtype=torch.int64, device=device)
    while keys.numel() < n:
        m = int((n - keys.numel()) * 1.4) + 64
        new = _draw(row_cdf, m, g) * n_cols + _draw(col_cdf, m, g)
        keys = torch.unique(torch.cat([keys, new]))
    keys = keys[torch.randperm(keys.numel(), generator=g, device=device)[:n]]
    return keys // n_cols, keys % n_cols


def apply_values(score: torch.Tensor, model: dict) -> torch.Tensor:
    """A cell's value model on the latent scores: ``shift + scale * score``
    rounded to a multiple of ``step`` and clipped to [lo, hi]."""
    x = model.get("shift", 0.0) + model.get("scale", 1.0) * score
    step = model["step"]
    x = torch.round(x / step) * step
    return torch.clamp(x, model["lo"], model["hi"])


def make_data(config: dict, value_model: dict, seed: int, device) -> Data:
    """The configuration's matrix for ``seed``, made on ``device``."""
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(splitmix64(seed ^ 0xDA7A) & ((1 << 63) - 1))
    n_rows, n_cols, n = config["n_rows"], config["n_cols"], config["n_ratings"]
    row_w = item_weights(config["row_law"], n_rows, g, device)
    col_w = item_weights(config["col_law"], n_cols, g, device)
    rows, cols = sample_pairs(n_rows, n_cols, n, row_w, col_w, g)

    k, sd = config["latent_rank"], config["latent_sd"]
    f64 = dict(generator=g, dtype=torch.float64, device=device)
    uf = torch.randn((n_rows, k), **f64) * sd
    vf = torch.randn((n_cols, k), **f64) * sd
    score = torch.empty(n, dtype=torch.float64, device=device)
    step = 1 << 22  # bounded temporaries at tens of millions of ratings
    for s in range(0, n, step):
        e = min(s + step, n)
        score[s:e] = (uf[rows[s:e]] * vf[cols[s:e]]).sum(1)
    del uf, vf
    score += config["offset"] + config["noise_sd"] * torch.randn(n, **f64)
    vals = apply_values(score, value_model)
    del score

    n_test = int(n * config["test_frac"])
    perm = torch.randperm(n, generator=g, device=device)
    te, tr = perm[:n_test], perm[n_test:]
    return Data((n_rows, n_cols), Ratings(rows[tr], cols[tr], vals[tr]),
                Ratings(rows[te], cols[te], vals[te]))


def to_csc(r: Ratings, shape: tuple[int, int]):
    """A scipy CSC matrix of the triples, sorted on the device (the pairs
    are distinct, so nothing is summed)."""
    import scipy.sparse as sp

    n_rows, n_cols = shape
    order = torch.argsort(r.cols * n_rows + r.rows)
    indptr = torch.zeros(n_cols + 1, dtype=torch.int64, device=r.rows.device)
    indptr[1:] = torch.cumsum(torch.bincount(r.cols, minlength=n_cols), 0)
    return sp.csc_matrix(
        (r.vals[order].cpu().numpy(),
         r.rows[order].to(torch.int32).cpu().numpy(),
         indptr.cpu().numpy()), shape=shape)

