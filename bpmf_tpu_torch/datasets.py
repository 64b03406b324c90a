"""Deterministic synthetic datasets for benchmarks and tests.

The reference repo ships only ml-100k (data/movielens) and a 4x2 tiny set;
the BASELINE configs reference ml-1m / ml-25M / chembl_20, which are not in
the repo (chembl matrices are .MISSING_LARGE_BLOBS).  These generators
produce size- and skew-matched stand-ins, deterministically, so the same
benchmark runs anywhere.

Degree skew matters (SURVEY.md §7 risk 2): movie popularity follows a
Zipf-like law and user activity a lognormal, roughly matching MovieLens
marginals; ``synth_chembl`` makes a tall-skinny matrix with extreme row
degree imbalance like ChEMBL compound x protein activity data.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = ["synth_movielens", "synth_chembl", "synth_jester", "ML1M_SHAPE",
           "ML25M_SHAPE", "JESTER1_SHAPE"]

ML1M_SHAPE = (6040, 3952)    # users x movies, ~1M ratings
ML25M_SHAPE = (162541, 59047)  # users x movies, ~25M ratings
JESTER1_SHAPE = (73421, 100)   # users x jokes, over 4.1M ratings


def _sample_pairs(rng, n_users, n_movies, n_ratings, user_w, movie_w):
    """Draw distinct (user, movie) pairs weighted by popularity
    (vectorized rejection: scales to tens of millions of pairs)."""
    codes = np.empty(0, np.int64)
    while codes.size < n_ratings:
        m = int((n_ratings - codes.size) * 1.4) + 64
        u = rng.choice(n_users, size=m, p=user_w)
        v = rng.choice(n_movies, size=m, p=movie_w)
        new = u.astype(np.int64) * n_movies + v
        codes = np.unique(np.concatenate([codes, new]))
    # unique() sorts; shuffle so train/test splits stay unbiased
    rng.shuffle(codes)
    codes = codes[:n_ratings]
    return codes // n_movies, codes % n_movies


def _latent_ratings(rng, rows, cols, n_users, n_movies, k_true=10):
    uf = rng.normal(0, 0.6, size=(n_users, k_true))
    vf = rng.normal(0, 0.6, size=(n_movies, k_true))
    raw = np.sum(uf[rows] * vf[cols], axis=1) + 3.6 + rng.normal(0, 0.4, len(rows))
    return np.clip(np.round(raw), 1.0, 5.0)


def synth_movielens(
    n_users: int = ML1M_SHAPE[0],
    n_movies: int = ML1M_SHAPE[1],
    n_ratings: int = 1_000_000,
    seed: int = 20260816,
    test_frac: float = 0.1,
):
    """MovieLens-like synthetic ratings; default is the ml-1m scale of
    BASELINE config 2.  Returns (train_csc, test_csc) of identical shape."""
    rng = np.random.default_rng(seed)
    movie_w = 1.0 / np.arange(1, n_movies + 1) ** 0.8
    rng.shuffle(movie_w)
    movie_w /= movie_w.sum()
    user_w = rng.lognormal(0, 1.0, n_users)
    user_w /= user_w.sum()

    rows, cols = _sample_pairs(rng, n_users, n_movies, n_ratings, user_w, movie_w)
    vals = _latent_ratings(rng, rows, cols, n_users, n_movies)

    n_test = int(n_ratings * test_frac)
    perm = rng.permutation(n_ratings)
    te, tr = perm[:n_test], perm[n_test:]
    shape = (n_users, n_movies)
    train = sp.csc_matrix((vals[tr], (rows[tr], cols[tr])), shape=shape)
    test = sp.csc_matrix((vals[te], (rows[te], cols[te])), shape=shape)
    return train, test


def synth_chembl(
    n_compounds: int = 167_000,
    n_proteins: int = 360,
    n_ratings: int = 600_000,
    seed: int = 77,
    test_frac: float = 0.1,
):
    """ChEMBL-like tall-skinny activity matrix (BASELINE config 3): few
    columns with enormous degrees (> breakpoint2 = 10500, c++/bpmf.h:256),
    most compounds with a handful of measurements."""
    rng = np.random.default_rng(seed)
    prot_w = 1.0 / np.arange(1, n_proteins + 1) ** 1.1
    rng.shuffle(prot_w)
    prot_w /= prot_w.sum()
    comp_w = rng.pareto(2.0, n_compounds) + 0.1
    comp_w /= comp_w.sum()

    rows, cols = _sample_pairs(
        rng, n_compounds, n_proteins, n_ratings, comp_w, prot_w
    )
    vals = _latent_ratings(rng, rows, cols, n_compounds, n_proteins, k_true=6)

    n_test = int(n_ratings * test_frac)
    perm = rng.permutation(n_ratings)
    te, tr = perm[:n_test], perm[n_test:]
    shape = (n_compounds, n_proteins)
    train = sp.csc_matrix((vals[tr], (rows[tr], cols[tr])), shape=shape)
    test = sp.csc_matrix((vals[te], (rows[te], cols[te])), shape=shape)
    return train, test


def synth_jester(
    n_users: int = JESTER1_SHAPE[0],
    n_jokes: int = JESTER1_SHAPE[1],
    n_ratings: int = 4_100_000,
    seed: int = 1999,
    test_frac: float = 0.1,
    n_gauge: int = 10,
):
    """Jester-like dense ratings at the scale of Jester Dataset 1 (Goldberg
    et al., "Eigentaste: A Constant Time Collaborative Filtering
    Algorithm", Information Retrieval 4(2), 2001: 73,421 users, 100
    jokes, over 4.1 million ratings, 56% of the matrix).  As there, every
    user rates the ``n_gauge`` gauge jokes and 15 to 100 jokes in all (a
    third of the users 15-35, the rest 36-100, then evened out to
    ``n_ratings``), the others drawn uniformly.  Jester's own ratings are
    continuous (-10.00 to +10.00 in steps of 0.01: 2,001 levels, past the
    255 codes of the dense8 routes); these are the integers 1..5 of the
    latent model, as in ``synth_movielens``."""
    rng = np.random.default_rng(seed)
    per = np.where(rng.random(n_users) < 1 / 3, rng.integers(15, 36, n_users),
                   rng.integers(36, n_jokes + 1, n_users))
    while (gap := n_ratings - int(per.sum())) != 0:
        room = np.flatnonzero(per < n_jokes if gap > 0 else per > 15)
        pick = rng.choice(room, size=min(abs(gap), room.size), replace=False)
        per[pick] += 1 if gap > 0 else -1
    # each user's jokes: the gauge set, then the rest in a random order
    keys = rng.random((n_users, n_jokes))
    keys[:, :n_gauge] = -1.0
    order = np.argsort(keys, axis=1)
    take = np.arange(n_jokes)[None, :] < per[:, None]
    rows = np.broadcast_to(np.arange(n_users)[:, None], take.shape)[take]
    cols = order[take]
    vals = _latent_ratings(rng, rows, cols, n_users, n_jokes)

    n_test = int(n_ratings * test_frac)
    perm = rng.permutation(n_ratings)
    te, tr = perm[:n_test], perm[n_test:]
    shape = (n_users, n_jokes)
    train = sp.csc_matrix((vals[tr], (rows[tr], cols[tr])), shape=shape)
    test = sp.csc_matrix((vals[te], (rows[te], cols[te])), shape=shape)
    return train, test
