"""The work one Gibbs iteration needs, counted from the ratings, and the
card's published peaks.  Frozen here so that a roofline share counts the
same work whatever route or kernel does it.

Per half-sweep, for the side whose items are drawn (S) given the frozen
side (O):

- each training rating: K(K+1) + 2K float32 operations (the Gram's
  multiply-adds over the full K x K and the rhs) and 5 bytes (a 1-byte
  rating code and a 4-byte index);
- each item of S: K^3/3 + 2K^2 operations (the Cholesky factor and the
  two triangular solves), and its K-vector written (4K bytes);
- the frozen side's table read once (4K bytes an item of O).

Per iteration, both half-sweeps and the evaluation's 2K operations per
test rating.  A share of the roofline is the least time the card could
take, max(operations / peak FLOP/s, bytes / peak bytes/s), over the time
measured; the bound says which of the two it is.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 3.35 TB/s of HBM3; float32 outside the tensor cores 67 TFLOP/s,
bf16 on the tensor cores 989 TFLOP/s.  A float32 configuration runs no
TF32, so its peak is the 67.
"""

from __future__ import annotations

from typing import NamedTuple

__all__ = ["PEAK_BYTES_PER_S", "PEAK_FLOPS", "Shape", "half_sweep",
           "iteration_ops", "sweep_bound"]

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
RATING_BYTES = 5  # an int8 code and an int32 index


class Shape(NamedTuple):
    k: int
    n_users: int     # rows
    n_movies: int    # columns
    nnz_train: int
    nnz_test: int


class Work(NamedTuple):
    ops: float
    bytes: float


def half_sweep(k: int, nnz: int, n_items: int, n_frozen: int) -> Work:
    """The work of drawing ``n_items`` items from ``nnz`` ratings given
    ``n_frozen`` frozen items."""
    ops = nnz * (k * (k + 1) + 2 * k) + n_items * (k ** 3 / 3 + 2 * k ** 2)
    nbytes = nnz * RATING_BYTES + 4 * k * (n_items + n_frozen)
    return Work(float(ops), float(nbytes))


def sweeps(s: Shape) -> tuple[Work, Work]:
    """(movies' half-sweep, users' half-sweep)."""
    return (half_sweep(s.k, s.nnz_train, s.n_movies, s.n_users),
            half_sweep(s.k, s.nnz_train, s.n_users, s.n_movies))


def sweep_bound(s: Shape, dtype: str = "float32") -> tuple[float, str]:
    """The least seconds both half-sweeps of one iteration take on the
    card, each bound by the larger of its operations and its bytes, and
    which bound the pair: ``operations`` or ``bytes``."""
    total, by_ops = 0.0, 0.0
    for w in sweeps(s):
        t_ops = w.ops / PEAK_FLOPS[dtype]
        t_bytes = w.bytes / PEAK_BYTES_PER_S
        total += max(t_ops, t_bytes)
        by_ops += t_ops if t_ops >= t_bytes else 0.0
    return total, "operations" if by_ops >= total / 2 else "bytes"


def iteration_ops(s: Shape) -> float:
    """The operations of one iteration: both half-sweeps and the
    evaluation."""
    return sum(w.ops for w in sweeps(s)) + 2 * s.k * s.nnz_test
