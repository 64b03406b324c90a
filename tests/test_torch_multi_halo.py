"""The halo ring on the buckets (gather mode): ``spmd.halo_gather`` against the
all_gather (tests/test_spmd.py:337's data), ``--halo on`` against ``--halo
off`` at 2 and 4 gloo ranks (equal: the same values reach every row a bucket
reads) and against the JAX package at n_devices 2 and 4, under the
``nogather`` and ``nogram`` ablations too (rows no bucket references stay
zero and are read only under a zero mask, except by ``nogather``, which
reads row 0 as the JAX package does); the ``--halo auto`` choice against the
JAX package's on a block-sparse and a dense matrix; and empty shards (3
movies over 4 ranks), halo and chunked reduce, on the one-rank chain.

Each group of ranks runs every case in one spawn (module fixtures), and
each JAX reference runs once (the helpers of tests/test_torch_multi.py)."""

import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from bpmf_tpu.config import Config as JaxConfig
from bpmf_tpu.ops import pallas_solve as jax_ps
from bpmf_tpu.sampler import BPMF as JaxBPMF
from bpmf_tpu_torch.config import Config
from bpmf_tpu_torch.parallel.launch import run_ranks
from bpmf_tpu_torch.parallel.mesh import Mesh
from bpmf_tpu_torch.sampler import BPMF
from tests.conftest import make_ratings
from tests.test_torch_multi import (
    N_ITERS,
    _agree,
    jax_chain,
    port_results,
    recorded_draws,
)
from tests.torch_ranks import halo_check

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def ungrouped(monkeypatch):
    for var in ("BPMF_TRI_GROUPED", "BPMF_D8_SOLVE", "BPMF_D8_PT",
                "BPMF_TRI_ALIGNED_MM"):
        monkeypatch.delenv(var, raising=False)
    jax_ps._tri_grouped_reset()
    yield
    jax_ps._tri_grouped_reset()


@pytest.fixture(scope="module")
def cases():
    """name -> (train, test, port kwargs, JAX kwargs, draws): the buckets in
    gather mode with the halo ring off and on, plain and under two
    ablations; and the empty-shard data in halo and in chunked reduce
    mode.  The JAX side takes solver vpu where the port's smart runs #8's
    plain version."""
    train, test = make_ratings(n_users=70, n_movies=45, density=0.3, seed=11)
    draws = recorded_draws(train, 6, N_ITERS)
    base = dict(num_latent=6, nsims=N_ITERS, burnin=1, gram_impl="bucketed")
    out = {}
    for ablate in ("", "nogather", "nogram"):
        for halo in ("off", "on"):
            name = "_".join(x for x in (ablate, "halo" if halo == "on" else "gather") if x)
            out[name] = (train, test, dict(base, halo=halo, ablate=ablate),
                         dict(solver="vpu"), draws)
    # 3 movies over 4 ranks: one rank owns none (float64 by the auto dtype)
    etrain, etest = make_ratings(n_users=40, n_movies=3, density=0.5, seed=4)
    edraws = recorded_draws(etrain, 4, N_ITERS)
    ebase = dict(num_latent=4, nsims=N_ITERS, burnin=1, gram_impl="bucketed")
    out["empty_halo"] = (etrain, etest, dict(ebase, halo="on"), {}, edraws)
    out["empty_chunked"] = (etrain, etest, dict(ebase, comm_mode="reduce",
                                                reduce_chunked="on"), {}, edraws)
    return out


@pytest.fixture(scope="module")
def port(cases):
    return port_results(cases)


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("pair", [("halo", "gather"), ("nogram_halo", "nogram_gather")],
                         ids=("plain", "nogram"))
def test_halo_equals_all_gather(port, pair, d):
    """--halo on against --halo off at d ranks: per-iteration metrics and
    both factor tables equal, bit for bit; the ring's D - 1 rounds a sweep
    take the place of the frozen side's all_gather."""
    on, off = (port[d][n] for n in pair)
    np.testing.assert_array_equal(on["metrics"], off["metrics"])
    for side in ("users", "movies"):
        np.testing.assert_array_equal(on[side], off[side])
    assert on["collectives"] == dict(
        off["collectives"], ppermute=2 * (d - 1) * N_ITERS,
        all_gather=off["collectives"]["all_gather"] - 2 * N_ITERS)


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("name", ["halo", "nogather_halo"])
def test_halo_matches_jax(cases, port, name, d):
    """The port at d ranks with --halo on against the JAX package at
    n_devices d with its halo exchange, within 2e-5, under ``nogather``
    too: there both read row 0 of the ring's buffer, which is zero on a
    rank whose buckets do not reference it."""
    got, want = port[d][name], jax_chain(cases, name, d)
    assert {s: r[0] for s, r in got["routes"].items()} == want["impl"]
    _agree(got, want, f"{name} at {d} ranks")


@pytest.mark.parametrize("name", ["empty_halo", "empty_chunked"])
def test_empty_shards(port, name):
    """3 movies over 4 ranks, one of which owns none: the halo ring and the
    chunked reduce (its empty destination still all-reduced by every rank)
    run on the one-rank chain, within 2e-5."""
    for d in (2, 4):
        _agree(port[d][name], port[1][name], f"{name}: {d} ranks against 1")


def test_halo_gather_matches_all_gather():
    """At 4 ranks on tests/test_spmd.py:337's matrix, each rank's ring
    buffer equals the table on every row its ratings reference and on its
    own shard, in 3 rounds of ppermute and no other collective."""
    for out in run_ranks(halo_check, 4, device="cpu", threads=1, timeout_s=600):
        assert out["needed"] == 0.0 and out["own"] == 0.0
        assert out["collectives"] == {"all_gather": 0, "all_reduce": 0,
                                      "reduce_scatter": 0, "ppermute": 3}


def _block_sparse():
    """64 users x 32 movies in 4 blocks: user block b rates only movie block
    b, so with -k (contiguous shards) each rank needs few foreign rows."""
    rng = np.random.default_rng(0)
    rows, cols = [], []
    for b in range(4):
        for u in range(16 * b, 16 * (b + 1)):
            for m in rng.choice(8, 4, replace=False):
                rows.append(u)
                cols.append(8 * b + m)
    # one foreign rating a block keeps the halo non-empty
    rows += [0, 17, 33, 49]
    cols += [31, 0, 8, 16]
    vals = rng.integers(1, 6, len(rows)).astype(np.float64)
    m = sp.csc_matrix((vals, (rows, cols)), shape=(64, 32))
    return m, sp.csc_matrix(m[:8])


@pytest.mark.parametrize("data", ["block_sparse", "dense"])
def test_halo_auto_matches_jax(data):
    """Under --halo auto at 4 devices, each side takes the ring exactly
    where the JAX package does (volume ratio at most 0.5), with its volume
    ratio, widest round and per-pair counts; the banner prints them."""
    train, test = (_block_sparse() if data == "block_sparse" else
                   make_ratings(n_users=70, n_movies=45, density=0.3, seed=11))
    kw = dict(num_latent=4, nsims=1, n_devices=4, gram_impl="bucketed",
              permute=False)
    ref = JaxBPMF(JaxConfig(**kw), train=train, test=test, out=open(os.devnull, "w"))
    ref.setup()
    log = []
    port = BPMF(Config(**kw), train, test, device="cpu",
                mesh=Mesh(rank=1, size=4, device=torch.device("cpu")))
    port._log = log.append
    port.setup()
    taken = []
    for jside, pside in ((ref.movies, port.movies), (ref.users, port.users)):
        assert (pside.halo is None) == (jside.halo is None)
        assert pside.exchange == ("gather" if jside.halo is None else "halo")
        if jside.halo is not None:
            taken.append(pside.name)
            assert pside.halo.volume_ratio == jside.halo.volume_ratio <= 0.5
            assert pside.halo.halo_rows == jside.halo.halo_rows
            np.testing.assert_array_equal(pside.halo.pair_counts,
                                          jside.halo.pair_counts)
            assert any(line.startswith(f"halo {pside.name}: <= ") for line in log)
    assert taken == ([] if data == "dense" else ["movs", "users"])
