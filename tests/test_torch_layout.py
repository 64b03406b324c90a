"""The port's copies of the JAX package's modules are pinned to their
originals: the layout helpers and routing gates (``bpmf_tpu.ops.dense8``
and ``bpmf_tpu.ops.pallas_solve`` import jax), and the host modules the
port keeps its own copies of (it imports nothing of the JAX package):
``config``, ``io``, ``datasets``, ``sparse``, ``parallel.partition``,
``utils.counters`` and the CLI parser."""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp

from bpmf_tpu import cli as jax_cli
from bpmf_tpu import config as jax_config
from bpmf_tpu import datasets as jax_datasets
from bpmf_tpu import io as jax_io
from bpmf_tpu import sparse as jax_sparse
from bpmf_tpu.models import bpmf as jax_model
from bpmf_tpu.ops import dense8 as jax_d8
from bpmf_tpu.ops import pallas_solve as jax_ps
from bpmf_tpu.parallel import partition as jax_part
from bpmf_tpu.utils import counters as jax_counters
from bpmf_tpu_torch import cli as port_cli
from bpmf_tpu_torch import config as port_config
from bpmf_tpu_torch import datasets as port_datasets
from bpmf_tpu_torch import io as port_io
from bpmf_tpu_torch import sparse as port_sparse
from bpmf_tpu_torch.models import bpmf as port_model
from bpmf_tpu_torch.ops import dense8 as port_d8
from bpmf_tpu_torch.ops import pallas_solve as port_ps
from bpmf_tpu_torch.parallel import partition as port_part
from bpmf_tpu_torch.utils import counters as port_counters
from tests.conftest import make_ratings

VALUE_SETS = {
    "integers": np.asarray([1.0, 2.0, 3.0, 4.0, 5.0, 3.0, 1.0]),
    "half_stars": np.asarray([0.5, 1.0, 3.5, 5.0, 4.5]),
    "single": np.asarray([2.5, 2.5]),
    "offset_grid": np.asarray([-1.25, 0.0, 2.5, 3.75]),
    "continuous": np.random.default_rng(0).normal(size=300),
    "too_many": np.arange(1, 300, dtype=np.float64),
    "wide_int16": np.arange(1, 200, dtype=np.float64),
    "empty": np.zeros(0),
}


def test_block_multiple():
    assert port_d8.BLOCK_MULTIPLE == jax_d8.BLOCK_MULTIPLE


@pytest.mark.parametrize("name", sorted(VALUE_SETS))
def test_quantize_values_matches(name):
    vals = VALUE_SETS[name]
    want = jax_d8.quantize_values(vals)
    got = port_d8.quantize_values(vals)
    assert (got is None) == (want is None)
    if want is not None:
        assert tuple(got) == tuple(want)


@pytest.mark.parametrize("name", ["integers", "half_stars", "offset_grid",
                                  "wide_int16"])
def test_build_code_array_matches(name):
    vals = VALUE_SETS[name]
    rng = np.random.default_rng(1)
    pos = rng.permutation(64 * 48)[:len(vals)]  # distinct entries
    rows, cols = pos // 48, pos % 48
    q = jax_d8.quantize_values(vals)
    want = jax_d8.build_code_array(rows, cols, vals, q, 64, 48)
    got = port_d8.build_code_array(rows, cols, vals,
                                   port_d8.Quantization(*q), 64, 48)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [1, 4, 16, 32])
def test_aggr_pair_indices_match(k):
    for got, want in zip(port_model.aggr_pair_indices(k),
                         jax_model.aggr_pair_indices(k)):
        np.testing.assert_array_equal(got, want)


@pytest.fixture
def ungrouped(monkeypatch):
    """The JAX package's bottom-padded layout (its default), unpinned."""
    monkeypatch.delenv("BPMF_TRI_GROUPED", raising=False)
    jax_ps._tri_grouped_reset()
    yield
    jax_ps._tri_grouped_reset()


@pytest.mark.parametrize("k", [1, 3, 8, 10, 16, 32, 64, 79])
def test_tri_layouts_match(k, ungrouped):
    assert port_ps.tri_offsets(k) == jax_ps.tri_offsets(k)
    assert port_d8._tight_offsets(k) == jax_d8._tight_offsets(k)
    pairs = [(port_ps.tri_index_pairs(k), jax_ps.tri_index_pairs(k)),
             (port_ps.tri_tight_pairs(k), jax_ps.tri_tight_pairs(k)),
             (port_d8._aligned_pairs(k), jax_d8._aligned_pairs(k))]
    for got, want in pairs:
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("k", [8, 10, 16, 32, 64])
def test_grouped_layouts_match(k, monkeypatch):
    """The top-aligned layout of BPMF_TRI_GROUPED=1 (the JAX package pins
    it for K % 8 == 0; the port takes it as ``grouped``): the index pairs,
    the prior rhs routing and the packed prior."""
    monkeypatch.setenv("BPMF_TRI_GROUPED", "1")
    jax_ps._tri_grouped_reset()
    try:
        grouped = jax_ps.tri_grouped(k)
        assert grouped == (k % 8 == 0)
        for g, w in zip(port_ps.tri_index_pairs(k, grouped=grouped),
                        jax_ps.tri_index_pairs(k)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        for g, w in zip(port_ps._prior_rhs_consts(k, grouped),
                        jax_ps._prior_rhs_consts(k, grouped)):
            np.testing.assert_array_equal(g, w)
        lam = np.random.default_rng(k).normal(size=(5, k, k))
        np.testing.assert_array_equal(port_ps.pack_prior_tri(lam, k, grouped),
                                      jax_ps.pack_prior_tri(lam, k))
    finally:
        jax_ps._tri_grouped_reset()


def test_gates_match():
    for k in range(1, 101):
        for peritem in (False, True):
            assert (port_ps.tri_fused_supported(k, peritem)
                    == jax_ps.tri_fused_supported(k, peritem)), (k, peritem)
        for layout in ("aligned", "tight"):
            assert (port_d8.solve_fused_supported(k, layout)
                    == jax_d8.solve_fused_supported(k, layout)), (k, layout)


def test_solve_fused_mode_matches(monkeypatch):
    for value in ("fused", "fused_aligned", "split", "other"):
        monkeypatch.setenv("BPMF_D8_SOLVE", value)
        assert port_d8.solve_fused_mode(value) == jax_d8.solve_fused_mode()


@pytest.mark.parametrize("pt", ["auto", "inkernel", "hoisted"])
def test_pt_mode_matches(pt, monkeypatch):
    """Over the ml-1m, chembl and ml-25M padded shapes and both routes."""
    monkeypatch.delenv("BPMF_D8_BLOCKS", raising=False)
    if pt == "auto":
        monkeypatch.delenv("BPMF_D8_PT", raising=False)
    else:
        monkeypatch.setenv("BPMF_D8_PT", pt)
    shapes = [(6144, 4096), (167424, 512), (162816, 59392), (512, 1536)]
    for r, c in shapes:
        for k in (8, 10, 16, 32, 41, 64, 79):
            for fused in (False, True):
                for items, frozen, o in ((r, c, "rows"), (c, r, "cols")):
                    assert (port_d8.pt_mode(items, frozen, k, fused, o, pt)
                            == jax_d8.pt_mode(items, frozen, k, fused, o)), (
                        items, frozen, k, fused, o)


def test_config_copy_matches():
    """Same fields, defaults and resolutions; the same values refused."""
    want = [(f.name, f.default) for f in dataclasses.fields(jax_config.Config)]
    assert [(f.name, f.default)
            for f in dataclasses.fields(port_config.Config)] == want
    for dtype in ("auto", "float32", "float64"):
        for solver in ("auto", "xla", "vpu", "smart", "unrolled", "pallas"):
            for k, side in ((32, 10), (32, 6040), (8, 3)):
                pair = [m.Config(num_latent=k, dtype=dtype, solver=solver)
                        for m in (jax_config, port_config)]
                assert (pair[0].resolve_dtype(side)
                        == pair[1].resolve_dtype(side))
                for backend in ("tpu", "cpu", "gpu"):
                    got = []
                    for c in pair:
                        try:
                            got.append(c.resolve_solver(backend))
                        except ValueError as e:
                            got.append(str(e))
                    assert got[0] == got[1]
                    assert (pair[0].resolve_matmul_dtype(backend)
                            == pair[1].resolve_matmul_dtype(backend))
    for bad in (dict(dtype="half"), dict(solver="lu"), dict(gram_impl="csr"),
                dict(num_latent=0), dict(ablate="nothing"),
                dict(fuse_dense="maybe"), dict(comm_mode="ring")):
        for m in (jax_config, port_config):
            with pytest.raises(ValueError):
                m.Config(**bad)


@pytest.mark.parametrize("name,dense", [
    ("m.mtx", False), ("m.mtx.gz", False), ("m.sdm", False),
    ("m.sdm.gz", False), ("m.sbm", False), ("d.mtx", True), ("d.ddm", True),
    ("d.ddm.gz", True), ("d.csv", True),
])
def test_matrix_io_copy_matches(tmp_path, name, dense):
    """Files written by either package read back the same in both."""
    rng = np.random.default_rng(3)
    if dense:
        x = np.round(rng.normal(size=(5, 4)), 3)
    else:
        x = sp.random(9, 7, density=0.3, random_state=4, format="csc")
        if name.startswith("m.sbm"):
            x.data[:] = 1.0
    for writer in (jax_io, port_io):
        path = str(tmp_path / name)
        writer.write_matrix(path, x)
        got = [reader.read_matrix(path) for reader in (jax_io, port_io)]
        if dense:
            np.testing.assert_array_equal(got[1], got[0])
        else:
            assert (got[1] != got[0]).nnz == 0 and got[1].shape == got[0].shape


def test_datasets_copy_matches():
    for fn, kw in ((
            "synth_movielens", dict(n_users=80, n_movies=50, n_ratings=900, seed=2)),
            ("synth_chembl", dict(n_compounds=300, n_proteins=20, n_ratings=900))):
        want = getattr(jax_datasets, fn)(**kw)
        got = getattr(port_datasets, fn)(**kw)
        for g, w in zip(got, want):
            assert (g != w).nnz == 0 and g.shape == w.shape


@pytest.mark.parametrize("width", [2048, 8])
def test_bucket_layouts_match(width):
    """bucketize, build_gather_layout and build_dense_layout give the JAX
    package's arrays on the conftest synthetics (both sides); at width 8
    the buckets split."""
    train, _ = make_ratings(n_users=60, n_movies=45, density=0.4)
    fields = ("nbr", "val", "mask", "row_slot", "item_ids", "orig_ids",
              "slot_valid", "split")
    for side_m, other_num in ((train, 60), (train.T.tocsc(), 45)):
        num = side_m.shape[1]
        ids = np.arange(num, dtype=np.int32)
        for g, w in zip(
                port_sparse.bucketize(side_m, ids, -1, max_bucket_width=width).buckets,
                jax_sparse.bucketize(side_m, ids, -1, max_bucket_width=width).buckets):
            for f in fields:
                np.testing.assert_array_equal(getattr(g, f), getattr(w, f), f)
        maps = [m.make_maps([ids], num) for m in (jax_part, port_part)]
        other = [m.make_maps([np.arange(other_num, dtype=np.int32)], other_num)
                 for m in (jax_part, port_part)]
        for f in ("local_pad", "orig_to_padded", "local_orig", "local_valid"):
            np.testing.assert_array_equal(getattr(maps[1], f), getattr(maps[0], f))
        want = jax_part.build_gather_layout(side_m, maps[0], other[0].orig_to_padded,
                                            width, 2)
        got = port_part.build_gather_layout(side_m, maps[1], other[1].orig_to_padded,
                                            width, 2)
        assert got.splits == want.splits and any(got.splits) == (width == 8)
        for g, w in zip(got.buckets, want.buckets):
            for f in fields:
                np.testing.assert_array_equal(getattr(g, f), getattr(w, f), f)
        np.testing.assert_array_equal(
            port_part.build_dense_layout(side_m, maps[1], other[1].orig_to_padded,
                                         other[1].padded_num),
            jax_part.build_dense_layout(side_m, maps[0], other[0].orig_to_padded,
                                        other[0].padded_num))


def test_assign_items_copy_matches():
    degrees = np.random.default_rng(5).integers(0, 40, size=50)
    for n_dev in (1, 3):
        for balance in (True, False):
            for g, w in zip(port_part.assign_items(degrees, n_dev, balance),
                            jax_part.assign_items(degrees, n_dev, balance)):
                np.testing.assert_array_equal(g, w)


BUCKET_FIELDS = ("nbr", "val", "mask", "row_slot", "item_ids", "orig_ids",
                 "slot_valid", "split")


def _multi_maps(module, degrees, n_dev, multiple, balance=True):
    ids = module.assign_items(degrees, n_dev, balance)
    return module.make_maps(ids, len(degrees), multiple=multiple)


@pytest.mark.parametrize("multiple", [None, 512], ids=["pad8", "dense8"])
@pytest.mark.parametrize("n_dev", [3, 4])
def test_make_maps_copy_matches_at_d(n_dev, multiple):
    """make_maps over n_dev devices, with and without the dense8 block
    multiple, LPT and contiguous assignment: every field the JAX
    package's."""
    degrees = np.random.default_rng(n_dev).integers(0, 60, size=301)
    for balance in (True, False):
        want = _multi_maps(jax_part, degrees, n_dev, multiple, balance)
        got = _multi_maps(port_part, degrees, n_dev, multiple, balance)
        assert (got.n_devices, got.num, got.local_pad, got.padded_num) == (
            want.n_devices, want.num, want.local_pad, want.padded_num)
        for f in ("orig_to_padded", "local_orig", "local_valid"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)
        for g, w in zip(got.ids_per_dev, want.ids_per_dev):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("width", [2048, 8])
@pytest.mark.parametrize("n_dev", [3, 4])
def test_multi_device_layouts_match(n_dev, width):
    """At n_dev devices, both sides: build_gather_layout (its stacked
    [D, ...] buckets, split at width 8), build_dense_layout and each of its
    rows alone (build_dense_block, what one rank builds), the JAX
    package's arrays."""
    train, _ = make_ratings(n_users=60, n_movies=45, density=0.4, seed=n_dev)
    sides = ((train, train.T.tocsc()), (train.T.tocsc(), train))
    for side_m, other_m in sides:
        num, other_num = side_m.shape[1], other_m.shape[1]
        deg, odeg = np.diff(side_m.indptr), np.diff(other_m.indptr)
        maps = [_multi_maps(m, deg, n_dev, None) for m in (jax_part, port_part)]
        other = [_multi_maps(m, odeg, n_dev, None) for m in (jax_part, port_part)]
        want = jax_part.build_gather_layout(side_m, maps[0], other[0].orig_to_padded,
                                            width, 2)
        got = port_part.build_gather_layout(side_m, maps[1], other[1].orig_to_padded,
                                            width, 2)
        assert got.splits == want.splits and any(got.splits) == (width == 8)
        for g, w in zip(got.buckets, want.buckets):
            assert g.nbr.shape[0] == n_dev
            for f in BUCKET_FIELDS:
                np.testing.assert_array_equal(getattr(g, f), getattr(w, f), f)
        dense = jax_part.build_dense_layout(side_m, maps[0], other[0].orig_to_padded,
                                            other[0].padded_num)
        np.testing.assert_array_equal(
            port_part.build_dense_layout(side_m, maps[1], other[1].orig_to_padded,
                                         other[1].padded_num), dense)
        for d in range(n_dev):
            np.testing.assert_array_equal(
                port_part.build_dense_block(side_m, maps[1], other[1].orig_to_padded,
                                            other[1].padded_num, d), dense[d])
        assert num == maps[1].num and other_num == other[1].num


def _stacked_equal(got, want, n_dev):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.nbr.shape[0] == n_dev and g.split == w.split
        for f in BUCKET_FIELDS:
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f), f)


@pytest.mark.parametrize("layout", ["halo", "reduce", "reduce_chunked"])
@pytest.mark.parametrize("n_dev", [2, 3, 4])
def test_exchange_layouts_match(n_dev, layout):
    """At n_dev devices, both sides, on a sparse matrix (the halo's rows
    differ by pair) at bucket width 8 (split buckets): build_halo_layout's
    per-round tables, pair counts, widest round and volume ratio;
    build_reduce_layout's and build_reduce_layout_chunked's stacked buckets
    (of every destination), the JAX package's.  At 4 devices the movies
    are 3: one shard of each side's other side is empty, and so is one
    destination of the chunked layout."""
    train, _ = make_ratings(n_users=60, n_movies=3 if n_dev == 4 else 45,
                            density=0.3 if n_dev == 4 else 0.4, seed=n_dev)
    sides = ((train, train.T.tocsc()), (train.T.tocsc(), train))
    for side_m, other_m in sides:
        deg, odeg = np.diff(side_m.indptr), np.diff(other_m.indptr)
        maps = [_multi_maps(m, deg, n_dev, None) for m in (jax_part, port_part)]
        other = [_multi_maps(m, odeg, n_dev, None) for m in (jax_part, port_part)]
        if layout == "halo":
            want = jax_part.build_halo_layout(side_m, maps[0], other[0])
            got = port_part.build_halo_layout(side_m, maps[1], other[1])
            assert len(got.send_rows) == n_dev - 1
            for g, w in zip(got.send_rows + got.recv_pos, want.send_rows + want.recv_pos):
                np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(got.pair_counts, want.pair_counts)
            assert (got.halo_rows, got.volume_ratio) == (want.halo_rows, want.volume_ratio)
        elif layout == "reduce":
            want = jax_part.build_reduce_layout(
                side_m, maps[0].orig_to_padded, maps[0].padded_num,
                other[0].ids_per_dev, 8, 2)
            got = port_part.build_reduce_layout(
                side_m, maps[1].orig_to_padded, maps[1].padded_num,
                other[1].ids_per_dev, 8, 2)
            assert got.splits == want.splits
            _stacked_equal(got.buckets, want.buckets, n_dev)
        else:
            want = jax_part.build_reduce_layout_chunked(
                side_m, maps[0], other[0].ids_per_dev, 8, 2)
            got = port_part.build_reduce_layout_chunked(
                side_m, maps[1], other[1].ids_per_dev, 8, 2)
            assert len(got.per_dest) == n_dev
            for (gb, gs), (wb, ws) in zip(got.per_dest, want.per_dest):
                assert gs == ws
                _stacked_equal(gb, wb, n_dev)
            if side_m.shape[1] < n_dev:
                # 3 movies over 4 devices: one destination holds none
                assert got.per_dest[-1] == ([], ())


@pytest.mark.parametrize("n_dev", [3, 4])
def test_stack_buckets_copy_matches_at_d(n_dev):
    """stack_buckets on per-device bucket lists of different widths and
    counts (a device may lack a width: it gets an empty bucket), the JAX
    package's stacked arrays and split flags."""
    train, _ = make_ratings(n_users=60, n_movies=45, density=0.4, seed=5)
    num = train.shape[1]
    rng = np.random.default_rng(n_dev)
    ids = np.array_split(rng.permutation(num).astype(np.int32), n_dev)
    out = []
    for sparse, part in ((jax_sparse, jax_part), (port_sparse, port_part)):
        per_dev = [sparse.bucketize(train, np.sort(i), -1, max_bucket_width=8 << d,
                                    growth=2).buckets
                   for d, i in enumerate(ids)]
        out.append(part.stack_buckets(per_dev, [len(i) for i in ids], num))
    (want, want_splits), (got, got_splits) = out
    assert got_splits == want_splits and len(got) == len(want)
    for g, w in zip(got, want):
        for f in BUCKET_FIELDS:
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f), f)


def test_counters_copy_matches():
    reports = []
    for m in (jax_counters, port_counters):
        c = m.Counters(enabled=True)
        with c.scope("main"):
            with c.scope("sweep"):
                pass
        reports.append([line.split()[0] for line in c.report().splitlines()])
        assert m.tick() <= m.tick()
    assert reports[0] == reports[1]


def test_cli_copy_matches():
    """The port's parser takes every flag of the JAX package's, with the
    same defaults, and builds the same Config; it adds --device and
    --fuse-dense."""
    want = {a.dest: a.default for a in jax_cli.build_parser()._actions}
    got = {a.dest: a.default for a in port_cli.build_parser()._actions}
    assert set(got) - set(want) == {"device", "fuse_dense"}
    assert {d: got[d] for d in want} == want
    argv = ["-n", "a.mtx", "-p", "b.mtx", "-d", "16", "--solver", "vpu",
            "--gram-impl", "bucketed", "--diagonal-only", "--dtype", "float64",
            "-k", "--seed", "3", "--chunk", "4"]
    assert (port_cli.config_from_args(port_cli.build_parser().parse_args(argv))
            == port_config.Config(**dataclasses.asdict(
                jax_cli.config_from_args(jax_cli.build_parser().parse_args(argv)))))


def test_ablation_and_checkpoint_pins():
    """The ablations the port takes are the JAX package's (its config and
    its CLI), the ones that keep the dense8 and fused dense routes are
    those of bpmf_tpu/sampler.py:296-297 and :486-487, and the checkpoint
    format version is the JAX package's."""
    from bpmf_tpu import checkpoint as jax_ckpt
    from bpmf_tpu_torch import checkpoint as port_ckpt
    from bpmf_tpu_torch.sampler import FAST_ROUTE_ABLATIONS, PHASE_NAMES

    allowed = ("nogather", "nogram", "nomatmul", "nosolve", "nopredict",
               "nohyper", "nonoise")
    for m in (jax_config, port_config):
        for a in allowed + ("nohyper,nonoise",):
            m.Config(ablate=a)
    choices = [next(x.choices for x in m.build_parser()._actions
                    if x.dest == "ablate") for m in (jax_cli, port_cli)]
    assert choices[0] == choices[1] and set(choices[1]) == {""} | set(allowed)
    assert FAST_ROUTE_ABLATIONS == ("", "nopredict", "nomatmul", "nosolve",
                                    "nohyper", "nonoise")
    assert set(PHASE_NAMES) == set(allowed) - {"nogram"}
    assert port_ckpt.FORMAT_VERSION == jax_ckpt.FORMAT_VERSION


def test_dataset_hash_copy_matches():
    """The port's dataset_hash is the JAX package's on the same matrices."""
    from bpmf_tpu import checkpoint as jax_ckpt
    from bpmf_tpu_torch import checkpoint as port_ckpt

    class Data:
        def __init__(self, seed):
            self.train, self.test = (sp.csc_matrix(m) for m in make_ratings(seed=seed))

    for seed in (0, 1):
        assert port_ckpt.dataset_hash(Data(seed)) == jax_ckpt.dataset_hash(Data(seed))
    assert port_ckpt.dataset_hash(Data(0)) != port_ckpt.dataset_hash(Data(1))
