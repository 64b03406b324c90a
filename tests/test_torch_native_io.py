"""The port's native matrix I/O (``bpmf_tpu_torch.io.native``) on the CPU:
its readers and writers against the port's pure-Python ones in every
format, both directions; files of the JAX package's pure-Python writer
read by it; its errors; ``sparse.bucketize`` filled natively against the
Python fill and the JAX package's; concurrent builds into one fresh
directory; and what ``native.status()`` reports.  Nothing here needs the
JAX package's own native library: its writer is held to Python."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from bpmf_tpu import sparse as jax_sparse
from bpmf_tpu.io import matrix_io as jax_io
from bpmf_tpu.io import native as jax_native
from bpmf_tpu_torch import sparse as port_sparse
from bpmf_tpu_torch.config import Config
from bpmf_tpu_torch.io import matrix_io as port_io
from bpmf_tpu_torch.io import native
from bpmf_tpu_torch.sampler import BPMF
from tests.conftest import make_ratings, tiny_matrices

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def native_on(monkeypatch):
    """Every test starts with the native library asked for."""
    monkeypatch.delenv("BPMF_NO_NATIVE", raising=False)


@pytest.fixture
def jax_python_io(monkeypatch):
    """The JAX package's readers and writers on their pure-Python paths,
    whether or not its own library built."""
    monkeypatch.setattr(jax_native, "LIB", None)
    monkeypatch.setattr(jax_native, "_tried", True)


def _matrix(fmt, seed=0):
    """A dense matrix over seven decades (ddm, array), or a sparse one with
    an empty last row and column."""
    rng = np.random.default_rng(seed)
    if fmt in ("ddm", "array"):
        return rng.normal(size=(11, 5)) * 10.0 ** rng.integers(-3, 4, (11, 5))
    x = sp.random(17, 9, density=0.3, random_state=seed, format="coo")
    x.data = rng.random(x.nnz) * 4 + 1
    x = sp.csc_matrix(x)
    x.resize((18, 10))
    return x


def _equal(got, want):
    if sp.issparse(want):
        assert sp.issparse(got) and got.shape == want.shape
        assert got.format == "csc"
        np.testing.assert_array_equal(got.toarray(), want.toarray())
    else:
        assert isinstance(got, np.ndarray) and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def _python(monkeypatch, fn, *args):
    """``fn(*args)`` with the port on its pure-Python path."""
    with monkeypatch.context() as m:
        m.setenv("BPMF_NO_NATIVE", "1")
        assert native.get_lib() is None
        return fn(*args)


BINARY = ["sdm", "sbm", "ddm", "sdm.gz", "sbm.gz", "ddm.gz"]


@pytest.mark.parametrize("writer", ["native", "python"])
@pytest.mark.parametrize("ext", BINARY)
def test_binary_formats_native_against_python(tmp_path, monkeypatch, ext, writer):
    """One writes, the other reads, and the matrix comes back equal; the
    native reader reads its own file the same.  Plain files are byte for
    byte the same from both writers."""
    x = _matrix(ext.split(".")[0])
    if ext.startswith("sbm"):
        x.data[:] = 1.0
    path = str(tmp_path / f"m.{ext}")
    if writer == "native":
        port_io.write_matrix(path, x)
        got = _python(monkeypatch, port_io.read_matrix, path)
    else:
        _python(monkeypatch, port_io.write_matrix, path, x)
        got = port_io.read_matrix(path)
    _equal(got, x)
    _equal(port_io.read_matrix(path), x)
    if not ext.endswith(".gz"):
        other = str(tmp_path / f"o.{ext}")
        if writer == "native":
            _python(monkeypatch, port_io.write_matrix, other, x)
        else:
            port_io.write_matrix(other, x)
        assert open(path, "rb").read() == open(other, "rb").read()


@pytest.mark.parametrize("kind", ["sparse", "pattern", "array", "sparse.gz"])
def test_mtx_native_against_python(tmp_path, monkeypatch, kind):
    """MatrixMarket (coordinate, pattern, array, gzipped): the native
    tokenizer reads what the Python reader reads."""
    gz = kind.endswith(".gz")
    base = kind.removesuffix(".gz")
    x = _matrix("array" if base == "array" else "sdm", seed=2)
    path = str(tmp_path / ("m.mtx.gz" if gz else "m.mtx"))
    if base == "pattern":
        coo = x.tocoo()
        body = "".join(f"{r + 1} {c + 1}\n" for r, c in zip(coo.row, coo.col))
        with open(path, "w") as f:
            f.write("%%MatrixMarket matrix coordinate pattern general\n"
                    f"% a comment\n{x.shape[0]} {x.shape[1]} {coo.nnz}\n{body}")
        x = sp.csc_matrix((np.ones(coo.nnz), (coo.row, coo.col)), shape=x.shape)
    else:
        port_io.write_matrix(path, x)
    want = _python(monkeypatch, port_io.read_matrix, path)
    out = native.read_mtx(path)
    assert out[0] == ("dense" if base == "array" else "sparse")
    _equal(port_io.read_matrix(path), want)
    _equal(want, x)


@pytest.mark.parametrize("ext", ["sdm", "sbm", "ddm", "sdm.gz", "ddm.gz", "mtx"])
def test_reads_jax_python_writer(tmp_path, jax_python_io, ext):
    """Files of the JAX package's pure-Python writer read by the port's
    native reader as the JAX package's Python reader reads them; the plain
    binary files are the bytes the port's native writer writes."""
    x = _matrix(ext.split(".")[0], seed=5)
    if ext == "sbm":
        x.data[:] = 1.0
    path = str(tmp_path / f"j.{ext}")
    jax_io.write_matrix(path, x)
    assert native.get_lib() is not None
    _equal(port_io.read_matrix(path), jax_io.read_matrix(path))
    if ext in ("sdm", "sbm", "ddm"):
        mine = str(tmp_path / f"p.{ext}")
        port_io.write_matrix(mine, x)
        assert open(mine, "rb").read() == open(path, "rb").read()


@pytest.mark.parametrize("what", ["header", "indices", "mtx"])
def test_errors_on_garbage(tmp_path, what):
    """The library names what is wrong with a file; ``read_matrix`` then
    hands it to the Python reader, which raises as it always has."""
    if what == "mtx":
        path = tmp_path / "g.mtx"
        path.write_text("this is not a matrix\n1 2 3\n")
        with pytest.raises(IOError, match="not a MatrixMarket file"):
            native.read_mtx(str(path))
        with pytest.raises(ValueError, match="not a MatrixMarket file"):
            port_io.read_matrix(str(path))
        return
    path = tmp_path / "g.sdm"
    if what == "header":
        path.write_bytes(b"garbage")
        message = "truncated header"
    else:
        path.write_bytes(np.asarray([3, 3, 1000], "<u8").tobytes() + b"\1" * 40)
        message = "truncated indices"
    with pytest.raises(IOError, match=message):
        native.read_sparse_bin(str(path), pattern=False)
    with pytest.raises(ValueError, match="truncated binary matrix file"):
        port_io.read_matrix(str(path))


@pytest.mark.parametrize("width", [8, 2048])
def test_bucketize_native_fill(monkeypatch, width):
    """Native ``fill_bucket`` against the Python fill and the JAX package's
    ``bucketize``, both sides, items with no rating among them; at width 8
    the most-rated items split over rows."""
    train, _ = make_ratings(n_users=60, n_movies=45, density=0.4, seed=6)
    train = sp.csc_matrix(train)
    train.resize((61, 46))          # a user and a movie with no rating
    train = sp.csc_matrix(train)
    for m in (train, sp.csc_matrix(train.T)):
        ids = np.arange(m.shape[1], dtype=np.int32)
        assert native.get_lib() is not None
        got = port_sparse.bucketize(m, ids, -1, max_bucket_width=width)
        plain = _python(monkeypatch, port_sparse.bucketize, m, ids, -1, 8, width)
        want = jax_sparse.bucketize(m, ids, -1, max_bucket_width=width)
        assert len(got.buckets) == len(plain.buckets) == len(want.buckets)
        assert any(b.split for b in got.buckets) == (width == 8)
        for g, p, w in zip(got.buckets, plain.buckets, want.buckets):
            for f in ("nbr", "val", "mask", "row_slot", "item_ids", "orig_ids",
                      "slot_valid"):
                for other in (p, w):
                    np.testing.assert_array_equal(getattr(g, f), getattr(other, f),
                                                  err_msg=f)
                    assert getattr(g, f).dtype == getattr(other, f).dtype, f
            assert g.split == p.split == w.split


def test_fill_bucket_overflow_raises():
    """Items that need more rows than the arrays hold: ValueError, as the
    JAX package's loader raises."""
    m = sp.csc_matrix(np.ones((10, 3)))
    nbr = np.zeros((2, 4), np.int32)
    with pytest.raises(ValueError, match="capacity overflow"):
        native.fill_bucket(m.indptr.astype(np.int64), m.indices.astype(np.int32),
                           m.data.astype(np.float64),
                           np.arange(3, dtype=np.int32), 4, nbr,
                           np.zeros((2, 4)), np.zeros((2, 4), np.float32),
                           np.full(2, 7, np.int32))


def test_concurrent_builds_into_a_fresh_directory(tmp_path):
    """Four processes build the library into one empty directory at once:
    each loads a whole library, and the directory ends with that one
    library and no temporary file."""
    build_dir = tmp_path / "build"
    go = tmp_path / "go"
    code = textwrap.dedent(f"""
        import os, sys, time
        from pathlib import Path
        import bpmf_tpu_torch.io.native as native
        native.BUILD_DIR = Path({str(build_dir)!r})
        while not os.path.exists({str(go)!r}):
            time.sleep(0.001)
        assert native.get_lib() is not None, native.status()
        assert native.read_mtx is not None
        print(native.status())
    """)
    env = {k: v for k, v in os.environ.items() if k != "BPMF_NO_NATIVE"}
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    go.touch()
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == f"native {build_dir}/{native.library_path().name}"
    assert sorted(os.listdir(build_dir)) == [native.library_path().name]


def test_status_reports_native_and_the_switch(tmp_path, monkeypatch):
    """``native <path>`` on this box; ``BPMF_NO_NATIVE`` turns it off, says
    so, and the readers still read."""
    assert native.status() == f"native {native.library_path()}"
    assert native.library_path().parent == native.BUILD_DIR
    path = str(tmp_path / "t.sdm")
    x = _matrix("sdm")
    port_io.write_matrix(path, x)
    monkeypatch.setenv("BPMF_NO_NATIVE", "1")
    assert native.get_lib() is None
    assert native.status() == "python: BPMF_NO_NATIVE is set"
    _equal(port_io.read_matrix(path), x)
    with pytest.raises(RuntimeError, match="BPMF_NO_NATIVE"):
        native.read_sparse_bin(path, pattern=False)


def test_build_failure_is_reported(tmp_path, monkeypatch):
    """A source that does not compile: the compiler's message in
    ``status()``, no library, and the Python readers read."""
    bad = tmp_path / "matrix_io.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_loaded", None)
    assert native.get_lib() is None
    st = native.status()
    assert st.startswith("python: g++ ") and "error" in st, st
    assert os.listdir(tmp_path / "build") == []      # the temporary file went
    path = str(tmp_path / "t.ddm")
    x = _matrix("ddm")
    port_io.write_matrix(path, x)
    _equal(port_io.read_matrix(path), x)


def test_banner_prints_status():
    """The sampler's banner names the matrix I/O path."""
    import io

    train, test = tiny_matrices()
    out = io.StringIO()
    s = BPMF(Config(nsims=1, num_latent=2), train, test, device="cpu", out=out)
    s.setup()
    assert f"matrix I/O: native {native.library_path()}" in out.getvalue()
    assert torch.isfinite(s.state_m.items).all()
