"""Matrix readers/writers, byte-compatible with the reference I/O layer.

The reference (c++/io.cpp) dispatches on file extension and supports five
formats, each optionally gzip-compressed (c++/io.cpp:31-77):

* ``.mtx`` / ``.mm``  MatrixMarket: coordinate (sparse, ``real`` or
  ``pattern``) and array (dense) variants, 1-based indices
  (c++/io.cpp:318-522).
* ``.sdm``  sparse binary double: u64 nrow, u64 ncol, u64 nnz, then
  u32 rows[nnz] (1-based), u32 cols[nnz] (1-based), f64 vals[nnz]
  (c++/io.cpp:256-288, writer :626-653).
* ``.sbm``  sparse binary pattern: same header + rows + cols, no values;
  all values are 1.0 (c++/io.cpp:290-314, writer :655-682).
* ``.ddm``  dense binary double: u64 nrow, u64 ncol, f64 data in
  column-major order (c++/io.cpp:195-205, writer :607-615).
* ``.csv``  dense: first line nrow, second line ncol, then nrow lines of
  comma-separated values (row-major) (c++/io.cpp:207-254, writer :619-624).

All binary fields are little-endian (x86 reference writes native).  Sparse
matrices are returned as ``scipy.sparse.csc_matrix`` (the analog of Eigen's
default column-major SparseMatrix), dense as C-ordered ``numpy.ndarray``.

Copy of ``bpmf_tpu/io/matrix_io.py``.  The binary formats and
MatrixMarket are read, and the binary formats written, by the native C++
library (:mod:`bpmf_tpu_torch.io.native`) where it builds; this module is
the always-available pure-Python implementation, which gives the same
matrices, and the arbiter of the on-disk layout.
"""

from __future__ import annotations

import gzip
import os

import numpy as np
import scipy.sparse as sp

from bpmf_tpu_torch.io import native

__all__ = [
    "read_matrix",
    "write_matrix",
    "read_dense",
    "read_sparse",
]

_SPARSE_EXTS = {".mtx", ".mm", ".sdm", ".sbm"}
_DENSE_EXTS = {".ddm", ".csv"}


def _split_ext(path: str) -> tuple[str, bool]:
    """Return (format extension, is_gzipped) — mirrors ExtensionToMatrixType
    (c++/io.cpp:31-77)."""
    base = path
    gz = False
    if base.endswith(".gz"):
        gz = True
        base = base[: -len(".gz")]
    _, ext = os.path.splitext(base)
    ext = ext.lower()
    if ext not in _SPARSE_EXTS | _DENSE_EXTS:
        raise ValueError(f"Unknown matrix extension {ext!r} for {path!r}")
    return ext, gz


def _open_read(path: str, gz: bool, text: bool):
    if gz:
        return gzip.open(path, "rt" if text else "rb")
    return open(path, "r" if text else "rb")


def _open_write(path: str, gz: bool, text: bool):
    if gz:
        return gzip.open(path, "wt" if text else "wb")
    return open(path, "w" if text else "wb")


# ---------------------------------------------------------------------------
# MatrixMarket
# ---------------------------------------------------------------------------


def _read_mtx(f) -> sp.csc_matrix | np.ndarray:
    header = f.readline()
    if not header.startswith("%%MatrixMarket"):
        raise ValueError("not a MatrixMarket file")
    tokens = header.strip().split()
    if len(tokens) < 4 or tokens[1].lower() != "matrix":
        raise ValueError(f"bad MatrixMarket header: {header!r}")
    fmt = tokens[2].lower()  # coordinate | array
    field = tokens[3].lower()  # real | integer | pattern
    sym = tokens[4].lower() if len(tokens) > 4 else "general"
    if sym != "general":
        raise ValueError(f"unsupported MatrixMarket symmetry {sym!r}")

    line = f.readline()
    while line.startswith("%") or not line.strip():
        line = f.readline()

    if fmt == "coordinate":
        dims = line.split()
        nrow, ncol, nnz = int(dims[0]), int(dims[1]), int(dims[2])
        rows = np.empty(nnz, dtype=np.int64)
        cols = np.empty(nnz, dtype=np.int64)
        vals = np.ones(nnz, dtype=np.float64)
        pattern = field == "pattern"
        k = 0
        for line in f:
            line = line.strip()
            if not line or line.startswith("%"):
                continue
            parts = line.split()
            rows[k] = int(parts[0]) - 1
            cols[k] = int(parts[1]) - 1
            if not pattern:
                vals[k] = float(parts[2])
            k += 1
        if k != nnz:
            raise ValueError(f"expected {nnz} entries, read {k}")
        return sp.csc_matrix((vals, (rows, cols)), shape=(nrow, ncol))

    if fmt == "array":
        dims = line.split()
        nrow, ncol = int(dims[0]), int(dims[1])
        data = np.empty(nrow * ncol, dtype=np.float64)
        k = 0
        for line in f:
            line = line.strip()
            if not line or line.startswith("%"):
                continue
            data[k] = float(line)
            k += 1
        if k != nrow * ncol:
            raise ValueError(f"expected {nrow * ncol} values, read {k}")
        # array format is column-major (c++/io.cpp write_matrix_market)
        return data.reshape((nrow, ncol), order="F").copy()

    raise ValueError(f"unsupported MatrixMarket format {fmt!r}")


def _write_mtx_sparse(f, X: sp.spmatrix) -> None:
    X = X.tocoo()
    f.write("%%MatrixMarket matrix coordinate real general\n")
    f.write(f"{X.shape[0]} {X.shape[1]} {X.nnz}\n")
    # one joined write: a per-entry f.write(f-string) loop crawls at
    # tens-of-MB outputs (dominated by the per-line write call)
    if X.nnz:
        body = "\n".join(
            "%d %d %.17g" % t
            for t in zip(X.row + 1, X.col + 1, X.data.astype(np.float64))
        )
        f.write(body + "\n")


def _write_mtx_dense(f, X: np.ndarray) -> None:
    f.write("%%MatrixMarket matrix array real general\n")
    f.write(f"{X.shape[0]} {X.shape[1]}\n")
    flat = np.asarray(X, dtype=np.float64).flatten(order="F")
    if flat.size:
        f.write("\n".join("%.17g" % v for v in flat) + "\n")


# ---------------------------------------------------------------------------
# Binary formats (.sdm, .sbm, .ddm)
# ---------------------------------------------------------------------------

_U64 = np.dtype("<u8")
_U32 = np.dtype("<u4")
_F64 = np.dtype("<f8")


def _read_exact(f, dtype: np.dtype, count: int) -> np.ndarray:
    buf = f.read(dtype.itemsize * count)
    if len(buf) != dtype.itemsize * count:
        raise ValueError("truncated binary matrix file")
    return np.frombuffer(buf, dtype=dtype, count=count)


def _read_sdm(f, pattern: bool) -> sp.csc_matrix:
    nrow, ncol, nnz = (int(x) for x in _read_exact(f, _U64, 3))
    rows = _read_exact(f, _U32, nnz).astype(np.int64) - 1
    cols = _read_exact(f, _U32, nnz).astype(np.int64) - 1
    if pattern:
        vals = np.ones(nnz, dtype=np.float64)
    else:
        vals = _read_exact(f, _F64, nnz).astype(np.float64)
    return sp.csc_matrix((vals, (rows, cols)), shape=(nrow, ncol))


def _write_sdm(f, X: sp.spmatrix, pattern: bool) -> None:
    # Reference writer iterates CSC order (outer = columns, c++/io.cpp:626-653)
    X = X.tocsc()
    coo = X.tocoo()
    # tocoo() of csc yields column-major ordering already; enforce it:
    order = np.lexsort((coo.row, coo.col))
    rows = coo.row[order].astype(np.uint32) + 1
    cols = coo.col[order].astype(np.uint32) + 1
    vals = coo.data[order].astype(np.float64)
    # pattern (.sbm) writes every STORED entry's coordinates regardless of
    # value (c++/io.cpp:655-682) — do not filter zero/negative values
    f.write(np.asarray([X.shape[0], X.shape[1], len(rows)], dtype=_U64).tobytes())
    f.write(rows.astype(_U32).tobytes())
    f.write(cols.astype(_U32).tobytes())
    if not pattern:
        f.write(vals.astype(_F64).tobytes())


def _read_ddm(f) -> np.ndarray:
    nrow, ncol = (int(x) for x in _read_exact(f, _U64, 2))
    data = _read_exact(f, _F64, nrow * ncol)
    return data.reshape((nrow, ncol), order="F").copy()


def _write_ddm(f, X: np.ndarray) -> None:
    X = np.asarray(X, dtype=np.float64)
    f.write(np.asarray(X.shape, dtype=_U64).tobytes())
    f.write(X.flatten(order="F").astype(_F64).tobytes())


def _read_csv(f) -> np.ndarray:
    nrow = int(f.readline().strip())
    ncol = int(f.readline().strip())
    X = np.empty((nrow, ncol), dtype=np.float64)
    for i in range(nrow):
        parts = f.readline().strip().split(",")
        if len(parts) != ncol:
            raise ValueError("invalid number of columns")
        X[i] = [float(p) for p in parts]
    return X


def _write_csv(f, X: np.ndarray) -> None:
    X = np.asarray(X, dtype=np.float64)
    f.write(f"{X.shape[0]}\n{X.shape[1]}\n")
    for row in X:
        f.write(",".join(f"{v:.6g}" for v in row) + "\n")


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def _read_native(path: str, ext: str):
    """The native C++ reader's matrix; None where it is unavailable or
    fails on the file (the pure-Python reader then reads it, or says what
    is wrong with it)."""
    if native.get_lib() is None:
        return None
    try:
        if ext in (".mtx", ".mm"):
            out = native.read_mtx(path)
            if out[0] == "dense":
                return out[1]
            _, nrow, ncol, rows, cols, vals = out
            return sp.csc_matrix((vals, (rows, cols)), shape=(nrow, ncol))
        if ext in (".sdm", ".sbm"):
            nrow, ncol, rows, cols, vals = native.read_sparse_bin(
                path, pattern=(ext == ".sbm"))
            return sp.csc_matrix((vals, (rows, cols)), shape=(nrow, ncol))
        if ext == ".ddm":
            return native.read_dense_bin(path)
    except IOError:
        return None
    return None


def read_matrix(path: str):
    """Read a matrix file; returns csc_matrix for sparse formats,
    ndarray for dense formats (extension-dispatched like c++/io.cpp:166).
    Uses the native C++ reader when available, this module otherwise."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    ext, gz = _split_ext(path)
    native_out = _read_native(path, ext)
    if native_out is not None:
        return native_out
    if ext in (".mtx", ".mm"):
        with _open_read(path, gz, text=True) as f:
            return _read_mtx(f)
    if ext == ".sdm":
        with _open_read(path, gz, text=False) as f:
            return _read_sdm(f, pattern=False)
    if ext == ".sbm":
        with _open_read(path, gz, text=False) as f:
            return _read_sdm(f, pattern=True)
    if ext == ".ddm":
        with _open_read(path, gz, text=False) as f:
            return _read_ddm(f)
    if ext == ".csv":
        with _open_read(path, gz, text=True) as f:
            return _read_csv(f)
    raise ValueError(f"unsupported extension {ext!r}")


def read_sparse(path: str) -> sp.csc_matrix:
    X = read_matrix(path)
    if not sp.issparse(X):
        raise ValueError(f"{path!r} is not a sparse matrix file")
    return X.tocsc()


def read_dense(path: str) -> np.ndarray:
    X = read_matrix(path)
    if sp.issparse(X):
        raise ValueError(f"{path!r} is not a dense matrix file")
    return X


def _write_native(path: str, ext: str, gz: bool, X) -> bool:
    """Write a binary format with the native C++ writer; False where it is
    unavailable or fails (the pure-Python writer then writes the file)."""
    if native.get_lib() is None:
        return False
    try:
        if ext in (".sdm", ".sbm"):
            coo = X.tocoo()
            order = np.lexsort((coo.row, coo.col))  # column-major like Eigen
            # .sbm writes every stored entry regardless of value
            # (c++/io.cpp:655-682)
            native.write_sparse_bin(
                path, ext == ".sbm", gz, X.shape[0], X.shape[1],
                coo.row[order], coo.col[order], coo.data[order])
            return True
        if ext == ".ddm":
            native.write_dense_bin(path, gz, np.asarray(X, np.float64))
            return True
    except IOError:
        return False
    return False


def write_matrix(path: str, X) -> None:
    """Write a matrix file; format chosen by extension (c++/io.cpp:560).
    Uses the native C++ writer for the binary formats when available."""
    ext, gz = _split_ext(path)
    sparse = sp.issparse(X)
    if ext in (".sdm", ".sbm", ".ddm") and (sparse == (ext != ".ddm")):
        if _write_native(path, ext, gz, X):
            return
    if ext in (".mtx", ".mm"):
        with _open_write(path, gz, text=True) as f:
            (_write_mtx_sparse if sparse else _write_mtx_dense)(f, X)
        return
    if ext == ".sdm":
        if not sparse:
            raise ValueError(".sdm requires a sparse matrix")
        with _open_write(path, gz, text=False) as f:
            _write_sdm(f, X, pattern=False)
        return
    if ext == ".sbm":
        if not sparse:
            raise ValueError(".sbm requires a sparse matrix")
        with _open_write(path, gz, text=False) as f:
            _write_sdm(f, X, pattern=True)
        return
    if ext == ".ddm":
        if sparse:
            raise ValueError(".ddm requires a dense matrix")
        with _open_write(path, gz, text=False) as f:
            _write_ddm(f, X)
        return
    if ext == ".csv":
        if sparse:
            raise ValueError(".csv requires a dense matrix")
        with _open_write(path, gz, text=True) as f:
            _write_csv(f, X)
        return
    raise ValueError(f"unsupported extension {ext!r}")
