"""ctypes loader for the native matrix-I/O library (port of
``bpmf_tpu/io/native``).

On first use ``g++ -O2 -shared -fPIC -std=c++17 matrix_io.cpp -lz`` builds
``libbpmf_io-<hash>.so`` into ``build/bpmf_tpu_torch/`` beside the package
(the CUDA libraries' directory, ``ops/_build.py``); the hash covers the
source and the flags, so an edited source is never served by a stale
build.  The build writes a temporary file of its own
(``tempfile.mkstemp`` in that directory) and renames it into place, so
processes that build at once (test workers on a fresh checkout) all load a
whole library.

Where the library cannot be built or loaded, ``bpmf_tpu_torch.io`` and
``bpmf_tpu_torch.sparse`` take their pure-Python paths, which give the same
matrices and buckets.  That is never silent: :func:`status` says
``"native <path>"`` or ``"python: <why>"`` (the compiler's message, or
``BPMF_NO_NATIVE``), and the sampler's banner prints it.  ``BPMF_NO_NATIVE``
set to anything but the empty string asks for Python on purpose; it is read
at every call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from bpmf_tpu_torch.ops._build import BUILD_DIR

__all__ = ["fill_bucket", "get_lib", "library_path", "read_dense_bin",
           "read_mtx", "read_sparse_bin", "status", "write_dense_bin",
           "write_sparse_bin"]

SRC = Path(__file__).resolve().with_name("matrix_io.cpp")
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_loaded: tuple | None = None   # (library or None, status), once tried


def library_path() -> Path:
    """Where the library of this source and these flags is built."""
    digest = hashlib.sha256(SRC.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libbpmf_io-{digest.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    """Compile the library to ``path`` under a temporary name of this
    process, then rename it; raises RuntimeError with the compiler's
    message."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *CXX_FLAGS, str(SRC), "-lz", "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        os.unlink(tmp)
        raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}): "
                           f"{proc.stderr.strip()}")
    os.replace(tmp, path)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u32pp = ctypes.POINTER(ctypes.POINTER(ctypes.c_uint32))
    f64pp = ctypes.POINTER(ctypes.POINTER(ctypes.c_double))
    lib.bpmf_last_error.restype = ctypes.c_char_p
    lib.bpmf_free.argtypes = [ctypes.c_void_p]
    lib.bpmf_read_sparse_bin.argtypes = [
        ctypes.c_char_p, ctypes.c_int, u64p, u64p, u64p, u32pp, u32pp, f64pp,
    ]
    lib.bpmf_write_sparse_bin.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.bpmf_read_dense_bin.argtypes = [ctypes.c_char_p, u64p, u64p, f64pp]
    lib.bpmf_write_dense_bin.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.bpmf_read_mtx.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int), u64p, u64p, u64p,
        u32pp, u32pp, f64pp, f64pp,
    ]
    lib.bpmf_fill_bucket.restype = ctypes.c_int64
    lib.bpmf_fill_bucket.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
    ]
    return lib


def _load() -> tuple:
    path = library_path()
    try:
        if not path.exists():
            _build(path)
        return _bind(ctypes.CDLL(str(path))), f"native {path}"
    except (RuntimeError, OSError) as e:
        return None, f"python: {e}"


def get_lib():
    """The library (built and loaded on first use), or None where it is
    not to be had or ``BPMF_NO_NATIVE`` is set: :func:`status` says why."""
    global _loaded
    if os.environ.get("BPMF_NO_NATIVE"):
        return None
    with _lock:
        if _loaded is None:
            _loaded = _load()
    return _loaded[0]


def status() -> str:
    """``"native <library path>"``, or ``"python: <why>"`` when the readers
    take their pure-Python paths."""
    if os.environ.get("BPMF_NO_NATIVE"):
        return "python: BPMF_NO_NATIVE is set"
    get_lib()
    return _loaded[1]


def _lib():
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"native matrix I/O unavailable ({status()})")
    return lib


def _take(ptr, n, lib) -> np.ndarray:
    """A copy of the library's array of n items, which it then frees."""
    arr = (np.ctypeslib.as_array(ptr, shape=(n,)).copy() if n
           else np.zeros(0, ptr._type_))
    lib.bpmf_free(ptr)
    return arr


def _check(rc, lib) -> None:
    if rc != 0:
        raise IOError(lib.bpmf_last_error().decode())


def read_sparse_bin(path: str, pattern: bool):
    """.sdm / .sbm -> (nrow, ncol, rows, cols, vals), 0-based indices."""
    lib = _lib()
    nrow, ncol, nnz = ctypes.c_uint64(), ctypes.c_uint64(), ctypes.c_uint64()
    rows = ctypes.POINTER(ctypes.c_uint32)()
    cols = ctypes.POINTER(ctypes.c_uint32)()
    vals = ctypes.POINTER(ctypes.c_double)()
    _check(lib.bpmf_read_sparse_bin(
        path.encode(), int(pattern), ctypes.byref(nrow), ctypes.byref(ncol),
        ctypes.byref(nnz), ctypes.byref(rows), ctypes.byref(cols),
        ctypes.byref(vals)), lib)
    n = nnz.value
    r, c = _take(rows, n, lib), _take(cols, n, lib)
    v = np.ones(n) if pattern else _take(vals, n, lib)
    return nrow.value, ncol.value, r, c, v


def write_sparse_bin(path, pattern, gz, nrow, ncol, rows, cols, vals) -> None:
    """.sdm / .sbm (gzipped with ``gz``) from 0-based COO in file order."""
    lib = _lib()
    rows = np.ascontiguousarray(rows, dtype=np.uint32)
    cols = np.ascontiguousarray(cols, dtype=np.uint32)
    vals = np.ascontiguousarray(vals, dtype=np.float64)
    _check(lib.bpmf_write_sparse_bin(
        path.encode(), int(pattern), int(gz), nrow, ncol, len(rows),
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double))), lib)


def read_dense_bin(path: str) -> np.ndarray:
    """.ddm -> [nrow, ncol] float64."""
    lib = _lib()
    nrow, ncol = ctypes.c_uint64(), ctypes.c_uint64()
    data = ctypes.POINTER(ctypes.c_double)()
    _check(lib.bpmf_read_dense_bin(path.encode(), ctypes.byref(nrow),
                                   ctypes.byref(ncol), ctypes.byref(data)), lib)
    flat = _take(data, nrow.value * ncol.value, lib)
    return flat.reshape((nrow.value, ncol.value), order="F").copy()


def write_dense_bin(path: str, gz: bool, x: np.ndarray) -> None:
    """.ddm (gzipped with ``gz``), column-major."""
    lib = _lib()
    xf = np.asfortranarray(x, dtype=np.float64)
    _check(lib.bpmf_write_dense_bin(
        path.encode(), int(gz), x.shape[0], x.shape[1],
        xf.ctypes.data_as(ctypes.POINTER(ctypes.c_double))), lib)


def read_mtx(path: str):
    """.mtx -> ("sparse", nrow, ncol, rows, cols, vals) or ("dense", array)."""
    lib = _lib()
    kind = ctypes.c_int()
    nrow, ncol, nnz = ctypes.c_uint64(), ctypes.c_uint64(), ctypes.c_uint64()
    rows = ctypes.POINTER(ctypes.c_uint32)()
    cols = ctypes.POINTER(ctypes.c_uint32)()
    vals = ctypes.POINTER(ctypes.c_double)()
    dense = ctypes.POINTER(ctypes.c_double)()
    _check(lib.bpmf_read_mtx(
        path.encode(), ctypes.byref(kind), ctypes.byref(nrow),
        ctypes.byref(ncol), ctypes.byref(nnz), ctypes.byref(rows),
        ctypes.byref(cols), ctypes.byref(vals), ctypes.byref(dense)), lib)
    if kind.value == 0:
        n = nnz.value
        return ("sparse", nrow.value, ncol.value, _take(rows, n, lib),
                _take(cols, n, lib), _take(vals, n, lib))
    flat = _take(dense, nrow.value * ncol.value, lib)
    return "dense", flat.reshape((nrow.value, ncol.value), order="F").copy()


def fill_bucket(indptr, indices, data, ids, width, nbr, val, mask,
                row_slot) -> int:
    """Fill one degree bucket's zeroed arrays (``nbr`` int32, ``val``
    float64, ``mask`` float32 [R, width], ``row_slot`` int32 [R] preset to
    the padding slot) from CSC ``indptr`` int64, ``indices`` int32 and
    ``data`` float64, items ``ids`` int32 in slot order, each item's list
    split into rows of ``width``; returns the rows written.  Raises
    ValueError when the items need more than R rows."""
    lib = _lib()
    arrays = ((indptr, np.int64), (indices, np.int32), (data, np.float64),
              (ids, np.int32), (nbr, np.int32), (val, np.float64),
              (mask, np.float32), (row_slot, np.int32))
    for a, dt in arrays:
        if a.dtype != dt or not a.flags.c_contiguous:
            raise TypeError(f"fill_bucket needs C-contiguous {np.dtype(dt)}, "
                            f"got {a.dtype}")
    if (nbr.ndim != 2 or nbr.shape[1] != width or val.shape != nbr.shape
            or mask.shape != nbr.shape or row_slot.shape != nbr.shape[:1]
            or len(indices) < indptr[-1] or len(data) < indptr[-1]
            or (len(ids) and not 0 <= ids.min() <= ids.max() < len(indptr) - 1)):
        raise ValueError("fill_bucket: arrays of inconsistent shapes")

    def ptr(a, ct):
        return a.ctypes.data_as(ctypes.POINTER(ct))

    rows = lib.bpmf_fill_bucket(
        ptr(indptr, ctypes.c_int64), ptr(indices, ctypes.c_int32),
        ptr(data, ctypes.c_double), ptr(ids, ctypes.c_int32), len(ids),
        width, ptr(nbr, ctypes.c_int32), ptr(val, ctypes.c_double),
        ptr(mask, ctypes.c_float), ptr(row_slot, ctypes.c_int32),
        nbr.shape[0])
    if rows < 0:
        raise ValueError("bucket row capacity overflow")
    return rows
