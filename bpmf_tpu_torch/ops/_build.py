"""Build and load the port's CUDA kernels.

The kernels live as plain-C-interface CUDA sources under
``bpmf_tpu_torch/csrc``.  On first use they are compiled with ``nvcc`` for
``sm_90a`` into ``build/bpmf_tpu_torch/`` beside the package and loaded with
``ctypes``.  The library's file name carries a hash of its sources, so an
edited source is never served by a stale build.  Nothing here runs at import
time: the CPU tests import every module where there is no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

from bpmf_tpu_torch.utils.counters import count_build

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "bpmf_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the CUDA kernels of bpmf_tpu_torch cannot be built")
    return found


def build(name: str) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` into a shared library unless an up-to-date
    build exists (a compile is counted, with its seconds, in
    ``utils.counters.event_counts``).  Returns (library path, ptxas report;
    empty when cached)."""
    srcs = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    digest = hashlib.sha256()
    for s in srcs:
        digest.update(s.name.encode())
        digest.update(s.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a temporary name, then rename: concurrent builds never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    count_build(time.perf_counter() - t0)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {name}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; one handle per process."""
    path, _ = build(name)
    return ctypes.CDLL(str(path))
