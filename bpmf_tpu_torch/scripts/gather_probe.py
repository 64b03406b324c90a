"""Neighbour-gather probes on the card (port of ``scripts/gather_probe.py``).

The bucketed route's Gram needs ``table[idx]`` for every rated entry; on
the card that gather takes half of the ml-25M half-scale iteration
(``PERF.md`` §5).  Each probe computes

    out[r, :] = sum_w table[idx[r, w], :]     idx [R, W] int32, table [NV, K]

by one strategy, over a chain of ``N_STEPS`` launches whose table is carried
as ``c * (1 + 1e-30 * o[0, 0])``, so that no launch can be skipped:

A. each item row's neighbours split over ``split`` warps, a table row read
   as 16-byte pieces by a quarter warp at K=32, the warps' partials added
   in order (``csrc/gather_probe.cu`` ``gather_rows_kernel``, planned by
   :func:`probe_plan_rows`; the JAX script's ``kernel_a``)
B. the transposed table [K, NV], one k-row at a time in shared memory
   (chunk by chunk past about 58,000 rows), lanes take neighbours and look
   them up there, a warp-shuffle sum per (r, k) (``gather_lanes_kernel``,
   planned by :func:`probe_plan_lanes`; ``kernel_b``)
C. persistent blocks, each streaming its item rows' neighbour rows through
   a ring of slots in shared memory: producer warps copy each row with one
   bulk copy (the TMA) that completes on the slot's mbarrier, while four
   consumer warps sum the slots that have landed and free them (4-byte
   ``cp.async`` for a K or a table off 16-byte alignment;
   ``gather_copy_kernel``, planned by :func:`probe_plan_copy`;
   ``kernel_c``)
D. PyTorch's ``index_select`` then a sum: a gather that writes the rows out
   to device memory, as XLA's ``jnp.take`` does in the JAX script.  Not a
   kernel of the port.

Each prints ms per step and M edges/s (1 edge = one K-row fetched).

    python -m bpmf_tpu_torch.scripts.gather_probe [A|B|C|D ...] [--device cuda|cpu]

Each kernel wrapper runs its plain PyTorch version for CPU tensors only; a
CUDA tensor launches the kernel or raises.  ``launches`` counts the kernel
launches of each.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import sys
import time

import numpy as np
import torch

from bpmf_tpu_torch.device import resolve_device
from bpmf_tpu_torch.ops.dense8 import _sm_count

__all__ = ["K", "NV", "R", "W", "N_STEPS", "launches", "make_inputs",
           "probe_plan_rows", "probe_plan_lanes", "probe_plan_copy",
           "gather_sum_rows", "gather_sum_lanes", "gather_sum_copy",
           "gather_sum_ref", "gather_sum_lanes_ref", "probe_chain", "run",
           "main"]

K = 32
NV = 32768          # table rows
R = 512             # item rows per call
W = 512             # neighbours per item row
N_STEPS = 10

# CUDA launches of each kernel (not plain-version calls)
launches = {"A": 0, "B": 0, "C": 0}

SMEM_MAX = 232448         # dynamic shared memory a block may have
ROWS_WARPS = 16           # A: warps a block (csrc kRowsWarps)
LANES_THREADS = 1024      # B: threads a block (csrc kLanesThreads)
COPY_MAX_CHUNK = 256      # C: table rows a slot, 32 a producer warp (csrc kCopyMaxChunk)
COPY_MAX_STAGES = 16      # C: slots a ring (csrc kCopyMaxStages)
COPY_MAX_COLS = 1024      # C: columns a copy (wider rows go in slabs)
COPY_SLOT = 32768         # C: bytes of table rows a slot holds at most
COPY_RING = 3 * COPY_SLOT  # C: bytes of slots a ring asks for


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def probe_plan_rows(r: int, w: int, k: int, sms: int = 132) -> dict:
    """#9A's launch: each of the ``r`` item rows gets ``split`` warps (a
    power of two dividing ROWS_WARPS), warp s taking neighbours
    [s * per_warp, (s + 1) * per_warp) of the ``w``.  ``split`` doubles
    while r * split warps stay within the ``sms`` SMs' 64 warps each (two
    waves of the 32 a SM holds at the kernel's registers: 16 at R = 512, 1
    at R = 8192 on an H100 SXM's 132) and each warp keeps at least 32
    neighbours; the split warps' [K] partials meet in ``smem`` bytes of
    shared memory (none at split 1; the kernel sizes it the same way)."""
    split = 1
    while (2 * split <= ROWS_WARPS and r * 2 * split <= sms * 64
           and 2 * split * 32 <= w
           and 4 * ROWS_WARPS * k <= SMEM_MAX):
        split *= 2
    rows_per_block = ROWS_WARPS // split
    return {"split": split, "per_warp": _cdiv(w, split),
            "rows_per_block": rows_per_block,
            "blocks": _cdiv(r, rows_per_block),
            "smem": 4 * ROWS_WARPS * k if split > 1 else 0}


def probe_plan_lanes(r: int, w: int, nv: int, k: int, sms: int = 132) -> dict:
    """#9B's launch: a grid of ``k`` k-rows x ``groups`` groups of
    ``rows_per_block`` item rows.  A block stages its k-row in ``chunks``
    pieces of ``chunk`` floats (one, up to 58,108 = NV; more past it), each
    in ``smem`` bytes (3 floats of slack align the 16-byte copies; the
    kernel sizes it the same way).  The groups fill one wave: as many
    blocks as the ``sms`` SMs hold at that shared memory, at least one a
    k-row; ``w`` does not change the plan."""
    cap = SMEM_MAX // 4 - 4
    chunks = _cdiv(nv, cap)
    chunk = _cdiv(nv, chunks)
    smem = 16 * _cdiv(4 * (chunk + 3), 16)
    per_sm = max(1, min(2048 // LANES_THREADS, (228 * 1024) // (smem + 1024)))
    groups = max(1, min(r, sms * per_sm // k))
    rows_per_block = _cdiv(r, groups)
    groups = _cdiv(r, rows_per_block)
    return {"rows_per_block": rows_per_block, "groups": groups,
            "chunk": chunk, "chunks": chunks, "smem": smem,
            "blocks": k * groups}


def probe_plan_copy(r: int, w: int, k: int, sms: int = 132) -> dict:
    """#9C's launch: ``blocks`` persistent blocks, about two an SM of the
    ``sms`` (each takes ceil(r / blocks) or one fewer of the ``r`` item
    rows, block b rows b, b + blocks, ...).  A row goes in slabs of
    ``cols`` columns (one slab up to COPY_MAX_COLS), a slab's neighbours in
    chunks of ``chunk`` table rows (COPY_SLOT bytes of rows, at most
    COPY_MAX_CHUNK: 256 at K = 32), one chunk a slot of a ring of
    ``stages`` slots: at least 3 and as many as COPY_RING bytes take, at
    most COPY_MAX_STAGES.  From K = 6 the ring holds at least COPY_RING
    bytes; below it its 16 slots of 256 rows hold 16 KB a column of K.
    Two rings an SM keep more than the ~48 KB in flight that ~60 GB/s an
    SM needs at ~0.8 us of L2 latency at every K but 1 (32 KB there).  The
    kernel sizes its shared memory (the ring, the consumers' partials, the
    slots' mbarriers) from these four numbers; ``w`` changes none."""
    cols = min(k, COPY_MAX_COLS)
    chunk = max(1, min(COPY_MAX_CHUNK, COPY_SLOT // (4 * cols)))
    stages = max(3, min(COPY_MAX_STAGES, _cdiv(COPY_RING, 4 * chunk * cols)))
    rows_per_block = _cdiv(r, 2 * sms)
    return {"blocks": _cdiv(r, rows_per_block), "chunk": chunk,
            "stages": stages, "cols": cols}


def make_inputs(*, k: int = K, nv: int = NV, r: int = R, w: int = W,
                seed: int = 0):
    """(idx [r, w] int32, table [nv, k] float32) as numpy, drawn as the JAX
    script draws them: the same arrays at the same shapes."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(nv, k)).astype(np.float32)
    idx = rng.integers(0, nv, size=(r, w)).astype(np.int32)
    return idx, table


def _check(name: str, idx: torch.Tensor, table: torch.Tensor) -> str:
    """Device type of the call after the wrapper's checks."""
    if idx.dtype != torch.int32 or idx.dim() != 2:
        raise ValueError(f"{name}: idx must be [R, W] int32, got "
                         f"{idx.dtype} {tuple(idx.shape)}")
    if table.dtype != torch.float32 or table.dim() != 2:
        raise ValueError(f"{name}: the table must be 2-D float32, got "
                         f"{table.dtype} {tuple(table.shape)}")
    if idx.device != table.device:
        raise ValueError(f"{name}: idx is on {idx.device}, the table on "
                         f"{table.device}")
    if not (idx.is_contiguous() and table.is_contiguous()):
        raise ValueError(f"{name}: idx and the table must be contiguous")
    if idx.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for {idx.device}")
    return idx.device.type


def _launch(key: str, device: torch.device, fn, *args) -> None:
    err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gather probe {key}: kernel launch failed: "
                           f"cudaError {err}")
    launches[key] += 1


def gather_sum_rows(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """9A: out [R, K] = sum_w table[idx[r, w]], each item row's neighbours
    split over warps (:func:`probe_plan_rows`)."""
    if _check("gather_sum_rows", idx, table) == "cpu":
        return gather_sum_ref(idx, table)
    (r, w), k = idx.shape, table.shape[1]
    plan = probe_plan_rows(r, w, k, _sm_count(idx.device))
    out = torch.empty((r, k), dtype=torch.float32, device=idx.device)
    _launch("A", idx.device, _lib().bpmf_gather_rows, idx.data_ptr(),
            table.data_ptr(), r, w, k, plan["split"], plan["per_warp"],
            out.data_ptr())
    return out


def gather_sum_lanes(idx: torch.Tensor, table_t: torch.Tensor) -> torch.Tensor:
    """9B: the same from the transposed table [K, NV], a k-row at a time in
    shared memory (:func:`probe_plan_lanes`)."""
    if _check("gather_sum_lanes", idx, table_t) == "cpu":
        return gather_sum_lanes_ref(idx, table_t)
    (r, w), (k, nv) = idx.shape, table_t.shape
    plan = probe_plan_lanes(r, w, nv, k, _sm_count(idx.device))
    out = torch.empty((r, k), dtype=torch.float32, device=idx.device)
    _launch("B", idx.device, _lib().bpmf_gather_lanes, idx.data_ptr(),
            table_t.data_ptr(), r, w, nv, k, plan["rows_per_block"],
            plan["chunk"], out.data_ptr())
    return out


def gather_sum_copy(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """9C: the same with each item row's table rows streamed through a ring
    of slots in shared memory, copied asynchronously and summed as they
    land (:func:`probe_plan_copy`)."""
    if _check("gather_sum_copy", idx, table) == "cpu":
        return gather_sum_ref(idx, table)
    (r, w), k = idx.shape, table.shape[1]
    plan = probe_plan_copy(r, w, k, _sm_count(idx.device))
    out = torch.empty((r, k), dtype=torch.float32, device=idx.device)
    _launch("C", idx.device, _lib().bpmf_gather_copy, idx.data_ptr(),
            table.data_ptr(), r, w, k, plan["blocks"], plan["chunk"],
            plan["stages"], plan["cols"], out.data_ptr())
    return out


@functools.cache
def _lib():
    """The built library's C entry points (built on first use)."""
    from bpmf_tpu_torch.ops._build import load

    lib = load("gather_probe")
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, args in (("bpmf_gather_rows", [p, p, i, i, i, i, i, p, p]),
                       ("bpmf_gather_lanes", [p, p, i, i, i, i, i, i, p, p]),
                       ("bpmf_gather_copy", [p, p, i, i, i, i, i, i, i, p, p])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = ctypes.c_int, args
    return lib


def gather_sum_ref(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of 9A and 9C, and probe D's step: one
    ``index_select`` of the R*W rows, then the sum over W."""
    r, w = idx.shape
    return table.index_select(0, idx.reshape(-1)).reshape(r, w, -1).sum(1)


def gather_sum_lanes_ref(idx: torch.Tensor, table_t: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of 9B: gather along the table's columns, sum
    over W, transpose (the JAX ``kernel_b``'s body)."""
    r, w = idx.shape
    g = table_t.index_select(1, idx.reshape(-1))          # [K, R*W]
    return g.reshape(-1, r, w).sum(2).t()


PROBES = {
    "A": ("A split warps, rows  ", gather_sum_rows, False),
    "B": ("B lanes, transposed  ", gather_sum_lanes, True),
    "C": ("C ring of row copies ", gather_sum_copy, False),
    "D": ("D torch index_select ", gather_sum_ref, False),
}


def probe_chain(step, idx: torch.Tensor, table: torch.Tensor,
                n_steps: int = N_STEPS) -> torch.Tensor:
    """``n_steps`` launches of ``step``, each on the table the last one left
    (``c * (1 + 1e-30 * o[0, 0])``, as the JAX script's scan carries it)."""
    c = table
    for _ in range(n_steps):
        o = step(idx, c)
        c = c * (1.0 + 1e-30 * o[0, 0])
    return c


def _seconds(fn, device: torch.device) -> float:
    if device.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def run(which=("A", "B", "C", "D"), device="cuda", *, n_steps: int = N_STEPS,
        reps: int = 3, out=None, **shapes) -> dict:
    """Time each probe in ``which``: one chain to warm up (and build), then
    the best of ``reps`` chains (CUDA events on the card).  ``shapes`` takes
    k, nv, r, w (the JAX script's constants by default).  Prints one line
    per probe and returns {probe: {"ms_per_step", "m_edges_per_s"}}."""
    dev = resolve_device(device)
    out = out if out is not None else sys.stdout
    idx_np, table_np = make_inputs(**shapes)
    idx = torch.from_numpy(idx_np).to(dev)
    table = torch.from_numpy(table_np).to(dev)
    table_t = table.t().contiguous()
    edges = idx_np.size * n_steps
    results = {}
    for key in which:
        name, step, transposed = PROBES[key]
        t = table_t if transposed else table
        probe_chain(step, idx, t, n_steps)
        best = min(_seconds(lambda: probe_chain(step, idx, t, n_steps), dev)
                   for _ in range(reps))
        results[key] = {"ms_per_step": best / n_steps * 1e3,
                        "m_edges_per_s": edges / best / 1e6}
        print(f"{name}: {best / n_steps * 1e3:8.3f} ms/step  "
              f"{edges / best / 1e6:10.1f} M edges/s  ({dev})",
              file=out, flush=True)
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m bpmf_tpu_torch.scripts.gather_probe",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("probes", nargs="*", metavar="A|B|C|D",
                   help="the probes to run (default: all four)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu' (the plain versions)")
    args = p.parse_args(argv)
    if set(args.probes) - set(PROBES):
        p.error(f"unknown probes {sorted(set(args.probes) - set(PROBES))}")
    which = [k for k in PROBES if k in args.probes] or list(PROBES)
    run(which, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
