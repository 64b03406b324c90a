"""Start the ranks of a multi-device run on this host, one process each.

    results = run_ranks(fn, 2, arg, device="cpu")   # fn(mesh, arg) on 2 gloo ranks

Each rank is a process started by ``torch.multiprocessing`` with the spawn
method.  It joins the group on a free local port (:func:`~bpmf_tpu_torch.
parallel.mesh.init_mesh`), calls ``fn(mesh, *args)`` and sends its return
value back; the group is destroyed before the rank exits.  In a run over
several processes each starts its block of the group's ranks
(``rank_offset``, ``world_size``, ``init_method``: ``--dist``).  ``fn`` must be a
module-level function of a module that a fresh interpreter can import.
A rank that raises, or dies, stops the others, and :func:`run_ranks` raises
with its traceback.
"""

from __future__ import annotations

import queue
import time
import traceback
from typing import Callable, Optional

import torch

from bpmf_tpu_torch.parallel.mesh import free_port, init_mesh

__all__ = ["run_ranks"]


def _rank_main(local: int, offset: int, size: int, init_method: str, device,
               backend, threads, fn: Callable, args: tuple, results) -> None:
    rank = offset + local
    if threads:
        torch.set_num_threads(threads)
    try:
        mesh = init_mesh(rank, size, init_method, device, backend, local=local)
        try:
            out = fn(mesh, *args)
        finally:
            import torch.distributed as dist

            dist.destroy_process_group()
        results.put((local, True, out))
    except BaseException:
        results.put((local, False, traceback.format_exc()))  # the parent reports it
        raise


def run_ranks(fn: Callable, size: int, *args, device="cuda",
              backend: Optional[str] = None, threads: Optional[int] = None,
              timeout_s: Optional[float] = None, rank_offset: int = 0,
              world_size: Optional[int] = None,
              init_method: Optional[str] = None) -> list:
    """``fn(mesh, *args)`` on ``size`` ranks of this host; their return
    values in rank order.  ``device``: ``cuda`` (the host's i-th rank on
    ``cuda:i``, NCCL; the default), ``cpu`` (gloo) or ``cuda:<i>`` (every
    rank on that GPU; gloo only).  ``threads`` sets each rank's torch
    thread count.  ``timeout_s`` bounds the wait for the results (none by
    default: a chain runs as long as it needs; a rank that dies is caught
    by its exit code).  By default the ranks are the whole group, meeting
    on a free local port; in a group of ``world_size`` ranks over several
    processes, these are global ranks ``rank_offset`` on, meeting at
    ``init_method``."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    world = size if world_size is None else world_size
    init = init_method or f"tcp://127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_rank_main,
                         args=(r, rank_offset, world, init, device, backend,
                               threads, fn, args, results))
             for r in range(size)]
    for p in procs:
        p.start()
    out = {}
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        while len(out) < size:
            try:
                rank, ok, value = results.get(timeout=0.5)
            except queue.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    raise RuntimeError(f"rank(s) exited without a result: {dead}")
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"ranks still running after {timeout_s} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank_offset + rank} of {world} "
                                   f"failed:\n{value}")
            out[rank] = value
    finally:
        for p in procs:
            p.join(timeout=5 if len(out) < size else 60)
            if p.is_alive():
                p.terminate()
                p.join()
    return [out[r] for r in range(size)]
