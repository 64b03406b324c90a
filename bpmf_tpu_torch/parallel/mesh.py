"""The device mesh of a multi-device run (port of ``bpmf_tpu/parallel/mesh.py``).

The JAX package runs one SPMD program over a 1-D mesh of devices.  The port
runs one process per rank over ``torch.distributed``: NCCL when each rank
holds its own GPU, gloo on the CPU (the tests) or where asked.  A
:class:`Mesh` is one rank's view of that group: its rank, the world size,
the backend and its device, with the four exchanges the sweeps use, each
on dim 0 (the item axis):

* :meth:`Mesh.all_gather` -- ``all_gather_into_tensor``: every rank's
  ``[n, ...]`` rows in rank order, ``[D * n, ...]`` (``lax.all_gather(...,
  tiled=True)``; also ``to_host``'s gather of a row-sharded array);
* :meth:`Mesh.all_reduce` -- the sum over ranks (``lax.psum``);
* :meth:`Mesh.reduce_scatter` -- ``[D * n, ...]`` summed over ranks, rank
  r keeping rows ``[r * n, (r + 1) * n)`` (``lax.psum_scatter``);
* :meth:`Mesh.ppermute` -- one round of a ring: ``x`` to rank ``(r +
  shift) % D``, the same shape from ``(r - shift) % D`` (``lax.ppermute``,
  the halo ring's step).

``collectives`` counts the calls of each, for the perf records; with
``log`` a list, each call also appends its name and its input's shape.  A
mesh without a group (``group=None``) plans a layout for ``rank`` of
``size`` ranks and refuses collectives when ``size > 1``; at ``size == 1``
they are identities, as on one device in the JAX package.

A run over several processes (``--dist HOST:PORT,NPROC,PID`` or
``BPMF_DIST``, the JAX package's ``initialize_from_env``) is one group of
``N`` ranks, ``N / NPROC`` of them in each process: :func:`dist_spec`
reads the spec and :func:`dist_ranks` places a process's ranks; each
takes the GPU of its place among them (``init_mesh(..., local=)``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import socket
import warnings
from typing import Optional

import torch

__all__ = ["DistSpec", "Mesh", "dist_ranks", "dist_spec", "free_port",
           "init_mesh", "mesh_from_env", "resolve_n_devices", "shared_gpu"]

# a rank that waits this long in a collective gives up (a peer has died)
TIMEOUT = datetime.timedelta(seconds=600)


@contextlib.contextmanager
def _quiet():
    """Newer torch releases call ``all_gather_into_tensor`` and
    ``reduce_scatter_tensor`` deprecated; their successors are missing from
    the older releases the card runs, so the port keeps these two."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", ".*(all_gather_into_tensor|"
                                "reduce_scatter_tensor).*", FutureWarning)
        yield


def resolve_n_devices(n_devices: int, device) -> int:
    """The rank count of a run (``bpmf_tpu/sampler.py:210-215``): ``0``
    means every visible GPU on ``cuda`` and one rank on the CPU.  Asking
    for more GPUs than there are raises; nothing falls back to fewer ranks
    or to the CPU."""
    dev = torch.device(device)
    if n_devices < 0:
        raise ValueError(f"n_devices must be >= 0, got {n_devices}")
    if dev.type != "cuda":
        return n_devices if n_devices > 0 else 1
    n_avail = torch.cuda.device_count()
    n = n_devices if n_devices > 0 else n_avail
    if n > n_avail:
        raise ValueError(f"requested {n} devices, only {n_avail} available")
    return n


@dataclasses.dataclass
class Mesh:
    """One rank of a 1-D mesh of ``size`` ranks (see the module doc)."""

    rank: int
    size: int
    device: torch.device
    backend: Optional[str] = None
    group: Optional[object] = None   # torch.distributed ProcessGroup
    collectives: dict = dataclasses.field(default_factory=lambda: {
        "all_gather": 0, "all_reduce": 0, "reduce_scatter": 0, "ppermute": 0})
    log: Optional[list] = None       # (name, input shape) of every call

    def _check(self, what: str, x: torch.Tensor) -> bool:
        """True when the collective must run; False at one rank without a
        group, where it is the identity."""
        self.collectives[what] += 1
        if self.log is not None:
            self.log.append((what, tuple(x.shape)))
        if self.group is not None:
            return True
        if self.size > 1:
            raise RuntimeError(f"{what} on rank {self.rank} of {self.size}: "
                               "this mesh has no process group")
        return False

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of ``x`` ([n, ...], the same shape on every
        rank) in rank order: [size * n, ...]."""
        if not self._check("all_gather", x):
            return x
        import torch.distributed as dist

        x = x.contiguous()
        out = x.new_empty((self.size * x.shape[0],) + tuple(x.shape[1:]))
        with _quiet():
            dist.all_gather_into_tensor(out, x, group=self.group)
        return out

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over ranks (a new tensor)."""
        if not self._check("all_reduce", x):
            return x
        import torch.distributed as dist

        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=self.group)
        return x

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` [size * n, ...] summed over ranks; this rank keeps rows
        [rank * n, (rank + 1) * n).  Rank r's block must lie contiguous in
        dim 0, which is the split gloo and NCCL both take."""
        if not self._check("reduce_scatter", x):
            return x
        import torch.distributed as dist

        if x.shape[0] % self.size:
            raise ValueError(f"reduce_scatter: {x.shape[0]} rows over "
                             f"{self.size} ranks")
        x = x.contiguous()
        out = x.new_empty((x.shape[0] // self.size,) + tuple(x.shape[1:]))
        with _quiet():
            dist.reduce_scatter_tensor(out, x, group=self.group)
        return out

    def ppermute(self, x: torch.Tensor, shift: int) -> torch.Tensor:
        """``x`` ([n, ...], the same shape on every rank) sent to rank
        ``(rank + shift) % size``; returns the rows received from ``(rank -
        shift) % size``.  One ``all_to_all_single`` whose splits are ``n``
        to one peer and 0 to every other: the point-to-point exchange that
        NCCL and gloo both take, on CPU and CUDA tensors alike."""
        if not self._check("ppermute", x):
            return x
        import torch.distributed as dist

        x = x.contiguous()
        n = x.shape[0]
        send = [0] * self.size
        recv = [0] * self.size
        send[(self.rank + shift) % self.size] = n
        recv[(self.rank - shift) % self.size] = n
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, recv, send, group=self.group)
        return out


def free_port() -> int:
    """A free TCP port on this host, for the group's store."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def shared_gpu(device) -> bool:
    """True when ``device`` names one GPU by its index (``cuda:<i>``): every
    rank of the host then takes that GPU, over gloo, since NCCL refuses two
    ranks on one GPU (``run_ranks(..., device="cuda:0", backend="gloo")``,
    the CLI's ``--device cuda:0``)."""
    dev = torch.device(device)
    return dev.type == "cuda" and dev.index is not None


def _rank_device(device, local: int) -> torch.device:
    """The device of the rank that is ``local``-th on its host: ``cuda``
    means the rank's own GPU (``cuda:<local>``), ``cuda:<i>`` one GPU for
    every rank (gloo only), ``cpu`` the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", local)
    return dev


def init_mesh(rank: int, size: int, init_method: str, device="cuda",
              backend: Optional[str] = None,
              local: Optional[int] = None) -> Mesh:
    """Join the group of ``size`` ranks at ``init_method`` (for example
    ``tcp://127.0.0.1:<port>``) as ``rank`` and return its mesh.  ``local``
    is the rank's place among its host's ranks (its GPU on ``cuda``;
    ``rank`` itself by default, one host).  The backend is NCCL on CUDA and
    gloo on the CPU unless ``backend`` says otherwise; NCCL refuses two
    ranks on one GPU."""
    import torch.distributed as dist

    dev = _rank_device(device, rank if local is None else local)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, world_size=size,
                            rank=rank, timeout=TIMEOUT, **kw)
    return Mesh(rank=rank, size=size, device=dev, backend=backend,
                group=dist.group.WORLD)


def mesh_from_env(device="cuda") -> Optional[Mesh]:
    """The mesh of a rank started by ``torchrun`` (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT`` in the
    environment), or None outside such a launch."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    return init_mesh(rank, size, "env://", device,
                     local=int(os.environ.get("LOCAL_RANK", rank)))


@dataclasses.dataclass(frozen=True)
class DistSpec:
    """One process of a run over ``num_processes`` processes, whose group
    meets at ``tcp://<coordinator>`` (``host:port``, where process 0
    serves the store)."""

    coordinator: str
    num_processes: int
    process_id: int

    @property
    def init_method(self) -> str:
        return f"tcp://{self.coordinator}"


def dist_spec(spec: Optional[str] = None) -> Optional[DistSpec]:
    """The process's place in a multi-process run: ``spec``, else the
    ``BPMF_DIST`` environment variable, as ``host:port,num_processes,
    process_id`` (``bpmf_tpu/parallel/mesh.py:55``); None when both are
    empty (one process).  A malformed spec raises the JAX package's
    message."""
    if spec is None:
        spec = os.environ.get("BPMF_DIST", "")
    if not spec:
        return None
    try:
        coord, nproc, pid = spec.rsplit(",", 2)
        out = DistSpec(coord, int(nproc), int(pid))
        if not coord or out.num_processes < 1 or not (
                0 <= out.process_id < out.num_processes):
            raise ValueError(spec)
        return out
    except ValueError as e:
        raise ValueError(
            f"BPMF_DIST must be 'host:port,num_processes,process_id', got {spec!r}"
        ) from e


def dist_ranks(n_ranks: int, spec: DistSpec) -> tuple[int, int]:
    """(ranks of this process, global rank of its first) when ``n_ranks``
    ranks run over ``spec.num_processes`` processes, the same number in
    each: process p holds global ranks ``p * n_ranks / NPROC`` on."""
    per, rest = divmod(n_ranks, spec.num_processes)
    if rest or not per:
        raise ValueError(f"{n_ranks} ranks do not divide over "
                         f"{spec.num_processes} processes")
    return per, spec.process_id * per
