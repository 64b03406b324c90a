"""Command-line interface of the port: the JAX package's flags (its own
copy of ``bpmf_tpu/cli.py``'s ``build_parser`` / ``config_from_args``)
plus ``--device`` and ``--fuse-dense``.

Usage: python -m bpmf_tpu_torch -n <MTX> -p <MTX> [-i N] [-b N] [-d K]
                                [--gram-impl auto|dense|dense8|bucketed]
                                [--solver auto|xla|vpu|pallas|smart|unrolled]
                                [--fuse-dense auto|on|off] [--diagonal-only]
                                [--dtype auto|float32|float64]
                                [-o DIR] [-v] [--checkpoint FILE] [--resume FILE]
                                [--ablate ...] [--profile]
                                [--devices N] [--mode auto|gather|reduce]
                                [--reduce-chunked auto|on|off]
                                [--halo auto|on|off]
                                [--dist HOST:PORT,NPROC,PID]
                                [--device cuda|cpu] ...

``--devices N`` (N > 1) starts N ranks on this host, one process each, on a
free local port: NCCL with one GPU a rank on ``cuda``, gloo on the CPU
(``--device cpu``); ``0`` means every visible GPU (one rank on the CPU).
Asking for more GPUs than there are is an error.  Under ``torchrun`` the
ranks come from the environment instead.  Rank 0 prints and writes the
files; the other ranks are silent.

``--dist HOST:PORT,NPROC,PID`` (or ``BPMF_DIST``) makes this process one of
NPROC that run one group together, meeting at ``tcp://HOST:PORT``, where
process 0 serves the store (``bpmf_tpu/cli.py:102``).  ``--devices N``
then counts the ranks of the whole run (``0``: NPROC times this host's
GPUs, one rank a process on the CPU), N / NPROC of them in each process,
which holds global ranks ``PID * N / NPROC`` on; each takes its GPU by
its place on its host.  Only global rank 0 prints.

Every flag of the JAX CLI is ported but ``--platform``, which selects a
JAX platform and stops the run with an error (``--device`` selects the
port's).
"""

from __future__ import annotations

import argparse
import os
import sys

from bpmf_tpu_torch.config import Config
from bpmf_tpu_torch.sampler import unsupported

__all__ = ["build_parser", "config_from_args", "main"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m bpmf_tpu_torch",
        description="Bayesian Probabilistic Matrix Factorization in PyTorch/CUDA",
    )
    # reference flags (c++/bpmf.cpp:83-109)
    p.add_argument("-n", dest="train", metavar="MTX", help="training input data")
    p.add_argument("-p", dest="test", metavar="MTX", help="test input data")
    p.add_argument("-o", dest="output", metavar="DIR", default="",
                   help="output directory for model and predictions")
    p.add_argument("-i", dest="nsims", type=int, default=20,
                   help="number of total iterations (default 20)")
    p.add_argument("-b", dest="burnin", type=int, default=5,
                   help="number of burnin iterations (default 5)")
    p.add_argument("-f", dest="update_freq", type=int, default=1,
                   help="send frequency (parity flag; unused, like the reference)")
    p.add_argument("-a", dest="alpha", type=float, default=2.0,
                   help="noise precision alpha (default 2.0)")
    p.add_argument("-d", dest="num_latent", type=int, default=32,
                   help="number of latent dimensions K (default 32)")
    p.add_argument("-k", dest="no_permute", action="store_true",
                   help="do not optimize item-to-shard assignment")
    p.add_argument("-r", dest="redirect", action="store_true",
                   help="redirect stdout to bpmf_0.out")
    p.add_argument("-v", dest="verbose", action="store_true",
                   help="output all samples")
    p.add_argument("-t", dest="nthreads", type=int, default=-1,
                   help="thread count (parity flag; unused)")
    p.add_argument("-m", dest="prop_v", metavar="MTX,MTX", default="",
                   help="propagated posterior mu,Lambda for V (movies)")
    p.add_argument("-l", dest="prop_u", metavar="MTX,MTX", default="",
                   help="propagated posterior mu,Lambda for U (users)")
    # extras of the JAX package
    p.add_argument("--mode", choices=["auto", "gather", "reduce"], default="auto",
                   help="exchange mode (multi-device)")
    p.add_argument("--dtype", choices=["auto", "float32", "float64"], default="auto")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--devices", type=int, default=0,
                   help="number of devices (0 = all available)")
    p.add_argument("--profile", action="store_true",
                   help="per-phase counters (ENABLE_PROFILING analog)")
    p.add_argument("--diagonal-only", action="store_true",
                   help="diagonal precision only (ONLY_VARIANCE analog)")
    p.add_argument("--chunk", type=int, default=8, metavar="N",
                   help="iterations per host sync; per-iteration log lines "
                        "are preserved")
    p.add_argument("--solver", default="auto",
                   choices=["auto", "xla", "vpu", "pallas", "smart", "unrolled"],
                   help="batched Cholesky+solve of the dense and bucketed "
                        "routes (auto: smart in float32, xla in float64)")
    p.add_argument("--gram-impl", default="auto",
                   choices=["auto", "dense", "dense8", "bucketed"],
                   help="Gram accumulation layout (auto picks per side: int8 "
                        "dense stream for grid-quantizable ratings, dense "
                        "adjacency while it fits, degree buckets otherwise)")
    p.add_argument("--fuse-dense", default="auto", choices=["auto", "on", "off"],
                   help="packed-triangle fused solve on dense sides "
                        "(auto = where eligible; off = the plain dense route)")
    p.add_argument("--reduce-chunked", default="auto",
                   choices=["auto", "on", "off"],
                   help="reduce-mode stat exchange granularity (multi-device)")
    p.add_argument("--halo", default="auto", choices=["auto", "on", "off"],
                   help="connectivity-aware frozen-side exchange (multi-device)")
    p.add_argument("--checkpoint", default="", metavar="FILE",
                   help="save full sampler state to FILE (.npz)")
    p.add_argument("--checkpoint-freq", type=int, default=0, metavar="N")
    p.add_argument("--resume", default="", metavar="FILE",
                   help="resume a run from a checkpoint file")
    p.add_argument("--ablate", default="",
                   choices=["", "nogather", "nogram", "nomatmul", "nosolve",
                            "nopredict", "nohyper", "nonoise"],
                   help="perf-debug: skip a sweep phase to isolate its cost")
    p.add_argument("--dist", default="", metavar="HOST:PORT,NPROC,PID",
                   help="join a run over NPROC processes: the store's "
                        "address, the process count, this process's id; "
                        "also settable via BPMF_DIST")
    p.add_argument("--platform", default="", metavar="NAME",
                   help="a JAX platform; this package takes --device")
    p.add_argument("--device", default="cuda",
                   help="torch device, 'cuda' (default: a GPU a rank) or "
                        "'cpu'; 'cuda:<i>' puts every rank of this host on "
                        "GPU i, over gloo; there is no fallback between them")
    return p


def config_from_args(args) -> Config:
    return Config(
        num_latent=args.num_latent,
        nsims=args.nsims,
        burnin=args.burnin,
        alpha=args.alpha,
        update_freq=args.update_freq,
        permute=not args.no_permute,
        verbose=args.verbose,
        redirect=args.redirect,
        output_dir=args.output,
        train_file=args.train or "",
        test_file=args.test or "",
        prop_u=args.prop_u,
        prop_v=args.prop_v,
        seed=args.seed,
        dtype=args.dtype,
        comm_mode=args.mode,
        n_devices=args.devices,
        diagonal_only=args.diagonal_only,
        profile=args.profile,
        chunk=args.chunk,
        solver=args.solver,
        gram_impl=args.gram_impl,
        fuse_dense=args.fuse_dense,
        reduce_chunked=args.reduce_chunked,
        halo=args.halo,
        checkpoint_path=args.checkpoint,
        checkpoint_freq=args.checkpoint_freq,
        resume=args.resume,
        ablate=args.ablate,
    )


def main(argv=None) -> int:
    parser = build_parser()
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser.parse_args(argv)
    if not args.train or not args.test:
        parser.print_help()
        return 1
    cfg = config_from_args(args)
    problems = unsupported(cfg)
    if args.platform:
        problems.append("--platform selects a JAX platform; this package "
                        "takes --device")
    if problems:
        parser.error("; ".join(problems))

    from bpmf_tpu_torch.parallel import mesh as pm

    try:
        spec = pm.dist_spec(args.dist or None)
    except ValueError as e:
        parser.error(str(e))
    mesh = None if spec else pm.mesh_from_env(args.device)  # a rank of torchrun
    if mesh is not None:
        return _run_rank(cfg, args.device, mesh)
    # a GPU named by its index (--device cuda:<i>) holds every rank of this
    # host, over gloo: NCCL refuses two ranks on one GPU
    shared = pm.shared_gpu(args.device)
    backend = "gloo" if shared else None

    def host_ranks(n: int) -> int:
        # a shared GPU, as the CPU, takes any number of ranks (0: one)
        return pm.resolve_n_devices(n, "cpu" if shared else args.device)

    try:
        if spec is None:
            n = host_ranks(cfg.n_devices)
            per, offset = n, 0
        else:
            n = cfg.n_devices or spec.num_processes * host_ranks(0)
            per, offset = pm.dist_ranks(n, spec)
            host_ranks(per)   # this host's share
    except ValueError as e:
        print(f"bpmf: error: {e}", file=sys.stderr)
        return 1
    if spec is None and n <= 1:
        return _run(cfg, args.device, None)
    init = spec.init_method if spec else None
    if per == 1 and spec is not None:
        # one rank in this process: it joins the group itself
        mesh = pm.init_mesh(offset, n, init, args.device, backend, local=0)
        return _run_rank(cfg, args.device, mesh)
    from bpmf_tpu_torch.parallel.launch import run_ranks

    threads = (max(1, (os.cpu_count() or 1) // per)
               if args.device == "cpu" else None)
    try:
        codes = run_ranks(_rank, per, argv, device=args.device, backend=backend,
                          threads=threads, rank_offset=offset, world_size=n,
                          init_method=init)
    except RuntimeError as e:
        print(f"bpmf: error: {e}", file=sys.stderr)
        return 1
    return max(codes)


def _run_rank(cfg: Config, device, mesh) -> int:
    """The run of one rank that this process joined to its group."""
    try:
        return _run(cfg, device, mesh)
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()


def _rank(mesh, argv) -> int:
    """One rank of ``--devices N`` (``parallel.launch.run_ranks``)."""
    args = build_parser().parse_args(argv)
    return _run(config_from_args(args), args.device, mesh)


def _run(cfg: Config, device, mesh) -> int:
    """The run of one device or of this rank of ``mesh``; rank 0 prints
    (to ``bpmf_0.out`` under ``-r``) and reports the errors."""
    from bpmf_tpu_torch.sampler import BPMF

    rank0 = mesh is None or mesh.rank == 0
    out = open("bpmf_0.out", "w") if cfg.redirect and rank0 else None
    try:
        BPMF(cfg, out=out, device=device, mesh=mesh).run()
    except FileNotFoundError as e:
        if rank0:
            print(f"bpmf: error: file not found: {e}", file=sys.stderr)
        return 1
    except (ValueError, NotImplementedError) as e:
        if rank0:
            print(f"bpmf: error: {e}", file=sys.stderr)
        return 1
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
