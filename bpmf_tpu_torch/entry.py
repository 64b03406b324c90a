"""Entry points of the port, the counterparts of the JAX package's
``__graft_entry__.py`` (which stays that package's):

``entry(device="cuda")``        one full Gibbs iteration of BPMF as a function
                                of explicit state (``BPMF.iter_fn``) on a
                                tiny chain, and arguments to call it with.
``dryrun_multichip(n, device)`` the sharded training step on ``n`` ranks in
                                five exchange legs, two steps each, then a
                                run of two processes joined through
                                ``BPMF_DIST``, ``n // 2`` ranks in each.

    python -m bpmf_tpu_torch.entry     # dryrun_multichip(8), then entry()'s
                                       # function once; needs CUDA

Both run on the card unless the caller passes ``device="cpu"`` (the
kernels' plain versions, gloo ranks); without CUDA the default raises.  A
host with fewer GPUs than ranks puts them all on one GPU over gloo (NCCL
refuses two ranks on one GPU), as ``--device cuda:0`` does on the command
line, and the dryrun's lines say which placement ran.
"""

from __future__ import annotations

import io
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from bpmf_tpu_torch.config import Config
from bpmf_tpu_torch.datasets import synth_movielens
from bpmf_tpu_torch.device import resolve_device
from bpmf_tpu_torch.ops import launch_counts
from bpmf_tpu_torch.parallel.mesh import free_port, shared_gpu

__all__ = ["LEGS", "dryrun_multichip", "entry"]

# the JAX package's tiny chain (__graft_entry__.py:16-38): on the grid and
# float32 (its smaller side, 64, is 2K), so one device takes dense8 and #1
TINY_DATA = dict(n_users=96, n_movies=64, n_ratings=1500, seed=7)
TINY_CFG = dict(num_latent=16, nsims=4, burnin=1)
# the five exchange legs (mode, gram_impl, reduce_chunked, halo),
# __graft_entry__.py:161-171: value exchange; statistic exchange, plain and
# chunked; the sharded dense8 stream; the buckets over the halo ring
LEGS = (("gather", "auto", "auto", "auto"),
        ("reduce", "auto", "auto", "auto"),
        ("reduce", "auto", "on", "auto"),
        ("gather", "dense8", "auto", "auto"),
        ("gather", "bucketed", "auto", "on"))
# the kernel libraries the legs run (#3, #5, #8): built in the parent once,
# before the ranks start, so that they do not all build them at once
LEG_LIBS = ("dense8_gram_rhs", "tri_combine_solve", "chol_solve_sample")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny_sampler(n_devices: int, comm_mode: str = "gather",
                  gram_impl: str = "auto", reduce_chunked: str = "auto",
                  halo: str = "auto", device="cuda", mesh=None):
    """The tiny chain's sampler, set up: on ``device``, or on this rank of
    ``mesh`` (``n_devices`` ranks)."""
    from bpmf_tpu_torch.sampler import BPMF

    train, test = synth_movielens(**TINY_DATA)
    cfg = Config(n_devices=n_devices, comm_mode=comm_mode, gram_impl=gram_impl,
                 reduce_chunked=reduce_chunked, halo=halo, **TINY_CFG)
    s = BPMF(cfg, train, test, out=io.StringIO(), device=device, mesh=mesh)
    s.setup()
    return s


def entry(device="cuda"):
    """Return (fn, example_args): ``fn(state_m, state_u, est, draws, it)``,
    one full Gibbs iteration of the tiny chain (:meth:`BPMF.iter_fn`: new
    state, new Welford state and the metrics, none of the inputs written),
    and its first iteration's arguments (the initial state and the chain's
    ``TorchDraws``, which stand for the JAX key)."""
    s = _tiny_sampler(1, device=device)
    return s.iter_fn, (s.state_m, s.state_u, s.est, s.draws, 0)


def _legs_rank(mesh, n_devices: int) -> list:
    """Every leg on this rank: its sampler, two steps.  Per leg, the
    metrics of both steps ([2, 4]: rmse, rmse_avg, norm_users,
    norm_movies) and the kernels this rank launched."""
    out = []
    for leg in LEGS:
        before = launch_counts()
        s = _tiny_sampler(n_devices, *leg, mesh=mesh)
        mets = np.array([list(s.step()) for _ in range(2)])
        after = launch_counts()
        out.append((mets, {k: after[k] - before[k] for k in after
                           if after[k] != before[k]}))
    return out


def _placement(n_devices: int, device) -> tuple:
    """(rank device, backend, what the lines say) of ``n_devices`` ranks:
    gloo on the CPU; a GPU a rank over NCCL where the host has enough; else
    every rank on ``device``'s GPU over gloo."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return "cpu", "gloo", "gloo on the CPU"
    if not shared_gpu(device) and torch.cuda.device_count() >= n_devices:
        return "cuda", "nccl", "nccl, a GPU a rank"
    return (str(dev), "gloo", f"gloo, {n_devices} ranks on {dev} "
            f"({torch.cuda.get_device_name(dev)})")


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """One full sharded training step, twice, on ``n_devices`` ranks for
    each of :data:`LEGS`, asserting finite metrics and printing a line per
    leg; then :func:`_dryrun_multihost`.  The ranks are started once
    (``parallel.launch.run_ranks``) and run every leg.  Returns {"legs":
    [{"leg", "metrics": rank 0's [2, 4], "launches": summed over ranks}],
    "placement", "multihost": its result}."""
    from bpmf_tpu_torch.parallel.launch import run_ranks

    rank_dev, backend, where = _placement(n_devices, device)
    threads = None
    if rank_dev == "cpu":
        threads = max(1, (os.cpu_count() or 1) // n_devices)
    else:
        from bpmf_tpu_torch.ops._build import build

        with ThreadPoolExecutor(len(LEG_LIBS)) as pool:
            list(pool.map(build, LEG_LIBS))
    ranks = run_ranks(_legs_rank, n_devices, n_devices, device=rank_dev,
                      backend=backend, threads=threads, timeout_s=900)
    legs = []
    for j, (mode, gram, chunked, halo) in enumerate(LEGS):
        mets = ranks[0][j][0]
        if not np.isfinite(mets).all():
            raise FloatingPointError(f"dryrun_multichip: leg {LEGS[j]} gave "
                                     f"non-finite metrics {mets.tolist()}")
        launches: dict = {}
        for rank in ranks:
            for key, c in rank[j][1].items():
                launches[key] = launches.get(key, 0) + c
        legs.append({"leg": LEGS[j], "metrics": mets, "launches": launches})
        print(f"dryrun_multichip: mode={mode} gram={gram} chunked={chunked} "
              f"halo={halo} n_devices={n_devices} ok (rmse={mets[1, 0]:.4f}) "
              f"[{where}]", flush=True)
    return {"legs": legs, "placement": where,
            "multihost": _dryrun_multihost(n_devices, device)}


def _dryrun_multihost(n_devices: int, device="cuda"):
    """Two OS processes of ``n_devices // 2`` ranks each, joined into one
    group through ``BPMF_DIST`` (``__graft_entry__.py:187-260``):
    ``python -m bpmf_tpu_torch`` on the tiny chain written as .sdm, 3
    iterations.  One retry when a run fails (the store's port taken between
    the probe and its use); a child past its time is killed with its
    sibling.  Skipped, with a notice, for odd ``n_devices``.  Returns
    {"final": process 0's "Final Avg RMSE" line, "stdout": its output}, or
    None when skipped."""
    from bpmf_tpu_torch.io import write_matrix

    if n_devices % 2 or n_devices < 2:
        print(f"dryrun_multichip: multihost skipped (n_devices={n_devices})",
              flush=True)
        return None
    per = n_devices // 2
    # the command line's placements: --device cpu; --device cuda, each
    # process seeing its own block of the host's GPUs; --device cuda:<i>,
    # every rank on that GPU over gloo
    dev_arg, backend, where = _placement(n_devices, device)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)
    gpus = None
    if backend == "nccl":
        visible = env.get("CUDA_VISIBLE_DEVICES")
        gpus = (visible.split(",") if visible
                else [str(i) for i in range(torch.cuda.device_count())])

    train, test = synth_movielens(**TINY_DATA)
    with tempfile.TemporaryDirectory() as td:
        tr, te = os.path.join(td, "train.sdm"), os.path.join(td, "test.sdm")
        write_matrix(tr, train)
        write_matrix(te, test)
        args = ["-n", tr, "-p", te, "-i", "3", "-b", "1", "-d", "16",
                "--seed", "7", "--devices", str(n_devices), "--device", dev_arg]
        for attempt in range(2):
            port = free_port()
            procs = []
            for pid in range(2):
                penv = dict(env, BPMF_DIST=f"127.0.0.1:{port},2,{pid}")
                if gpus is not None:
                    penv["CUDA_VISIBLE_DEVICES"] = ",".join(
                        gpus[pid * per:(pid + 1) * per])
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "bpmf_tpu_torch", *args], env=penv,
                    cwd=td, text=True, stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE))
            # a wedged child must not hang the dryrun: kill both (one hung
            # store strands its sibling) and take the retry or failure path
            outs, timed_out = [], False
            for p in procs:
                try:
                    outs.append(p.communicate(timeout=600))
                except subprocess.TimeoutExpired:
                    timed_out = True
                    for q in procs:
                        if q.poll() is None:
                            q.kill()
                    outs.append(p.communicate())
            if not timed_out and all(p.returncode == 0 for p in procs):
                break
            if attempt == 0:
                continue
            raise RuntimeError("dryrun_multichip: multihost failed: "
                               + "".join(err[-2000:] for _, err in outs))
    stdout = outs[0][0]
    final = [line for line in stdout.splitlines()
             if line.startswith("Final Avg RMSE")]
    if not final:
        raise RuntimeError("dryrun_multichip: multihost printed no Final Avg "
                           f"RMSE:\n{stdout[-2000:]}")
    print(f"dryrun_multichip: multihost 2 procs x {per} devices ok "
          f"({final[0]}) [{where}]", flush=True)
    return {"final": final[0], "stdout": stdout}


def main() -> None:
    dryrun_multichip(8)
    fn, args = entry()
    out = fn(*args)
    print("entry: run ok; rmse =", float(out[3].rmse), flush=True)


if __name__ == "__main__":
    # through the module's own name, so that the ranks (spawned
    # interpreters) import the rank function from bpmf_tpu_torch.entry
    from bpmf_tpu_torch.entry import main as _main

    _main()
