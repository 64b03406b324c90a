"""Where one chain's time goes on the card: ``torch.profiler`` over a chunk
of iterations after a warm-up, each kernel's device time per iteration, and
the device's idle share.

    python -m bpmf_tpu_torch.profile_chain --data ml1m -d 64
    python -m bpmf_tpu_torch.profile_chain --data chembl -d 64 --warmup 10 --iters 10
    python -m bpmf_tpu_torch.profile_chain --data chembl-tall --warmup 3 --iters 5
    BPMF_D8_SOLVE=split python -m bpmf_tpu_torch.profile_chain --data ml1m -d 32
    python -m bpmf_tpu_torch.profile_chain --data ml1m --gram-impl bucketed
    python -m bpmf_tpu_torch.profile_chain --data ml25m-half --gram-impl bucketed
    python -m bpmf_tpu_torch.profile_chain --data ml1m --offgrid [--fuse-dense off]
    python -m bpmf_tpu_torch.profile_chain --data ml1m -d 96

The routing knobs (``BPMF_D8_SOLVE``, ``BPMF_D8_PT``) apply as in any run;
``--gram-impl`` and ``--fuse-dense`` are the Config fields of the same
names, and ``--offgrid`` moves the ratings off their grid by a seeded
uniform +-0.25 (what ``chip_smoke.py``'s offgrid phase runs).
Prints one JSON object: ms/iter of an unprofiled chunk and of the profiled
one (both host clock, each ending in a device sync), device ms/iter (the
sum of all kernel times: one stream, so kernels do not overlap), the idle
share 1 - device time / wall time of the unprofiled chunk (the profiler
slows the host, so the same share of the profiled chunk is printed beside
it as an upper bound), and the kernels by device time per iteration.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from bpmf_tpu_torch import Config, synth_chembl, synth_movielens
from bpmf_tpu_torch.device import card_power


def _device_us(evt) -> float:
    # the attribute was renamed from cuda to device in torch 2.4
    return getattr(evt, "self_device_time_total", None) or evt.self_cuda_time_total


def dataset(data: str, offgrid: bool):
    if data == "ml1m":
        train, test = synth_movielens()
    elif data == "ml25m-half":  # bench.py's ml-25M half-scale leg
        train, test = synth_movielens(n_users=81_270, n_movies=29_523,
                                      n_ratings=6_250_000, seed=25)
    elif data == "chembl-tall":  # 800,256 padded compounds: past the
        # crossover where a fused K=32 side streams the hoisted operand (#2)
        train, test = synth_chembl(n_compounds=800_000, n_proteins=360,
                                   n_ratings=2_875_000, seed=77)
    else:
        train, test = synth_chembl()
    if offgrid:
        rng = np.random.default_rng(2024)
        train.data = train.data + rng.uniform(-0.25, 0.25, train.nnz)
        test.data = test.data + rng.uniform(-0.25, 0.25, test.nnz)
    return train, test


def profile(data: str, k: int, warmup: int, iters: int, top: int,
            offgrid: bool = False, **cfg) -> dict:
    from bpmf_tpu_torch.sampler import BPMF

    train, test = dataset(data, offgrid)
    s = BPMF(Config(num_latent=k, burnin=2, nsims=warmup + 2 * iters, **cfg),
             train, test, out=open(os.devnull, "w"), device="cuda")
    s.run_chunk(warmup)  # builds the kernels, warms the allocator
    t0 = time.perf_counter()
    s.run_chunk(iters)
    plain_s = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        s.run_chunk(iters)
        wall_s = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0]
    kernels.sort(key=_device_us, reverse=True)
    device_ms = sum(_device_us(e) for e in kernels) / 1e3 / iters
    wall_ms = wall_s * 1e3 / iters
    return {
        "data": data, "offgrid": offgrid, "k": k, "iterations": iters,
        "config": cfg, "solver": s.solver,
        "routes": {"movies": [s.movies.impl, s.movies.route],
                   "users": [s.users.impl, s.users.route]},
        "ms_per_iter": plain_s * 1e3 / iters,
        "ms_per_iter_profiled": wall_ms,
        "device_ms_per_iter": device_ms,
        "idle_share": 1.0 - device_ms / (plain_s * 1e3 / iters),
        "idle_share_profiled": 1.0 - device_ms / wall_ms,
        "kernels": [{"name": e.key[:100], "calls_per_iter": e.count / iters,
                     "ms_per_iter": _device_us(e) / 1e3 / iters}
                    for e in kernels[:top]],
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": card_power(),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data",
                    choices=("ml1m", "chembl", "chembl-tall", "ml25m-half"),
                    default="ml1m",
                    help="synth_movielens(), synth_chembl(), the same at "
                         "800,000 compounds x 360 proteins with 2,875,000 "
                         "ratings, or bench.py's ml-25M half scale")
    ap.add_argument("--offgrid", action="store_true",
                    help="move the ratings off their grid (uniform +-0.25)")
    ap.add_argument("--gram-impl", default="auto",
                    choices=("auto", "dense", "dense8", "bucketed"))
    ap.add_argument("--fuse-dense", default="auto", choices=("auto", "on", "off"))
    ap.add_argument("-d", "--num-latent", type=int, default=32)
    ap.add_argument("--warmup", type=int, default=30)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--top", type=int, default=15, help="kernels listed")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_chain: needs an NVIDIA GPU")
    print(json.dumps(profile(a.data, a.num_latent, a.warmup, a.iters, a.top,
                             offgrid=a.offgrid, gram_impl=a.gram_impl,
                             fuse_dense=a.fuse_dense)), flush=True)


if __name__ == "__main__":
    main()
