"""Times of the dense8 kernels on the chains' own inputs, to compare two
checkouts of this repository on one card.

    python bpmf_tpu_torch/scripts/sweep_times.py [--root DIR] [--label NAME]
        [--legs tall,ml1m,random,wide,instances,split,blast,hoisted,bf16,
               mega_bf16,probe]

Imports ``bpmf_tpu_torch`` from DIR (default: the checkout this file lies
in), so one copy of the script times any tree whose megakernel has the
signature ``dense8_sweep_solve(codes, p_t, v_t, lam, prior_rhs, noise_t,
cs, cb, alpha, orientation, layout)`` and whose split kernels have
``dense8_gram_rhs_rows/cols(codes, p_t, v_t, cs, cb)`` and
``tri_combine_solve_sample(gram_t, lam, rhs_t, noise_t, alpha, ...)``;
where the tree's wrapper takes ``max_degree`` it gets the side's, as the
sampler passes it.  Run the trees in turns in one call (parent, change,
change, parent): times of one tree differ across calls by more than
between turns of one call.

Prints one JSON line with a key per leg (default: tall, ml1m, random):

* ``tall``: the chembl synth at 800,000 compounds x 360 proteins (seed 77,
  K=32; the compounds on #2, the proteins on #1): ms/iter of a chunk of
  iterations after a warm-up chunk (host clock, ending in a sync); then on
  the chain's code array and last state, the median CUDA-event time of #1
  on the proteins (cols), of #2 on the compounds (rows, tight operand), and
  of #2 on an all-zero code array of the compounds' shape (the tile scan
  and the per-item solve, no rating);
* ``ml1m``: the ml-1m synth at K=32 (#1 on both sides): ms/iter, and #1 on
  the users (rows) and on the movies (cols) on the chain's last state;
* ``random``: #1 and #2 (tight, aligned) at the padded ml-1m shape
  [6144, 4096], K=32 and K=16, on random codes 1..5 at ~4% (the inputs
  of ``chip_smoke.py`` phase 3), rows + cols;
* ``wide``: the ml-1m synth and the chembl synth (167,000 x 360) at K=40:
  ms/iter after a warm-up chunk, and each side's route (the megakernel,
  #1 and #2 at a runtime K on the capacity 40, where the tree fuses K=40;
  else the split pipeline);
* ``instances`` (trees with ``ops.dense8.sweep_instance`` only): the
  megakernel's instances per launch on random codes at [6144, 4096] and
  on light [167424, 512] and heavy [1024, 4096] items: #2 at K=16/32 on
  its own instance and on the runtime-K one, #1 and #2 tight at K=40
  (capacity 40) and 41 (44), #2 aligned at K=39 (:func:`instance_times`);
* ``split``: the split pipeline (#3/#4 + #5).  The chembl synth (167,000 x
  360, seed 77) at K=64 (the compounds on #4 + #5, the proteins on #3 +
  #5) and the ml-1m synth at K=64 (#3 + #5 on both sides): ms/iter after a
  warm-up chunk, then one more iteration whose kernel calls are kept, and
  each kept call timed again on its own arguments (the chain's codes, last
  state and systems); the off-grid ml-1m synth at K=32 (fused dense, #5 on
  the packed Gram matmul's batch-last systems) the same way; and #3 and #5
  at [6144, 4096], K=64 and K=32, on ``chip_smoke.py`` phase 5's random
  codes and frozen items, rows + cols;
* ``blast``: #8 at B = 6144 on ``chip_smoke.py`` phase 10's random SPD
  systems at every K of :data:`BLAST_KS` (one K per instance class and
  its edges), each beside the ``torch.linalg`` chain (Cholesky, two
  triangular solves); then the chains whose solve is #8: the ml-1m synth
  at K=32 on the bucketed route, the ml-25M synth at half scale (81,270 x
  29,523, 6.25M ratings, seed 25) bucketed, and the ml-1m synth at K=96
  (plain dense): ms/iter after a warm-up chunk, then #8 on each side's
  systems of one more iteration;
* ``hoisted``: #4 at [6144, 4096], K=64, rows + cols, on ``chip_smoke.py``
  phase 5's random codes and frozen items, beside its library chain (the
  f32 indicator's matmul with the packed operand and the rhs matmul, TF32
  off) and, where the tree has ``hoisted_plan``, forced to one segment;
  then the chembl synth at K=64 under ``BPMF_D8_PT=hoisted`` (#4 on both
  sides: the proteins' most-rated with 61,253 ratings) as ``split`` runs
  its chains;
* ``bf16``: the split and hoisted legs on bf16 operands
  (``Config.matmul_dtype="bfloat16"``): #3 and #4 at [6144, 4096], K=64,
  rows + cols, on the hoisted leg's codes and frozen items rounded to bf16
  (single calls, per launch, and cuBLAS's bf16 chain,
  :func:`bf16_random`), then the ml-1m synth and the chembl synth at K=64
  as ``split`` runs them (the ml-1m sides on #3, the chembl compounds on
  #4 and its proteins on #3);
* ``mega_bf16``: the megakernel on bf16 operands, #1 and #2 (tight,
  aligned) at [6144, 4096], K=32, rows + cols, on random codes at every
  density of :data:`MEGA_DENSITIES` from all zero (the code scan and the
  per-item solve alone) to 4% (:func:`mega_bf16_times`), then #1 at bf16
  on the chembl synth's and the ml-25M synth at half scale's own codes and
  state at K=32 (:func:`mega_chain_times`): the two ends of the densities
  the bench's legs run;
* ``ml1m_bf16``: the ml-1m synth's chain at K=32 on bf16 operands (#1 on
  both sides, by the route), three runs of ``--ml1m-iters`` iterations
  after a warm chunk of 50: ms/iter, host-paced (any tree);
* ``bf16_choice``: #1 and #2 on bf16 operands on the tensor-core kernel
  and on the walk, each side of five chains' own state at K=32 (ml-1m,
  ml-100k's 943 x 1682 with 100,000 ratings, the 3000 x 2000 dense
  synth, the chembl synth, and ``synth_jester`` at Jester Dataset 1's
  scale), beside both cost models' times and the kernel
  ``sweep_bf16_kernel`` picks (:func:`bf16_choice_times`);
* ``probe``: the gather probes #9A, #9B, #9C and ``embedding_bag`` (the
  same function in one PyTorch call) at the JAX script's shapes (R = W =
  512, NV = 32768, K = 32), at R = 8192, B and ``embedding_bag`` at NV =
  81,270 (the ml-25M half-scale user count), and A, C and
  ``embedding_bag`` at W = 2000 (C there only where it has
  ``probe_plan_copy``): ms per launch over 100 back-to-back launches
  (:func:`per_launch_ms`), and beside it the median of 51 single calls,
  as ``chip_smoke.py``'s ``ms`` times them, with the wrapper's host time
  (the kernels' calls interleaved, :func:`single_calls`) and one launch's
  device time alone (:func:`alone_ms`).  Any tree whose wrappers are
  ``gather_sum_rows/lanes/copy(idx, table)`` times.
"""

from __future__ import annotations

import argparse
import inspect
import json
import math
import os
import subprocess
import sys
import time


def median_ms(fn, reps, warmup=2):
    """Median of per-launch CUDA-event times."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


SPIN_CYCLES = 20_000_000   # a spin kernel of about 10 ms on an H100


def per_launch_ms(fn, n=100, warmup=3):
    """CUDA-event time of ``n`` back-to-back calls of ``fn``, over ``n``.  A
    spin kernel (``torch.cuda._sleep``) holds the stream while the host
    enqueues the calls, so the host's work per call (a wrapper's checks,
    ``torch.empty``, the launch) does not pace the device: the spin is
    lengthened until the host has enqueued all ``n`` before it ends."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = SPIN_CYCLES
    for _ in range(4):
        spin, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        spin.record()
        torch.cuda._sleep(cycles)
        a.record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        b.record()
        b.synchronize()
        spin_ms = spin.elapsed_time(a)
        if host_ms < spin_ms:
            return a.elapsed_time(b) / n
        cycles *= 2 * math.ceil(host_ms / spin_ms)
    raise RuntimeError(f"per_launch_ms: the host took {host_ms:.3f} ms to "
                       f"enqueue {n} calls, longer than a {spin_ms:.3f} ms spin")


def single_calls(fns, reps=51, warmup=3):
    """Each of ``fns`` ({name: fn}) called alone ``reps`` times, the names
    taken in turn (rotated every rep) so that each meets the host in the
    same state: ``{name}_single_call_ms``, the median CUDA-event time
    around the call as ``median_ms`` (and ``chip_smoke.py``'s ``ms``) take
    it, and ``{name}_host_ms``, the median wall time until the call
    returns: a wrapper's checks, plan, ``torch.empty`` and the launch's API
    calls, what the single call spends before its kernel can start."""
    import torch

    names = list(fns)
    for name in names:
        for _ in range(warmup):
            fns[name]()
    single, host = ({name: [] for name in names} for _ in range(2))
    for i in range(reps):
        for name in names[i % len(names):] + names[:i % len(names)]:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            t0 = time.perf_counter()
            fns[name]()
            host[name].append((time.perf_counter() - t0) * 1e3)
            b.record()
            b.synchronize()
            single[name].append(a.elapsed_time(b))
    out = {}
    for name in names:
        out[f"{name}_single_call_ms"] = sorted(single[name])[reps // 2]
        out[f"{name}_host_ms"] = sorted(host[name])[reps // 2]
    return out


def alone_ms(fn, reps=9):
    """Median device time of one launch of ``fn`` on its own behind a spin
    kernel (:func:`per_launch_ms` of one call): no host work in it, and
    no launch before it whose tail it could overlap."""
    times = sorted(per_launch_ms(fn, 1, warmup=1) for _ in range(reps))
    return times[len(times) // 2]


PROBE_CELLS = {"R512": (32, 32768, 512, 512, "ABC"),
               "R8192": (32, 32768, 8192, 512, "ABC"),
               "NV81270": (32, 81270, 512, 512, "B"),
               "W2000": (32, 32768, 512, 2000, "AC")}


def probe_times(n=100):
    """#9A/B/C and ``embedding_bag`` per launch (``*_ms``), one launch alone
    on the device (``*_alone_ms``), and as single calls
    (``*_single_call_ms``) with their host time (``*_host_ms``) at each of
    PROBE_CELLS (K, NV, R, W, kernels), the probe's inputs from seed 0.  C
    at W2000 only where #9C has a plan (``probe_plan_copy``: the ring),
    since the earlier C held all W rows in shared memory and refuses that
    W."""
    import torch

    from bpmf_tpu_torch.scripts import gather_probe as gp

    ring = hasattr(gp, "probe_plan_copy")
    out = {}
    for label, (k, nv, r, w, keys) in PROBE_CELLS.items():
        if label == "W2000" and not ring:
            keys = keys.replace("C", "")
        idx_np, table_np = gp.make_inputs(k=k, nv=nv, r=r, w=w)
        idx = torch.from_numpy(idx_np).to("cuda")
        table = torch.from_numpy(table_np).to("cuda")
        table_t = table.t().contiguous()
        fns = {"A": lambda: gp.gather_sum_rows(idx, table),
               "B": lambda: gp.gather_sum_lanes(idx, table_t),
               "C": lambda: gp.gather_sum_copy(idx, table),
               "embedding_bag": lambda: torch.nn.functional.embedding_bag(
                   idx, table, mode="sum")}
        names = (*keys, "embedding_bag")
        cell = {}
        for key in names:
            cell[f"{key}_ms"] = per_launch_ms(fns[key], n)
            cell[f"{key}_alone_ms"] = alone_ms(fns[key])
        cell.update(single_calls({key: fns[key] for key in names}))
        out[label] = cell
        del idx, table, table_t
    return out


def chain(bpmf, cfg, train, test, warm, iters, k=32, **kw):
    """A chain on the card after a warm chunk, and its ms/iter."""
    s = bpmf(cfg(num_latent=k, burnin=2, nsims=warm + iters + 1, **kw), train,
             test, out=open(os.devnull, "w"), device="cuda")
    s.run_chunk(warm)
    t0 = time.perf_counter()
    s.run_chunk(iters)
    return s, (time.perf_counter() - t0) * 1e3 / iters


def sweep_timer(sampler, side, reps):
    """fn(name, codes=None) -> ms: the megakernel on ``side`` ('users':
    rows, 'movies': cols) of the chain's last state, #1 or, with name
    'tight', #2 on the packed operand; ``codes`` replaces the code array."""
    import torch

    from bpmf_tpu_torch.ops import dense8 as d8

    rows = side == "users"
    state, frozen = ((sampler.state_u, sampler.state_m) if rows
                     else (sampler.state_m, sampler.state_u))
    hp = state.hp
    v_t = frozen.items.t()
    k, items = v_t.shape[0], state.items.shape[0]
    noise_t = torch.randn((k, items), device="cuda",
                          generator=torch.Generator("cuda").manual_seed(0))
    kw = {}
    if "max_degree" in inspect.signature(d8.dense8_sweep_solve).parameters:
        kw["max_degree"] = int(getattr(sampler, side).degrees.max())

    def time_it(name, codes=None):
        codes = sampler._codes if codes is None else codes
        p_t = None if name == "inkernel" else d8.packed_tri_t(v_t)
        args = (codes, p_t, v_t, hp.lambda_f, (hp.lambda_f @ hp.mu)[:, None],
                noise_t, sampler._d8_cs, sampler._d8_cb, sampler.cfg.alpha,
                "rows" if rows else "cols")
        return median_ms(lambda: d8.dense8_sweep_solve(*args, layout="tight", **kw),
                         reps)
    return time_it


def random_times(reps=25):
    """#1 and #2 on random codes, rows + cols, as chip_smoke.py's phase 3
    draws them (its seeds 0 and 1), at K=32 (``<operand>_ms``) and on the
    K=16 instances (``k16_<operand>_ms``): the median single call, and
    (``..._per_launch_ms``) the device time per launch over 100 launches
    behind a spin kernel, which the wrapper's host work does not pace."""
    import torch

    from bpmf_tpu_torch.ops import dense8 as d8

    out = {}
    dev = torch.device("cuda")
    for k, prefix in ((32, ""), (16, "k16_")):
        total = {"inkernel": 0.0, "tight": 0.0, "aligned": 0.0}
        launch = dict.fromkeys(total, 0.0)
        for seed, orientation in enumerate(("rows", "cols")):
            g = torch.Generator(device=dev).manual_seed(seed)
            shape = (6144, 4096)
            codes = torch.where(torch.rand(shape, generator=g, device=dev) < 0.04,
                                torch.randint(1, 6, shape, generator=g, device=dev),
                                0).to(torch.int8)
            items, frozen = shape if orientation == "rows" else shape[::-1]
            g = torch.Generator(device=dev).manual_seed(seed + 100)
            v_t = 0.5 * torch.randn((k, frozen), generator=g, device=dev)
            w = torch.randn((k, k), generator=g, device=dev)
            lam = w @ w.T / k + torch.eye(k, device=dev)
            prior_rhs = torch.randn((k, 1), generator=g, device=dev)
            noise_t = torch.randn((k, items), generator=g, device=dev)
            for name in total:
                p_t = (None if name == "inkernel"
                       else d8.packed_tri_t(v_t, aligned=name == "aligned"))
                def call():
                    return d8.dense8_sweep_solve(
                        codes, p_t, v_t, lam, prior_rhs, noise_t, 2.0, -7.2, 2.0,
                        orientation, layout=name if p_t is not None else "aligned")
                total[name] += median_ms(call, reps)
                launch[name] += per_launch_ms(call)
        out.update({f"{prefix}{name}_ms": ms for name, ms in total.items()})
        out.update({f"{prefix}{name}_per_launch_ms": ms for name, ms in launch.items()})
    return out


def instance_times():
    """The megakernel's instances per launch (:func:`per_launch_ms`), on the
    ``rows`` side of random codes at the padded ml-1m shape [6144, 4096]
    (4%), of light items [167424, 512] (0.7%, about 3.6 ratings an item,
    the chembl compounds' shape) and of heavy ones [1024, 4096] (50%,
    about 2,048 an item): #1 and #2 (tight, aligned) at K = 16 and 32, #2
    both on its own instance and forced onto the runtime-K one of the same
    capacity (with the largest difference between the two draws), #1 and
    #2 tight at K=40 (capacity 40) and K=41 (44), #2 aligned at K=39.
    Needs a tree with ``ops.dense8.sweep_instance``."""
    import torch

    from bpmf_tpu_torch.ops import dense8 as d8

    dev = torch.device("cuda")
    own = d8.HOISTED_K
    out = {}

    def force(hoisted_k):
        d8.HOISTED_K = hoisted_k
        d8.sweep_instance.cache_clear()
        d8.sweep_instance_key.cache_clear()

    for tag, shape, density in (("ml1m", (6144, 4096), 0.04),
                                ("light", (167424, 512), 0.007),
                                ("heavy", (1024, 4096), 0.5)):
        g = torch.Generator(device=dev).manual_seed(3)
        codes = torch.where(torch.rand(shape, generator=g, device=dev) < density,
                            torch.randint(1, 6, shape, generator=g, device=dev),
                            0).to(torch.int8)
        items, frozen = shape
        for k in (16, 32, 39, 40, 41):
            v_t = (0.3 if tag != "heavy" else 0.05) * torch.randn(
                (k, frozen), generator=g, device=dev)
            w = torch.randn((k, k), generator=g, device=dev)
            lam = w @ w.T / k + torch.eye(k, device=dev)
            prior = torch.randn((k, 1), generator=g, device=dev)
            noise = torch.randn((k, items), generator=g, device=dev)
            operands = (("aligned",) if k == 39 else ("inkernel", "tight")
                        if k > 32 else ("inkernel", "tight", "aligned"))
            for operand in operands:
                p_t = (None if operand == "inkernel"
                       else d8.packed_tri_t(v_t, aligned=operand == "aligned"))
                ways = ((own, ""), ((), "_runtime")) if k in own and p_t is not None \
                    else ((own, ""),)
                got = {}
                for hoisted_k, suffix in ways:
                    force(hoisted_k)
                    def call():
                        return d8.dense8_sweep_solve(
                            codes, p_t, v_t, lam, prior, noise, 2.0, -7.2, 2.0,
                            "rows", layout="tight" if p_t is None else operand)
                    got[suffix] = call()
                    key = f"{tag}_k{k}_{operand}{suffix}"
                    out[key + "_ms"] = per_launch_ms(call)
                    out[key + "_instance"] = d8.sweep_instance_key(k, operand)
                if len(got) > 1:
                    out[f"{tag}_k{k}_{operand}_runtime_max_diff"] = float(
                        (got[""] - got["_runtime"]).abs().max())
                force(own)
    return out


def wide_times(bpmf, cfg, train, test):
    """The K=40 chains: the ml-1m synth and the chembl synth (167,000 x 360,
    seed 77), ms/iter after a warm-up chunk and the routes each side took
    (one megakernel launch a side where the tree fuses K=40, the split
    pipeline where it does not)."""
    from bpmf_tpu_torch import synth_chembl

    out = {}
    ctrain, ctest = synth_chembl()
    for name, (tr, te, warm, iters) in (("ml1m_k40", (train, test, 50, 200)),
                                        ("chembl_k40", (ctrain, ctest, 5, 20))):
        s, ms = chain(bpmf, cfg, tr, te, warm, iters, 40)
        out[name] = {"ms_per_iter": ms, "iterations": iters,
                     "routes": {"movies": s.movies.route, "users": s.users.route}}
        del s
    return out


SPLIT_CALLS = ("dense8_gram_rhs_rows", "dense8_gram_rhs_cols",
               "tri_combine_solve_sample")


def kept_calls(sampler):
    """One more iteration with the split kernels' wrappers (as the
    half-sweeps look them up) wrapped so that each call keeps its function
    and arguments: [(name, fn, args, kw)] in call order, movies first."""
    import bpmf_tpu_torch.parallel.spmd as spmd

    saved = {n: getattr(spmd, n) for n in SPLIT_CALLS}
    seen = []

    def wrap(name, fn):
        def kept(*args, **kw):
            seen.append((name, fn, args, kw))
            return fn(*args, **kw)
        return kept

    for name, fn in saved.items():
        setattr(spmd, name, wrap(name, fn))
    try:
        sampler.step()
    finally:
        for name, fn in saved.items():
            setattr(spmd, name, fn)
    return seen


def split_chain(bpmf, cfg, train, test, k, warm, iters, reps=10, **kw):
    """ms/iter of a split chain (``kw``: more of its Config), then each
    kernel call of one more iteration timed on its own arguments:
    gram_<side> (#3 or #4) and solve_<side> (#5), sides named movies and
    users."""
    s, ms = chain(bpmf, cfg, train, test, warm, iters, k, **kw)
    out = {"ms_per_iter": ms, "iterations": iters, "k": k,
           "routes": {"movies": s.movies.route, "users": s.users.route}}
    sides = iter(("movies", "users"))
    side = None
    for name, fn, args, kw in kept_calls(s):
        if name != "tri_combine_solve_sample":
            side = next(sides)
            key = f"gram_{'hoisted' if args[1] is not None else 'inkernel'}_{side}_ms"
        else:
            if side is None or any(x.startswith(f"solve_{side}") for x in out):
                side = next(sides)
            key = f"solve_{side}_ms"
        out[key] = median_ms(lambda: fn(*args, **kw), reps)
    return out


def split_random(reps=25):
    """#3 and #5 at [6144, 4096], K=64 and K=32, rows + cols, on
    chip_smoke.py phase 5's random codes and frozen items (its seeds, cs,
    cb and alpha)."""
    import torch

    from bpmf_tpu_torch.ops import dense8 as d8
    from bpmf_tpu_torch.ops import pallas_solve as ps

    out = {}
    for k in (64, 32):
        gram_ms = solve_ms = 0.0
        for i, orientation in enumerate(("rows", "cols")):
            g = torch.Generator(device="cuda").manual_seed(10 * k + i)
            gc = torch.Generator(device="cuda").manual_seed(10 * k + i)
            shape = (6144, 4096)
            codes = torch.where(
                torch.rand(shape, generator=gc, device="cuda") < 0.04,
                torch.randint(1, 6, shape, generator=gc, device="cuda"),
                0).to(torch.int8)
            items, frozen = shape if orientation == "rows" else shape[::-1]
            v_t = 0.5 * torch.randn((k, frozen), generator=g, device="cuda")
            fn = d8.dense8_gram_rhs_rows if orientation == "rows" else d8.dense8_gram_rhs_cols
            gram, rhs0 = fn(codes, None, v_t, 2.0, -7.2)
            w = torch.randn((k, k), generator=g, device="cuda")
            lam = w @ w.T / k + torch.eye(k, device="cuda")
            rhs = rhs0 + torch.randn((k, items), generator=g, device="cuda")
            noise = torch.randn((k, items), generator=g, device="cuda")
            gram_ms += median_ms(lambda: fn(codes, None, v_t, 2.0, -7.2), reps)
            solve_ms += median_ms(lambda: ps.tri_combine_solve_sample(
                gram, lam, rhs, noise, 2.0), reps)
        out[f"k{k}"] = {"gram_inkernel_ms": gram_ms, "solve_shared_ms": solve_ms}
    return out


# #8's K: each instance class of the kernel (register capacities 8-64,
# the panels at three and four rows a lane) and its edges
BLAST_KS = (8, 16, 32, 33, 48, 64, 65, 79, 96, 106)


def blast_times(reps=25):
    """#8 at B = 6144 on chip_smoke.py phase 10's random SPD systems (its
    seeds), and the torch.linalg chain on the same systems."""
    import torch

    from bpmf_tpu_torch.ops import pallas_solve as ps
    from bpmf_tpu_torch.ops.update import chol_solve_sample as linalg_solve

    out = {}
    for k in BLAST_KS:
        g = torch.Generator(device="cuda").manual_seed(800 + k)
        w = torch.randn((6144, k, k), generator=g, device="cuda")
        prec = w @ w.mT / k + torch.eye(k, device="cuda")
        rhs, noise = torch.randn((2, 6144, k), generator=g, device="cuda")
        out[f"k{k}_ms"] = median_ms(
            lambda: ps.chol_solve_sample_pallas_blast(prec, rhs, noise), reps)
        out[f"k{k}_linalg_ms"] = median_ms(
            lambda: linalg_solve(prec, rhs, noise), reps)
    return out


def blast_chain(bpmf, cfg, train, test, k, warm, iters, reps=10, **kw):
    """ms/iter of a chain whose solve is #8, then #8 on each side's
    systems (precision, rhs, noise) of one more iteration, as the solvers
    look the kernel up in its module at each call: solve_<side>_ms, sides
    named movies and users."""
    from bpmf_tpu_torch.ops import pallas_solve as ps

    s, ms = chain(bpmf, cfg, train, test, warm, iters, k, **kw)
    blast, seen = ps.chol_solve_sample_pallas_blast, []

    def keep(*args):
        seen.append(args)
        return blast(*args)

    ps.chol_solve_sample_pallas_blast = keep
    try:
        s.step()
    finally:
        ps.chol_solve_sample_pallas_blast = blast
    assert len(seen) == 2, len(seen)
    out = {"ms_per_iter": ms, "iterations": iters, "k": k,
           "impl": {"movies": s.movies.impl, "users": s.users.impl}}
    for side, args in zip(("movies", "users"), seen):
        out[f"solve_{side}_ms"] = median_ms(lambda: blast(*args), reps)
        out[f"solve_{side}_batch"] = int(args[0].shape[0])
    return out


def gram_library(codes, p_t, v_t, cs, cb, orientation):
    """The split Gram's function (#3 with p_t None, #4) as a library
    chain, its yardstick: the f32 indicator and centered codes, the packed
    operand (built from v_t for #3), gram_t = p_t @ ind' and rhs_t =
    v_t @ cv', two cuBLAS SGEMMs with TF32 off (restored after)."""
    import torch

    from bpmf_tpu_torch.ops import dense8 as d8

    x = codes if orientation == "rows" else codes.t()
    ind = (x != 0).float()
    cv = cs * x.float() + cb * ind
    p = d8.packed_tri_t(v_t) if p_t is None else p_t
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return p @ ind.t(), v_t @ cv.t()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def bf16_library(codes, p_t, v_t, cs, cb, orientation, solve=None):
    """The bf16 kernels' function as a library chain, their yardstick:
    cuBLAS bf16 products with float32 sums (``torch.mm(..., out_dtype=
    torch.float32)``) of the packed operand (built from v_t, rounded, for
    #1/#3; p_t's valid rows for #2, its every row for #4) and the bf16
    indicator, and of v_t and the bf16 codes (exact up to 256) for the
    rhs.  ``solve`` (lam, prior_rhs, noise_t, alpha, layout): the
    megakernel's rest, ops.pallas_solve.tri_combine and torch.linalg."""
    import torch

    from bpmf_tpu_torch.ops import dense8 as d8
    from bpmf_tpu_torch.ops import pallas_solve as ps

    bf, f32 = torch.bfloat16, torch.float32
    k = v_t.shape[0]
    tv = k * (k + 1) // 2
    x = codes if orientation == "rows" else codes.t()
    ind, cv = (x != 0).to(bf), x.to(bf)
    if p_t is None:
        p = d8.packed_tri_t(v_t.float())[:tv].to(bf)
    elif solve is not None:
        p = p_t[torch.as_tensor(d8._layout_rows(k, solve[4])[0], device=p_t.device)]
    else:
        p = p_t
    gram = torch.mm(p, ind.t(), out_dtype=f32)
    rhs = (cs * torch.mm(v_t, cv.t(), out_dtype=f32)
           + cb * torch.mm(v_t, ind.t(), out_dtype=f32))
    if solve is None:
        return gram, rhs
    lam, prior_rhs, noise_t, alpha, _ = solve
    chol = torch.linalg.cholesky_ex(ps.tri_combine(gram, lam, alpha)).L
    y = torch.linalg.solve_triangular(chol, (rhs + prior_rhs).t()[..., None],
                                      upper=False)
    return torch.linalg.solve_triangular(
        chol.mT, y + noise_t.t()[..., None], upper=True)[..., 0].t()


def hoisted_random(reps=25):
    """#4 at [6144, 4096], K=64, rows + cols, on chip_smoke.py phase 5's
    random codes and frozen items (its seeds, cs and cb): this tree's
    plan, one segment where the tree has hoisted_plan, and the library
    chain."""
    import torch

    from bpmf_tpu_torch.ops import dense8 as d8

    out = {}
    k = 64
    for i, orientation in enumerate(("rows", "cols")):
        g = torch.Generator(device="cuda").manual_seed(10 * k + i)
        gc = torch.Generator(device="cuda").manual_seed(10 * k + i)
        shape = (6144, 4096)
        codes = torch.where(torch.rand(shape, generator=gc, device="cuda") < 0.04,
                            torch.randint(1, 6, shape, generator=gc, device="cuda"),
                            0).to(torch.int8)
        frozen = shape[1] if orientation == "rows" else shape[0]
        v_t = 0.5 * torch.randn((k, frozen), generator=g, device="cuda")
        p_t = d8.packed_tri_t(v_t)
        fn = d8.dense8_gram_rhs_rows if orientation == "rows" else d8.dense8_gram_rhs_cols
        out[f"{orientation}_ms"] = median_ms(lambda: fn(codes, p_t, v_t, 2.0, -7.2), reps)
        out[f"{orientation}_library_ms"] = median_ms(
            lambda: gram_library(codes, p_t, v_t, 2.0, -7.2, orientation), reps)
        plan = getattr(d8, "hoisted_plan", None)
        if plan is not None:
            items = shape[0] if orientation == "rows" else shape[1]
            out[f"{orientation}_segments"] = plan(items, frozen, p_t.shape[0], k).segments
            d8.hoisted_plan = lambda items, frozen, t, k, *a, **kw: d8.SweepPlan(
                1, frozen // d8.BLOCK_MULTIPLE, (), 0)
            try:
                out[f"{orientation}_one_segment_ms"] = median_ms(
                    lambda: fn(codes, p_t, v_t, 2.0, -7.2), reps)
            finally:
                d8.hoisted_plan = plan
    return out


def bf16_random(reps=25):
    """#3 and #4 on bf16 operands at [6144, 4096], K=64, rows + cols, on
    hoisted_random's codes and frozen items rounded to bf16, with
    chip_smoke.py phase 26's cs and cb (not bf16 values): the median of
    ``reps`` single calls, the time per launch over 100 back-to-back
    launches (:func:`per_launch_ms`), and :func:`bf16_library`."""
    import torch

    from bpmf_tpu_torch.ops import dense8 as d8

    out = {}
    k, cs, cb = 64, 0.7, -1.3
    for i, orientation in enumerate(("rows", "cols")):
        g = torch.Generator(device="cuda").manual_seed(10 * k + i)
        gc = torch.Generator(device="cuda").manual_seed(10 * k + i)
        shape = (6144, 4096)
        codes = torch.where(torch.rand(shape, generator=gc, device="cuda") < 0.04,
                            torch.randint(1, 6, shape, generator=gc, device="cuda"),
                            0).to(torch.int8)
        frozen = shape[1] if orientation == "rows" else shape[0]
        v_b = (0.5 * torch.randn((k, frozen), generator=g, device="cuda")).bfloat16()
        fn = d8.dense8_gram_rhs_rows if orientation == "rows" else d8.dense8_gram_rhs_cols
        for pt in ("inkernel", "hoisted"):
            p_t = d8.packed_tri_t(v_b.float()).bfloat16() if pt == "hoisted" else None
            key = f"{pt}_{orientation}"
            out[f"{key}_ms"] = median_ms(lambda: fn(codes, p_t, v_b, cs, cb), reps)
            out[f"{key}_per_launch_ms"] = per_launch_ms(lambda: fn(codes, p_t, v_b, cs, cb))
            out[f"{key}_library_ms"] = median_ms(
                lambda: bf16_library(codes, p_t, v_b, cs, cb, orientation), reps)
    return out


MEGA_DENSITIES = (0.0, 0.0025, 0.005, 0.01, 0.02, 0.04, 0.08, 0.16)
MEGA_KS = (32, 24, 16, 8)   # the tensor-core megakernel's capacities


def mega_inputs(orientation, density, k=32, seed=0):
    """The megakernel's inputs at the padded ml-1m shape [6144, 4096]: int8
    codes 1..5 rated with probability ``density`` (0: all zero), and the
    frozen items (bf16), prior and noise of one half-sweep, from ``seed``."""
    import torch

    dev = torch.device("cuda")
    shape = (6144, 4096)
    g = torch.Generator(device=dev).manual_seed(seed)
    codes = torch.where(torch.rand(shape, generator=g, device=dev) < density,
                        torch.randint(1, 6, shape, generator=g, device=dev),
                        0).to(torch.int8)
    items, frozen = shape if orientation == "rows" else shape[::-1]
    g = torch.Generator(device=dev).manual_seed(seed + 100)
    v_b = (0.5 * torch.randn((k, frozen), generator=g, device=dev)).bfloat16()
    w = torch.randn((k, k), generator=g, device=dev)
    lam = w @ w.T / k + torch.eye(k, device=dev)
    prior_rhs = torch.randn((k, 1), generator=g, device=dev)
    noise_t = torch.randn((k, items), generator=g, device=dev)
    return codes, v_b, lam, prior_rhs, noise_t


def mega_bf16_times(reps=25, cs=0.7, cb=-1.3, alpha=2.0):
    """#1 and #2 (tight, aligned) on bf16 operands (the tree's tensor-core
    kernel where it has one, forced by ``walk_work`` the code array's size, else
    the walk) at [6144, 4096], rows +
    cols summed, at every density of :data:`MEGA_DENSITIES` (0: the code
    scan and the per-item solve alone): per launch (:func:`per_launch_ms`)
    and the median single call, at K=32 (``d<density>``) and at the other
    K of :data:`MEGA_KS` (``k<K>_d<density>``); at K=32 and 4% also
    the plain version, the library chain (:func:`bf16_library` with its
    solve) and #1 on the same inputs in float32."""
    import torch

    from bpmf_tpu_torch.ops import dense8 as d8

    # a tree with the tensor-core kernel: forced by every entry rated
    full = "walk_work" in inspect.signature(d8.dense8_sweep_solve).parameters
    out = {}
    for k, density in [(k, d) for k in MEGA_KS for d in MEGA_DENSITIES]:
        cell = {}
        for seed, orientation in enumerate(("rows", "cols")):
            codes, v_b, lam, prior, noise = mega_inputs(orientation, density, k, seed)
            kw = {"walk_work": codes.numel()} if full else {}
            for name in ("inkernel", "tight", "aligned"):
                p_t = (None if name == "inkernel" else
                       d8.packed_tri_t(v_b.float(), aligned=name == "aligned").bfloat16())
                layout = "aligned" if p_t is None else name

                def call(v=v_b, p_t=p_t, layout=layout, kw=kw):
                    return d8.dense8_sweep_solve(codes, p_t, v, lam, prior, noise, cs,
                                                 cb, alpha, orientation, layout=layout,
                                                 **kw)
                times = {"per_launch_ms": per_launch_ms(call),
                         "ms": median_ms(call, reps)}
                if density == 0.04 and k == 32:
                    times["plain_ms"] = median_ms(lambda: d8.dense8_sweep_solve_ref(
                        codes, p_t, v_b, lam, prior, noise, cs, cb, alpha,
                        orientation, layout), 5)
                    times["library_ms"] = median_ms(lambda: bf16_library(
                        codes, p_t, v_b, cs, cb, orientation,
                        (lam, prior, noise, alpha, layout)), reps)
                    if name == "inkernel":
                        v32 = v_b.float()
                        times["float32_per_launch_ms"] = per_launch_ms(
                            lambda: call(v=v32))
                        times["float32_ms"] = median_ms(lambda: call(v=v32), reps)
                for key, t in times.items():
                    cell[f"{name}_{key}"] = cell.get(f"{name}_{key}", 0.0) + t
        out[f"d{density}" if k == 32 else f"k{k}_d{density}"] = cell
    return out


def mega_chain_times(bpmf, cfg, train, test, reps=10):
    """#1 on bf16 operands on a chain's own codes and state (a bf16 chain
    after one iteration), each side: the median single call and per
    launch, with the side's rated share of the padded code array."""
    import torch

    from bpmf_tpu_torch.ops import dense8 as d8

    s = bpmf(cfg(num_latent=32, burnin=2, nsims=4, matmul_dtype="bfloat16"),
             train, test, out=open(os.devnull, "w"), device="cuda")
    s.run_chunk(1)
    out = {"density": float((s._codes != 0).sum()) / s._codes.numel(),
           "shape": list(s._codes.shape)}
    for side, rows in (("users", True), ("movies", False)):
        state, frozen = ((s.state_u, s.state_m) if rows else (s.state_m, s.state_u))
        hp = state.hp
        v_b = frozen.items.t().bfloat16()
        k, items = v_b.shape[0], state.items.shape[0]
        noise = torch.randn((k, items), device="cuda",
                            generator=torch.Generator("cuda").manual_seed(0))
        kw = {}
        params = inspect.signature(d8.dense8_sweep_solve).parameters
        if "max_degree" in params:
            kw["max_degree"] = int(getattr(s, side).degrees.max())
        if "walk_work" in params:   # the tensor-core kernel, forced
            kw["walk_work"] = s._codes.numel()

        def call():
            return d8.dense8_sweep_solve(
                s._codes, None, v_b, hp.lambda_f, (hp.lambda_f @ hp.mu)[:, None],
                noise, s._d8_cs, s._d8_cb, s.cfg.alpha, "rows" if rows else "cols",
                **kw)
        out[f"inkernel_{side}_ms"] = median_ms(call, reps)
        out[f"inkernel_{side}_per_launch_ms"] = per_launch_ms(call, 20)
    del s
    torch.cuda.empty_cache()
    return out


def bf16_choice_times(bpmf, cfg, train, test, n=20):
    """#1 and #2 (tight, aligned) on bf16 operands on a chain's own codes
    and state (a bf16 chain at K=32 after one iteration), each side, on
    both kernels: the walk (``walk_work=0``) and the tensor-core kernel
    (``walk_work`` the code array's size), per launch over ``n`` launches,
    each asserted launched by its instance; beside them the cost models'
    times (``sweep_mma_plan``'s ``us``, ``sweep_walk_us`` at the side's
    ``walk_work``, both in ms) and the kernel ``sweep_bf16_kernel`` picks
    there."""
    import torch

    from bpmf_tpu_torch.ops import dense8 as d8

    s = bpmf(cfg(num_latent=32, burnin=2, nsims=4, matmul_dtype="bfloat16"),
             train, test, out=open(os.devnull, "w"), device="cuda")
    s.run_chunk(1)
    codes = s._codes
    nnz = int((codes != 0).sum())
    out = {"shape": list(codes.shape), "nnz": nnz, "density": nnz / codes.numel(),
           "routes": [s.users.route, s.movies.route], "walk_work": s._d8_walk}
    sms = d8._sm_count(codes.device)
    for side, rows in (("users", True), ("movies", False)):
        state, frozen = ((s.state_u, s.state_m) if rows else (s.state_m, s.state_u))
        hp = state.hp
        v_b = frozen.items.t().bfloat16()
        k, items = v_b.shape[0], state.items.shape[0]
        noise = torch.randn((k, items), device="cuda",
                            generator=torch.Generator("cuda").manual_seed(0))
        degree = int(getattr(s, side).degrees.max())
        work = s._d8_walk["users" if rows else "movs"]
        for op in ("inkernel", "tight", "aligned"):
            p_t = (None if op == "inkernel" else
                   d8.packed_tri_t(v_b.float(), aligned=op == "aligned").bfloat16())
            t_in = None if p_t is None else p_t.shape[0]
            cell = {"mma_model_ms": d8.sweep_mma_plan(
                        items, v_b.shape[1], k, t_in, sms,
                        code_bytes=codes.element_size()).us / 1e3,
                    "walk_model_ms": d8.sweep_walk_us(items, v_b.shape[1], work, k,
                                                      op, t_in) / 1e3,
                    "picked": d8.sweep_bf16_kernel(items, v_b.shape[1], work, k, op,
                                                   t_in, codes.element_size(), sms)}
            for kern, force in (("walk", 0), ("mma", codes.numel())):
                key = (d8.sweep_mma_key(k, op) if kern == "mma"
                       else d8.sweep_instance_key(k, op, torch.bfloat16))

                def call(force=force, p_t=p_t):
                    return d8.dense8_sweep_solve(
                        codes, p_t, v_b, hp.lambda_f, (hp.lambda_f @ hp.mu)[:, None],
                        noise, s._d8_cs, s._d8_cb, s.cfg.alpha,
                        "rows" if rows else "cols",
                        layout="aligned" if op == "inkernel" else op,
                        max_degree=degree, walk_work=force)
                before = d8.sweep_instance_launches.get(key, 0)
                call()
                torch.cuda.synchronize()
                assert d8.sweep_instance_launches.get(key, 0) == before + 1, key
                cell[f"{kern}_per_launch_ms"] = per_launch_ms(call, n)
            out[f"{side}_{op}"] = cell
    del s
    torch.cuda.empty_cache()
    return out


def main(argv=None):
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)),
                    help="the checkout whose bpmf_tpu_torch is timed")
    ap.add_argument("--label", default="", help="a name for the tree, echoed")
    ap.add_argument("--tall-iters", type=int, default=10)
    ap.add_argument("--ml1m-iters", type=int, default=200)
    ap.add_argument("--legs", default="tall,ml1m,random",
                    help="comma-separated: tall, ml1m, ml1m_bf16, bf16_choice, "
                         "random, wide, instances, split, blast, hoisted, bf16, "
                         "mega_bf16, probe")
    a = ap.parse_args(argv)
    legs = a.legs.split(",")
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("sweep_times: needs an NVIDIA GPU")
    import bpmf_tpu_torch
    from bpmf_tpu_torch import Config, synth_chembl, synth_movielens
    from bpmf_tpu_torch.sampler import BPMF

    assert os.path.dirname(os.path.dirname(bpmf_tpu_torch.__file__)) == root
    out = {"label": a.label, "root": root}
    if "tall" in legs:
        train, test = synth_chembl(n_compounds=800_000, n_proteins=360,
                                   n_ratings=2_875_000, seed=77)
        s, ms = chain(BPMF, Config, train, test, 3, a.tall_iters)
        assert (s.users.route, s.movies.route) == ("fused_hoisted", "fused")
        proteins = sweep_timer(s, "movies", 10)
        compounds = sweep_timer(s, "users", 10)
        out["tall"] = {"ms_per_iter": ms, "iterations": a.tall_iters,
                       "inkernel_proteins_ms": proteins("inkernel"),
                       "tight_compounds_ms": compounds("tight"),
                       "tight_compounds_zero_codes_ms": compounds(
                           "tight", torch.zeros_like(s._codes))}
        del s, train, test
    train, test = synth_movielens()
    if "ml1m" in legs:
        s, ms = chain(BPMF, Config, train, test, 50, a.ml1m_iters)
        assert s.users.route == s.movies.route == "fused"
        out["ml1m"] = {"ms_per_iter": ms, "iterations": a.ml1m_iters,
                       "inkernel_users_ms": sweep_timer(s, "users", 25)("inkernel"),
                       "inkernel_movies_ms": sweep_timer(s, "movies", 25)("inkernel")}
        del s
    if "ml1m_bf16" in legs:
        runs = []
        for _ in range(3):
            s, ms = chain(BPMF, Config, train, test, 50, a.ml1m_iters,
                          matmul_dtype="bfloat16")
            assert s.users.route == s.movies.route == "fused"
            runs.append(ms)
            del s
        out["ml1m_bf16"] = {"ms_per_iter": runs, "iterations": a.ml1m_iters}
    if "bf16_choice" in legs:
        from bpmf_tpu_torch import synth_jester

        ctrain, ctest = synth_chembl()
        out["bf16_choice"] = {
            "ml1m": bf16_choice_times(BPMF, Config, train, test),
            "ml100k": bf16_choice_times(BPMF, Config, *synth_movielens(
                n_users=943, n_movies=1682, n_ratings=100_000, seed=100)),
            "dense3000": bf16_choice_times(BPMF, Config, *synth_movielens(
                n_users=3000, n_movies=2000, n_ratings=1_250_000, seed=26)),
            "chembl": bf16_choice_times(BPMF, Config, ctrain, ctest),
            "jester": bf16_choice_times(BPMF, Config, *synth_jester())}
        del ctrain, ctest
    if "random" in legs:
        out["random"] = random_times()
    if "wide" in legs:
        out["wide"] = wide_times(BPMF, Config, train, test)
    if "instances" in legs:
        out["instances"] = instance_times()
    if "split" in legs:
        ctrain, ctest = synth_chembl()
        split = {"chembl_k64": split_chain(BPMF, Config, ctrain, ctest, 64, 5, 20),
                 "ml1m_k64": split_chain(BPMF, Config, train, test, 64, 20, 100)}
        del ctrain, ctest
        rng = np.random.default_rng(2024)   # chip_smoke.py phase 13's data
        otrain, otest = train.copy(), test.copy()
        otrain.data = otrain.data + rng.uniform(-0.25, 0.25, otrain.nnz)
        otest.data = otest.data + rng.uniform(-0.25, 0.25, otest.nnz)
        split["offgrid_k32"] = split_chain(BPMF, Config, otrain, otest, 32, 20, 100)
        split["random"] = split_random()
        out["split"] = split
    if "blast" in legs:
        blast = blast_times()
        blast["ml1m_bucketed_k32"] = blast_chain(BPMF, Config, train, test, 32, 20,
                                                 100, gram_impl="bucketed")
        blast["ml1m_dense_k96"] = blast_chain(BPMF, Config, train, test, 96, 10, 50)
        btrain, btest = synth_movielens(n_users=81_270, n_movies=29_523,
                                        n_ratings=6_250_000, seed=25)
        blast["ml25m_half_bucketed_k32"] = blast_chain(
            BPMF, Config, btrain, btest, 32, 5, 20, gram_impl="bucketed")
        del btrain, btest
        out["blast"] = blast
    if "hoisted" in legs:
        hoisted = {"random_k64": hoisted_random()}
        ctrain, ctest = synth_chembl()
        os.environ["BPMF_D8_PT"] = "hoisted"   # read once, at the setup
        try:
            hoisted["chembl_k64"] = split_chain(BPMF, Config, ctrain, ctest, 64, 5, 20)
        finally:
            del os.environ["BPMF_D8_PT"]
        out["hoisted"] = hoisted
    if "bf16" in legs:
        ctrain, ctest = synth_chembl()
        out["bf16"] = {
            "random_k64": bf16_random(),
            "ml1m_k64": split_chain(BPMF, Config, train, test, 64, 20, 100,
                                    matmul_dtype="bfloat16"),
            "chembl_k64": split_chain(BPMF, Config, ctrain, ctest, 64, 5, 20,
                                      matmul_dtype="bfloat16")}
        del ctrain, ctest
    if "mega_bf16" in legs:
        ctrain, ctest = synth_chembl()
        mtrain, mtest = synth_movielens(n_users=81_270, n_movies=29_523,
                                        n_ratings=6_250_000, seed=25)
        out["mega_bf16"] = {
            "random_k32": mega_bf16_times(),
            "chembl_k32": mega_chain_times(BPMF, Config, ctrain, ctest),
            "ml25m_half_k32": mega_chain_times(BPMF, Config, mtrain, mtest)}
        del ctrain, ctest, mtrain, mtest
    if "probe" in legs:
        out["probe"] = probe_times()
    out["device"] = torch.cuda.get_device_name(0)
    out["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
