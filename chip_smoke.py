#!/usr/bin/env python3
"""Smoke run of bpmf_tpu_torch on one NVIDIA GPU: the quickest proof that
the port builds, is right and runs its paths on the card.

    python3 chip_smoke.py        # from the repository root; needs CUDA + nvcc

Phases, each printing JSON lines:
  1. device   torch/CUDA versions, the card, its power limit
  2. build    nvcc builds the seven kernel libraries of bpmf_tpu_torch/csrc
              (the megakernel's bf16 instances and the tensor-core Gram of
              bf16 operands in two of their own), and g++ the native matrix
              I/O (bpmf_tpu_torch/io/native), all at once; each kernel's
              registers and spill bytes (ptxas); native.status()
  3. kernel   the megakernel (#1), and the megakernel streaming a hoisted
              operand (#2) in the tight and the 8-aligned layout, against
              their plain PyTorch versions at the padded ml-1m shape
              [6144, 4096], K=32 (#2 also K=16), both orientations, random
              codes at ~4%, and skewed codes (one item with every frozen
              entry rated, three at 50%, the rest 1-4%); median times by
              CUDA events, beside the library chain (cuBLAS SGEMMs for the
              Gram and rhs, tri_combine, torch.linalg); every launch
              repeated bitwise equal.  Then the instances past one row a
              lane and #2 at a runtime K, a kernels-line row each: #1 at
              K = 33, 40 (capacity 40), 41 (44), #2 tight at K = 24, 40 and
              aligned at K = 10, 39, on random codes, and K=40 (39
              aligned) on skewed codes
  4. main     BPMF on ml-1m synth (6040x3952, 1M ratings), K=32, f32, the
              schedule of bench.py: 4 chunks of 500 iterations through #1;
              rmse_avg must land within 0.01 of 0.5306 (the JAX package's
              rmse_avg_check on this data, seed and schedule,
              BENCH_r05.json); then phase 3 again (#1, #2 in both layouts)
              on the chain's own code array and state
  5. kernel   the split pipeline's kernels against their plain versions at
              [6144, 4096], K=64 and K=32: the Gram with in-kernel products
              (#3) and with the hoisted operand (#4), both orientations,
              random codes at ~4%, each beside its library chain (two
              cuBLAS SGEMMs), #4 twice bitwise equal; the solve with the
              shared (#5) and the per-item prior (#6) on those Grams; then
              #3 and #4 on skewed codes (phase 3's pattern, the frozen axis
              split over segments by the degree) at K 16/32/48/64/79 (every
              instance class of both), rows + cols, int8 and int16, three
              launches bitwise equal; and #5/#6/#7 on random systems
              at every instance (K 8, 31, 32, 33, 64, 79; per-item to 74;
              grouped at 8/32/64), on the item-major and the batch-last
              Gram, two launches bitwise equal
  6. split    phase 4's run with BPMF_D8_SOLVE=split (#3 + #5) and with
              BPMF_D8_SOLVE=split BPMF_D8_PT=hoisted (#4 + #5): the same
              rmse_avg gate; no launch of #1
  7. k64      ml-1m synth at K=64, no forced route (split, in-kernel Gram
              on both sides), the same schedule: finite metrics, and the
              first 3 iterations equal the same chain through the plain
              versions on the card (same draws) at 1e-3
  8. prop     ml-1m synth, K=32, a propagated posterior on the users (-l,
              mu and Lambda from a seed, written as .ddm): both
              strict_reference settings, 200 iterations each, the users
              through #3 + #6, the movies through #1; finite, and 3
              iterations equal to the plain-version chain
  9. chembl   chembl synth (167000x360, 600k ratings) at K=64, 2 chunks of
              50 iterations: compounds on the hoisted Gram (#4), proteins
              on the in-kernel one (#3); finite, and 3 iterations equal to
              the plain-version chain; then 2 chunks of 10 under
              BPMF_D8_PT=hoisted (#4 on both sides, the 61,253-rated
              protein over segments), the same checks; then the bench's
              chembl leg in this process: K=32, 4 chunks of 100 on the
              default route, both sides on #1 (2 launches an iteration),
              rmse_avg within 0.01 of 0.7568, and #1 on both sides once
              more on the chain's own codes and last state (below)
  10. kernel8 the batched solve (#8) against its plain version and the
              torch.linalg chain (Cholesky, two triangular solves) at
              B = 6144, K in {1, 8, 16, 24, 32, 33, 48, 63, 64, 65, 79, 80,
              96, 97, 106} (every instance class and its edges), random SPD
              systems; each item held to the float64 solution within
              SOLVE_BOUND; an indefinite item draws NaN where plain does,
              its neighbours bitwise unchanged (B = 1001, K 32 and 96)
  11. bucketed ml-1m synth, K=32, gram_impl="bucketed", the schedule of
              phase 4: rmse_avg within 0.01 of 0.5306; #8 twice per
              iteration, no dense8 kernel (the movies' split buckets among
              its systems)
  12. ml25m    the bench's ml-25M half scale (81270 x 29523, 6.25M ratings,
              seed 25), K=32, 3 chunks of 20 (bench.py's measure with
              iters=20, repeats=2): on the default route (both sides on
              #1, 2 launches an iteration; then #1 on both sides once more
              on the chain's own codes and last state, below), then
              bucketed (#8); each rmse_avg within 0.01 of 1.0902
  13. offgrid  ml-1m synth with train and test moved off the grid by a
              seeded uniform +-0.25: the auto route (fused dense, #5) and
              fuse_dense="off" (plain dense, #8), 500 iterations each,
              finite, rmse_avg within 0.005 of each other, and 3 iterations
              equal to the plain-version chain
  14. k96      ml-1m synth at K=96, past the dense8 gate: plain dense with
              #8, 200 iterations, finite, 3 iterations against plain
After each chain that runs #8 (phases 11-14), one more iteration keeps the
systems each side hands #8, and #8 runs once more on them against its
plain version and the float64 draw, item by item (SOLVE_BOUND).
  15. tiny64   the 4x2 tiny matrices: auto dtype gives float64 and the xla
              solver; "Final Avg RMSE" < 3 on the median of 5 seeds, no
              kernel launch
  16. hoisted  phase 4's chain with BPMF_D8_PT=hoisted (#2, tight) and with
              BPMF_D8_SOLVE=fused_aligned (#2, aligned), 4 chunks of 500
              each: rmse_avg within 0.01 of 0.5306, #2 twice per iteration
              and no #1
  17. tall     chembl synth at 800,000 compounds x 360 proteins (2,875,000
              ratings, seed 77), K=32, no knob: the compounds (800,256
              padded, past the 759,808-item crossover) on #2, the proteins
              on #1; 2 chunks of 20, finite, 3 iterations equal to the
              plain-version chain, rmse_avg within 0.005 of the same chain
              under BPMF_D8_PT=inkernel (both sides #1); then #2 on the
              compounds and #1 on the proteins (the most-rated 294k of
              800k compounds, split over 143 segments), each on the
              chain's own codes and last state against its plain version
              and, item by item, the float64 draw within SOLVE_BOUND; #2
              on an all-zero code array of the compounds' shape (the scan
              and the per-item solve alone)
  18. grouped  BPMF_TRI_GROUPED=1 (the top-aligned packed layout, #7):
              phase 8's -l chain (users through #3 and #6's grouped
              variant) and phase 13's fused dense chain (#5's), each finite
              with 3 iterations equal to the plain-version chain; the
              grouped solve against plain at B=6144, K=32, both priors
  19. probe    the gather probes (#9: A, B, C) at the JAX script's shapes
              (R = W = 512, NV = 32768, K = 32): the probe's entry point
              (its chains of 10 launches, best of 3, CUDA events; D is
              torch's index_select), then each kernel against its plain
              version at 1e-4 there, at R = 8192, (B) at NV = 81,270
              (its k-rows staged in two chunks) and (A, C) at W = 2000
              (past the W the earlier C held): ms (and plain_ms,
              library_ms) the median of 25 single calls, as before,
              per_launch_ms the time per launch over 100 back-to-back
              launches behind a spin kernel (sweep_times.per_launch_ms),
              with embedding_bag's time as the library yardstick
  20. perfdebug phase 4's chain, 100 iterations with profile=True through
              BPMF.run: the counters report and the phase attribution
              (profile_phases: the full program, then nopredict, nosolve,
              nomatmul, nohyper, nonoise), its launches counted as each
              variant's route says; then each ablation alone for a chunk
              of 25 (nomatmul: #5 only; nosolve: #3 only; the others #1),
              and defer_predict "on" against "off" over a chunk of 20,
              per-iteration rmse within 1e-6
  21. outputs  phase 20's chain with -o (output_dir) into a temporary
              directory: the six files, Final Avg RMSE recomputed from
              Pavg.sdm within 1e-5, Lambda finite and symmetric; then 2 x 50
              iterations checkpointed after 50 and resumed, whose rmse_avg
              must equal the straight 100-iteration chain's (burn-in 49, so
              the checkpoint's final Welford pass changes nothing)
  22. int16    int16 codes and small K: #1, #2 (tight, aligned), #3 and #4
              against plain on random int16 codes 1..255 at ~4%, [6144,
              4096], K=32, rows + cols, and #1 on int8 codes at K=10 and
              K=24; phase 13's off-grid data rounded to a 1/32 grid (145
              levels, int16 codes), K=32, 2 chunks of 250 on #1: rmse_avg
              within 0.005 of the same data on the fused dense route (#5),
              and 3 iterations equal to the plain chain on the CPU with the
              same draws; the K=10 chain (the Julia reference's default) on
              #1, 2 chunks of 250, rmse_avg within 0.005 of the same chain
              under BPMF_D8_SOLVE=split
  23. wide     the K=40 chains, one megakernel launch a side as in the JAX
              package: ml-1m synth, 2 chunks of 100, #1 on both sides (the
              capacity 40), 3 iterations equal to the plain chain, rmse_avg
              within 0.005 of the same chain under BPMF_D8_SOLVE=split (#3
              + #5); chembl synth (phase 9's data), 2 chunks of 20, the
              compounds on #2 (tight, runtime K=40), the proteins on #1,
              finite and 3 iterations equal to the plain chain; then
              ml-1m at K=41 (#1 on the capacity 44), at K=24 under
              BPMF_D8_PT=hoisted, K=10 and K=39 under
              BPMF_D8_SOLVE=fused_aligned (#2 at a runtime K on the
              capacities 24, 16 and 40), 2 chunks of 50, finite; every
              chain's launches counted by kernel and by instance
  24. multi    multi-device on the one card (bpmf_tpu_torch.parallel): (a)
              a real NCCL group of one rank (a TCP store on a free local
              port): on ml-1m synth K=32, the sharded dense8 half-sweep in
              both orientations (the split pipeline, #3 + #5, as the JAX
              package runs it at D > 1), the entry-sharded evaluation and
              gather mode's plain dense (#8), fused dense (#5) and bucketed
              (#8) sweeps, each held to its one-device function on the same
              inputs within MULTI_TOL, the sharded calls' launches and
              collectives counted between a reset and a read; (b) two ranks
              on the one GPU through gloo on CUDA tensors (NCCL refuses two
              ranks on one GPU): first each collective once (a refusal is
              quoted and ends (b)), then the ml-1m K=32 chain through BPMF at
              n_devices=2, 2 chunks of 50, each rank holding half the user
              rows of the code array: finite, the split kernels launched on
              every rank, rmse_avg within MULTI_BAND of the one-device chain
              of the same seed and both factor tables within MULTI_TABLES
              of one device's; its ms/iter, beside one device's, is
              gloo through the host, not a speed of the port
  25. reduce   the buckets' exchanges and --dist on the one card: (a) a
              one-rank NCCL group, on both sides of ml-1m synth K=32
              (gram_impl bucketed), reduce_half_sweep and
              reduce_half_sweep_chunked against gather_half_sweep on the
              same inputs and the same noise row per original id, within
              REDUCE_TOL, #8 in each, launches and collectives counted; (b)
              two gloo ranks on the one GPU (after each of the four
              exchanges once, the halo ring's ppermute among them): the
              ml-1m K=32 bucketed chain in reduce, chunked reduce, halo and
              gather mode (BUCKET_CHAINS), 2 chunks of 50 each, against one
              device within MULTI_BAND and MULTI_TABLES, the halo's tables
              equal to gather's, #8 twice a rank and iteration, gloo ms/iter
              beside one device's; (c) python -m bpmf_tpu_torch with
              --dist 127.0.0.1:<port>,1,0 (one process, one NCCL rank
              through the TCP store), 20 iterations, the trajectory of the
              same run without it
  26. bf16   bf16 matmul inputs (Config.matmul_dtype="bfloat16", the JAX
              package's own main path on a TPU; cs = 0.7, cb = -1.3, which
              bf16 does not hold): #1 and #2 (tight, aligned) at phase 3's
              [6144, 4096], K=32, each on both of its bf16 kernels (the
              tensor-core megakernel, csrc/dense8_sweep_solve_mma.cu, with
              walk_work the code array's size; the walk, walk_work = 0;
              ops.dense8.sweep_bf16_kernel's cost models), the launch counted
              under its instance, the tensor-core one beside its dense
              floor, and #3/#4 (the tensor-core Gram,
              csrc/dense8_gram_mma.cu) at K=64 and 79, rows + cols, on bf16
              operands against their plain versions at KERNEL_TOL, the
              solves also item by item against the float64 draw of the same
              bf16 system (SOLVE_BOUND), every launch repeated bitwise
              equal, beside cuBLAS on the same bf16 inputs; the dense
              routes' bf16 product (torch.mm/bmm with out_dtype float32)
              timed against converting the operands and an SGEMM, each
              against float64; then every megakernel capacity of phase 3's
              WIDE on bf16 operands against plain; then the ml-1m K=32 chain on #1 (4 chunks of 500) and
              the bucketed ml-1m chain (4 of 500) within 0.01 of 0.5306,
              the ml-25M half bucketed chain (3 of 20) within 0.01 of
              1.0902, 2 chunks of 50 of the K=32 chain under
              BPMF_D8_PT=hoisted (#2 tight) and BPMF_D8_SOLVE=fused_aligned
              (#2 aligned) and of the K=64 split chain, in-kernel (#3) and
              under BPMF_D8_PT=hoisted (#4), and phase 13's off-grid fused
              dense chain (2 of 250, the dense blocks in bf16, within 0.005
              of its float32 twin); each finite, its launches counted on the
              bf16 instances only, and 3 iterations against the plain chain;
              synth_jester at Jester Dataset 1's scale (73,421 users x 100
              jokes, 4.1M ratings, 10% of the padded array) at K=32, 2 of
              50 on #1 and under both #2 knobs, each side on the kernel
              sweep_bf16_kernel picks by the cost models (the jokes on the
              tensor cores), and the chembl synth at K=32 under both #2
              knobs (2 of 50 each, 0.63% rated: the compounds on the
              walk), each 3 iterations against the plain chain;
              last phase 9's chembl K=64 chain at bf16 (2 of 50: #4 on the
              compounds, #3 on the proteins) within 0.01 of phase 9's
              rmse_avg, then #3/#4 on its own codes and last state; each
              Gram row beside its dense floor, 2 items frozen (T + 2K) at
              BF16_MMA_FLOPS_PER_S
  27. api    the functional model API (bpmf_tpu_torch.models): gibbs_iter
              with solver "smart" (#8 twice an iteration) on ml-1m synth,
              K=32, each side's SideData built with parallel.partition,
              against BPMF with gram_impl="bucketed", both on
              HostDraws(seed): 2 halves of 250 iterations each, the first 3
              iterations within CHAIN_TOL, both rmse_avg within API_BAND of
              each other and RMSE_BAND of 0.5306, launches counted, both
              ms/iter; then the native matrix I/O: the ml-1m train matrix
              written by the Python writer as .sdm, .sdm.gz and .mtx, read
              natively and in Python (equal), and sparse.bucketize of the
              ml-25M half-scale matrix (both sides) filled natively and in
              Python (equal), each in host seconds with the host's CPU;
              native.status() must read native
  28. entry  the entry points (bpmf_tpu_torch.entry) and the pure
              iteration BPMF.iter_fn: (a) entry()'s function (the tiny
              chain, K=16, #1) twice on cloned inputs, bitwise equal and
              finite, beside the same call through the plain versions at
              CHAIN_TOL; (b) phase 4's ml-1m K=32 chain on #1, 2 chunks of
              50 through an iter_fn loop and through BPMF.run_chunk from the
              same state on the same TorchDraws: bitwise equal, finite, both
              ms/iter; (c) the host syncs of one iter_fn call on #1 and on
              the bucketed route (#8), counted under
              torch.cuda.set_sync_debug_mode("warn") with their file:line
              (measured, not gated); (d) dryrun_multichip(2): two gloo ranks
              on the one GPU started once for its five legs, each leg's two
              steps within ENTRY_LEG_TOL of the one-device tiny chain and its
              kernels counted (#3 + #5 on the dense8 legs, #8 on the
              buckets), then its two processes under BPMF_DIST, whose final
              line must equal one process of two ranks (--device cuda:0)
  29. bench  the port's bench legs (bpmf_tpu_torch.bench) as a user runs
              them: ml1m (4 chunks of 500), chembl (4 of 100, K=32) and
              ml25m_half (3 of 20), each through bench.run_leg, its own
              subprocess under a hard timeout, on the route the sampler
              picks by default; each leg's dict printed; its rmse_avg_check
              within 0.01 of the JAX package's (BENCH_ANCHORS), both sides
              dense8 on #1 (route fused), 2 fused_inkernel launches an
              iteration and no other kernel; each rmse_avg_check also
              within 0.005 of the same chain run in this process (phases
              4, 9, 12), whose kernels were checked there; a timeout or an
              error fails the phase
After the #1 chains of phases 9 and 12 and phase 17's chain, the
megakernel runs once more on each side, on the chain's own code array,
scales and last state: each item's draw against the float64 draw of its
system within SOLVE_BOUND, its max_abs_err against the plain version in
the kernels line; after phases 9 and 12 (the sparse ends of the
densities, 0.63% and 0.23%) also #1 on bf16 operands (the frozen side
rounded), the tensor-core megakernel's launch, held the same way.
After each of phases 7-9, every split kernel of that chain runs once more
on the chain's own code array and last state against its plain version:
the skewed degrees of the real layouts (items with more rated entries than
the Gram kernel's list holds, 167k compounds in one solve) that random
codes do not have.  There the solve is held, item by item, to the same
system solved in float64 within the accuracy an f32 Cholesky solve of that
system can promise (SOLVE_BOUND), since the most-rated items' systems are
too ill-conditioned for two f32 factorizations to agree at 1e-3.
Each path's launch counts are set to 0 just before it runs and read just
after; every kernel must have launched there as often as the path says.
Then the card's `nvidia-smi` name and power limit, the kernels' JSON line
(each kernel's time, its plain version's, the library call's where one
computes the same function, and bound_ms: the larger of the bytes it must
move over HBM_BYTES_PER_S and its operations over the peak of their type,
float32 at F32_FLOPS_PER_S; on bf16 operands the Gram's sums at
BF16_MMA_FLOPS_PER_S and its products at BF16_FLOPS_PER_S), and
{"ok": true, ...} last.  Any failure raises: nothing is caught.
"""

import concurrent.futures
import contextlib
import io
import json
import os
import platform
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

N_USERS, N_MOVIES = 6144, 4096   # ml-1m synth padded to the dense8 block
K = 32
RMSE_AVG_JAX = 0.5306            # BENCH_r05.json detail_ml1m.rmse_avg_check
RMSE_BAND = 0.01
KERNEL_TOL = dict(rtol=1e-3, atol=1e-3)  # f32, another summation order,
                                         # amplified by the Cholesky
CHAIN_TOL = dict(rtol=1e-3, atol=1e-3)   # 3 iterations, same draws
# The solve on a chain's own state: a most-rated item's system (chembl's
# proteins, ~1e5 ratings) is too ill-conditioned for two f32 Cholesky
# orders to agree at 1e-3.  So item b's draw is held to the float64 draw of
# the same system within u * kappa_F(A_b) * |u_b|_2 + atol, with u the f32
# unit roundoff and kappa_F = |A_b|_F |A_b^-1|_F (at least the 2-norm
# condition number): the first-order forward error of a solve whose
# backward error is of order u, which is all f32 can promise on that
# system.  The f32 plain version's ratio to the bound is printed beside the
# kernel's.
SOLVE_BOUND = {"per_item": "u*kappa_F(A)*|u|_2 + atol", "u": 2.0 ** -24,
               "atol": 1e-5}
LIBS = ("dense8_sweep_solve", "dense8_gram_rhs", "tri_combine_solve",
        "chol_solve_sample", "gather_probe", "dense8_sweep_solve_bf16",
        "dense8_gram_mma", "dense8_sweep_solve_mma")
PROBE_TOL = dict(rtol=1e-4, atol=1e-4)  # sums of 512 f32 terms, other order
DEFER_TOL = dict(rtol=1e-6, atol=0.0)   # the same predictions, gathered at once
PAVG_TOL = dict(rtol=1e-5, atol=0.0)    # f32 on the card, float64 from the file
TALL_BAND = 0.005                # two routes of one chain, other rounding
RMSE_AVG_ML25M_HALF = 1.0902     # BENCH_r05.json, the ml-25M half-scale leg
OFFGRID_BAND = 0.005             # two routes of one chain, other rounding
GRID_BAND = 0.005                # the same, for phase 22's chains
WIDE_BAND = 0.005                # the same, for phase 23's K=40 chains
# phase 29: the bench legs, each with the JAX package's rmse_avg_check on
# the same data, seed and schedule (BENCH_r05.json) and a hard timeout
BENCH_ANCHORS = {"ml1m": 0.5306, "chembl": 0.7568, "ml25m_half": 1.0902}
BENCH_TIMEOUT_S = {"ml1m": 150.0, "chembl": 150.0, "ml25m_half": 240.0}
LEG_BAND = 0.005                 # a leg against the same chain run in this
                                 # process (phases 4, 9, 12): the same data,
                                 # seed and schedule in another process
ENTRY_LEG_TOL = 1e-4             # phase 28 (d): a dryrun leg's two steps
                                 # against the one-device tiny chain (the
                                 # JAX package's one-trajectory invariant)
API_BAND = 1e-3                  # phase 27: gibbs_iter against BPMF's
                                 # bucketed chain, the same draws, other
                                 # rounding (test order, hyperprior batching)
MULTI_TOL = 1e-6                 # phase 24 (a): the same kernels on the same
                                 # inputs; relative to the largest magnitude
MULTI_BAND = 0.005               # phase 24 (b): 2 ranks against 1, other
                                 # routes (split against #1) and sum orders
MULTI_TABLES = 1e-3              # phase 24 (b): the factor tables' largest
                                 # difference from one device's (3.7e-5 read
                                 # on an H100, PERF.md section 6); phase 25 (b)
REDUCE_TOL = 1e-4                # phase 25 (a): reduce and chunked reduce
                                 # against gather on the same inputs, relative
                                 # to the largest magnitude: f32 sums in
                                 # another order (the scatter-add's atomics),
                                 # as tests/test_spmd.py:204 holds them
# Phase 25 (b)'s chains: two gloo ranks on the one GPU, the buckets in each
# exchange, against one device
BUCKET_CHAINS = {"reduce": {"comm_mode": "reduce", "reduce_chunked": "off"},
                 "reduce_chunked": {"comm_mode": "reduce", "reduce_chunked": "on"},
                 "halo": {"halo": "on"},
                 "gather": {"halo": "off"}}
# Phase 3's rows of the megakernel past one row a lane (#1 at K 33-41, on
# the capacities 40 and 44) and of #2 at a runtime K: (operand, K)
WIDE = (("inkernel", 33), ("inkernel", 40), ("inkernel", 41), ("tight", 24),
        ("tight", 40), ("aligned", 10), ("aligned", 39))
CS16 = 1 / 64                    # int16 kernel inputs: cs = 2 * CS16 keeps
                                 # cs*code + cb of codes up to 255 near the
                                 # int8 inputs' weights
CS_BF16, CB_BF16 = 0.7, -1.3     # phase 26's kernel inputs: not bf16 values,
                                 # so the fold's rounding of cs*v, cb*v shows
BF16_BAND = 0.005                # phase 26: the off-grid chain at bf16
                                 # against float32, other rounding
# The card's peaks for bound_ms (H100 SXM datasheet, dense, at 700 W): HBM
# bandwidth; float32 outside the tensor cores; bf16 operands with float32
# accumulation on the tensor cores; packed bf16x2 outside them, twice the
# float32 rate on the same pipes (133.8 TFLOP/s in the H100 whitepaper).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_MMA_FLOPS_PER_S = 989e12
BF16_FLOPS_PER_S = 2 * F32_FLOPS_PER_S


def bound(nbytes, flops, bf16_mma=0, bf16_vec=0):
    """The least time the card could take for work of ``nbytes`` moved,
    ``flops`` float32 operations, ``bf16_mma`` operations on bf16 operands
    with float32 accumulation (a matmul's) and ``bf16_vec`` packed bf16
    operations, and which of bytes or operations sets it.  float32 and
    packed bf16 share the pipes outside the tensor cores, so their times
    add; the tensor cores run beside them."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(flops / F32_FLOPS_PER_S + bf16_vec / BF16_FLOPS_PER_S,
                bf16_mma / BF16_MMA_FLOPS_PER_S)
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def solve_flops(k, b):
    """Cholesky, both substitutions and the draw of b K x K systems."""
    return b * (k ** 3 / 3 + 2 * k * k + k)


def gram_flops(k, nnz):
    """One rated entry: the lower triangle of its outer product (K(K+1)/2
    FMAs) and its rhs term (K FMAs)."""
    return nnz * (k * (k + 1) + 2 * k)


def bf16_gram_work(k, nnz, n_frozen, inkernel):
    """The Gram and rhs on bf16 operands by type, for bound(): each rated
    entry's packed row summed as a matmul against the {0,1} indicator
    (K(K+1) operations an entry, bf16 operands, float32 accumulation); on
    in-kernel products, the packed products of the frozen items rounded to
    bf16 (K(K+1)/2 each, once per frozen item); the rhs (2K an entry) in
    float32."""
    return {"flops": nnz * 2 * k, "bf16_mma": nnz * k * (k + 1),
            "bf16_vec": n_frozen * k * (k + 1) // 2 if inkernel else 0}


def hoisted_gram_flops(k, nnz):
    """One rated entry on a hoisted operand: K(K+1)/2 additions of its
    packed row, and its rhs term (K FMAs)."""
    return nnz * (k * (k + 1) // 2 + 2 * k)


TINY_TRAIN = [(0, 0, 2.0), (1, 0, 3.0), (2, 0, 7.0), (3, 0, 4.0), (0, 1, 5.0),
              (2, 1, 1.0)]                   # the reference's data/tiny, 4x2
TINY_TEST = [(1, 1, 5.0), (3, 1, 1.0)]


def emit(obj):
    print(json.dumps(obj), flush=True)


def ptxas_summary(report):
    """{kernel: [registers, spill store bytes, spill load bytes]} from the
    ``-Xptxas -v`` report of one library's build."""
    out, fn = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            out[fn] = [None, None, None]
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn:
            out[fn][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn][0] = int(m.group(1))
    return out


def median_ms(fn, reps=25, warmup=3):
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


def random_codes(seed, int16=False):
    """[6144, 4096] codes at ~4%: int8 1..5 (like ml-1m), or int16 1..255."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (N_USERS, N_MOVIES)
    hi = 256 if int16 else 6
    return torch.where(torch.rand(shape, generator=g, device="cuda") < 0.04,
                       torch.randint(1, hi, shape, generator=g, device="cuda"),
                       0).to(torch.int16 if int16 else torch.int8)


def skewed_codes(seed, orientation, int16=False):
    """[6144, 4096] int8 codes 1..5 (int16 1..255) with skewed degrees
    along the items of ``orientation``: item 5 with every frozen entry
    rated, items 17, 300 and 701 half of them, every other item 1-4% (its
    own density)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    items, frozen = ((N_USERS, N_MOVIES) if orientation == "rows"
                     else (N_MOVIES, N_USERS))
    density = 0.01 + 0.03 * torch.rand((items, 1), generator=g, device="cuda")
    density[[17, 300, 701]] = 0.5
    density[5] = 1.0
    hi = 256 if int16 else 6
    x = torch.where(torch.rand((items, frozen), generator=g, device="cuda") < density,
                    torch.randint(1, hi, (items, frozen), generator=g, device="cuda"),
                    0).to(torch.int16 if int16 else torch.int8)
    return x if orientation == "rows" else x.t().contiguous()


def kernel_inputs(orientation, seed, k=K, int16=False, skewed=False):
    """Random codes at ~4% density (random_codes), or skewed ones
    (skewed_codes), and the other operands of one half-sweep, on the
    card."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed + 100)
    dev = torch.device("cuda")
    codes = skewed_codes(seed, orientation) if skewed else random_codes(seed, int16)
    items, frozen = ((N_USERS, N_MOVIES) if orientation == "rows"
                     else (N_MOVIES, N_USERS))
    v_t = 0.5 * torch.randn((k, frozen), generator=g, device=dev)
    w = torch.randn((k, k), generator=g, device=dev)
    lam = w @ w.T / k + torch.eye(k, device=dev)
    prior_rhs = torch.randn((k, 1), generator=g, device=dev)
    noise_t = torch.randn((k, items), generator=g, device=dev)
    return codes, v_t, lam, prior_rhs, noise_t


class Counts:
    """The launch counters of every kernel wrapper."""

    def __init__(self):
        from bpmf_tpu_torch.ops import dense8, pallas_solve
        from bpmf_tpu_torch.scripts import gather_probe

        self.d8, self.ps, self.gp = dense8, pallas_solve, gather_probe

    def reset(self):
        self.d8.sweep_instance_launches.clear()
        for d in (self.d8.sweep_launches, self.d8.gram_launches,
                  self.ps.solve_launches, self.gp.launches):
            for key in d:
                d[key] = 0

    def instances(self):
        """The megakernel's (#1, #2) launches by instance
        (ops.dense8.sweep_instance_key), those that launched."""
        return {k: c for k, c in self.d8.sweep_instance_launches.items() if c}

    def read(self):
        """#1 (fused_inkernel), #2 by layout (fused_tight, fused_aligned),
        #3/#4 (gram_*), each also on bf16 operands (*_bf16), #5/#6 and
        their grouped variants #7 (solve_*), #8, #9 (probe_A, probe_B,
        probe_C)."""
        from bpmf_tpu_torch.ops import launch_counts

        return {**launch_counts(),
                **{"probe_" + n: c for n, c in self.gp.launches.items()}}


COUNT_KEYS = tuple(
    f"{kernel}_{operand}{suffix}" for suffix in ("", "_bf16")
    for kernel, operand in (("fused", "inkernel"), ("fused", "tight"),
                            ("fused", "aligned"), ("gram", "inkernel"),
                            ("gram", "hoisted"))) + (
    "solve_shared", "solve_peritem", "solve_shared_grouped",
    "solve_peritem_grouped", "blast", "probe_A", "probe_B", "probe_C")


def launches(**nonzero):
    """A full launch-count dict: the given counts, 0 for every other."""
    assert set(nonzero) <= set(COUNT_KEYS), nonzero
    want = dict.fromkeys(COUNT_KEYS, 0)
    want.update(nonzero)
    return want


@contextlib.contextmanager
def env(**values):
    """The routing knobs, set for one sampler's setup."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def plain_kernels():
    """The half-sweep with every kernel wrapper replaced by its plain
    version, for the comparison chains (their launches are not counted)."""
    import bpmf_tpu_torch.parallel.spmd as spmd
    from bpmf_tpu_torch.ops import dense8 as d8
    from bpmf_tpu_torch.ops import pallas_solve as ps

    plain = {
        # the plain version has no segments to split by the side's degree,
        # and no choice of megakernel by the density
        "dense8_sweep_solve": lambda *args, max_degree=None, walk_work=None, **kw:
            d8.dense8_sweep_solve_ref(*args, **kw),
        "dense8_gram_rhs_rows": lambda c, p, v, cs, cb, max_degree=None:
            d8.dense8_gram_rhs_ref(c, p, v, cs, cb, "rows"),
        "dense8_gram_rhs_cols": lambda c, p, v, cs, cb, max_degree=None:
            d8.dense8_gram_rhs_ref(c, p, v, cs, cb, "cols"),
        "tri_combine_solve_sample": ps.tri_combine_solve_sample_ref,
    }
    saved = {name: getattr(spmd, name) for name in plain}
    for name, fn in plain.items():
        setattr(spmd, name, fn)
    # the solvers look the solve kernel up in its module at each call
    blast = ps.chol_solve_sample_pallas_blast
    ps.chol_solve_sample_pallas_blast = ps.chol_solve_sample_pallas_blast_ref
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(spmd, name, fn)
        ps.chol_solve_sample_pallas_blast = blast


def chain_systems(sampler):
    """The systems each side of a chain hands the batched solve (#8): one
    more iteration, run with the solve wrapped so that it keeps its inputs
    (precision [B, K, K], rhs, noise), after the chain's launch counts are
    read.  Returns them in sweep order, movies first."""
    from bpmf_tpu_torch.ops import pallas_solve as ps

    blast, seen = ps.chol_solve_sample_pallas_blast, []

    def keep(precision, rhs, noise):
        seen.append((precision, rhs, noise))
        return blast(precision, rhs, noise)

    ps.chol_solve_sample_pallas_blast = keep
    try:
        sampler.step()
    finally:
        ps.chol_solve_sample_pallas_blast = blast
    assert len(seen) == 2, len(seen)
    return seen


def drive(make, counts, chunks, iters):
    """Set up a sampler, then run its chunks between a reset and a read of
    the launch counts.  Returns (sampler, per-chunk metrics, chunk seconds,
    setup seconds, launch counts)."""
    t0 = time.perf_counter()
    sampler = make()
    sampler.setup()
    setup_s = time.perf_counter() - t0
    counts.reset()
    mets, chunk_s = [], []
    for _ in range(chunks):
        t0 = time.perf_counter()
        mets.append(sampler.run_chunk(iters))   # ends in a host sync
        chunk_s.append(time.perf_counter() - t0)
    return sampler, mets, chunk_s, setup_s, counts.read()


def check_first_iterations(make, mets, counts):
    """The first 3 iterations of a kernel chain against the same chain (same
    seed, so the same draws) through the plain versions on the card, which
    must launch no kernel."""
    import numpy as np

    counts.reset()
    with plain_kernels():
        plain = make().run_chunk(3)
    assert not any(counts.read().values()), counts.read()
    err = 0.0
    for got, want in zip(mets, plain):
        assert np.isfinite(want).all(), want
        np.testing.assert_allclose(got[:3], want, **CHAIN_TOL)
        err = max(err, float(np.abs(got[:3] - want).max()))
    return err


def assert_finite(mets):
    import numpy as np

    for m in mets:
        for name, x in zip(m._fields, m):
            assert np.isfinite(x).all(), (name, x)


def solve_vs_f64(system64, rhs, noise, outs, chunk=16384):
    """``outs`` (f32 draws [B, K] of the solve of B systems) against the
    float64 draw of the same systems, item by item: for each, the largest
    error over its SOLVE_BOUND and the largest 2-norm error; and the largest
    kappa_F.  ``system64(sl)`` gives the full symmetric float64 matrices of
    the items ``sl``; rhs and noise are [B, K]."""
    import torch

    b, k = rhs.shape
    f64 = torch.float64
    eye = torch.eye(k, dtype=f64, device=rhs.device)
    worst, err, kappa_max = [0.0] * len(outs), [0.0] * len(outs), 0.0
    for s in range(0, b, chunk):
        sl = slice(s, min(s + chunk, b))
        a = system64(sl)
        chol = torch.linalg.cholesky(a)
        inv = torch.linalg.solve_triangular(chol, eye.expand_as(a), upper=False)
        kappa = torch.linalg.matrix_norm(a) * torch.linalg.matrix_norm(inv.mT @ inv)
        y = torch.linalg.solve_triangular(chol, rhs[sl].to(f64)[..., None],
                                          upper=False)
        u = torch.linalg.solve_triangular(
            chol.mT, y + noise[sl].to(f64)[..., None], upper=True)[..., 0]
        bound = SOLVE_BOUND["u"] * kappa * u.norm(dim=1) + SOLVE_BOUND["atol"]
        for n, o in enumerate(outs):
            e = (o[sl].to(f64) - u).norm(dim=1)
            worst[n] = max(worst[n], float((e / bound).max()))
            err[n] = max(err[n], float(e.max()))
        kappa_max = max(kappa_max, float(kappa.max()))
    return worst, err, kappa_max


def tri_system64(gram, lam, lam_tri_t, alpha, grouped=False):
    """system64 of the packed-triangle solve (#5/#6, #7 with ``grouped``)
    on (gram_t, lam, lam_tri_t): the combined systems, mirrored, in
    float64."""
    import torch

    from bpmf_tpu_torch.ops import pallas_solve as ps

    def system64(sl):
        f64 = torch.float64
        a = ps.tri_combine(gram[:, sl].to(f64), lam.to(f64), alpha,
                           None if lam_tri_t is None else lam_tri_t[:, sl].to(f64),
                           grouped)
        return a + a.mT - torch.diag_embed(a.diagonal(dim1=1, dim2=2))
    return system64


def d8_system64(codes, v_t, lam, alpha, orientation):
    """system64 of the megakernels (#1, #2) on one half-sweep's inputs:
    lam + alpha * G with the Gram of the rated entries in float64 (the
    lower triangles, mirrored); on bf16 operands each product rounded to
    bf16 first, as the kernels and the JAX package round it."""
    import torch

    f64 = torch.float64
    k = v_t.shape[0]
    x = codes if orientation == "rows" else codes.t()
    v64 = v_t.to(f64)
    outer = (v64[:, None, :] * v64[None, :, :]).reshape(k * k, -1)
    if v_t.dtype == torch.bfloat16:
        outer = outer.to(torch.bfloat16).to(f64)   # exact products, rounded once
    lam64 = lam.to(f64)

    def system64(sl):
        g = ((x[sl] != 0).to(f64) @ outer.t()).reshape(-1, k, k)
        a = torch.tril(lam64 + alpha * g)
        return a + a.mT - torch.diag_embed(a.diagonal(dim1=1, dim2=2))
    return system64


def d8_rhs64(codes, v_t, prior_rhs, cs, cb, orientation, fold, chunk=4096):
    """[items, K] float64 rhs of the megakernels' systems, the prior's
    included: cs v.code + cb v.ind (#1, and #2 on float32 operands), or with
    ``fold`` (#2 on bf16 operands) code.bf16(cs v) + ind.bf16(cb v)
    (ops.dense8.fold_weights); ``chunk`` items at a time, so that the
    float64 codes of an ml-25M side are never whole."""
    import torch

    from bpmf_tpu_torch.ops import dense8 as d8

    f64 = torch.float64
    x = codes if orientation == "rows" else codes.t()
    if fold:
        ws, wb = (w.to(f64).t() for w in d8.fold_weights(v_t, cs, cb))
    else:
        v = v_t.to(f64).t()
    rhs = torch.empty((x.shape[0], v_t.shape[0]), dtype=f64, device=x.device)
    for s in range(0, x.shape[0], chunk):
        xs = x[s:s + chunk]
        ind, cv = (xs != 0).to(f64), xs.to(f64)
        rhs[s:s + chunk] = (cv @ ws + ind @ wb if fold
                            else cs * (cv @ v) + cb * (ind @ v))
    return rhs + prior_rhs.to(f64).t()


def full_system64(prec):
    """system64 of the full-precision solve (#8): the lower triangle of
    ``prec`` [B, K, K], mirrored, in float64."""
    import torch

    def system64(sl):
        a = torch.tril(prec[sl].to(torch.float64))
        return a + a.mT - torch.diag_embed(a.diagonal(dim1=1, dim2=2))
    return system64


def per_iter_stats(sampler, chunk_s, iters):
    """All the time of chunks 2..n over their iterations (the first chunk
    warms up), the best chunk beside it, and items/s."""
    per_iter = sum(chunk_s[1:]) / ((len(chunk_s) - 1) * iters)
    return {"ms_per_iter": per_iter * 1e3,
            "ms_per_iter_best_chunk": min(chunk_s[1:]) / iters * 1e3,
            "items_per_sec": (sampler.users.num + sampler.movies.num) / per_iter,
            "chunk_s": chunk_s}


def write_prop(path, k, num, seed):
    """mu [K, num] and Lambda [K*K, num] (item i's precision W W'/K + 2I,
    column-major) from a seed, as .ddm; returns the '-l' argument."""
    import numpy as np

    from bpmf_tpu_torch import write_matrix

    rng = np.random.default_rng(seed)
    w = rng.normal(size=(num, k, k))
    lam = w @ w.transpose(0, 2, 1) / k + 2.0 * np.eye(k)
    mu_f, lam_f = os.path.join(path, "mu.ddm"), os.path.join(path, "Lambda.ddm")
    write_matrix(mu_f, 0.1 * rng.normal(size=(k, num)))
    write_matrix(lam_f, lam.transpose(1, 2, 0).reshape(k * k, num, order="F"))
    return f"{mu_f},{lam_f}"


def multi_rank_chain(mesh, chunks, iters, seed, k, data_kw):
    """Phase 24 (b): one rank of a chain on ml-1m synth (``data_kw``; every
    rank makes the same data from its seed) through ``BPMF`` on ``mesh``.
    First each of the three collectives once on this rank's device: if the
    backend refuses one, the rank returns the refusals and runs no chain.
    Else the chain's launch counts (set to 0 after setup, read after the
    chunks), its collectives, per-chunk seconds and last metrics."""
    import numpy as np
    import torch

    from bpmf_tpu_torch import Config, synth_movielens
    from bpmf_tpu_torch.sampler import BPMF

    refused = {}
    x = torch.ones((2, 3), device=mesh.device)
    for name, call in (("all_gather", lambda: mesh.all_gather(x)),
                       ("all_reduce", lambda: mesh.all_reduce(x)),
                       ("reduce_scatter", lambda: mesh.reduce_scatter(
                           x.repeat(mesh.size, 1)))):
        try:
            call()
        except RuntimeError as e:      # the backend's refusal, quoted
            refused[name] = f"{type(e).__name__}: {e}"[:1000]
    if refused:
        return {"rank": mesh.rank, "refused": refused}
    torch.backends.cuda.matmul.allow_tf32 = False
    train, test = synth_movielens(**data_kw)
    counts = Counts()
    sampler = BPMF(Config(num_latent=k, burnin=2, nsims=chunks * iters, seed=seed),
                   train, test, out=open(os.devnull, "w"), mesh=mesh)
    sampler.setup()
    counts.reset()
    before = dict(mesh.collectives)
    mets, chunk_s = [], []
    for _ in range(chunks):
        t0 = time.perf_counter()
        mets.append(sampler.run_chunk(iters))   # ends in a host sync
        chunk_s.append(time.perf_counter() - t0)
    n = counts.read()
    collectives = {c: m - before[c] for c, m in mesh.collectives.items()}
    tables = [sampler.items_host(sampler.users, sampler.state_u),
              sampler.items_host(sampler.movies, sampler.state_m)]
    return {"rank": mesh.rank, "launches": n, "tables": tables,
            "collectives": collectives,
            "routes": {s.name: s.route for s in (sampler.movies, sampler.users)},
            "codes": list(sampler._codes.shape),
            "layout": [sampler.users.maps.local_pad, sampler.users.maps.padded_num,
                       sampler.movies.maps.padded_num], "chunk_s": chunk_s,
            "rmse_avg": float(mets[-1].rmse_avg[-1]),
            "rmse": float(mets[-1].rmse[-1]), "finite": bool(all(
                np.isfinite(x).all() for m in mets for x in m))}


def multi_phase(train, test, counts, total, tag, devnull, device="cuda",
                k=K, data_kw=None, chunks=2, iters=50):
    """Phase 24: multi-device on the one card.  (a) a real NCCL group of one
    rank: the sharded dense8 half-sweep in both orientations, the
    entry-sharded evaluation and gather mode's plain dense, fused dense and
    bucketed sweeps, each held to its one-device function on the same
    inputs (MULTI_TOL); (b) two ranks on the one GPU through gloo on CUDA
    tensors: the ml-1m chain through BPMF (``chunks`` of ``iters``), against
    one device (MULTI_BAND, MULTI_TABLES).  ``device``, ``k`` and
    ``data_kw`` (the synth_movielens arguments of ``train, test``) exist for
    a rehearsal on the CPU at a small size.  Returns the phase's lines and its seconds."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from bpmf_tpu_torch import Config
    from bpmf_tpu_torch.models.bpmf import predict
    from bpmf_tpu_torch.parallel import spmd
    from bpmf_tpu_torch.parallel.launch import run_ranks
    from bpmf_tpu_torch.parallel.mesh import free_port, init_mesh
    from bpmf_tpu_torch.sampler import BPMF

    t_phase = time.perf_counter()
    lines = []
    # (a) one NCCL rank
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    mesh = init_mesh(0, 1, f"tcp://127.0.0.1:{free_port()}", dev)
    assert mesh.group is not None and mesh.backend == (
        "nccl" if dev.type == "cuda" else "gloo")
    g = torch.Generator(device=dev).manual_seed(24)

    def rel(a, b):
        return float((a - b).abs().max() / max(1.0, float(b.abs().max())))

    def side_err(got, want):
        return max(rel(getattr(got, f), getattr(want, f))
                   for f in ("items", "sum", "cov", "norm"))

    with env(BPMF_D8_SOLVE="split"):
        s8 = BPMF(Config(num_latent=k, burnin=2, nsims=10), train, test,
                  out=devnull, device=dev)
        s8.setup()
    s8.run_chunk(3)                        # a state of the chain itself
    samplers = {}
    for name, kw in (("dense", dict(gram_impl="dense", fuse_dense="off")),
                     ("fused", dict(gram_impl="dense")),
                     ("bucketed", dict(gram_impl="bucketed"))):
        samplers[name] = BPMF(Config(num_latent=k, burnin=0, nsims=1, **kw),
                              train, test, out=devnull, device=dev)
        samplers[name].setup()
        assert (samplers[name].movies.impl, samplers[name].movies.route) == {
            "dense": ("dense", "plain"), "fused": ("dense", "fused"),
            "bucketed": ("bucketed", None)}[name]
    calls = []                              # (name, sharded call, one-device call)
    for orientation, side, state, other in (
            ("rows", s8.users, s8.state_u, s8.state_m),
            ("cols", s8.movies, s8.state_m, s8.state_u)):
        aux = s8._aux[side.name]
        noise = torch.randn((state.items.shape[0], k), generator=g, device=dev)
        kw = dict(num=side.num, local_valid=aux.local_valid, alpha=2.0, burnin=2,
                  cs=s8._d8_cs, cb=s8._d8_cb, orientation=orientation,
                  route=side.route, max_degree=s8._d8_max_degree[side.name])
        args = (state, s8._codes, other.items, state.hp, noise, 5)
        calls.append((f"dense8_{orientation}",
                      lambda args=args, kw=kw: spmd.dense8_half_sweep_sharded(
                          mesh, *args, **kw),
                      lambda args=args, kw=kw: spmd.dense8_half_sweep(*args, **kw)))
    for name, s in samplers.items():
        side, other = s.movies, s.users
        aux = s._aux[side.name]
        state = s.state_m._replace(items=torch.randn(s.state_m.items.shape,
                                                     generator=g, device=dev))
        other_items = 0.5 * torch.randn(s.state_u.items.shape, generator=g,
                                        device=dev)
        hp = s8.state_m.hp
        # noise rows by original id, as the chain draws them: the padding
        # slots share the row of id num, so their draws, which all land in
        # the scratch row, are equal
        ids = aux.bucket_orig if name == "bucketed" else aux.local_orig
        noise = torch.randn((side.num + 1, k), generator=g, device=dev)[ids]
        if name == "bucketed":
            fn = spmd.gather_half_sweep
            kw = dict(num=side.num, mean_rating=s._mean_rating, alpha=2.0,
                      burnin=0, splits=aux.splits, solver=s.solver)
            args = (state, aux.buckets, other_items, hp, noise, 5)
        else:
            fn = spmd.dense_half_sweep_fused if name == "fused" else spmd.dense_half_sweep
            kw = dict(num=side.num, local_valid=aux.local_valid, alpha=2.0, burnin=0)
            if name == "dense":
                kw["solver"] = s.solver
            args = (state, *aux.dense, other_items, hp, noise, 5)
        calls.append((name, lambda fn=fn, args=args, kw=kw: fn(*args, mesh=mesh, **kw),
                      lambda fn=fn, args=args, kw=kw: fn(*args, **kw)))
    ev1 = s8.ev._replace(valid=torch.ones_like(s8.ev.t_val))
    pkw = dict(mean_rating=s8._mean_rating, burnin=2)
    calls.append(("predict",
                  lambda: spmd.predict_sharded(
                      mesh, ev1, s8.est, s8.state_u.items, s8.state_m.items, 3,
                      nnz_true=len(s8.t_val), **pkw),
                  lambda: predict(s8.ev, s8.est, s8.state_u.items,
                                  s8.state_m.items, 3, **pkw)))
    # the sharded path alone between a reset and a read of the counts
    counts.reset()
    before = dict(mesh.collectives)
    got = {name: sharded() for name, sharded, _ in calls}
    if dev.type == "cuda":
        torch.cuda.synchronize()
    n = counts.read()
    collectives = {c: m - before[c] for c, m in mesh.collectives.items()}
    want_n = (launches(gram_inkernel=2, solve_shared=3, blast=2)
              if dev.type == "cuda" else launches())
    assert n == want_n, n
    assert collectives == {"all_gather": 6, "all_reduce": 6, "reduce_scatter": 1,
                           "ppermute": 0}, collectives
    for key, c in n.items():
        total[key] += c
    errs = {}
    for name, _, one_device in calls:
        want = one_device()
        if name == "predict":
            errs[name] = max(rel(got[name][1], want[1]), rel(got[name][2], want[2]),
                             rel(got[name][0].pavg, want[0].pavg),
                             rel(got[name][0].pm2, want[0].pm2))
        else:
            errs[name] = side_err(got[name], want)
        assert errs[name] <= MULTI_TOL, (name, errs[name])
    dist.destroy_process_group()
    lines.append({"phase": "multi", "part": "a", "what": "one NCCL rank: each "
                  "sharded function against its one-device function",
                  "dataset": "ml-1m synth", "k": k, "backend": mesh.backend,
                  "routes": {"dense8": [s8.users.route, s8.movies.route]},
                  "launches": n, "collectives": collectives,
                  "max_rel_err": errs, "tolerance": MULTI_TOL, **tag})
    del s8, samplers, calls, got

    # (b) two ranks on the one GPU, gloo on CUDA tensors, against one device
    one = BPMF(Config(num_latent=k, burnin=2, nsims=chunks * iters, seed=7),
               train, test, out=devnull, device=dev)
    one_mets, one_s = [], []
    for _ in range(chunks):
        t0 = time.perf_counter()
        one_mets.append(one.run_chunk(iters))
        one_s.append(time.perf_counter() - t0)
    one_avg = float(one_mets[-1].rmse_avg[-1])
    one_rmse, one_routes = float(one_mets[-1].rmse[-1]), one.movies.route
    one_tables = [one.items_host(one.users, one.state_u),
                  one.items_host(one.movies, one.state_m)]
    del one
    ranks = run_ranks(multi_rank_chain, 2, chunks, iters, 7, k, data_kw or {},
                      device=dev, backend="gloo", timeout_s=300)
    refused = {r["rank"]: r["refused"] for r in ranks if "refused" in r}
    if refused:
        # gloo takes no CUDA tensor for one of the three collectives: the
        # refusal is the finding (PERF.md quotes it) and (b) stops here
        lines.append({"phase": "multi", "part": "b", "gloo_refused": refused, **tag})
        return lines, time.perf_counter() - t_phase
    for r in ranks:
        assert r["finite"], r
        assert r["routes"] == {"movs": "inkernel", "users": "inkernel"}, r["routes"]
        if dev.type == "cuda":
            assert r["launches"] == launches(gram_inkernel=2 * chunks * iters,
                                             solve_shared=2 * chunks * iters), r["launches"]
        lp_u, r_u, c_m = r["layout"]          # the rank's [R/D, C] of the codes
        assert r["codes"] == [lp_u, c_m] and r_u == 2 * lp_u, (r["codes"], r["layout"])
    assert ranks[0]["rmse_avg"] == ranks[1]["rmse_avg"]
    # both factor tables after the chain, gathered, against one device's
    tables_diff = max(float(np.abs(a - b).max())
                      for a, b in zip(ranks[0]["tables"], one_tables))
    assert abs(ranks[0]["rmse_avg"] - one_avg) <= MULTI_BAND, (ranks[0]["rmse_avg"], one_avg)
    assert tables_diff <= MULTI_TABLES, (tables_diff, MULTI_TABLES)
    for key, c in ranks[0]["launches"].items():
        total[key] += c
    chunk_s = ranks[0]["chunk_s"]
    lines.append({"phase": "multi", "part": "b",
                  "what": "2 ranks on one GPU, gloo through the host (not a "
                          "speed of the port)", "dataset": "ml-1m synth", "k": k,
                  "iterations": chunks * iters, "rmse_avg": ranks[0]["rmse_avg"],
                  "rmse": ranks[0]["rmse"], "one_device_rmse_avg": one_avg,
                  "one_device_rmse": one_rmse, "one_device_route": one_routes,
                  "tables_max_abs_diff": tables_diff, "tables_bound": MULTI_TABLES,
                  "one_device_ms_per_iter": sum(one_s[1:]) / ((chunks - 1) * iters) * 1e3,
                  "band": MULTI_BAND, "launches_per_rank": ranks[0]["launches"],
                  "collectives_per_rank": ranks[0]["collectives"],
                  "codes_per_rank": ranks[0]["codes"],
                  "gloo_ms_per_iter": sum(chunk_s[1:]) / ((chunks - 1) * iters) * 1e3,
                  "chunk_s": chunk_s, **tag})
    return lines, time.perf_counter() - t_phase


def multi_bucket_chains(mesh, chunks, iters, seed, k, data_kw):
    """Phase 25 (b): one rank of each of BUCKET_CHAINS on ml-1m synth
    (``data_kw``) through ``BPMF`` on ``mesh``, the buckets on both sides.
    First each of the four exchanges once on this rank's device (the
    ppermute too: the halo ring's); a refusal ends the rank.  Per chain:
    each side's exchange, its launch counts (set to 0 after setup, read
    after the chunks), collectives, per-chunk seconds, last metrics and
    both factor tables."""
    import numpy as np
    import torch

    from bpmf_tpu_torch import Config, synth_movielens
    from bpmf_tpu_torch.sampler import BPMF

    refused = {}
    x = torch.ones((2, 3), device=mesh.device) * (mesh.rank + 1)
    for name, call in (("all_gather", lambda: mesh.all_gather(x)),
                       ("all_reduce", lambda: mesh.all_reduce(x)),
                       ("reduce_scatter", lambda: mesh.reduce_scatter(
                           x.repeat(mesh.size, 1))),
                       ("ppermute", lambda: mesh.ppermute(x, 1))):
        try:
            got = call()
            if name == "ppermute":     # the peer's rows, not this rank's
                assert float(got[0, 0]) == (mesh.rank - 1) % mesh.size + 1, got
        except RuntimeError as e:      # the backend's refusal, quoted
            refused[name] = f"{type(e).__name__}: {e}"[:1000]
    if refused:
        return {"rank": mesh.rank, "refused": refused}
    torch.backends.cuda.matmul.allow_tf32 = False
    train, test = synth_movielens(**data_kw)
    counts = Counts()
    out = {"rank": mesh.rank}
    for name, kw in BUCKET_CHAINS.items():
        sampler = BPMF(Config(num_latent=k, burnin=2, nsims=chunks * iters,
                              seed=seed, gram_impl="bucketed", **kw),
                       train, test, out=open(os.devnull, "w"), mesh=mesh)
        sampler.setup()
        counts.reset()
        before = dict(mesh.collectives)
        mets, chunk_s = [], []
        for _ in range(chunks):
            t0 = time.perf_counter()
            mets.append(sampler.run_chunk(iters))   # ends in a host sync
            chunk_s.append(time.perf_counter() - t0)
        out[name] = {
            "launches": counts.read(),
            "collectives": {c: m - before[c] for c, m in mesh.collectives.items()},
            "exchange": {s.name: s.exchange for s in (sampler.movies, sampler.users)},
            "halo_volume_ratio": {s.name: s.halo.volume_ratio
                                  for s in (sampler.movies, sampler.users)
                                  if s.halo is not None},
            "chunk_s": chunk_s, "rmse_avg": float(mets[-1].rmse_avg[-1]),
            "rmse": float(mets[-1].rmse[-1]),
            "finite": bool(all(np.isfinite(x).all() for m in mets for x in m)),
            "tables": [sampler.items_host(sampler.users, sampler.state_u),
                       sampler.items_host(sampler.movies, sampler.state_m)]}
        del sampler
    return out


def reduce_phase(train, test, counts, total, tag, devnull, device="cuda", k=K,
                 data_kw=None, chunks=2, iters=50):
    """Phase 25: bucketed reduce, its chunked form, the halo ring and
    ``--dist`` on the one card.  (a) a real NCCL group of one rank: on both
    sides of ml-1m synth, reduce_half_sweep and reduce_half_sweep_chunked
    against gather_half_sweep on the same inputs and noise rows
    (REDUCE_TOL), #8 in each; (b) two gloo ranks on the one GPU: the chains
    of BUCKET_CHAINS against one device (MULTI_BAND, MULTI_TABLES), the
    halo's tables equal to the all_gather's; (c) the CLI with ``--dist
    127.0.0.1:<port>,1,0`` (one process, one NCCL rank through the TCP
    store) against the same run without it.  ``device``, ``k`` and
    ``data_kw`` exist for a rehearsal on the CPU at a small size (which
    skips (c)).  Returns the phase's lines and its seconds."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from bpmf_tpu_torch import Config, write_matrix
    from bpmf_tpu_torch.parallel import spmd
    from bpmf_tpu_torch.parallel.launch import run_ranks
    from bpmf_tpu_torch.parallel.mesh import free_port, init_mesh
    from bpmf_tpu_torch.sampler import BPMF

    t_phase = time.perf_counter()
    lines = []
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    # (a) one NCCL rank: the three bucketed sweeps on the same inputs
    mesh = init_mesh(0, 1, f"tcp://127.0.0.1:{free_port()}", dev)
    assert mesh.group is not None
    g = torch.Generator(device=dev).manual_seed(25)
    samplers = {}
    for name, kw in (("gather", {}), ("reduce", {"comm_mode": "reduce",
                                                   "reduce_chunked": "off"}),
                     ("reduce_chunked", {"comm_mode": "reduce",
                                         "reduce_chunked": "on"})):
        s = BPMF(Config(num_latent=k, burnin=0, nsims=3, gram_impl="bucketed", **kw),
                 train, test, out=devnull, device=dev)
        s.setup()
        assert s.movies.exchange == s.users.exchange == name
        samplers[name] = s
    sg = samplers["gather"]
    sg.run_chunk(3)                          # a state of the chain itself

    def rel(a, b):
        return float((a - b).abs().max() / max(1.0, float(b.abs().max())))

    calls = {}
    for side_name, state, other in (("movs", sg.state_m, sg.state_u.items),
                                    ("users", sg.state_u, sg.state_m.items)):
        side = sg.movies if side_name == "movs" else sg.users
        # one noise row per item by original id: gather reads it per bucket
        # slot, reduce per local slot
        table = torch.randn((side.num + 1, k), generator=g, device=dev)
        common = dict(num=side.num, mean_rating=sg._mean_rating, alpha=2.0,
                      burnin=0, solver=sg.solver, mesh=mesh)
        ga, ra, ca = (samplers[n]._aux[side_name]
                      for n in ("gather", "reduce", "reduce_chunked"))
        args = (state, other, state.hp)
        calls[side_name] = {
            "gather": lambda ga=ga, args=args, table=table, common=common:
                spmd.gather_half_sweep(args[0], ga.buckets, *args[1:],
                                       table[ga.bucket_orig], 5,
                                       splits=ga.splits, **common),
            "reduce": lambda ra=ra, args=args, table=table, common=common,
                n=side.maps.padded_num:
                spmd.reduce_half_sweep(args[0], ra.buckets, *args[1:],
                                       table[ra.local_orig], 5, padded_num=n,
                                       local_valid=ra.local_valid,
                                       splits=ra.splits, **common),
            "reduce_chunked": lambda ca=ca, args=args, table=table, common=common:
                spmd.reduce_half_sweep_chunked(args[0], ca.per_dest, *args[1:],
                                               table[ca.local_orig], 5,
                                               local_valid=ca.local_valid,
                                               **common)}
    counts.reset()
    before = dict(mesh.collectives)
    got = {(side, name): fn() for side, fns in calls.items()
           for name, fn in fns.items()}
    if dev.type == "cuda":
        torch.cuda.synchronize()
    n = counts.read()
    collectives = {c: m - before[c] for c, m in mesh.collectives.items()}
    want_n = launches(blast=6) if dev.type == "cuda" else launches()
    assert n == want_n, n
    assert collectives == {"all_gather": 2, "all_reduce": 8, "reduce_scatter": 2,
                           "ppermute": 0}, collectives
    for key, c in n.items():
        total[key] += c
    errs, sweep_ms = {}, {}
    for side_name in calls:
        valid = sg._aux[side_name].local_valid > 0
        want = got[side_name, "gather"]
        for name in ("reduce", "reduce_chunked"):
            st = got[side_name, name]
            errs[f"{side_name}_{name}"] = max(
                rel(st.items[valid], want.items[valid]), rel(st.sum, want.sum),
                rel(st.cov, want.cov), rel(st.norm, want.norm))
            assert errs[f"{side_name}_{name}"] <= REDUCE_TOL, (side_name, name, errs)
        if dev.type == "cuda":
            sweep_ms[side_name] = {name: median_ms(fn, reps=10)
                                   for name, fn in calls[side_name].items()}
    dist.destroy_process_group()
    lines.append({"phase": "reduce", "part": "a", "what": "one NCCL rank: the "
                  "bucketed sweeps of reduce mode, plain and chunked, against "
                  "gather mode on the same inputs", "dataset": "ml-1m synth",
                  "k": k, "backend": mesh.backend, "launches": n,
                  "collectives": collectives, "max_rel_err": errs,
                  "tolerance": REDUCE_TOL, "sweep_ms": sweep_ms,
                  "buckets": {sn: {name: len(samplers[name]._aux[sn].buckets)
                                   if name != "reduce_chunked" else
                                   sum(len(b) for b, _ in samplers[name]._aux[sn].per_dest)
                                   for name in samplers} for sn in calls}, **tag})
    del samplers, calls, got, sg

    # (b) two gloo ranks on the one GPU, each exchange, against one device
    one = BPMF(Config(num_latent=k, burnin=2, nsims=chunks * iters, seed=7,
                      gram_impl="bucketed"), train, test, out=devnull, device=dev)
    one_mets, one_s = [], []
    for _ in range(chunks):
        t0 = time.perf_counter()
        one_mets.append(one.run_chunk(iters))
        one_s.append(time.perf_counter() - t0)
    one_avg = float(one_mets[-1].rmse_avg[-1])
    one_tables = [one.items_host(one.users, one.state_u),
                  one.items_host(one.movies, one.state_m)]
    del one
    ranks = run_ranks(multi_bucket_chains, 2, chunks, iters, 7, k, data_kw or {},
                      device=dev, backend="gloo", timeout_s=600)
    refused = {r["rank"]: r["refused"] for r in ranks if "refused" in r}
    assert not refused, refused              # the ring needs its ppermute
    want_exchange = {"reduce": "reduce", "reduce_chunked": "reduce_chunked",
                     "halo": "halo", "gather": "gather"}
    per_chain = {}
    for name in BUCKET_CHAINS:
        r0, r1 = ranks[0][name], ranks[1][name]
        for r in (r0, r1):
            assert r["finite"], (name, r)
            assert r["exchange"] == dict.fromkeys(("movs", "users"),
                                                  want_exchange[name]), r["exchange"]
            if dev.type == "cuda":
                assert r["launches"] == launches(blast=2 * chunks * iters), r["launches"]
        assert r0["rmse_avg"] == r1["rmse_avg"]
        diff = max(float(np.abs(a - b).max()) for a, b in zip(r0["tables"], one_tables))
        assert abs(r0["rmse_avg"] - one_avg) <= MULTI_BAND, (name, r0["rmse_avg"], one_avg)
        assert diff <= MULTI_TABLES, (name, diff)
        for key, c in r0["launches"].items():
            total[key] += c
        per_chain[name] = {
            "rmse_avg": r0["rmse_avg"], "rmse": r0["rmse"],
            "tables_max_abs_diff": diff, "collectives_per_rank": r0["collectives"],
            "launches_per_rank": r0["launches"],
            "halo_volume_ratio": r0["halo_volume_ratio"],
            "gloo_ms_per_iter": sum(r0["chunk_s"][1:]) / ((chunks - 1) * iters) * 1e3,
            "chunk_s": r0["chunk_s"]}
    # the ring moves the all_gather's values to every row a bucket reads
    halo_equal = all(np.array_equal(a, b) for a, b in
                     zip(ranks[0]["halo"]["tables"], ranks[0]["gather"]["tables"]))
    assert halo_equal
    lines.append({"phase": "reduce", "part": "b",
                  "what": "2 ranks on one GPU, gloo through the host (not a "
                          "speed of the port)", "dataset": "ml-1m synth", "k": k,
                  "iterations": chunks * iters, "chains": per_chain,
                  "halo_tables_equal_gather": halo_equal,
                  "one_device_rmse_avg": one_avg, "band": MULTI_BAND,
                  "tables_bound": MULTI_TABLES,
                  "one_device_ms_per_iter": sum(one_s[1:]) / ((chunks - 1) * iters) * 1e3,
                  **tag})

    # (c) the CLI with --dist: one process, one NCCL rank, the TCP store
    if dev.type == "cuda":
        with tempfile.TemporaryDirectory() as tmp:
            tr, te = os.path.join(tmp, "train.sdm"), os.path.join(tmp, "test.sdm")
            write_matrix(tr, train)
            write_matrix(te, test)
            runs = {}
            for label, extra in (("plain", []),
                                 ("dist", ["--dist", f"127.0.0.1:{free_port()},1,0"])):
                proc = subprocess.run(
                    [sys.executable, "-m", "bpmf_tpu_torch", "-n", tr, "-p", te,
                     "-i", "20", "-b", "5", "-d", str(k)] + extra,
                    capture_output=True, text=True, cwd=ROOT, timeout=300,
                    env=dict(os.environ, PYTHONPATH=ROOT))
                assert proc.returncode == 0, proc.stderr[-3000:]
                runs[label] = proc.stdout
            assert "process group: nccl, 1 rank(s)" in runs["dist"]
            assert "process group" not in runs["plain"]

            def trajectory(text):
                return [line.split("\titems/sec")[0] for line in text.splitlines()
                        if "iteration" in line and "RMSE" in line]
            traj = {label: trajectory(text) for label, text in runs.items()}
            assert len(traj["plain"]) == 20 and traj["dist"] == traj["plain"]
            lines.append({"phase": "reduce", "part": "c",
                          "what": "--dist 127.0.0.1:<port>,1,0 against no --dist",
                          "dataset": "ml-1m synth", "k": k, "iterations": 20,
                          "trajectory_equal": True,
                          "final": runs["dist"].split("Final Avg RMSE:")[1].split()[0],
                          **tag})
    return lines, time.perf_counter() - t_phase


def cpu_name():
    """The host CPU, which every host-seconds number names: its model name
    from /proc/cpuinfo (vendor, family and model where the name is
    hidden), the architecture and the cores this process may use."""
    fields = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _, value = line.partition(":")
            fields.setdefault(key.strip(), value.strip())
    name = fields.get("model name") or " ".join(
        f"{k} {fields[k]}" for k in ("vendor_id", "cpu family", "model")
        if k in fields) or "model not shown"
    return f"{name} ({platform.machine()}, {len(os.sched_getaffinity(0))} cores)"


def api_phase(train, test, btrain, counts, total, tag, devnull, device="cuda",
              k=K, iters=500):
    """Phase 27: the functional model API and the native matrix I/O.  (a)
    ``models.gibbs_iter`` (solver "smart": #8 twice an iteration) on each
    side's ``SideData`` built with ``parallel.partition`` as a user would,
    against ``BPMF(gram_impl="bucketed", solver="smart")``, both drawing
    from ``HostDraws(seed)``: the first 3 iterations within CHAIN_TOL, after
    ``iters`` both rmse_avg within API_BAND of each other and RMSE_BAND of
    RMSE_AVG_JAX, and both chains' ms/iter (the second half of each).  (b)
    the ml-1m train matrix written as .sdm, .sdm.gz and .mtx by the Python
    writer, each read by the native and the Python reader (equal), and
    ``sparse.bucketize`` of ``btrain`` (both sides) filled natively and in
    Python (equal), each in host seconds; ``native.status()`` must read
    native.  ``device``, ``k`` and ``iters`` exist for a rehearsal on the
    CPU at a small size (where the RMSE_AVG_JAX gate does not apply).
    Returns the phase's lines and its seconds."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    from bpmf_tpu_torch import Config, models
    from bpmf_tpu_torch.io import matrix_io, native
    from bpmf_tpu_torch.parallel import partition as part
    from bpmf_tpu_torch.sampler import BPMF, HostDraws, rank_buckets
    from bpmf_tpu_torch.sparse import bucketize

    t_phase = time.perf_counter()
    dev = torch.device(device)
    lines = []
    status = native.status()
    assert status.startswith("native "), status
    host = {**tag, "host_cpu": cpu_name()}

    # (a) the API chain against BPMF's bucketed chain, the same draws
    cfg = Config(num_latent=k, burnin=2, nsims=iters, gram_impl="bucketed",
                 solver="smart")
    half = iters // 2

    def halves(run):
        """``run(n)`` twice, n = half of ``iters`` then the rest, each ending
        in a host sync; (metrics [iters, 4], ms/iter of the second run)."""
        first = run(half)
        t0 = time.perf_counter()
        second = run(iters - half)
        ms = (time.perf_counter() - t0) / (iters - half) * 1e3
        return np.concatenate([first, second]), ms

    mats = {"movies": train.tocsc(), "users": sp.csc_matrix(train.T)}
    maps = {s: part.make_maps(part.assign_items(np.diff(m.indptr), 1), m.shape[1])
            for s, m in mats.items()}
    data, splits = {}, {}
    for s, o in (("movies", "users"), ("users", "movies")):
        layout = part.build_gather_layout(mats[s], maps[s], maps[o].orig_to_padded,
                                          cfg.max_bucket_width, cfg.bucket_growth)
        data[s] = models.SideData(buckets=rank_buckets(layout.buckets, 0,
                                                       torch.float32, dev))
        splits[s] = layout.splits
    state = {s: models.init_side_state(maps[s].padded_num, k, torch.float32,
                                       False, dev) for s in mats}
    tcoo = test.tocoo()
    ev = models.EvalData(
        t_user=torch.as_tensor(maps["users"].orig_to_padded[tcoo.row], device=dev),
        t_item=torch.as_tensor(maps["movies"].orig_to_padded[tcoo.col], device=dev),
        t_val=torch.as_tensor(tcoo.data, dtype=torch.float32, device=dev))
    est = models.EvalState(pavg=torch.zeros(test.nnz, device=dev),
                           pm2=torch.zeros(test.nnz, device=dev))
    mean = torch.as_tensor(train.sum() / train.nnz, dtype=torch.float32,
                           device=dev)
    draws = HostDraws(cfg.seed, dev)
    kw = dict(num_movies=maps["movies"].num, num_users=maps["users"].num,
              mean_rating=mean, alpha=cfg.alpha, burnin=cfg.burnin,
              movies_splits=splits["movies"], users_splits=splits["users"],
              solver="smart")

    done = 0

    def api_run(n):
        """n iterations of gibbs_iter, one host sync at the end, as
        BPMF.run_chunk."""
        nonlocal est, done
        mets = []
        for it in range(done, done + n):
            state["movies"], state["users"], est, met = models.gibbs_iter(
                state["movies"], state["users"], est, data["movies"],
                data["users"], ev, draws, it, **kw)
            mets.append(torch.stack(met))
        done += n
        return torch.stack(mets).cpu().numpy()

    counts.reset()
    api_mets, api_ms = halves(api_run)
    api_n = counts.read()
    sampler = BPMF(cfg, train, test, out=devnull, device=dev,
                   draws=HostDraws(cfg.seed, dev))
    sampler.setup()
    assert sampler.movies.impl == sampler.users.impl == "bucketed"
    for s, name in (("movies", "movs"), ("users", "users")):
        want = [b.nbr.shape for b in sampler._aux[name].buckets]
        assert [b.nbr.shape for b in data[s].buckets] == want, (s, want)
    counts.reset()
    bpmf_mets, bpmf_ms = halves(lambda n: np.stack(sampler.run_chunk(n), 1))
    bpmf_n = counts.read()
    del sampler
    if dev.type == "cuda":
        assert api_n == launches(blast=2 * iters), api_n
        assert bpmf_n == launches(blast=2 * iters), bpmf_n
        total["blast"] += api_n["blast"] + bpmf_n["blast"]
    assert np.isfinite(api_mets).all() and np.isfinite(bpmf_mets).all()
    np.testing.assert_allclose(api_mets[:3], bpmf_mets[:3], **CHAIN_TOL)
    api_avg, bpmf_avg = float(api_mets[-1, 1]), float(bpmf_mets[-1, 1])
    line = {"phase": "api", "chain": "ml-1m synth bucketed", "k": k,
            "iterations": iters, "solver": "smart", "launches": api_n,
            "bpmf_launches": bpmf_n, "rmse_avg": api_avg,
            "bpmf_rmse_avg": bpmf_avg, "rmse_avg_jax": RMSE_AVG_JAX,
            "first_3_max_abs_err": float(np.abs(api_mets[:3] - bpmf_mets[:3]).max()),
            "tolerance": CHAIN_TOL, "band": API_BAND,
            "ms_per_iter": api_ms, "bpmf_ms_per_iter": bpmf_ms,
            "timed": f"iterations {half}-{iters - 1}, host clock, one sync",
            **tag}
    lines.append(line)
    assert abs(api_avg - bpmf_avg) <= API_BAND, line
    if dev.type == "cuda":
        assert abs(api_avg - RMSE_AVG_JAX) <= RMSE_BAND, line

    # (b) the native matrix I/O against Python, host seconds
    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        return out, time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        for ext in ("sdm", "sdm.gz", "mtx"):
            path = os.path.join(tmp, "train." + ext)
            with env(BPMF_NO_NATIVE="1"):
                _, write_s = timed(matrix_io.write_matrix, path, train)
                py, py_s = timed(matrix_io.read_matrix, path)
            nat, nat_s = timed(matrix_io.read_matrix, path)
            assert nat.shape == py.shape == train.shape and nat.nnz == train.nnz
            assert (nat != py).nnz == 0 and (nat != train).nnz == 0, ext
            lines.append({"phase": "api", "read": ext, "bytes": os.path.getsize(path),
                          "nnz": int(nat.nnz), "native_s": nat_s, "python_s": py_s,
                          "python_write_s": write_s, "equal": True, **host})
    fields = ("nbr", "val", "mask", "row_slot", "item_ids", "orig_ids", "slot_valid")
    for name, m in (("movies", btrain.tocsc()), ("users", sp.csc_matrix(btrain.T))):
        ids = np.arange(m.shape[1], dtype=np.int32)
        args = (m, ids, -1, 8, cfg.max_bucket_width, 8, cfg.bucket_growth)
        nat, nat_s = timed(bucketize, *args)
        with env(BPMF_NO_NATIVE="1"):
            py, py_s = timed(bucketize, *args)
        assert len(nat.buckets) == len(py.buckets)
        for a, b in zip(nat.buckets, py.buckets):
            assert a.split == b.split
            for f in fields:
                assert np.array_equal(getattr(a, f), getattr(b, f)), (name, f)
        lines.append({"phase": "api", "bucketize": name, "items": int(m.shape[1]),
                      "nnz": int(m.nnz), "buckets": len(nat.buckets),
                      "native_s": nat_s, "python_s": py_s, "equal": True, **host})
    lines.append({"phase": "api", "native_status": status, **host})
    return lines, time.perf_counter() - t_phase


def host_syncs(sampler, it):
    """The host syncs of one ``iter_fn`` call on the sampler's state (after
    a warm call), as ``torch.cuda.set_sync_debug_mode("warn")`` reports
    them (a prototype that does not see every sync, torch says): their
    count and each warning's file:line; then, where there is one, the
    stack of the first (the call again under ``"error"``, which raises
    there).  Measured, not gated (the host enqueue, ROADMAP B2)."""
    import traceback
    import warnings

    import torch

    def site(filename, lineno, name=""):
        path = os.path.abspath(filename)
        path = (os.path.relpath(path, ROOT) if path.startswith(ROOT)
                else path.split("site-packages/")[-1])
        return f"{path}:{lineno} {name}".strip()

    state = (sampler.state_m, sampler.state_u, sampler.est)
    sampler.iter_fn(*state, sampler.draws, it)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            sampler.iter_fn(*state, sampler.draws, it)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    # the mode's own one-time notice ("Synchronization debug mode is a
    # prototype feature ...") is not a sync
    where = [site(w.filename, w.lineno) for w in caught
             if "called a synchronizing" in str(w.message)]
    first = []
    if where:
        torch.cuda.set_sync_debug_mode("error")
        try:
            sampler.iter_fn(*state, sampler.draws, it)
        except RuntimeError as e:
            first = [site(f.filename, f.lineno, f.name)
                     for f in traceback.extract_tb(e.__traceback__)][-6:]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    return {"host_syncs": len(where), "sync_sites": where,
            "first_sync_stack": first}


def entry_phase(train, test, counts, total, tag, devnull, device="cuda", k=K,
                chunks=2, iters=50, n_ranks=2):
    """Phase 28: the entry points (``bpmf_tpu_torch.entry``) and the pure
    iteration.  (a) ``entry()``'s function twice on cloned inputs, bitwise
    equal and finite, beside the same call through the plain versions
    (CHAIN_TOL); (b) the main path at full width (``train``: ml-1m synth,
    K=32, #1 on both sides), ``chunks`` of ``iters`` iterations through an
    ``iter_fn`` loop and through ``BPMF.run_chunk`` from the same initial
    state on the same ``TorchDraws``: bitwise equal, finite, both ms/iter;
    (c) the host syncs of one ``iter_fn`` call on #1 and on the bucketed
    route (#8) (measured, not gated); (d) ``dryrun_multichip(n_ranks)``:
    each leg's two steps within ENTRY_LEG_TOL of the one-device tiny chain,
    its kernels, and the two-process leg's final line equal to one process
    of ``n_ranks`` ranks on the command line.  ``device``, ``k``,
    ``chunks`` and ``iters`` exist for a rehearsal on the CPU at a small
    size.  Returns the phase's lines and its seconds."""
    import numpy as np
    import torch

    from bpmf_tpu_torch import Config, entry, synth_movielens, write_matrix
    from bpmf_tpu_torch.sampler import BPMF, TorchDraws

    t_phase = time.perf_counter()
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    lines = []

    def tensors(x):
        if isinstance(x, torch.Tensor):
            return [x]
        if x is None or isinstance(x, (int, float)):
            return []
        return [t for y in x for t in tensors(y)]

    def bitwise(a, b):
        ta, tb = tensors(a), tensors(b)
        return len(ta) == len(tb) and all(torch.equal(x, y) for x, y in zip(ta, tb))

    def clone(x):
        return type(x)(*(None if t is None else clone(t) if isinstance(t, tuple)
                         else t.clone() for t in x))

    # (a) entry()'s function on the card, twice, and through the plain versions
    fn, args = entry.entry(device=device)
    state, rest = args[:3], args[3:]
    counts.reset()
    first = fn(*(clone(x) for x in state), *rest)
    second = fn(*(clone(x) for x in state), *rest)
    n = counts.read()
    with plain_kernels():
        plain = fn(*(clone(x) for x in state), *rest)
    assert bitwise(first, second), "entry(): two calls differ"
    assert all(torch.isfinite(t).all() for t in tensors(first))
    got = torch.stack(first[3]).cpu().numpy()
    want = torch.stack(plain[3]).cpu().numpy()
    np.testing.assert_allclose(got, want, **CHAIN_TOL)
    items_err = max(float((a.items - b.items).abs().max())
                    for a, b in zip(first[:2], plain[:2]))
    assert items_err <= CHAIN_TOL["atol"] + CHAIN_TOL["rtol"] * max(
        float(t.items.abs().max()) for t in plain[:2]), items_err
    if cuda:
        assert n == launches(fused_inkernel=4), n
    for key, c in n.items():
        total[key] += c
    lines.append({"phase": "entry", "part": "a", "what": "entry()'s fn, twice on "
                  "cloned inputs, and through the plain versions",
                  "k": fn.__self__.cfg.num_latent, "launches": n,
                  "bitwise_repeat": True, "metrics": got.tolist(),
                  "plain_max_abs_err": float(np.abs(got - want).max()),
                  "items_max_abs_err": items_err, "tolerance": CHAIN_TOL, **tag})
    del fn, args, state, first, second, plain

    # (b) the main path at full width: an iter_fn loop against run_chunk
    s = BPMF(Config(num_latent=k, burnin=2, nsims=chunks * iters + 1), train,
             test, out=devnull, device=device)
    s.setup()
    if cuda:
        assert s.users.route == s.movies.route == "fused"
    loop_state = (s.state_m, s.state_u, s.est)
    draws = TorchDraws(s.cfg.seed, s.device)

    def timed(run):
        mets, chunk_s = [], []
        counts.reset()
        for c in range(chunks):
            t0 = time.perf_counter()
            mets.append(run(c))          # ends in a host sync
            chunk_s.append(time.perf_counter() - t0)
        return np.concatenate(mets), chunk_s, counts.read()

    def loop_chunk(c):
        nonlocal loop_state
        mets = []
        for it in range(c * iters, (c + 1) * iters):
            *loop_state, met = s.iter_fn(*loop_state, draws, it)
            mets.append(torch.stack(met))
        return torch.stack(mets).cpu().numpy()

    loop_mets, loop_s, loop_n = timed(loop_chunk)
    chunk_mets, chunk_s, chunk_n = timed(lambda c: np.stack(s.run_chunk(iters), 1))
    assert np.isfinite(loop_mets).all(), loop_mets
    assert np.array_equal(loop_mets, chunk_mets), "iter_fn loop != run_chunk"
    assert bitwise(tuple(loop_state), (s.state_m, s.state_u, s.est))
    done = chunks * iters
    if cuda:
        assert loop_n == chunk_n == launches(fused_inkernel=2 * done), (loop_n, chunk_n)
    for key in loop_n:
        total[key] += loop_n[key] + chunk_n[key]
    line = {"phase": "entry", "part": "b", "dataset": "ml-1m synth", "k": k,
            "iterations": done, "routes": [s.movies.route, s.users.route],
            "launches": loop_n, "run_chunk_launches": chunk_n,
            "bitwise_equal": True, "rmse_avg": float(loop_mets[-1, 1]),
            "iter_fn_ms_per_iter": sum(loop_s[1:]) / ((chunks - 1) * iters) * 1e3,
            "run_chunk_ms_per_iter": sum(chunk_s[1:]) / ((chunks - 1) * iters) * 1e3,
            "timed": f"chunks 2-{chunks} of {iters}, host clock, a sync each",
            **tag}

    # (c) host syncs in one iteration, #1 and the buckets
    if cuda:
        line.update(host_syncs(s, done))
    lines.append(line)
    del s, loop_state
    b = BPMF(Config(num_latent=k, burnin=2, nsims=10, gram_impl="bucketed"),
             train, test, out=devnull, device=device)
    b.setup()
    if cuda:
        counts.reset()
        syncs = host_syncs(b, 0)
        n = counts.read()
        assert n == launches(blast=4), n
        total["blast"] += n["blast"]
        lines.append({"phase": "entry", "part": "c", "dataset": "ml-1m synth",
                      "k": k, "route": "bucketed", "launches": n, **syncs, **tag})
    del b

    # (d) dryrun_multichip on gloo ranks (on the one GPU), each leg against
    # the one-device tiny chain; the two-process leg against one process
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        dry = entry.dryrun_multichip(n_ranks, device=device)
    printed = out.getvalue()
    one = entry._tiny_sampler(1, device=device)
    one_device = np.array([list(one.step()) for _ in range(2)])
    del one
    d8_kernels = {"gram_inkernel", "gram_hoisted", "solve_shared"}
    for leg in dry["legs"]:
        err = float(np.abs(leg["metrics"] - one_device).max())
        ran = set(leg["launches"])
        if cuda:
            if leg["leg"][1] == "bucketed":
                assert ran == {"blast"}, leg
            else:
                assert "solve_shared" in ran and ran <= d8_kernels, leg
                assert ran & {"gram_inkernel", "gram_hoisted"}, leg
        for key, c in leg["launches"].items():
            total[key] += c
        lines.append({"phase": "entry", "part": "d", "leg": list(leg["leg"]),
                      "n_ranks": n_ranks, "placement": dry["placement"],
                      "metrics": leg["metrics"].tolist(),
                      "one_device_max_abs_err": err, "tolerance": ENTRY_LEG_TOL,
                      "launches": leg["launches"], **tag})
        assert err <= ENTRY_LEG_TOL, lines[-1]
    with tempfile.TemporaryDirectory() as tmp:
        tr, te = os.path.join(tmp, "train.sdm"), os.path.join(tmp, "test.sdm")
        tiny = synth_movielens(**entry.TINY_DATA)
        write_matrix(tr, tiny[0])
        write_matrix(te, tiny[1])
        rank_dev = "cpu" if not cuda else f"cuda:{torch.cuda.current_device()}"
        proc = subprocess.run(
            [sys.executable, "-m", "bpmf_tpu_torch", "-n", tr, "-p", te, "-i", "3",
             "-b", "1", "-d", "16", "--seed", "7", "--devices", str(n_ranks),
             "--device", rank_dev], capture_output=True, text=True, cwd=tmp,
            timeout=300, env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    final = [x for x in proc.stdout.splitlines() if x.startswith("Final Avg RMSE")]
    assert dry["multihost"]["final"] == final[0], (dry["multihost"]["final"], final)
    lines.append({"phase": "entry", "part": "d", "leg": "two processes, BPMF_DIST",
                  "n_ranks": n_ranks, "final": final[0],
                  "one_process": f"--devices {n_ranks} --device {rank_dev}",
                  "printed": printed.splitlines(), **tag})
    return lines, time.perf_counter() - t_phase


def bench_phase(total, tag, chain_rmse):
    """Phase 29: the ml1m, chembl and ml25m_half legs of
    ``bpmf_tpu_torch.bench``, each through ``bench.run_leg`` (a subprocess
    of its own under BENCH_TIMEOUT_S) on the sampler's default route.  Each
    leg's dict is printed before its gates: ``rmse_avg_check`` within
    RMSE_BAND of BENCH_ANCHORS and within LEG_BAND of the same chain run in
    this process, whose kernels were held to their plain versions there
    (``chain_rmse``: phases 4, 9 and 12), both sides dense8 on #1
    (``fused``), 2 ``fused_inkernel`` launches an iteration of its timed
    chunks and no other kernel.  The legs' launches go into ``total``.
    Returns the phase's seconds."""
    from bpmf_tpu_torch.bench import run_leg

    t_phase = time.perf_counter()
    for leg, anchor in BENCH_ANCHORS.items():
        d = run_leg(leg, BENCH_TIMEOUT_S[leg])
        emit({"phase": "bench", "leg": leg, **d, "rmse_avg_jax": anchor,
              "band": RMSE_BAND, "rmse_avg_in_process": chain_rmse[leg],
              "leg_band": LEG_BAND, **tag})
        assert "items_per_sec" in d, (leg, d)
        assert abs(d["rmse_avg_check"] - anchor) <= RMSE_BAND, (leg, d)
        assert abs(d["rmse_avg_check"] - chain_rmse[leg]) <= LEG_BAND, (leg, d)
        for side in d["sides"].values():
            assert side == {"impl": "dense8", "route": "fused"}, (leg, d)
        assert d["launches_per_iter"] == {"fused_inkernel": 2.0}, (leg, d)
        total["fused_inkernel"] += d["launches"]["fused_inkernel"]
    return time.perf_counter() - t_phase


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    from bpmf_tpu_torch import Config, synth_chembl, synth_jester, synth_movielens
    from bpmf_tpu_torch.device import card_power
    from bpmf_tpu_torch.io import native
    from bpmf_tpu_torch.ops import dense8 as d8
    from bpmf_tpu_torch.ops import pallas_solve as ps
    from bpmf_tpu_torch.ops._build import build
    from bpmf_tpu_torch.ops.dense8 import (
        dense8_sweep_solve,
        dense8_sweep_solve_ref,
    )
    from bpmf_tpu_torch.ops.dense8 import quantize_values
    from bpmf_tpu_torch.ops.update import chol_solve_sample as linalg_solve
    from bpmf_tpu_torch.parallel.spmd import _combine_prior_rhs
    from bpmf_tpu_torch.sampler import BPMF, HostDraws
    from bpmf_tpu_torch.scripts.sweep_times import (
        PROBE_CELLS,
        bf16_library,
        gram_library,
        per_launch_ms,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    devnull = open(os.devnull, "w")
    counts = Counts()

    # 1. device
    smi = card_power()
    assert smi, "nvidia-smi did not read the card's name and power limit"
    card = torch.cuda.get_device_name(0)
    emit({"phase": "device", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": card, "count": torch.cuda.device_count(),
          "nvidia_smi": smi})
    tag = {"device": card, "nvidia_smi": smi}

    # 2. build, one nvcc per source and the native matrix I/O's g++, all
    # started together
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(LIBS) + 1) as pool:
        io_status = pool.submit(native.status)
        built = dict(zip(LIBS, pool.map(build, LIBS)))
        io_status = io_status.result()
    assert io_status.startswith("native "), io_status
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "libraries": {n: os.path.relpath(lib, ROOT) for n, (lib, _) in built.items()},
          "ptxas": {n: ptxas_summary(rep) for n, (_, rep) in built.items()},
          "native_io": io_status})

    # 3. the megakernels against plain: #1, and #2 in both layouts
    cs, cb, alpha = 2.0, -7.2, 2.0

    def compare(args, orientation, p_t=None, layout="aligned", reps=25,
                cs=cs, max_degree=None):
        """One megakernel launch (p_t None: #1, else #2 in ``layout``) on
        args = (codes, v_t, lam, prior_rhs, noise_t) against its plain
        version at KERNEL_TOL, with both times; a second launch must equal
        the first bit for bit (the segments' sums in one order, the
        arrival counters reset)."""
        codes, rest = args[0], args[1:]

        def call():
            return dense8_sweep_solve(codes, p_t, *rest, cs, cb, alpha,
                                      orientation, layout=layout,
                                      max_degree=max_degree)

        def plain():
            return dense8_sweep_solve_ref(codes, p_t, *rest, cs, cb, alpha,
                                          orientation, layout)
        got = call()
        torch.cuda.synchronize()
        assert torch.equal(got, call())
        want = plain()
        torch.testing.assert_close(got, want, **KERNEL_TOL)
        return {"max_abs_err": float((got - want).abs().max()),
                "ms": median_ms(call, reps), "plain_ms": median_ms(plain, reps),
                "library_ms": median_ms(lambda: sweep_library(
                    args, orientation, p_t, layout, cs), reps)}

    def sweep_library(args, orientation, p_t, layout, cs=cs):
        """The megakernel's function (#1, #2) as a library chain, its
        yardstick: the packed operand (built from v_t for #1, p_t's valid
        rows for #2) times the f32 indicator and the rhs by cuBLAS SGEMMs
        (TF32 off), the systems by ops.pallas_solve.tri_combine, then
        torch.linalg Cholesky and two triangular solves."""
        codes, v_t, lam, prior_rhs, noise_t = args
        k = v_t.shape[0]
        x = codes if orientation == "rows" else codes.t()
        ind = (x != 0).float()
        cv = cs * x.float() + cb * ind
        if p_t is None:
            p = d8.packed_tri_t(v_t)[:k * (k + 1) // 2]
        else:
            p = p_t[torch.as_tensor(d8._layout_rows(k, layout)[0], device=p_t.device)]
        chol = torch.linalg.cholesky_ex(ps.tri_combine(p @ ind.t(), lam, alpha)).L
        y = torch.linalg.solve_triangular(
            chol, (v_t @ cv.t() + prior_rhs).t()[..., None], upper=False)
        return torch.linalg.solve_triangular(
            chol.mT, y + noise_t.t()[..., None], upper=True)[..., 0].t()

    def sweep_work(args, p_t=None, layout="aligned"):
        """(bytes, flops) of one megakernel launch: the codes, v, p's valid
        rows, lam, prior, noise and the output once; the Gram and rhs of
        the rated entries, the combine and the solve."""
        codes, v_t, _, _, noise_t = args
        k, items = noise_t.shape
        tv = k * (k + 1) // 2
        nnz = int((codes != 0).sum())
        p_rows = 0 if p_t is None else len(d8._layout_rows(k, layout)[0])
        nbytes = (codes.numel() * codes.element_size()
                  + v_t.element_size() * (v_t.numel() + p_rows * v_t.shape[1])
                  + 4 * (k * k + k + 2 * k * items))
        gram = gram_flops if p_t is None else hoisted_gram_flops
        return nbytes, gram(k, nnz) + solve_flops(k, items) + 2 * tv * items

    # the kernels line's rows: random codes, K=32, rows + cols (one
    # iteration runs both orientations)
    result = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                     "library_ms": 0.0, "nbytes": 0, "flops": 0}
              for name in ("inkernel", "tight", "aligned")}
    mega_chain = {}   # the tensor-core megakernel on chains' own states (bf16)

    def sweep_record(name, args, orientation, inputs, k=K, headline=False,
                     where=None, cs=cs, max_degree=None, row=None):
        """#1 or #2 (``name``: inkernel, tight, aligned) against plain: one
        JSON line, and its times and bound under
        ``<key>_<where>_<orientation>`` of its kernels-line row (``row``,
        by default ``name``)."""
        p_t, layout = None, "aligned"   # layout: ignored by #1
        if name != "inkernel":
            p_t, layout = d8.packed_tri_t(args[1], aligned=name == "aligned"), name
        r = compare(args, orientation, p_t, layout, cs=cs, max_degree=max_degree)
        nbytes, flops = sweep_work(args, p_t, layout)
        emit({"phase": "kernel", "kernel": "dense8_sweep_solve",
              "operand": name, "inputs": inputs, "orientation": orientation,
              "shape": list(args[0].shape), "codes": str(args[0].dtype),
              "k": k, "density": float((args[0] != 0).float().mean()),
              "max_degree": max_degree, "tolerance": KERNEL_TOL,
              "instance": d8.sweep_instance_key(k, name), **r,
              **bound(nbytes, flops), **tag})
        res = result[row or name]
        res["max_abs_err"] = max(res["max_abs_err"], r["max_abs_err"])
        if where is None:
            where = f"k{k}" if inputs == "random codes" else inputs.replace(" ", "_")
        res[f"bound_ms_{where}_{orientation}"] = bound(nbytes, flops)["bound_ms"]
        for key in ("ms", "plain_ms", "library_ms"):
            res[f"{key}_{where}_{orientation}"] = r[key]
        if headline:
            for key, v in (("ms", r["ms"]), ("plain_ms", r["plain_ms"]),
                           ("library_ms", r["library_ms"]),
                           ("nbytes", nbytes), ("flops", flops)):
                res[key] += v

    for k in (K, 16):
        for i, orientation in enumerate(("rows", "cols")):
            args = kernel_inputs(orientation, seed=i + (0 if k == K else 50), k=k)
            for name in ("inkernel", "tight", "aligned"):
                if k != K and name == "inkernel":
                    continue
                sweep_record(name, args, orientation, "random codes", k,
                             headline=k == K)
    # skewed degrees, the main paths' shape: an item with every frozen
    # entry rated, the split over segments at its degree
    for i, orientation in enumerate(("rows", "cols")):
        args = kernel_inputs(orientation, seed=60 + i, skewed=True)
        frozen = args[1].shape[1]
        for name in ("inkernel", "tight", "aligned"):
            sweep_record(name, args, orientation, "skewed codes",
                         max_degree=frozen)
    # the instances past one row a lane and #2 at a runtime K: a row of the
    # kernels line each, random codes rows + cols; K=40 (39 aligned) also
    # on skewed codes over segments
    for key in WIDE:
        result[key] = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                       "library_ms": 0.0, "nbytes": 0, "flops": 0}
    for name, k in WIDE:
        for i, orientation in enumerate(("rows", "cols")):
            args = kernel_inputs(orientation, seed=300 + 2 * k + i, k=k)
            sweep_record(name, args, orientation, "random codes", k,
                         headline=True, row=(name, k))
            if k in (39, 40):
                args = kernel_inputs(orientation, seed=360 + i, k=k, skewed=True)
                sweep_record(name, args, orientation, "skewed codes", k,
                             max_degree=args[1].shape[1], row=(name, k))
    del args

    # 4. main path, K=32, the megakernel
    train, test = synth_movielens()
    iters, chunks = 500, 4

    def ml1m(k, **kw):
        return lambda: BPMF(Config(num_latent=k, burnin=2,
                                   nsims=(chunks + 1) * iters, **kw),
                            train, test, out=devnull, device="cuda")

    torch.cuda.reset_peak_memory_stats()
    sampler, mets, chunk_s, setup_s, n = drive(ml1m(K), counts, chunks, iters)
    done = chunks * iters
    assert sampler.users.route == sampler.movies.route == "fused"
    assert n == launches(fused_inkernel=2 * done), n
    rmse_avg = float(mets[-1].rmse_avg[-1])
    assert abs(rmse_avg - RMSE_AVG_JAX) <= RMSE_BAND, (
        f"rmse_avg {rmse_avg} outside {RMSE_AVG_JAX} +- {RMSE_BAND}")
    total = dict(n)
    chain_rmse = {"ml1m": rmse_avg}   # phase 29's legs against these chains
    emit({"phase": "main", "dataset": "ml-1m synth", "k": K,
          "iterations": done, "launches": n, "rmse_avg": rmse_avg,
          "rmse": float(mets[-1].rmse[-1]), "rmse_avg_jax": RMSE_AVG_JAX,
          **per_iter_stats(sampler, chunk_s, iters), "setup_s": setup_s,
          "peak_mem_bytes": torch.cuda.max_memory_allocated(), **tag})

    # the megakernels again at the main path's own inputs: the real code
    # array (skewed degrees) and the chain's last state
    for orientation, side, state, frozen in (
            ("cols", sampler.movies, sampler.state_m, sampler.state_u),
            ("rows", sampler.users, sampler.state_u, sampler.state_m)):
        hp = state.hp
        items = state.items.shape[0]
        noise_t = torch.randn((K, items), device="cuda")
        args = (sampler._codes, frozen.items.t(), hp.lambda_f,
                (hp.lambda_f @ hp.mu)[:, None], noise_t)
        for name in ("inkernel", "tight", "aligned"):
            sweep_record(name, args, orientation, "main path",
                         max_degree=side.max_degree)
    del sampler, args

    # 5. the split pipeline's kernels against plain
    split = {name: {"max_abs_err": 0.0} for name in
             ("gram_inkernel", "gram_hoisted", "solve_shared", "solve_peritem",
              "solve_shared_grouped", "solve_peritem_grouped")}

    def record(name, k, orientation, got, want, fn, plain_fn,
               inputs="random codes", shape=(N_USERS, N_MOVIES), f64=None,
               work=(0, 0), headline=None, library_fn=None, **info):
        """Holds a kernel's outputs to its plain version's at KERNEL_TOL, or,
        with ``f64`` (a solve's (args, lam_tri_t)), item by item to the
        float64 draw within SOLVE_BOUND; emits both times, then asserts."""
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        if f64 is None:
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, **KERNEL_TOL)
            tol = KERNEL_TOL
        else:
            (gram_a, lam_a, rhs_a, noise_a, alpha_a), lt_a, grouped_a = f64
            worst, err64, kappa = solve_vs_f64(
                tri_system64(gram_a, lam_a, lt_a, alpha_a, grouped_a), rhs_a.t(),
                noise_a.t(), [got[0].t(), want[0].t()])
            tol = SOLVE_BOUND
            info.update(err_over_bound=worst[0], plain_err_over_bound=worst[1],
                        err_vs_f64=err64[0], plain_err_vs_f64=err64[1],
                        max_kappa_f=kappa)
        r = {"max_abs_err": err, "ms": median_ms(fn), "plain_ms": median_ms(plain_fn)}
        if library_fn is not None:
            r["library_ms"] = median_ms(library_fn)
        emit({"phase": "kernel", "kernel": name, "inputs": inputs,
              "orientation": orientation, "shape": list(shape), "k": k,
              "tolerance": tol, **info, **r,
              **(bound(*work) if work != (0, 0) else {}), **tag})
        if f64 is not None:
            assert worst[0] <= 1.0, (name, inputs, orientation, worst, err64)
        s = split[name]
        s["max_abs_err"] = max(s["max_abs_err"], err)
        where = f"k{k}" if inputs == "random codes" else inputs
        for key in ("ms", "plain_ms", "library_ms"):
            if key in r:
                s[f"{key}_{where}_{orientation}"] = r[key]
        if work != (0, 0):
            s[f"bound_ms_{where}_{orientation}"] = bound(*work)["bound_ms"]
        # the headline: random codes, K=64 (the grouped solve: K=32), both
        # orientations per iteration
        if headline is None:
            headline = k == 64 and inputs == "random codes"
        if headline:
            for key, v in (("ms", r["ms"]), ("plain_ms", r["plain_ms"]),
                           ("library_ms", r.get("library_ms")),
                           ("nbytes", work[0]), ("flops", work[1])):
                if v is not None:
                    s[key] = s.get(key, 0.0) + v

    def linalg_chain(gram, lam, rhs, noise, alpha, lam_tri_t=None, grouped=False):
        """The packed-triangle solve (#5/#6/#7) as a torch.linalg chain, its
        library yardstick: unpack the Gram and add the prior
        (ops.pallas_solve.tri_combine), Cholesky, two triangular solves and
        the draw."""
        chol = torch.linalg.cholesky(ps.tri_combine(gram, lam, alpha, lam_tri_t,
                                                    grouped))
        y = torch.linalg.solve_triangular(chol, rhs.t()[..., None], upper=False)
        return torch.linalg.solve_triangular(chol.mT, y + noise.t()[..., None],
                                             upper=True)[..., 0].t()

    def chain_kernels(sampler, inputs):
        """Each split kernel of a chain's routes on its own code array and
        last state (a fresh noise draw) against its plain version."""
        codes, alpha_c = sampler._codes, sampler.cfg.alpha
        cs_c, cb_c = sampler._d8_cs, sampler._d8_cb
        for side, orientation, state, frozen in (
                (sampler.movies, "cols", sampler.state_m, sampler.state_u),
                (sampler.users, "rows", sampler.state_u, sampler.state_m)):
            if side.impl != "dense8" or side.route in d8.FUSED_ROUTES:
                continue
            v_t = frozen.items.t()
            k = v_t.shape[0]
            p_t = d8.packed_tri_t(v_t) if side.route == "hoisted" else None
            fn = d8.dense8_gram_rhs_rows if orientation == "rows" else d8.dense8_gram_rhs_cols
            deg = side.max_degree   # as the chain passes it
            got = fn(codes, p_t, v_t, cs_c, cb_c, max_degree=deg)
            x = codes if orientation == "rows" else codes.t()
            info = {"side": side.name, "items": x.shape[0],
                    "most_rated": int((x != 0).sum(1).max())}
            info["segments"] = (
                d8.sweep_plan(x.shape[0], x.shape[1], k, deg, d8._sm_count(codes.device))
                if p_t is None else
                d8.hoisted_plan(x.shape[0], x.shape[1], p_t.shape[0], k, deg,
                                d8._sm_count(codes.device))).segments
            nnz = int((codes != 0).sum())
            g_bytes = codes.numel() * codes.element_size() + 4 * (
                v_t.numel() + got[0].numel() + got[1].numel()
                + (0 if p_t is None else p_t.numel()))
            g_flops = (gram_flops if p_t is None else hoisted_gram_flops)(k, nnz)
            record("gram_" + side.route, k, orientation, got,
                   d8.dense8_gram_rhs_ref(codes, p_t, v_t, cs_c, cb_c, orientation),
                   lambda: fn(codes, p_t, v_t, cs_c, cb_c, max_degree=deg),
                   lambda: d8.dense8_gram_rhs_ref(codes, p_t, v_t, cs_c, cb_c,
                                                  orientation),
                   inputs=inputs, shape=codes.shape, work=(g_bytes, g_flops),
                   library_fn=lambda: gram_library(codes, p_t, v_t, cs_c, cb_c,
                                                   orientation),
                   **info)
            aux = sampler._aux[side.name]
            lt, hp, gr = aux.prior_tri_t, state.hp, sampler.grouped
            rhs = _combine_prior_rhs(got[1], hp, lt, aux.prior_rhs_t, gr)
            noise = torch.randn((k, x.shape[0]), device="cuda")
            args = (got[0], hp.lambda_f, rhs, noise, alpha_c)
            b, tvk = x.shape[0], k * (k + 1) // 2
            s_bytes = 4 * (tvk * b + (k * k if lt is None else tvk * b) + 3 * k * b)
            record(("solve_peritem" if lt is not None else "solve_shared")
                   + ("_grouped" if gr else ""), k, orientation,
                   [ps.tri_combine_solve_sample(*args, lam_tri_t=lt, grouped=gr)],
                   [ps.tri_combine_solve_sample_ref(*args, lt, gr)],
                   lambda: ps.tri_combine_solve_sample(*args, lam_tri_t=lt,
                                                       grouped=gr),
                   lambda: ps.tri_combine_solve_sample_ref(*args, lt, gr),
                   inputs=inputs, shape=codes.shape, f64=(args, lt, gr),
                   work=(s_bytes, solve_flops(k, b) + 2 * tvk * b), **info)

    def chain_sweep(sampler, inputs, operands, bf16=False):
        """The megakernels once more on a chain's own code array, scales and
        last state (a fresh noise draw), for each (orientation, operand) of
        ``operands`` (inkernel: #1; tight: #2): a second launch equal to
        the first bit for bit; each item's draw against the float64 draw of
        its system within SOLVE_BOUND (the most-rated items' systems are
        too ill-conditioned for two f32 orders to agree at KERNEL_TOL), the
        plain version's ratio beside it; max_abs_err against the plain
        version.  One JSON line each, and its times and bound under
        ``<key>_<where>_<orientation>`` of its kernels-line row (``where``:
        ``inputs``, underscored).  With ``bf16``, on the frozen side
        rounded to bf16: the tensor-core megakernel (``walk_work`` the
        code array's size, where its cost model wins), its rows under
        ``mega_chain``.  Returns each orientation's
        launch as ``call(codes)``."""
        codes, scs, scb = sampler._codes, sampler._d8_cs, sampler._d8_cb
        alpha_c, where = sampler.cfg.alpha, inputs.replace(" ", "_")
        sides = {"rows": (sampler.users, sampler.state_u, sampler.state_m),
                 "cols": (sampler.movies, sampler.state_m, sampler.state_u)}
        calls = {}
        for orientation, name in operands:
            side, state, frozen = sides[orientation]
            hp, v_t = state.hp, frozen.items.t()
            if bf16:
                v_t = v_t.to(torch.bfloat16)
            k, items = v_t.shape[0], state.items.shape[0]
            noise_t = torch.randn((k, items), device="cuda")
            prior_rhs = (hp.lambda_f @ hp.mu)[:, None]
            p_t = d8.packed_tri_t(v_t) if name == "tight" else None
            args = (v_t, hp.lambda_f, prior_rhs, noise_t, scs, scb, alpha_c,
                    orientation)

            def call(c=codes, p_t=p_t, args=args, deg=side.max_degree):
                return dense8_sweep_solve(c, p_t, *args, layout="tight",
                                          max_degree=deg,
                                          walk_work=c.numel() if bf16 else None)

            def plain(p_t=p_t, args=args):
                return dense8_sweep_solve_ref(codes, p_t, *args, layout="tight")
            mma = d8.sweep_mma_key(k, name)
            before = d8.sweep_instance_launches.get(mma, 0)
            got = call()
            torch.cuda.synchronize()
            # at bf16 the launch was the tensor-core kernel's
            assert not bf16 or d8.sweep_instance_launches.get(mma, 0) == before + 1
            assert torch.equal(got, call())
            want = plain()
            worst, err64, kappa = solve_vs_f64(
                d8_system64(codes, v_t, hp.lambda_f, alpha_c, orientation),
                d8_rhs64(codes, v_t, prior_rhs, scs, scb, orientation, False),
                noise_t.t(), [got.t(), want.t()])
            r = {"max_abs_err": float((got - want).abs().max()),
                 "ms": median_ms(call, 10, 2), "plain_ms": median_ms(plain, 3, 1)}
            del got, want
            nbytes, flops = sweep_work((codes, v_t, None, None, noise_t), p_t, "tight")
            extra = {"segments": d8.sweep_plan(items, v_t.shape[1], k, side.max_degree,
                                               d8._sm_count(codes.device)).segments}
            if bf16:   # the tensor-core kernel: its work by type, its floor
                wk = bf16_gram_work(k, int((codes != 0).sum()), v_t.shape[1], True)
                wk["flops"] += solve_flops(k, items) + k * (k + 1) * items
                work = bound(nbytes, **wk)
                extra = {"operands": "bfloat16", "instance": d8.sweep_mma_key(k, name),
                         "segments": d8.sweep_mma_plan(
                             items, v_t.shape[1], k, None, d8._sm_count(codes.device),
                             code_bytes=codes.element_size()).segments,
                         "dense_floor_ms": 1e3 * 2 * items * v_t.shape[1]
                         * (k * (k + 1) // 2 + 2 * k) / BF16_MMA_FLOPS_PER_S}
            else:
                work = bound(nbytes, flops)
            emit({"phase": "kernel", "kernel": "dense8_sweep_solve",
                  "operand": name, "inputs": inputs, "orientation": orientation,
                  "side": side.name, "max_degree": side.max_degree, **extra,
                  "shape": list(codes.shape), "k": k, "tolerance": SOLVE_BOUND,
                  "err_over_bound": worst[0], "plain_err_over_bound": worst[1],
                  "err_vs_f64": err64[0], "plain_err_vs_f64": err64[1],
                  "max_kappa_f": kappa, **r, **work, **tag})
            assert worst[0] <= 1.0, (inputs, side.name, worst, err64)
            res = mega_chain.setdefault(name, {"max_abs_err": 0.0}) if bf16 else result[name]
            res["max_abs_err"] = max(res["max_abs_err"], r["max_abs_err"])
            for key in ("ms", "plain_ms", "bound_ms", "dense_floor_ms"):
                if key in {**r, **work, **extra}:
                    res[f"{key}_{where}_{orientation}"] = {**r, **work, **extra}[key]
            calls[orientation] = call
        torch.cuda.empty_cache()
        return calls

    for k in (64, 32):
        for i, orientation in enumerate(("rows", "cols")):
            g = torch.Generator(device="cuda").manual_seed(10 * k + i)
            codes = random_codes(10 * k + i)
            items, frozen = ((N_USERS, N_MOVIES) if orientation == "rows"
                             else (N_MOVIES, N_USERS))
            v_t = 0.5 * torch.randn((k, frozen), generator=g, device="cuda")
            fn = d8.dense8_gram_rhs_rows if orientation == "rows" else d8.dense8_gram_rhs_cols
            gram3 = fn(codes, None, v_t, cs, cb)
            g_bytes = codes.numel() * codes.element_size() + 4 * (
                v_t.numel() + gram3[0].numel() + gram3[1].numel())
            nnz = int((codes != 0).sum())
            g_flops = gram_flops(k, nnz)
            record("gram_inkernel", k, orientation, gram3,
                   d8.dense8_gram_rhs_ref(codes, None, v_t, cs, cb, orientation),
                   lambda: fn(codes, None, v_t, cs, cb),
                   lambda: d8.dense8_gram_rhs_ref(codes, None, v_t, cs, cb, orientation),
                   work=(g_bytes, g_flops),
                   library_fn=lambda: gram_library(codes, None, v_t, cs, cb, orientation))
            p_t = d8.packed_tri_t(v_t)
            gram4 = fn(codes, p_t, v_t, cs, cb)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(gram4, fn(codes, p_t, v_t, cs, cb)))
            record("gram_hoisted", k, orientation, gram4,
                   d8.dense8_gram_rhs_ref(codes, p_t, v_t, cs, cb, orientation),
                   lambda: fn(codes, p_t, v_t, cs, cb),
                   lambda: d8.dense8_gram_rhs_ref(codes, p_t, v_t, cs, cb, orientation),
                   work=(g_bytes + 4 * p_t.numel(), hoisted_gram_flops(k, nnz)),
                   library_fn=lambda: gram_library(codes, p_t, v_t, cs, cb, orientation),
                   segments=d8.hoisted_plan(items, frozen, p_t.shape[0], k, None,
                                            d8._sm_count(codes.device)).segments,
                   bitwise_repeated=True)
            gram = gram3[0]
            w = torch.randn((k, k), generator=g, device="cuda")
            lam = w @ w.T / k + torch.eye(k, device="cuda")
            wb = torch.randn((items, k, k), generator=g, device="cuda")
            ii, jj = (torch.as_tensor(a, dtype=torch.long, device="cuda")
                      for a in ps.tri_index_pairs(k))
            lam_tri = (wb @ wb.mT / k + torch.eye(k, device="cuda"))[:, ii, jj].t()
            rhs = gram3[1] + torch.randn((k, items), generator=g, device="cuda")
            noise = torch.randn((k, items), generator=g, device="cuda")
            tvk = k * (k + 1) // 2
            for name, lt in (("solve_shared", None), ("solve_peritem", lam_tri)):
                prior_bytes = k * k if lt is None else tvk * items
                record(name, k, orientation,
                       [ps.tri_combine_solve_sample(gram, lam, rhs, noise, alpha, lam_tri_t=lt)],
                       [ps.tri_combine_solve_sample_ref(gram, lam, rhs, noise, alpha, lt)],
                       lambda: ps.tri_combine_solve_sample(gram, lam, rhs, noise, alpha,
                                                           lam_tri_t=lt),
                       lambda: ps.tri_combine_solve_sample_ref(gram, lam, rhs, noise,
                                                               alpha, lt),
                       library_fn=lambda: linalg_chain(gram, lam, rhs, noise, alpha, lt),
                       work=(4 * (tvk * items + prior_bytes + 3 * k * items),
                             solve_flops(k, items) + 2 * tvk * items),
                       items=items)
    del codes, wb, lam_tri

    # #3 and #4 on skewed codes, the frozen axis split over S segments by
    # the most-rated item's degree (every frozen entry), at every instance
    # class (#3: 16/32/48/64 register rows, 79 tiles; #4: 2, 5, 10, 17, 26
    # float4 sums a lane): against plain at KERNEL_TOL, three launches
    # bitwise equal
    for k in (16, 32, 48, 64, 79):
        for int16 in (False, True):
            for i, orientation in enumerate(("rows", "cols")):
                codes = skewed_codes(900 + k + 2 * i + int16, orientation, int16)
                items, frozen = ((N_USERS, N_MOVIES) if orientation == "rows"
                                 else (N_MOVIES, N_USERS))
                g = torch.Generator(device="cuda").manual_seed(950 + k + i)
                v_t = 0.2 * torch.randn((k, frozen), generator=g, device="cuda")
                fn = (d8.dense8_gram_rhs_rows if orientation == "rows"
                      else d8.dense8_gram_rhs_cols)
                cs_g = 2 * CS16 if int16 else cs
                for name, p_t in (("gram_inkernel", None),
                                  ("gram_hoisted", d8.packed_tri_t(v_t))):
                    got = [fn(codes, p_t, v_t, cs_g, cb, max_degree=frozen)
                           for _ in range(3)]
                    torch.cuda.synchronize()
                    assert all(torch.equal(a, b) for again in got[1:]
                               for a, b in zip(got[0], again))
                    want = d8.dense8_gram_rhs_ref(codes, p_t, v_t, cs_g, cb,
                                                  orientation)
                    for a, b in zip(got[0], want):
                        torch.testing.assert_close(a, b, **KERNEL_TOL)
                    err = max(float((a - b).abs().max())
                              for a, b in zip(got[0], want))
                    split[name]["max_abs_err"] = max(split[name]["max_abs_err"], err)
                    plan = (d8.sweep_plan(items, frozen, k, frozen, d8._sm_count(codes.device))
                            if p_t is None else
                            d8.hoisted_plan(items, frozen, p_t.shape[0], k, frozen,
                                            d8._sm_count(codes.device)))
                    assert plan.segments > 1, plan
                    emit({"phase": "kernel", "kernel": name,
                          "inputs": "skewed codes", "orientation": orientation,
                          "codes": str(codes.dtype), "k": k,
                          "segments": plan.segments,
                          "tolerance": KERNEL_TOL, "max_abs_err": err,
                          "bitwise_repeated": True,
                          "ms": median_ms(lambda: fn(codes, p_t, v_t, cs_g, cb,
                                                     max_degree=frozen), 5, 1),
                          **tag})
    del codes, got, want
    # #5/#6/#7 at every instance (K 8, 31 on capacity 32, 32, 33 on
    # capacity 48, 64; 79 on the panels; the per-item prior to its gate
    # 74), grouped at
    # K % 8 == 0, on the Gram kernel's item-major layout and fused dense's
    # batch-last one: against plain at KERNEL_TOL, two launches bitwise equal
    solve_cases = ([(k, False, False) for k in (8, 31, 32, 33, 64, 79)]
                   + [(k, True, False) for k in (8, 31, 32, 33, 64, 74)]
                   + [(k, p, True) for k in (8, 32, 64) for p in (False, True)])
    for k, peritem, grouped in solve_cases:
        g = torch.Generator(device="cuda").manual_seed(960 + k)
        b = N_USERS
        x = torch.randn((b, 30, k), generator=g, device="cuda") / 30 ** 0.5
        ii, jj = (torch.as_tensor(a[:k * (k + 1) // 2], dtype=torch.long, device="cuda")
                  for a in ps.tri_tight_pairs(k)[:2])
        gram = torch.full((ps.tight_rows(k), b), float("nan"), device="cuda")
        gram[:len(ii)] = (x.mT @ x)[:, ii, jj].t()       # NaN padding rows
        w = torch.randn((k, k), generator=g, device="cuda")
        lam = w @ w.T / k + torch.eye(k, device="cuda")
        lt = None
        if peritem:
            wb = torch.randn((b, k, k), generator=g, device="cuda")
            ai, aj = (torch.as_tensor(a, dtype=torch.long, device="cuda")
                      for a in ps.tri_index_pairs(k, grouped=grouped))
            lt = (wb @ wb.mT / k + torch.eye(k, device="cuda"))[:, ai, aj].t()
        rhs, noise = torch.randn((2, k, b), generator=g, device="cuda")
        name = ("solve_peritem" if peritem else "solve_shared") + (
            "_grouped" if grouped else "")
        for layout, gm in (("item-major", gram.t().contiguous().t()),
                           ("batch-last", gram)):
            def call():
                return ps.tri_combine_solve_sample(gm, lam, rhs, noise, alpha,
                                                   lam_tri_t=lt, grouped=grouped)
            got = call()
            torch.cuda.synchronize()
            assert torch.equal(got, call())
            want = ps.tri_combine_solve_sample_ref(gm, lam, rhs, noise, alpha, lt,
                                                   grouped)
            torch.testing.assert_close(got, want, **KERNEL_TOL)
            err = float((got - want).abs().max())
            split[name]["max_abs_err"] = max(split[name]["max_abs_err"], err)
            emit({"phase": "kernel", "kernel": name, "inputs": "random systems",
                  "gram_layout": layout, "batch": b, "k": k,
                  "tolerance": KERNEL_TOL, "max_abs_err": err,
                  "bitwise_repeated": True, "ms": median_ms(call, 5, 1), **tag})
    del x, gram, got, want

    # 6. the split route at K=32, anchored to the JAX package's rmse_avg
    for pt, gram_key in (("auto", "gram_inkernel"), ("hoisted", "gram_hoisted")):
        with env(BPMF_D8_SOLVE="split", BPMF_D8_PT=pt):
            sampler, mets, chunk_s, setup_s, n = drive(ml1m(K), counts, chunks, iters)
        want_route = "inkernel" if pt == "auto" else "hoisted"
        assert sampler.users.route == sampler.movies.route == want_route
        assert n == launches(**{gram_key: 2 * done, "solve_shared": 2 * done}), n
        rmse_avg = float(mets[-1].rmse_avg[-1])
        assert abs(rmse_avg - RMSE_AVG_JAX) <= RMSE_BAND, (
            f"split {pt}: rmse_avg {rmse_avg} outside {RMSE_AVG_JAX} +- {RMSE_BAND}")
        for key in (gram_key, "solve_shared"):
            total[key] += n[key]
        emit({"phase": "split", "dataset": "ml-1m synth", "k": K,
              "route": want_route, "iterations": done, "launches": n,
              "rmse_avg": rmse_avg, "rmse": float(mets[-1].rmse[-1]),
              "rmse_avg_jax": RMSE_AVG_JAX,
              **per_iter_stats(sampler, chunk_s, iters), "setup_s": setup_s, **tag})
        del sampler

    # 7. K=64 main path: the split route, in-kernel Gram on both sides
    sampler, mets, chunk_s, setup_s, n = drive(ml1m(64), counts, chunks, iters)
    assert sampler.users.route == sampler.movies.route == "inkernel"
    assert n == launches(gram_inkernel=2 * done, solve_shared=2 * done), n
    assert_finite(mets)
    err = check_first_iterations(ml1m(64), mets[0], counts)
    for key in ("gram_inkernel", "solve_shared"):
        total[key] += n[key]
    emit({"phase": "k64", "dataset": "ml-1m synth", "k": 64,
          "route": sampler.users.route, "iterations": done, "launches": n,
          "rmse_avg": float(mets[-1].rmse_avg[-1]),
          "rmse": float(mets[-1].rmse[-1]),
          "first_3_vs_plain_max_abs_err": err, "tolerance": CHAIN_TOL,
          **per_iter_stats(sampler, chunk_s, iters), "setup_s": setup_s, **tag})
    chain_kernels(sampler, "k64_chain")
    del sampler

    # 8. propagated posterior on the users, K=32
    prop_iters = 200
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        prop = write_prop(tmp, K, train.shape[0], seed=7)
        for strict in (True, False):
            make = lambda: BPMF(Config(num_latent=K, burnin=2, nsims=prop_iters,
                                       prop_u=prop, strict_reference=strict),
                                train, test, out=devnull, device="cuda")
            sampler, mets, chunk_s, setup_s, n = drive(make, counts, 1, prop_iters)
            assert (sampler.users.route, sampler.movies.route) == ("inkernel", "fused")
            assert n == launches(fused_inkernel=prop_iters, gram_inkernel=prop_iters,
                                 solve_peritem=prop_iters), n
            assert_finite(mets)
            err = check_first_iterations(make, mets[0], counts)
            for key in ("fused_inkernel", "gram_inkernel", "solve_peritem"):
                total[key] += n[key]
            emit({"phase": "prop", "dataset": "ml-1m synth", "k": K,
                  "prop": "users", "strict_reference": strict,
                  "iterations": prop_iters, "launches": n,
                  "rmse_avg": float(mets[-1].rmse_avg[-1]),
                  "rmse": float(mets[-1].rmse[-1]),
                  "first_3_vs_plain_max_abs_err": err, "tolerance": CHAIN_TOL,
                  "ms_per_iter": chunk_s[0] / prop_iters * 1e3,
                  "setup_s": setup_s, **tag})
            chain_kernels(sampler, "prop_chain" if strict else "prop_static_chain")
            del sampler

    # 9. chembl synth at K=64: compounds on the hoisted Gram
    ctrain, ctest = synth_chembl()
    c_iters, c_chunks = 50, 2

    def chembl():
        return BPMF(Config(num_latent=64, burnin=2, nsims=c_iters * c_chunks),
                    ctrain, ctest, out=devnull, device="cuda")

    sampler, mets, chunk_s, setup_s, n = drive(chembl, counts, c_chunks, c_iters)
    c_done = c_iters * c_chunks
    assert (sampler.users.route, sampler.movies.route) == ("hoisted", "inkernel")
    assert n == launches(gram_inkernel=c_done, gram_hoisted=c_done,
                         solve_shared=2 * c_done), n
    assert_finite(mets)
    err = check_first_iterations(chembl, mets[0], counts)
    for key in ("gram_inkernel", "gram_hoisted", "solve_shared"):
        total[key] += n[key]
    emit({"phase": "chembl", "dataset": "chembl synth", "k": 64,
          "routes": {"compounds": sampler.users.route,
                     "proteins": sampler.movies.route},
          "iterations": c_done, "launches": n,
          "rmse_avg": float(mets[-1].rmse_avg[-1]),
          "rmse": float(mets[-1].rmse[-1]),
          "first_3_vs_plain_max_abs_err": err, "tolerance": CHAIN_TOL,
          **per_iter_stats(sampler, chunk_s, c_iters), "setup_s": setup_s, **tag})
    chain_kernels(sampler, "chembl_chain")
    chembl_rmse = float(mets[-1].rmse_avg[-1])   # phase 26's bf16 chain's anchor
    del sampler
    # the same chain with BPMF_D8_PT=hoisted: the proteins on #4 too (the
    # most-rated protein's 61,253 ratings over the hoisted plan's segments)
    h_iters = 10
    with env(BPMF_D8_PT="hoisted"):
        sampler, mets, chunk_s, setup_s, n = drive(chembl, counts, 2, h_iters)
    assert (sampler.users.route, sampler.movies.route) == ("hoisted", "hoisted")
    assert n == launches(gram_hoisted=4 * h_iters, solve_shared=4 * h_iters), n
    assert_finite(mets)
    with env(BPMF_D8_PT="hoisted"):
        err = check_first_iterations(chembl, mets[0], counts)
    for key in ("gram_hoisted", "solve_shared"):
        total[key] += n[key]
    emit({"phase": "chembl", "dataset": "chembl synth", "k": 64,
          "knob": {"BPMF_D8_PT": "hoisted"},
          "routes": {"compounds": sampler.users.route,
                     "proteins": sampler.movies.route},
          "iterations": 2 * h_iters, "launches": n,
          "rmse_avg": float(mets[-1].rmse_avg[-1]),
          "rmse": float(mets[-1].rmse[-1]),
          "first_3_vs_plain_max_abs_err": err, "tolerance": CHAIN_TOL,
          **per_iter_stats(sampler, chunk_s, h_iters), "setup_s": setup_s, **tag})
    chain_kernels(sampler, "chembl_hoisted_chain")
    del sampler
    # the bench's chembl leg in this process: K=32, 4 chunks of 100 on the
    # default route (both sides #1), then #1 on the chain's own codes and
    # last state
    def chembl32():
        return BPMF(Config(num_latent=K, burnin=2, nsims=5 * 100), ctrain, ctest,
                    out=devnull, device="cuda")

    torch.cuda.reset_peak_memory_stats()
    sampler, mets, chunk_s, setup_s, n = drive(chembl32, counts, 4, 100)
    assert sampler.users.route == sampler.movies.route == "fused"
    assert n == launches(fused_inkernel=2 * 400), n
    total["fused_inkernel"] += n["fused_inkernel"]
    chain_rmse["chembl"] = float(mets[-1].rmse_avg[-1])
    emit({"phase": "chembl", "dataset": "chembl synth", "k": K,
          "routes": {"compounds": sampler.users.route,
                     "proteins": sampler.movies.route},
          "iterations": 400, "launches": n, "rmse_avg": chain_rmse["chembl"],
          "rmse": float(mets[-1].rmse[-1]),
          "rmse_avg_jax": BENCH_ANCHORS["chembl"], "band": RMSE_BAND,
          **per_iter_stats(sampler, chunk_s, 100), "setup_s": setup_s,
          "peak_mem_bytes": torch.cuda.max_memory_allocated(), **tag})
    assert abs(chain_rmse["chembl"] - BENCH_ANCHORS["chembl"]) <= RMSE_BAND
    chain_sweep(sampler, "chembl K32 chain", (("rows", "inkernel"),
                                              ("cols", "inkernel")))
    # the sparse end of the densities (0.63%): #1 on bf16 operands, the
    # tensor-core kernel, on the same state
    chain_sweep(sampler, "chembl K32 chain bf16", (("rows", "inkernel"),
                                                   ("cols", "inkernel")), bf16=True)
    del sampler

    # 10. kernel8: the batched solve (#8) against plain and torch.linalg
    blast = ps.chol_solve_sample_pallas_blast
    blast_ref = ps.chol_solve_sample_pallas_blast_ref
    # the kernels line's #8: its times at every shape held here, and as
    # headline one iteration of the bucketed ml-1m chain (both sides)
    main8 = dict.fromkeys(("ms", "plain_ms", "library_ms", "nbytes", "flops",
                           "max_abs_err"), 0.0)

    def blast_record(prec, rhs, noise, inputs, **info):
        """#8 on one batch against the float64 draw within SOLVE_BOUND (its
        plain version's ratio beside it), with the kernel's, the plain
        version's and the torch.linalg chain's times and the bound."""
        b, k = rhs.shape
        got = blast(prec, rhs, noise)
        torch.cuda.synchronize()
        want = blast_ref(prec, rhs, noise)
        worst, err64, kappa = solve_vs_f64(full_system64(prec), rhs, noise,
                                           [got, want])
        r = {"max_abs_err": float((got - want).abs().max()),
             "ms": median_ms(lambda: blast(prec, rhs, noise)),
             "plain_ms": median_ms(lambda: blast_ref(prec, rhs, noise)),
             "library_ms": median_ms(lambda: linalg_solve(prec, rhs, noise)),
             "nbytes": 4 * (b * k * (k + 1) // 2 + 3 * b * k),
             "flops": b * (k ** 3 / 3 + 2 * k * k)}
        emit({"phase": "kernel", "kernel": "chol_solve_sample", "inputs": inputs,
              "batch": b, "k": k, "tolerance": SOLVE_BOUND,
              "err_over_bound": worst[0], "plain_err_over_bound": worst[1],
              "err_vs_f64": err64[0], "plain_err_vs_f64": err64[1],
              "max_kappa_f": kappa, **info, **r,
              **bound(r["nbytes"], r["flops"]), **tag})
        assert worst[0] <= 1.0, (inputs, k, worst, err64)
        main8["max_abs_err"] = max(main8["max_abs_err"], r["max_abs_err"])
        where = inputs.replace(" ", "_") + "_" + info.get("side", f"k{k}")
        for key in ("ms", "plain_ms", "library_ms"):
            main8[f"{key}_{where}"] = r[key]
        return r

    def chain_records(sampler, inputs):
        """#8 on each side's own systems of a chain (chain_systems)."""
        out = []
        for side, (prec, rhs, noise) in zip((sampler.movies, sampler.users),
                                            chain_systems(sampler)):
            out.append(blast_record(prec, rhs, noise, inputs, side=side.name,
                                    most_rated=int(side.degrees.max())))
        return out

    # every instance class of #8 and its edges: the register solve at
    # capacity 8, 16, 24, 32, 48, 64, the panels at 3 and 4 rows a lane
    for k in (1, 8, 16, 24, 32, 33, 48, 63, 64, 65, 79, 80, 96, 97, 106):
        g = torch.Generator(device="cuda").manual_seed(800 + k)
        w = torch.randn((6144, k, k), generator=g, device="cuda")
        prec = w @ w.mT / k + torch.eye(k, device="cuda")
        rhs, noise = torch.randn((2, 6144, k), generator=g, device="cuda")
        blast_record(prec, rhs, noise, "random SPD", instance=ps.blast_instance(k))
    # an indefinite system draws NaN, as the plain version does, and leaves
    # its neighbours bit for bit as they are; B = 1001 leaves the last block
    # ragged
    for k in (32, 96):
        g = torch.Generator(device="cuda").manual_seed(870 + k)
        w = torch.randn((1001, k, k), generator=g, device="cuda")
        prec = w @ w.mT / k + torch.eye(k, device="cuda")
        rhs, noise = torch.randn((2, 1001, k), generator=g, device="cuda")
        bad = prec.clone()
        bad[500] = -bad[500]
        got, good = blast(bad, rhs, noise), blast(prec, rhs, noise)
        want = blast_ref(bad, rhs, noise)
        keep = torch.arange(1001, device="cuda") != 500
        assert torch.isnan(got[500]).all() and torch.isnan(want[500]).all()
        assert torch.equal(got[keep], good[keep])
        assert torch.isfinite(good).all()
        emit({"phase": "kernel", "kernel": "chol_solve_sample",
              "inputs": "random SPD, item 500 negative definite", "batch": 1001,
              "k": k, "nan_where_plain_nan": True, "others_bitwise_equal": True,
              **tag})
    del w, prec, bad

    # 11. the bucketed route on ml-1m synth, anchored to the JAX rmse_avg
    sampler, mets, chunk_s, setup_s, n = drive(ml1m(K, gram_impl="bucketed"),
                                               counts, chunks, iters)
    assert sampler.movies.impl == sampler.users.impl == "bucketed"
    assert n == launches(blast=2 * done), n
    rmse_avg = float(mets[-1].rmse_avg[-1])
    assert abs(rmse_avg - RMSE_AVG_JAX) <= RMSE_BAND, (
        f"bucketed: rmse_avg {rmse_avg} outside {RMSE_AVG_JAX} +- {RMSE_BAND}")
    total["blast"] = n["blast"]
    emit({"phase": "bucketed", "dataset": "ml-1m synth", "k": K,
          "iterations": done, "launches": n, "rmse_avg": rmse_avg,
          "rmse": float(mets[-1].rmse[-1]), "rmse_avg_jax": RMSE_AVG_JAX,
          "buckets": {s.name: [list(b.nbr.shape) for b in sampler._aux[s.name].buckets]
                      for s in (sampler.movies, sampler.users)},
          "splits": {s.name: sampler._aux[s.name].splits
                     for s in (sampler.movies, sampler.users)},
          **per_iter_stats(sampler, chunk_s, iters), "setup_s": setup_s, **tag})
    # #8 again on the chain's own systems, both sides (the movies' split
    # buckets among them): the kernels line's headline
    for r in chain_records(sampler, "bucketed chain"):
        for key in ("ms", "plain_ms", "library_ms", "nbytes", "flops"):
            main8[key] += r[key]
    del sampler

    # 12. the bench's ml-25M half scale on its default route (#1) and on the
    # bucketed route
    t0 = time.perf_counter()
    btrain, btest = synth_movielens(n_users=81_270, n_movies=29_523,
                                    n_ratings=6_250_000, seed=25)
    gen_s = time.perf_counter() - t0
    b_iters, b_chunks = 20, 3

    def ml25m(**kw):
        return lambda: BPMF(Config(num_latent=K, burnin=2, nsims=4 * b_iters, **kw),
                            btrain, btest, out=devnull, device="cuda")

    # the bench's leg in this process: the default route (dense8, both sides
    # #1; 81,270 padded users are far under pt_mode's crossover), then #1 on
    # the chain's own codes and last state
    torch.cuda.reset_peak_memory_stats()
    sampler, mets, chunk_s, setup_s, n = drive(ml25m(), counts, b_chunks, b_iters)
    assert sampler.users.route == sampler.movies.route == "fused"
    assert n == launches(fused_inkernel=2 * b_chunks * b_iters), n
    total["fused_inkernel"] += n["fused_inkernel"]
    chain_rmse["ml25m_half"] = float(mets[-1].rmse_avg[-1])
    emit({"phase": "ml25m", "dataset": "ml-25M synth, half scale", "k": K,
          "routes": {"users": sampler.users.route, "movies": sampler.movies.route},
          "iterations": b_chunks * b_iters, "launches": n,
          "rmse_avg": chain_rmse["ml25m_half"], "rmse": float(mets[-1].rmse[-1]),
          "rmse_avg_jax": RMSE_AVG_ML25M_HALF, "band": RMSE_BAND,
          "datagen_s": gen_s, "setup_s": setup_s,
          **per_iter_stats(sampler, chunk_s, b_iters),
          "peak_mem_bytes": torch.cuda.max_memory_allocated(), **tag})
    assert abs(chain_rmse["ml25m_half"] - RMSE_AVG_ML25M_HALF) <= RMSE_BAND
    chain_sweep(sampler, "ml25m half chain", (("rows", "inkernel"),
                                              ("cols", "inkernel")))
    # the sparsest (0.23%): the same at bf16 on the tensor-core kernel
    chain_sweep(sampler, "ml25m half chain bf16", (("rows", "inkernel"),
                                                   ("cols", "inkernel")), bf16=True)
    del sampler
    torch.cuda.reset_peak_memory_stats()
    sampler, mets, chunk_s, setup_s, n = drive(ml25m(gram_impl="bucketed"),
                                               counts, b_chunks, b_iters)
    assert sampler.movies.impl == sampler.users.impl == "bucketed"
    assert n == launches(blast=2 * b_chunks * b_iters), n
    total["blast"] += n["blast"]
    rmse_avg = float(mets[-1].rmse_avg[-1])
    emit({"phase": "ml25m", "dataset": "ml-25M synth, half scale", "k": K,
          "iterations": b_chunks * b_iters, "launches": n, "rmse_avg": rmse_avg,
          "rmse": float(mets[-1].rmse[-1]), "rmse_avg_jax": RMSE_AVG_ML25M_HALF,
          "datagen_s": gen_s, "setup_s": setup_s,
          "buckets": {s.name: len(sampler._aux[s.name].buckets)
                      for s in (sampler.movies, sampler.users)},
          **per_iter_stats(sampler, chunk_s, b_iters),
          "peak_mem_bytes": torch.cuda.max_memory_allocated(), **tag})
    chain_records(sampler, "ml25m chain")
    del sampler
    assert abs(rmse_avg - RMSE_AVG_ML25M_HALF) <= RMSE_BAND, (
        f"ml25m bucketed: rmse_avg {rmse_avg} outside "
        f"{RMSE_AVG_ML25M_HALF} +- {RMSE_BAND}")

    # 13. ratings off the grid: fused dense (#5) and plain dense (#8)
    rng = np.random.default_rng(2024)
    otrain, otest = train.copy(), test.copy()
    otrain.data = otrain.data + rng.uniform(-0.25, 0.25, otrain.nnz)
    otest.data = otest.data + rng.uniform(-0.25, 0.25, otest.nnz)
    assert quantize_values(otrain.data) is None
    o_iters, o_chunks = 250, 2

    def offgrid(**kw):
        return lambda: BPMF(Config(num_latent=K, burnin=2,
                                   nsims=o_iters * o_chunks, **kw),
                            otrain, otest, out=devnull, device="cuda")

    o_done = o_iters * o_chunks
    o_rmse = {}
    for route, kw, key in (("fused", {}, "solve_shared"),
                           ("plain", {"fuse_dense": "off"}, "blast")):
        sampler, mets, chunk_s, setup_s, n = drive(offgrid(**kw), counts,
                                                   o_chunks, o_iters)
        assert [(x.impl, x.route) for x in (sampler.movies, sampler.users)] == [
            ("dense", route)] * 2
        assert n == launches(**{key: 2 * o_done}), n
        assert_finite(mets)
        err = check_first_iterations(offgrid(**kw), mets[0], counts)
        total[key] += n[key]
        o_rmse[route] = float(mets[-1].rmse_avg[-1])
        emit({"phase": "offgrid", "dataset": "ml-1m synth, off grid", "k": K,
              "route": route, "iterations": o_done, "launches": n,
              "rmse_avg": o_rmse[route], "rmse": float(mets[-1].rmse[-1]),
              "first_3_vs_plain_max_abs_err": err, "tolerance": CHAIN_TOL,
              **per_iter_stats(sampler, chunk_s, o_iters), "setup_s": setup_s,
              **tag})
        if route == "plain":
            chain_records(sampler, "offgrid chain")
        del sampler
    assert abs(o_rmse["fused"] - o_rmse["plain"]) <= OFFGRID_BAND, o_rmse

    # 14. K=96, past the dense8 gate: plain dense with #8
    sampler, mets, chunk_s, setup_s, n = drive(ml1m(96), counts, 2, 100)
    assert [(x.impl, x.route) for x in (sampler.movies, sampler.users)] == [
        ("dense", "plain")] * 2
    assert n == launches(blast=400), n
    assert_finite(mets)
    err = check_first_iterations(ml1m(96), mets[0], counts)
    total["blast"] += n["blast"]
    emit({"phase": "k96", "dataset": "ml-1m synth", "k": 96, "iterations": 200,
          "launches": n, "rmse_avg": float(mets[-1].rmse_avg[-1]),
          "rmse": float(mets[-1].rmse[-1]),
          "first_3_vs_plain_max_abs_err": err, "tolerance": CHAIN_TOL,
          **per_iter_stats(sampler, chunk_s, 100), "setup_s": setup_s, **tag})
    chain_records(sampler, "k96 chain")
    del sampler

    # 15. the reference's tiny golden run on the card: float64, xla solver
    import scipy.sparse as sp

    def tiny(entries):
        r, c, v = zip(*entries)
        return sp.csc_matrix((v, (r, c)), shape=(4, 2))

    ttrain, ttest = tiny(TINY_TRAIN), tiny(TINY_TEST)
    counts.reset()
    finals = []
    for seed in range(5):
        s = BPMF(Config(nsims=9, burnin=0, seed=seed, permute=False), ttrain,
                 ttest, out=devnull, device="cuda")
        finals.append(s.run())
        assert s.dtype == torch.float64 and s.solver == "xla"
    assert counts.read() == launches(), counts.read()
    assert np.median(finals) < 3.0, finals
    emit({"phase": "tiny64", "final_avg_rmse": finals,
          "median": float(np.median(finals)), "dtype": "float64",
          "solver": "xla", **tag})

    # 16. the hoisted megakernel (#2) on the ml-1m chain, by its two knobs
    for knob, route, key in (({"BPMF_D8_PT": "hoisted"}, "fused_hoisted",
                              "fused_tight"),
                             ({"BPMF_D8_SOLVE": "fused_aligned"},
                              "fused_aligned", "fused_aligned")):
        with env(**knob):
            sampler, mets, chunk_s, setup_s, n = drive(ml1m(K), counts, chunks,
                                                       iters)
        assert sampler.users.route == sampler.movies.route == route
        assert n == launches(**{key: 2 * done}), n
        rmse_avg = float(mets[-1].rmse_avg[-1])
        assert abs(rmse_avg - RMSE_AVG_JAX) <= RMSE_BAND, (
            f"{route}: rmse_avg {rmse_avg} outside {RMSE_AVG_JAX} +- {RMSE_BAND}")
        total[key] += n[key]
        emit({"phase": "hoisted", "dataset": "ml-1m synth", "k": K,
              "knob": knob, "route": route, "iterations": done, "launches": n,
              "rmse_avg": rmse_avg, "rmse": float(mets[-1].rmse[-1]),
              "rmse_avg_jax": RMSE_AVG_JAX,
              **per_iter_stats(sampler, chunk_s, iters), "setup_s": setup_s,
              **tag})
        del sampler

    # 17. the tall chembl set: 800,256 padded compounds take #2 by default
    t0 = time.perf_counter()
    ttrain, ttest = synth_chembl(n_compounds=800_000, n_proteins=360,
                                 n_ratings=2_875_000, seed=77)
    tall_gen_s = time.perf_counter() - t0
    t_iters, t_chunks = 20, 2
    t_done = t_iters * t_chunks

    def tall():
        return BPMF(Config(num_latent=K, burnin=2, nsims=t_done), ttrain, ttest,
                    out=devnull, device="cuda")

    torch.cuda.reset_peak_memory_stats()
    sampler, mets, chunk_s, setup_s, n = drive(tall, counts, t_chunks, t_iters)
    routes = {"compounds": sampler.users.route, "proteins": sampler.movies.route}
    assert routes == {"compounds": "fused_hoisted", "proteins": "fused"}, routes
    assert n == launches(fused_inkernel=t_done, fused_tight=t_done), n
    assert_finite(mets)
    peak = torch.cuda.max_memory_allocated()
    err = check_first_iterations(tall, mets[0], counts)
    total["fused_inkernel"] += n["fused_inkernel"]
    total["fused_tight"] += n["fused_tight"]
    with env(BPMF_D8_PT="inkernel"):
        ref_s, rmets, rchunk_s, _, rn = drive(tall, counts, t_chunks, t_iters)
    assert rn == launches(fused_inkernel=2 * t_done), rn
    assert ref_s.users.route == ref_s.movies.route == "fused"
    del ref_s
    rmse_avg = float(mets[-1].rmse_avg[-1])
    rmse_avg_inkernel = float(rmets[-1].rmse_avg[-1])
    emit({"phase": "tall", "dataset": "chembl synth, 800000 x 360", "k": K,
          "shape": list(sampler._codes.shape), "routes": routes,
          "most_rated": {"compounds": int(sampler.users.degrees.max()),
                         "proteins": int(sampler.movies.degrees.max())},
          "iterations": t_done, "launches": n, "rmse_avg": rmse_avg,
          "rmse": float(mets[-1].rmse[-1]),
          "rmse_avg_inkernel": rmse_avg_inkernel, "band": TALL_BAND,
          "first_3_vs_plain_max_abs_err": err, "tolerance": CHAIN_TOL,
          **per_iter_stats(sampler, chunk_s, t_iters),
          "inkernel_ms_per_iter": per_iter_stats(sampler, rchunk_s,
                                                 t_iters)["ms_per_iter"],
          "datagen_s": tall_gen_s, "setup_s": setup_s, "peak_mem_bytes": peak,
          **tag})
    assert abs(rmse_avg - rmse_avg_inkernel) <= TALL_BAND, (
        rmse_avg, rmse_avg_inkernel)
    # #2 on the compounds and #1 on the proteins once more, on the chain's
    # own codes and last state; #2 again on all-zero codes (the scan and the
    # per-item solve alone)
    calls = chain_sweep(sampler, "tall chain", (("rows", "tight"),
                                                ("cols", "inkernel")))
    zeros = torch.zeros_like(sampler._codes)
    zero_ms = median_ms(lambda: calls["rows"](zeros), 10, 2)
    emit({"phase": "kernel", "kernel": "dense8_sweep_solve", "operand": "tight",
          "inputs": "tall chain, all-zero codes", "orientation": "rows",
          "ms": zero_ms, **tag})
    result["tight"]["ms_zero_codes_tall_chain_rows"] = zero_ms
    del sampler, zeros, calls, ttrain, ttest

    # 18. the grouped layout (#7): the -l chain (users split, #6 grouped)
    # and the fused dense chain off the grid (#5 grouped)
    g_iters = 200
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        prop = write_prop(tmp, K, train.shape[0], seed=7)
        grouped_chains = (
            ("prop", lambda: BPMF(Config(num_latent=K, burnin=2, nsims=g_iters,
                                         prop_u=prop), train, test, out=devnull,
                                  device="cuda"),
             launches(fused_inkernel=g_iters, gram_inkernel=g_iters,
                      solve_peritem_grouped=g_iters)),
            ("offgrid", offgrid(), launches(solve_shared_grouped=2 * g_iters)))
        for name, make, want_n in grouped_chains:
            with env(BPMF_TRI_GROUPED="1"):
                sampler, mets, chunk_s, setup_s, n = drive(make, counts, 1, g_iters)
                assert sampler.grouped
                assert n == want_n, n
                assert_finite(mets)
                err = check_first_iterations(make, mets[0], counts)
            for key in ("fused_inkernel", "gram_inkernel", "solve_peritem_grouped",
                        "solve_shared_grouped"):
                total[key] += n[key]
            emit({"phase": "grouped", "chain": name, "k": K,
                  "routes": {"movies": sampler.movies.route,
                             "users": sampler.users.route},
                  "iterations": g_iters, "launches": n,
                  "rmse_avg": float(mets[-1].rmse_avg[-1]),
                  "rmse": float(mets[-1].rmse[-1]),
                  "first_3_vs_plain_max_abs_err": err, "tolerance": CHAIN_TOL,
                  "ms_per_iter": chunk_s[0] / g_iters * 1e3,
                  "setup_s": setup_s, **tag})
            if name == "prop":
                chain_kernels(sampler, "grouped_prop_chain")
            del sampler
    # the grouped solve against plain at B = 6144, K=32: the Gram of random
    # codes (#3), a shared prior and a per-item prior packed top-aligned
    g = torch.Generator(device="cuda").manual_seed(700)
    codes = random_codes(700)
    v_t = 0.5 * torch.randn((K, N_MOVIES), generator=g, device="cuda")
    gram, rhs0 = d8.dense8_gram_rhs_rows(codes, None, v_t, cs, cb)
    w = torch.randn((K, K), generator=g, device="cuda")
    lam = w @ w.T / K + torch.eye(K, device="cuda")
    wb = torch.randn((N_USERS, K, K), generator=g, device="cuda")
    ii, jj = (torch.as_tensor(a, dtype=torch.long, device="cuda")
              for a in ps.tri_index_pairs(K, grouped=True))
    lam_tri = (wb @ wb.mT / K + torch.eye(K, device="cuda"))[:, ii, jj].t()
    rhs = rhs0 + torch.randn((K, N_USERS), generator=g, device="cuda")
    noise = torch.randn((K, N_USERS), generator=g, device="cuda")
    tvk = K * (K + 1) // 2
    for name, lt in (("solve_shared_grouped", None),
                     ("solve_peritem_grouped", lam_tri)):
        prior_bytes = K * K if lt is None else tvk * N_USERS
        record(name, K, "rows",
               [ps.tri_combine_solve_sample(gram, lam, rhs, noise, alpha,
                                            lam_tri_t=lt, grouped=True)],
               [ps.tri_combine_solve_sample_ref(gram, lam, rhs, noise, alpha,
                                                lt, True)],
               lambda: ps.tri_combine_solve_sample(gram, lam, rhs, noise, alpha,
                                                   lam_tri_t=lt, grouped=True),
               lambda: ps.tri_combine_solve_sample_ref(gram, lam, rhs, noise,
                                                       alpha, lt, True),
               library_fn=lambda: linalg_chain(gram, lam, rhs, noise, alpha, lt,
                                               True),
               work=(4 * (tvk * N_USERS + prior_bytes + 3 * K * N_USERS),
                     solve_flops(K, N_USERS) + 2 * tvk * N_USERS),
               headline=True, items=N_USERS)
    del codes, wb, lam_tri

    # 19. the gather probes (#9): the entry point at the JAX script's shapes,
    # then each kernel against its plain version there, at R = 8192, (B) at
    # NV = 81,270 and (A, C) at W = 2000
    from bpmf_tpu_torch import read_matrix
    from bpmf_tpu_torch.scripts import gather_probe as gp

    counts.reset()
    probe_run = gp.run(device="cuda", out=devnull)
    n = counts.read()
    assert n == launches(probe_A=4 * gp.N_STEPS, probe_B=4 * gp.N_STEPS,
                         probe_C=4 * gp.N_STEPS), n
    for key in ("probe_A", "probe_B", "probe_C"):
        total[key] = n[key]
    embedding_bag = torch.nn.functional.embedding_bag
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    probe_cells = {}
    for label, (pk, pnv, pr, pw, keys) in PROBE_CELLS.items():
        idx_np, table_np = gp.make_inputs(k=pk, nv=pnv, r=pr, w=pw)
        idx = torch.from_numpy(idx_np).to("cuda")
        table = torch.from_numpy(table_np).to("cuda")
        table_t = table.t().contiguous()
        library = embedding_bag(idx, table, mode="sum")
        torch.testing.assert_close(library, gp.gather_sum_ref(idx, table),
                                   **PROBE_TOL)
        yardsticks = {}
        for name, fn in (("library", lambda: embedding_bag(idx, table, mode="sum")),
                         ("probe_d", lambda: gp.gather_sum_ref(idx, table))):
            yardsticks[name + "_ms"] = median_ms(fn)
            yardsticks[name + "_per_launch_ms"] = per_launch_ms(fn)
        edges = pr * pw
        # the bytes the function must move: idx and out once, and the table
        # rows this run's indices touch, once each
        rows_touched = len(np.unique(idx_np))
        probe_bytes = 4 * (edges + rows_touched * pk + pr * pk)
        plan_a = gp.probe_plan_rows(pr, pw, pk, sms)
        plan_b = gp.probe_plan_lanes(pr, pw, pnv, pk, sms)
        plan_c = gp.probe_plan_copy(pr, pw, pk, sms)
        # the bytes each design is modelled to read from L2 (no profiler
        # counter backs them): A and C each neighbour's row and idx once; B
        # its staged k-rows and idx once per k-row and chunk
        l2_model = {"A": 4 * edges * (pk + 1), "C": 4 * edges * (pk + 1),
                    "B": 4 * pk * (plan_b["groups"] * pnv
                                   + plan_b["chunks"] * edges)}
        cell = {}
        for key in keys:
            fn, ref_fn, t = {
                "A": (gp.gather_sum_rows, gp.gather_sum_ref, table),
                "B": (gp.gather_sum_lanes, gp.gather_sum_lanes_ref, table_t),
                "C": (gp.gather_sum_copy, gp.gather_sum_ref, table)}[key]
            got = fn(idx, t)
            torch.cuda.synchronize()
            want = ref_fn(idx, t)
            torch.testing.assert_close(got, want, **PROBE_TOL)
            r = {"max_abs_err": float((got - want).abs().max()),
                 "ms": median_ms(lambda: fn(idx, t)),
                 "plain_ms": median_ms(lambda: ref_fn(idx, t)),
                 "per_launch_ms": per_launch_ms(lambda: fn(idx, t)),
                 "plain_per_launch_ms": per_launch_ms(lambda: ref_fn(idx, t)),
                 "nbytes": probe_bytes, "flops": edges * pk}
            cell[key] = r
            emit({"phase": "probe", "cell": label, "kernel": f"gather_probe {key}",
                  "shape": {"R": pr, "W": pw, "NV": pnv, "K": pk},
                  "tolerance": PROBE_TOL, **r,
                  "plan": {"A": plan_a, "B": plan_b, "C": plan_c}[key],
                  "m_edges_per_s": edges / r["ms"] / 1e3,
                  "l2_gathered_bytes": 4 * edges * pk,
                  "l2_model_bytes": l2_model[key],
                  "l2_model_tb_per_s": l2_model[key] / r["per_launch_ms"] / 1e9,
                  "rows_touched": rows_touched, **yardsticks,
                  "probe_d_m_edges_per_s": edges / yardsticks["probe_d_ms"] / 1e3,
                  **({"chain": probe_run[key]} if label == "R512" else {}),
                  **bound(probe_bytes, edges * pk), **tag})
        cell["library_ms"] = yardsticks["library_ms"]
        cell["library_per_launch_ms"] = yardsticks["library_per_launch_ms"]
        probe_cells[label] = cell
        del idx, table, table_t, library
    emit({"phase": "probe", "entry_point": probe_run, "launches": n,
          "embedding_bag_ms": {c: v["library_ms"] for c, v in probe_cells.items()},
          "embedding_bag_per_launch_ms": {
              c: v["library_per_launch_ms"] for c, v in probe_cells.items()},
          **tag})
    # the kernels line keeps ms, plain_ms and library_ms as single calls,
    # as every earlier line has them; the per-launch times stand beside
    probe = probe_cells["R512"]
    for key in "ABC":
        probe[key]["library_per_launch_ms"] = probe["library_per_launch_ms"]
    for key in "ABC":
        probe[key]["per_launch_ms_R8192"] = probe_cells["R8192"][key]["per_launch_ms"]
    for key in "AC":
        probe[key]["per_launch_ms_W2000"] = probe_cells["W2000"][key]["per_launch_ms"]
    probe["B"]["per_launch_ms_NV81270"] = (
        probe_cells["NV81270"]["B"]["per_launch_ms"])
    library_ms = probe["library_ms"]

    # 20. perf-debug: --profile on the main path, each ablation's route,
    # defer_predict
    p_iters = 100

    def ml1m_p(**kw):
        return lambda out=devnull: BPMF(
            Config(num_latent=K, burnin=2, nsims=p_iters, **kw), train, test,
            out=out, device="cuda")

    log = io.StringIO()
    counts.reset()
    sampler = ml1m_p(profile=True)(log)
    sampler.run()
    n = counts.read()
    # the chain, then profile_phases: 100 iterations of the full program
    # and of each variant (a warm chunk and 3 timed chunks of 25), with
    # nosolve on the split Gram (#3) and nomatmul on the split solve (#5)
    assert n == launches(fused_inkernel=2 * p_iters + 2 * 100 * 4, gram_inkernel=200,
                         solve_shared=200), n
    for key in ("fused_inkernel", "gram_inkernel", "solve_shared"):
        total[key] += n[key]
    text = log.getvalue()
    block = text[text.index("perf counters (hierarchical):"):].strip()
    print(block, flush=True)
    attribution = {m.group(1): float(m.group(2)) for m in
                   (re.match(r"  (\S.*?)\s+(\d+\.\d+) ms", line)
                    for line in block.splitlines()) if m}
    assert set(attribution) == {"full iteration", "predict/eval",
                                "cholesky-solve-sample", "gram matmul",
                                "hyperprior resample", "noise tables"}, attribution
    emit({"phase": "perfdebug", "what": "--profile", "dataset": "ml-1m synth",
          "k": K, "iterations": p_iters, "launches": n,
          "attribution_ms": attribution,
          "main_s": sampler.counters.hier["main"],
          "rmse_avg": sampler.rmse_avg, **tag})
    del sampler
    for v, route, want_n in (("nomatmul", "inkernel", launches(solve_shared=50)),
                             ("nosolve", "inkernel", launches(gram_inkernel=50)),
                             ("nohyper", "fused", launches(fused_inkernel=50)),
                             ("nonoise", "fused", launches(fused_inkernel=50)),
                             ("nopredict", "fused", launches(fused_inkernel=50))):
        sampler, mets, chunk_s, setup_s, n = drive(ml1m_p(ablate=v), counts, 1, 25)
        assert sampler.movies.route == sampler.users.route == route, v
        assert n == want_n, (v, n)
        if v == "nopredict":
            assert not mets[0].rmse.any()
        elif v != "nosolve":  # nosolve's draws grow without bound
            assert np.isfinite(mets[0].norm_users).all(), v
        emit({"phase": "perfdebug", "ablate": v, "route": route, "launches": n,
              "ms_per_iter": chunk_s[0] / 25 * 1e3, "setup_s": setup_s, **tag})
        del sampler
    deferred = {}
    for defer in ("off", "on"):
        sampler, mets, chunk_s, setup_s, n = drive(
            ml1m_p(defer_predict=defer), counts, 2, 20)
        assert n == launches(fused_inkernel=80), n
        deferred[defer] = (mets, sampler.defer_group(20), chunk_s)
        del sampler
    for m_on, m_off in zip(deferred["on"][0], deferred["off"][0]):
        np.testing.assert_allclose(m_on.rmse, m_off.rmse, **DEFER_TOL)
        np.testing.assert_allclose(m_on.rmse_avg, m_off.rmse_avg, **DEFER_TOL)
    emit({"phase": "perfdebug", "what": "defer_predict", "group": deferred["on"][1],
          "tolerance": DEFER_TOL,
          "max_rel_diff": max(float(np.abs(a.rmse_avg / b.rmse_avg - 1).max())
                              for a, b in zip(deferred["on"][0], deferred["off"][0])),
          "ms_per_iter_chunk2": {d: deferred[d][2][1] / 20 * 1e3
                                 for d in deferred}, **tag})

    # 21. outputs and checkpoint/resume
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        odir = os.path.join(tmp, "out")
        counts.reset()
        sampler = ml1m_p(output_dir=odir)()
        final = sampler.run()
        n = counts.read()
        assert n == launches(fused_inkernel=2 * p_iters), n
        total["fused_inkernel"] += n["fused_inkernel"]
        names = ("Pavg.sdm", "Pm2.sdm", "U-mu.ddm", "U-Lambda.ddm", "V-mu.ddm",
                 "V-Lambda.ddm")
        assert sorted(os.listdir(odir)) == sorted(names), os.listdir(odir)
        t = test.tocoo()
        pavg = read_matrix(os.path.join(odir, "Pavg.sdm")).tocsr()
        pa = np.asarray(pavg[t.row, t.col]).ravel()
        from_file = float(np.sqrt(np.mean((t.data - pa) ** 2)))
        np.testing.assert_allclose(from_file, final, **PAVG_TOL)
        lam_asym = 0.0
        for prefix, num in (("U", train.shape[0]), ("V", train.shape[1])):
            lam = read_matrix(os.path.join(odir, f"{prefix}-Lambda.ddm"))
            assert lam.shape == (K * K, num) and np.isfinite(lam).all()
            full = lam.reshape(K, K, num, order="F")
            asym = np.abs(full - full.transpose(1, 0, 2)).max() / np.abs(full).max()
            assert asym <= 1e-6, (prefix, asym)
            lam_asym = max(lam_asym, float(asym))
            mu = read_matrix(os.path.join(odir, f"{prefix}-mu.ddm"))
            assert mu.shape == (K, num) and np.isfinite(mu).all()
        emit({"phase": "outputs", "dataset": "ml-1m synth", "k": K,
              "iterations": p_iters, "launches": n, "files": sorted(names),
              "final_avg_rmse": final, "rmse_from_pavg": from_file,
              "tolerance": PAVG_TOL, "lambda_max_rel_asymmetry": lam_asym,
              **tag})
        del sampler
        half = 50
        ck = os.path.join(tmp, "state.npz")

        def chain(**kw):
            return BPMF(Config(num_latent=K, burnin=half - 1, **kw), train, test,
                        out=devnull, device="cuda")

        straight = chain(nsims=2 * half)
        straight_rmse = straight.run()
        chain(nsims=half, checkpoint_path=ck).run()
        resumed = chain(nsims=2 * half, resume=ck)
        resumed_rmse = resumed.run()
        assert resumed_rmse == straight_rmse, (resumed_rmse, straight_rmse)
        assert torch.equal(resumed.state_u.items, straight.state_u.items)
        emit({"phase": "outputs", "what": "checkpoint/resume",
              "iterations": [half, half], "rmse_avg_straight": straight_rmse,
              "rmse_avg_resumed": resumed_rmse, "checkpoint_bytes": os.path.getsize(ck),
              **tag})
        del straight, resumed

    # 22. int16 codes (128-255 levels) and the megakernel at K < 32
    # #1, #2 and #3/#4 against plain on int16 codes 1..255, K=32; #1 at K=10
    # (run on its capacity 16) and K=24 on int8 codes
    cs16 = 2 * CS16
    for i, orientation in enumerate(("rows", "cols")):
        args = kernel_inputs(orientation, seed=220 + i, int16=True)
        for name in ("inkernel", "tight", "aligned"):
            sweep_record(name, args, orientation, "random int16 codes",
                         where="int16", cs=cs16)
        codes, v_t = args[:2]
        fn = d8.dense8_gram_rhs_rows if orientation == "rows" else d8.dense8_gram_rhs_cols
        gram3 = fn(codes, None, v_t, cs16, cb)
        g_bytes = codes.numel() * codes.element_size() + 4 * (
            v_t.numel() + gram3[0].numel() + gram3[1].numel())
        nnz = int((codes != 0).sum())
        for key, p_t in (("gram_inkernel", None),
                         ("gram_hoisted", d8.packed_tri_t(v_t))):
            extra = 0 if p_t is None else 4 * p_t.numel()
            flops = (gram_flops if p_t is None else hoisted_gram_flops)(K, nnz)
            record(key, K, orientation, fn(codes, p_t, v_t, cs16, cb),
                   d8.dense8_gram_rhs_ref(codes, p_t, v_t, cs16, cb, orientation),
                   lambda: fn(codes, p_t, v_t, cs16, cb),
                   lambda: d8.dense8_gram_rhs_ref(codes, p_t, v_t, cs16, cb,
                                                  orientation),
                   inputs="int16", work=(g_bytes + extra, flops),
                   headline=False, codes=str(codes.dtype))
        for k in (10, 24):
            args = kernel_inputs(orientation, seed=230 + k + i, k=k)
            sweep_record("inkernel", args, orientation, "random codes", k,
                         where=f"k{k}")
    del args, codes, gram3

    # the 1/32-grid chain: phase 13's off-grid data rounded to 1/32
    gtrain, gtest = otrain.copy(), otest.copy()
    for m in (gtrain, gtest):
        m.data = np.round(m.data * 32) / 32
    q = quantize_values(gtrain.data)
    assert q is not None and q.levels > 127, q
    g_iters, g_chunks = 250, 2
    g_done = g_iters * g_chunks

    def grid(**kw):
        return lambda: BPMF(Config(num_latent=K, burnin=2, nsims=g_done, **kw),
                            gtrain, gtest, out=devnull, device="cuda")

    grid_rmse = {}
    for route, kw, want_n in (("fused", {}, launches(fused_inkernel=2 * g_done)),
                              ("fused dense", {"gram_impl": "dense"},
                               launches(solve_shared=2 * g_done))):
        sampler, mets, chunk_s, setup_s, n = drive(grid(**kw), counts,
                                                   g_chunks, g_iters)
        assert n == want_n, (route, n)
        assert_finite(mets)
        if route == "fused":
            assert sampler._codes.dtype == torch.int16, sampler._codes.dtype
            assert sampler.users.route == sampler.movies.route == "fused"
        else:
            assert [(x.impl, x.route) for x in (sampler.movies, sampler.users)] == [
                ("dense", "fused")] * 2
        for key in ("fused_inkernel", "solve_shared"):
            total[key] += n[key]
        grid_rmse[route] = float(mets[-1].rmse_avg[-1])
        emit({"phase": "int16", "chain": "1/32 grid", "route": route,
              "dataset": "ml-1m synth, off grid rounded to 1/32", "k": K,
              "levels": q.levels, "iterations": g_done, "launches": n,
              "rmse_avg": grid_rmse[route], "rmse": float(mets[-1].rmse[-1]),
              **per_iter_stats(sampler, chunk_s, g_iters), "setup_s": setup_s,
              **tag})
        del sampler
    assert abs(grid_rmse["fused"] - grid_rmse["fused dense"]) <= GRID_BAND, grid_rmse
    # 3 iterations on the card against the plain chain on the CPU, same draws
    runs = {}
    for dev in (torch.device("cpu"), torch.device("cuda")):
        s3 = BPMF(Config(num_latent=K, burnin=1, nsims=3), gtrain, gtest,
                  out=devnull, device=dev, draws=HostDraws(42, dev))
        counts.reset()
        runs[dev.type] = s3.run_chunk(3)
        n = counts.read()
        assert s3._codes.dtype == torch.int16
        assert n == (launches(fused_inkernel=6) if dev.type == "cuda" else launches()), n
    err = 0.0
    for got, want in zip(runs["cuda"], runs["cpu"]):
        assert np.isfinite(got).all(), got
        np.testing.assert_allclose(got, want, **CHAIN_TOL)
        err = max(err, float(np.abs(got - want).max()))
    emit({"phase": "int16", "chain": "1/32 grid", "first_3_vs_cpu_max_abs_err": err,
          "tolerance": CHAIN_TOL, "band": GRID_BAND, **tag})
    del gtrain, gtest, s3

    # the K=10 chain (the Julia reference's default) on #1 and on split
    k10 = {}
    for solve, want_n in (("fused", launches(fused_inkernel=2 * g_done)),
                          ("split", launches(gram_inkernel=2 * g_done,
                                             solve_shared=2 * g_done))):
        with env(BPMF_D8_SOLVE=solve):
            sampler, mets, chunk_s, setup_s, n = drive(
                lambda: BPMF(Config(num_latent=10, burnin=2, nsims=g_done),
                             train, test, out=devnull, device="cuda"),
                counts, g_chunks, g_iters)
        route = "fused" if solve == "fused" else "inkernel"
        assert sampler.users.route == sampler.movies.route == route
        assert n == want_n, (solve, n)
        assert_finite(mets)
        for key in ("fused_inkernel", "gram_inkernel", "solve_shared"):
            total[key] += n[key]
        k10[solve] = float(mets[-1].rmse_avg[-1])
        emit({"phase": "int16", "chain": "k10", "dataset": "ml-1m synth",
              "k": 10, "route": route, "iterations": g_done, "launches": n,
              "rmse_avg": k10[solve], "rmse": float(mets[-1].rmse[-1]),
              **per_iter_stats(sampler, chunk_s, g_iters), "setup_s": setup_s,
              **tag})
        del sampler
    assert abs(k10["fused"] - k10["split"]) <= GRID_BAND, k10

    # 23. the megakernel past one row a lane: the K=40 chains, one kernel a
    # side (#1 on the capacity 48, #2 at a runtime K), as the JAX package
    # fuses them
    wide_n = {}

    def wide_chain(make, chunks_w, iters_w, routes, want_n, want_inst, **info):
        """A chain on the megakernel's new instances: its routes, launch
        counts (by kernel and by instance), finite metrics; returns its
        sampler, metrics and the JSON line's fields."""
        sampler, mets, chunk_s, setup_s, n = drive(make, counts, chunks_w, iters_w)
        inst = counts.instances()
        got = {"movies": sampler.movies.route, "users": sampler.users.route}
        assert got == routes, got
        assert n == want_n, n
        assert inst == want_inst, inst
        assert_finite(mets)
        for key, c in n.items():
            total[key] += c
        for key, c in inst.items():
            wide_n[key] = wide_n.get(key, 0) + c
        return sampler, mets, {
            **info, "routes": got, "iterations": chunks_w * iters_w,
            "launches": n, "instances": inst, "rmse_avg": float(mets[-1].rmse_avg[-1]),
            "rmse": float(mets[-1].rmse[-1]),
            **per_iter_stats(sampler, chunk_s, iters_w), "setup_s": setup_s, **tag}

    # ml-1m synth at K=40: #1 on both sides, against the split pipeline
    w_iters, w_chunks = 100, 2
    w_done = w_iters * w_chunks

    def ml1m40():
        return BPMF(Config(num_latent=40, burnin=2, nsims=w_done), train, test,
                    out=devnull, device="cuda")

    sampler, mets, line = wide_chain(
        ml1m40, w_chunks, w_iters, {"movies": "fused", "users": "fused"},
        launches(fused_inkernel=2 * w_done), {d8.sweep_instance_key(40, "inkernel"): 2 * w_done},
        dataset="ml-1m synth", k=40)
    err = check_first_iterations(ml1m40, mets[0], counts)
    del sampler
    with env(BPMF_D8_SOLVE="split"):
        ref_s, _, ref_line = wide_chain(
            ml1m40, w_chunks, w_iters, {"movies": "inkernel", "users": "inkernel"},
            launches(gram_inkernel=2 * w_done, solve_shared=2 * w_done), {},
            dataset="ml-1m synth", k=40)
    del ref_s
    emit({"phase": "wide", "chain": "ml-1m k40", **line,
          "first_3_vs_plain_max_abs_err": err, "tolerance": CHAIN_TOL,
          "split_rmse_avg": ref_line["rmse_avg"],
          "split_ms_per_iter": ref_line["ms_per_iter"], "band": WIDE_BAND})
    assert abs(line["rmse_avg"] - ref_line["rmse_avg"]) <= WIDE_BAND, (
        line["rmse_avg"], ref_line["rmse_avg"])

    # chembl synth at K=40 (phase 9's data): the 167,424 padded compounds
    # on #2 (tight, by the default pt_mode), the proteins on #1 over
    # segments (the most-rated with 61,253 ratings)
    ctrain, ctest = synth_chembl()
    c_iters, c_chunks = 20, 2
    c_done = c_iters * c_chunks

    def chembl40():
        return BPMF(Config(num_latent=40, burnin=2, nsims=c_done), ctrain, ctest,
                    out=devnull, device="cuda")

    sampler, mets, line = wide_chain(
        chembl40, c_chunks, c_iters, {"movies": "fused", "users": "fused_hoisted"},
        launches(fused_inkernel=c_done, fused_tight=c_done),
        {d8.sweep_instance_key(40, "inkernel"): c_done,
         d8.sweep_instance_key(40, "tight"): c_done},
        dataset="chembl synth, 167000 x 360", k=40)
    err = check_first_iterations(chembl40, mets[0], counts)
    emit({"phase": "wide", "chain": "chembl k40", **line,
          "most_rated": {"compounds": int(sampler.users.degrees.max()),
                         "proteins": int(sampler.movies.degrees.max())},
          "segments": {side.name: d8.sweep_plan(
              st.items.shape[0], fr.items.shape[0],
              d8.sweep_instance(40, "inkernel")[0], side.max_degree,
              d8._sm_count(sampler._codes.device)).segments
              for side, st, fr in ((sampler.users, sampler.state_u, sampler.state_m),
                                   (sampler.movies, sampler.state_m, sampler.state_u))},
          "first_3_vs_plain_max_abs_err": err, "tolerance": CHAIN_TOL})
    del sampler, ctrain, ctest

    # the other new instances on a chain of their own: #1 at K=41 (capacity
    # 44), #2 at K=24 (tight, capacity 24), K=10 and K=39 (aligned,
    # capacities 16 and 40)
    for k, knob, route, key, operand in (
            (41, {}, "fused", "fused_inkernel", "inkernel"),
            (24, {"BPMF_D8_PT": "hoisted"}, "fused_hoisted", "fused_tight", "tight"),
            (10, {"BPMF_D8_SOLVE": "fused_aligned"}, "fused_aligned", "fused_aligned",
             "aligned"),
            (39, {"BPMF_D8_SOLVE": "fused_aligned"}, "fused_aligned", "fused_aligned",
             "aligned")):
        inst = d8.sweep_instance_key(k, operand)
        kn_iters, kn_chunks = 50, 2
        with env(**knob):
            sampler, mets, line = wide_chain(
                lambda: BPMF(Config(num_latent=k, burnin=2,
                                    nsims=kn_iters * kn_chunks),
                             train, test, out=devnull, device="cuda"),
                kn_chunks, kn_iters, {"movies": route, "users": route},
                launches(**{key: 2 * kn_iters * kn_chunks}),
                {inst: 2 * kn_iters * kn_chunks},
                dataset="ml-1m synth", k=k, knob=knob)
        emit({"phase": "wide", "chain": f"ml-1m k{k}", **line})
        del sampler

    # 24. multi-device on the one card: (a) one NCCL rank, each sharded
    # function against its one-device function; (b) two gloo ranks on the
    # one GPU through BPMF
    lines, multi_s = multi_phase(train, test, counts, total, tag, devnull)
    for line in lines:
        emit({**line, "phase_s": multi_s})

    # 25. bucketed reduce, its chunked form, the halo ring and --dist: (a)
    # one NCCL rank, each reduce sweep against gather mode; (b) two gloo
    # ranks on the one GPU, a chain of each; (c) the CLI with --dist
    lines, reduce_s = reduce_phase(train, test, counts, total, tag, devnull)
    for line in lines:
        emit({**line, "phase_s": reduce_s})

    # 26. bf16 matmul inputs: #1-#4 on bf16 operands against plain (and the
    # solves against the float64 draw of the same bf16 systems), then the
    # anchored chains and one chain a bf16 instance at bf16
    t26 = time.perf_counter()
    bf = torch.bfloat16
    cs26, cb26 = CS_BF16, CB_BF16
    # the megakernel's rows by operand and kernel: "mma" the tensor-core
    # kernel, "walk" the rated entries' (the bf16 instances of
    # dense8_sweep_solve.cuh), which ops.dense8.sweep_bf16_kernel picks
    # below the crossover density
    MEGA = [(name, kern) for name in ("inkernel", "tight", "aligned")
            for kern in ("mma", "walk")]
    bf16_rows = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                        "library_ms": 0.0, "nbytes": 0, "flops": 0,
                        "bf16_mma": 0, "bf16_vec": 0}
                 for name in (*MEGA, "gram_inkernel", "gram_hoisted")}

    def bf16_record(name, r, nbytes, work, **info):
        """One bf16 kernel against plain: a JSON line, and its times and
        bound (``work``: bf16_gram_work's) summed into its kernels-line row
        (rows + cols)."""
        emit({"phase": "bf16", "kernel": "_".join(name) if isinstance(name, tuple) else name,
              **info, **r, **work, **bound(nbytes, **work), **tag})
        row = bf16_rows[name]
        row["max_abs_err"] = max(row["max_abs_err"], r["max_abs_err"])
        for key, v in (("ms", r["ms"]), ("plain_ms", r["plain_ms"]),
                       ("library_ms", r["library_ms"]), ("nbytes", nbytes),
                       *work.items()):
            row[key] += v

    def gram26(codes, v_b, orientation, name, headline, **info):
        """The tensor-core Gram (#3 'gram_inkernel', #4 'gram_hoisted') on
        bf16 operands against its plain version, twice bitwise equal, with
        its bound (the bytes, or the rated entries' operations by type) and
        beside it the dense floor, 2 items x frozen x (T + 2K) at
        BF16_MMA_FLOPS_PER_S: the work the kernel does whatever the
        density.  ``headline``: summed into the kernels line's row."""
        k = v_b.shape[0]
        fn = d8.dense8_gram_rhs_rows if orientation == "rows" else d8.dense8_gram_rhs_cols
        p_t = d8.packed_tri_t(v_b.float()).to(bf) if name == "gram_hoisted" else None
        got = fn(codes, p_t, v_b, cs26, cb26)
        torch.cuda.synchronize()
        again = fn(codes, p_t, v_b, cs26, cb26)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        want = d8.dense8_gram_rhs_ref(codes, p_t, v_b, cs26, cb26, orientation)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, **KERNEL_TOL)
        nnz = int((codes != 0).sum())
        nbytes = (codes.numel() * codes.element_size()
                  + 2 * (v_b.numel() + (0 if p_t is None else p_t.numel()))
                  + 4 * (got[0].numel() + got[1].numel()))
        work = bf16_gram_work(k, nnz, v_b.shape[1], p_t is None)
        t_out, items = got[0].shape
        floor = 1e3 * 2 * items * v_b.shape[1] * (t_out + 2 * k) / BF16_MMA_FLOPS_PER_S
        r = {"max_abs_err": max(float((g - w).abs().max()) for g, w in zip(got, want)),
             "ms": median_ms(lambda: fn(codes, p_t, v_b, cs26, cb26)),
             "plain_ms": median_ms(lambda: d8.dense8_gram_rhs_ref(
                 codes, p_t, v_b, cs26, cb26, orientation)),
             "library_ms": median_ms(lambda: bf16_library(
                 codes, p_t, v_b, cs26, cb26, orientation))}
        plan = d8.mma_plan(items, v_b.shape[1], t_out, k, d8._sm_count(codes.device),
                           code_bytes=codes.element_size())
        info.update(orientation=orientation, k=k, shape=list(codes.shape),
                    operands="bfloat16", segments=plan.segments,
                    dense_floor_ms=floor, tolerance=KERNEL_TOL, bitwise_repeated=True)
        if headline:
            bf16_record(name, r, nbytes, work, **info)
            bf16_rows[name]["dense_floor_ms"] = (
                bf16_rows[name].get("dense_floor_ms", 0.0) + floor)
        else:
            emit({"phase": "bf16", "kernel": name, **info, **r, **work,
                  **bound(nbytes, **work), **tag})

    for i, orientation in enumerate(("rows", "cols")):
        codes, v_t, lam, prior_rhs, noise_t = kernel_inputs(orientation, seed=260 + i)
        v_b = v_t.to(bf)
        for name in ("inkernel", "tight", "aligned"):
            p_t, layout = None, "aligned"
            if name != "inkernel":
                p_t = d8.packed_tri_t(v_b.float(), aligned=name == "aligned").to(bf)
                layout = name

            def plain():
                return dense8_sweep_solve_ref(codes, p_t, v_b, lam, prior_rhs, noise_t,
                                              cs26, cb26, alpha, orientation, layout)
            want = plain()
            system = d8_system64(codes, v_b, lam, alpha, orientation)
            rhs64 = d8_rhs64(codes, v_b, prior_rhs, cs26, cb26, orientation,
                             fold=p_t is not None)
            shared = {"plain_ms": median_ms(plain),
                      "library_ms": median_ms(lambda: bf16_library(
                          codes, p_t, v_b, cs26, cb26, orientation,
                          (lam, prior_rhs, noise_t, alpha, layout)))}
            nbytes = sweep_work((codes, v_b, lam, prior_rhs, noise_t), p_t,
                                layout)[0]
            n_items, n_frozen = noise_t.shape[1], v_b.shape[1]
            # the tensor-core kernel with every entry rated, the walk with
            # none (sweep_bf16_kernel's cost models); each launch counted
            # under its instance
            for kern, work in (("mma", codes.numel()), ("walk", 0)):
                key = (d8.sweep_mma_key(K, name) if kern == "mma"
                       else d8.sweep_instance_key(K, name, bf))

                def call(work=work):
                    return dense8_sweep_solve(codes, p_t, v_b, lam, prior_rhs, noise_t,
                                              cs26, cb26, alpha, orientation,
                                              layout=layout, walk_work=work)
                before = d8.sweep_instance_launches.get(key, 0)
                got = call()
                torch.cuda.synchronize()
                assert d8.sweep_instance_launches.get(key, 0) == before + 1, key
                assert torch.equal(got, call())
                torch.testing.assert_close(got, want, **KERNEL_TOL)
                worst, err64, kappa = solve_vs_f64(system, rhs64, noise_t.t(),
                                                   [got.t(), want.t()])
                r = {"max_abs_err": float((got - want).abs().max()),
                     "ms": median_ms(call), **shared}
                work = bf16_gram_work(K, int((codes != 0).sum()), n_frozen, p_t is None)
                # the combine and the solve, float32
                work["flops"] += solve_flops(K, n_items) + K * (K + 1) * n_items
                info = {}
                if kern == "mma":   # its work whatever the density
                    floor = (1e3 * 2 * n_items * n_frozen * (K * (K + 1) // 2 + 2 * K)
                             / BF16_MMA_FLOPS_PER_S)
                    info["dense_floor_ms"] = floor
                    row = bf16_rows[(name, kern)]
                    row["dense_floor_ms"] = row.get("dense_floor_ms", 0.0) + floor
                bf16_record((name, kern), r, nbytes, work, orientation=orientation, k=K,
                            shape=list(codes.shape), operands="bfloat16", instance=key,
                            tolerance=KERNEL_TOL, solve_bound=SOLVE_BOUND,
                            err_over_bound=worst[0], plain_err_over_bound=worst[1],
                            err_vs_f64=err64[0], max_kappa_f=kappa,
                            bitwise_repeated=True, **info)
                assert worst[0] <= 1.0, (name, kern, orientation, worst, err64)
            del system, rhs64
        # the split Gram (the tensor-core kernel) at K=64 and 79 on bf16
        # operands; K=64 is the kernels line's row
        for k in (64, 79):
            codes, v_t = kernel_inputs(orientation, seed=270 + i + (k == 79), k=k)[:2]
            for name in ("gram_inkernel", "gram_hoisted"):
                gram26(codes, v_t.to(bf), orientation, name, headline=k == 64,
                       inputs="random codes")
    # the dense routes' bf16 products (ops.update.matmul_acc): cuBLAS with
    # out_dtype float32 against converting both operands and an SGEMM
    g26 = torch.Generator(device="cuda").manual_seed(290)
    a26 = torch.randn((4096, 6144), generator=g26, device="cuda").to(bf)
    b26 = torch.randn((6144, 1024), generator=g26, device="cuda").to(bf)
    exact = a26.double() @ b26.double()
    probe26 = {}
    for name, fn in (
            ("mm_out_dtype", lambda: torch.mm(a26, b26, out_dtype=torch.float32)),
            ("bmm_out_dtype",
             lambda: torch.bmm(a26[None], b26[None], out_dtype=torch.float32)[0]),
            ("converted_sgemm", lambda: a26.float() @ b26.float())):
        probe26[name] = {"ms": median_ms(fn),
                         "err_vs_f64": float((fn().double() - exact).abs().max())}
    emit({"phase": "bf16", "probe": "matmul out_dtype",
          "shape": [[4096, 6144], [6144, 1024]], **probe26, **tag})
    del a26, b26, exact
    # every other megakernel instance on bf16 operands: phase 3's WIDE
    for name, k in WIDE:
        args = kernel_inputs("rows", seed=280 + k, k=k)
        v_b = args[1].to(bf)
        p_t = (None if name == "inkernel" else
               d8.packed_tri_t(v_b.float(), aligned=name == "aligned").to(bf))
        layout = "aligned" if name == "inkernel" else name
        got = dense8_sweep_solve(args[0], p_t, v_b, *args[2:], cs26, cb26, alpha,
                                 "rows", layout=layout)
        want = dense8_sweep_solve_ref(args[0], p_t, v_b, *args[2:], cs26, cb26,
                                      alpha, "rows", layout)
        torch.testing.assert_close(got, want, **KERNEL_TOL)
        kern = d8.sweep_bf16_kernel(*args[0].shape, None, k, name,
                                    None if p_t is None else p_t.shape[0])
        emit({"phase": "bf16", "kernel": "dense8_sweep_solve", "operand": name,
              "k": k, "instance": (d8.sweep_mma_key(k, name) if kern == "mma"
                                   else d8.sweep_instance_key(k, name, bf)),
              "max_abs_err": float((got - want).abs().max()),
              "tolerance": KERNEL_TOL})
    del args, codes, v_t, v_b, got, want

    def bf16_chain(make, chunks_n, iters_n, routes, want, **info):
        """A chain at bf16 between a reset and a read of the launch counts:
        its routes, its launches (the bf16 instances only), finite
        metrics; returns (sampler, metrics, its JSON line)."""
        sampler, mets, chunk_s, setup_s, n = drive(make, counts, chunks_n, iters_n)
        inst = counts.instances()   # the megakernel by instance: mma or walk
        for key, c in inst.items():
            total[key] = total.get(key, 0) + c
        assert sampler._md == bf
        got_routes = {s.name: s.route or s.impl for s in (sampler.movies, sampler.users)}
        assert got_routes == routes, got_routes
        assert n == want, n
        assert_finite(mets)
        for key, c in n.items():
            total[key] = total.get(key, 0) + c
        line = {"phase": "bf16", "matmul_dtype": "bfloat16", **info,
                "routes": got_routes, "iterations": chunks_n * iters_n,
                "launches": n, "instances": inst,
                "density": float((sampler._codes != 0).sum()) / sampler._codes.numel()
                if sampler._codes is not None else None,
                "walk_work": getattr(sampler, "_d8_walk", None),
                "rmse_avg": float(mets[-1].rmse_avg[-1]),
                "rmse": float(mets[-1].rmse[-1]),
                **per_iter_stats(sampler, chunk_s, iters_n), "setup_s": setup_s,
                **tag}
        return sampler, mets, line

    # the anchored chains: ml-1m K=32 on #1, bucketed ml-1m, ml-25M half
    bf16_anchor = {}
    for chain, make, c_n, i_n, routes, want, anchor in (
            ("ml-1m k32", ml1m(K, matmul_dtype="bfloat16"), chunks, iters,
             {"movs": "fused", "users": "fused"}, launches(fused_inkernel_bf16=2 * done),
             RMSE_AVG_JAX),
            ("ml-1m k32 bucketed", ml1m(K, gram_impl="bucketed",
                                        matmul_dtype="bfloat16"), chunks, iters,
             {"movs": "bucketed", "users": "bucketed"}, launches(blast=2 * done),
             RMSE_AVG_JAX),
            ("ml-25M half bucketed", ml25m(gram_impl="bucketed",
                                           matmul_dtype="bfloat16"),
             b_chunks, b_iters, {"movs": "bucketed", "users": "bucketed"},
             launches(blast=2 * b_chunks * b_iters), RMSE_AVG_ML25M_HALF)):
        sampler, mets, line = bf16_chain(make, c_n, i_n, routes, want, chain=chain)
        bf16_anchor[chain] = line["rmse_avg"]
        emit({**line, "rmse_avg_jax_tpu_bf16": anchor, "band": RMSE_BAND})
        del sampler
        assert abs(line["rmse_avg"] - anchor) <= RMSE_BAND, (chain, line, anchor)
    del btest   # btrain stays for phase 27's bucketize
    # one chain each for the other bf16 instances, 3 iterations against the
    # plain chain: #2 in both layouts (K=32), #3 and #4 (the K=64 split
    # route), and the off-grid fused dense chain (bf16 blocks, #5)
    s_iters, s_chunks = 50, 2
    s_done = s_iters * s_chunks
    for chain, make, c_n, i_n, knob, routes, want in (
            ("ml-1m k32 hoisted", ml1m(K, matmul_dtype="bfloat16"), s_chunks,
             s_iters, {"BPMF_D8_PT": "hoisted"},
             {"movs": "fused_hoisted", "users": "fused_hoisted"},
             launches(fused_tight_bf16=2 * s_done)),
            ("ml-1m k32 aligned", ml1m(K, matmul_dtype="bfloat16"), s_chunks,
             s_iters, {"BPMF_D8_SOLVE": "fused_aligned"},
             {"movs": "fused_aligned", "users": "fused_aligned"},
             launches(fused_aligned_bf16=2 * s_done)),
            ("ml-1m k64 split", ml1m(64, matmul_dtype="bfloat16"), s_chunks,
             s_iters, {}, {"movs": "inkernel", "users": "inkernel"},
             launches(gram_inkernel_bf16=2 * s_done, solve_shared=2 * s_done)),
            ("ml-1m k64 split hoisted", ml1m(64, matmul_dtype="bfloat16"),
             s_chunks, s_iters, {"BPMF_D8_PT": "hoisted"},
             {"movs": "hoisted", "users": "hoisted"},
             launches(gram_hoisted_bf16=2 * s_done, solve_shared=2 * s_done)),
            ("ml-1m k32 off grid", offgrid(matmul_dtype="bfloat16"), o_chunks,
             o_iters, {}, {"movs": "fused", "users": "fused"},
             launches(solve_shared=2 * o_iters * o_chunks))):
        with env(**knob):
            sampler, mets, line = bf16_chain(make, c_n, i_n, routes, want,
                                             chain=chain, knob=knob)
            err = check_first_iterations(make, mets[0], counts)
        line.update(first_3_vs_plain_max_abs_err=err, tolerance=CHAIN_TOL)
        if chain == "ml-1m k32 off grid":
            line.update(float32_rmse_avg=o_rmse["fused"], band=BF16_BAND)
            assert abs(line["rmse_avg"] - o_rmse["fused"]) <= BF16_BAND, line
        emit(line)
        del sampler
    # the chembl synth at K=64 on bf16 operands, phase 9's chain: #4 on the
    # compounds, #3 on the proteins (S segments of the compounds), within
    # RMSE_BAND of the float32 chain; then both on the chain's own codes
    # and last state
    ctrain, ctest = synth_chembl()

    def chembl_bf16():
        return BPMF(Config(num_latent=64, burnin=2, nsims=s_done,
                           matmul_dtype="bfloat16"), ctrain, ctest, out=devnull,
                    device="cuda")
    sampler, mets, line = bf16_chain(
        chembl_bf16, s_chunks, s_iters, {"movs": "inkernel", "users": "hoisted"},
        launches(gram_inkernel_bf16=s_done, gram_hoisted_bf16=s_done,
                 solve_shared=2 * s_done), chain="chembl k64")
    line.update(first_3_vs_plain_max_abs_err=check_first_iterations(
        chembl_bf16, mets[0], counts), tolerance=CHAIN_TOL,
        float32_rmse_avg=chembl_rmse, band=RMSE_BAND)
    emit(line)
    assert abs(line["rmse_avg"] - chembl_rmse) <= RMSE_BAND, line
    for side, orientation, name, frozen in (
            (sampler.users, "rows", "gram_hoisted", sampler.state_m),
            (sampler.movies, "cols", "gram_inkernel", sampler.state_u)):
        gram26(sampler._codes, frozen.items.t().to(bf), orientation, name,
               headline=False, inputs="chembl_bf16_chain", side=side.name)
    del sampler
    def chosen(sampler, operand):
        """The bf16 megakernel instances sweep_bf16_kernel names for a
        chain's sides (its launches under the instance's key): rows, then
        cols, s_done each."""
        codes = sampler._codes
        t_in = None if operand == "inkernel" else d8._sweep_rows(K, operand)
        want = {}
        for (items, frozen), side in ((codes.shape, "users"),
                                      (codes.shape[::-1], "movs")):
            kern = d8.sweep_bf16_kernel(items, frozen, sampler._d8_walk[side], K,
                                        operand, t_in, codes.element_size(),
                                        d8._sm_count(codes.device))
            key = (d8.sweep_mma_key(K, operand) if kern == "mma"
                   else d8.sweep_instance_key(K, operand, bf))
            want[key] = want.get(key, 0) + s_done
        return want

    # the chembl synth at K=32 under both #2 knobs at bf16: its 167,424
    # compounds (1.6 rated a protein) keep the walk, which the cost models
    # put at 2.5x faster than the tensor cores there
    def chembl32_bf16():
        return BPMF(Config(num_latent=K, burnin=2, nsims=s_done,
                           matmul_dtype="bfloat16"), ctrain, ctest, out=devnull,
                    device="cuda")
    for chain, knob, routes, operand in (
            ("chembl k32 hoisted", {"BPMF_D8_PT": "hoisted"}, "fused_hoisted", "tight"),
            ("chembl k32 aligned", {"BPMF_D8_SOLVE": "fused_aligned"}, "fused_aligned",
             "aligned")):
        with env(**knob):
            sampler, mets, line = bf16_chain(
                chembl32_bf16, s_chunks, s_iters, {"movs": routes, "users": routes},
                launches(**{f"fused_{operand}_bf16": 2 * s_done}), chain=chain,
                knob=knob)
            want = chosen(sampler, operand)
            assert d8.sweep_instance_key(K, operand, bf) in want, want  # compounds
            assert line["instances"] == want, (line, want)
            err = check_first_iterations(chembl32_bf16, mets[0], counts)
        emit({**line, "first_3_vs_plain_max_abs_err": err, "tolerance": CHAIN_TOL})
        del sampler
    del ctrain, ctest
    # the dense ratings of Jester Dataset 1's scale (synth_jester: 73,421
    # users rate 15-100 of 100 jokes): sweep_bf16_kernel's cost models put
    # the jokes (512 padded items, 73,728 frozen) on the tensor cores and
    # the users on either kernel by the operand; each side's launches on
    # the instance the choice names, 3 iterations against the plain chain
    dtrain, dtest = synth_jester()

    def dense(**kw):
        return lambda: BPMF(Config(num_latent=K, burnin=2, nsims=s_done,
                                   matmul_dtype="bfloat16", **kw),
                            dtrain, dtest, out=devnull, device="cuda")
    for chain, knob, routes, operand in (
            ("jester k32", {}, "fused", "inkernel"),
            ("jester k32 hoisted", {"BPMF_D8_PT": "hoisted"}, "fused_hoisted", "tight"),
            ("jester k32 aligned", {"BPMF_D8_SOLVE": "fused_aligned"}, "fused_aligned",
             "aligned")):
        with env(**knob):
            sampler, mets, line = bf16_chain(
                dense(), s_chunks, s_iters, {"movs": routes, "users": routes},
                launches(**{f"fused_{operand}_bf16": 2 * s_done}), chain=chain,
                knob=knob)
            want = chosen(sampler, operand)
            assert d8.sweep_mma_key(K, operand) in want, want   # the jokes
            assert line["instances"] == want, (line, want)
            err = check_first_iterations(dense(), mets[0], counts)
        emit({**line, "first_3_vs_plain_max_abs_err": err, "tolerance": CHAIN_TOL})
        del sampler
    del dtrain, dtest
    emit({"phase": "bf16", "phase_s": time.perf_counter() - t26, **tag})

    # 27. the functional model API's chain against BPMF's bucketed chain,
    # and the native matrix I/O against Python
    lines, api_s = api_phase(train, test, btrain, counts, total, tag, devnull)
    for line in lines:
        emit({**line, "phase_s": api_s})
    del btrain

    # 28. the entry points: entry()'s function, the main path through
    # iter_fn against run_chunk, host syncs per iteration, dryrun_multichip(2)
    lines, entry_s = entry_phase(train, test, counts, total, tag, devnull)
    for line in lines:
        emit({**line, "phase_s": entry_s})

    # 29. the bench legs, each in its subprocess; this process's cached
    # blocks go back to the card first
    torch.cuda.empty_cache()
    emit({"phase": "bench", "phase_s": bench_phase(total, tag, chain_rmse), **tag})

    print(smi, flush=True)
    src = "bpmf_tpu_torch/csrc/"

    def entry(name, source, replaces, key, numbers, library_ms=None):
        numbers = dict(numbers)
        work = bound(numbers.pop("nbytes"), numbers.pop("flops"),
                     numbers.pop("bf16_mma", 0), numbers.pop("bf16_vec", 0))
        library_ms = numbers.pop("library_ms", library_ms)
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": replaces, "launches": total[key], **numbers,
                **work, "library_ms": library_ms}

    library8 = main8.pop("library_ms")
    wide_rows = []
    for name, k in WIDE:
        inst = d8.sweep_instance_key(k, name)
        assert wide_n.get(inst), (inst, wide_n)   # launched on a chain of phase 23
        total[inst] = wide_n[inst]
        what = ("in-kernel products" if name == "inkernel"
                else f"hoisted operand, {name}")
        wide_rows.append(entry(
            f"dense8_sweep_solve ({what}, K={k}, instance {inst})",
            "dense8_sweep_solve.cu",
            "bpmf_tpu/ops/dense8.py:" + ("580" if name == "inkernel" else "509"),
            inst, {**result[(name, k)], "k": k, "instance": inst}))
    # the megakernel's rows on bf16 operands, each beside its float32 row:
    # the tensor-core kernel and the walk, each by its instance's launches
    # on the chains of phase 26 (sweep_bf16_kernel picks one by density)
    for name, numbers in mega_chain.items():   # on chains' own states
        row = bf16_rows[(name, "mma")]
        err = numbers.pop("max_abs_err")
        row.update(numbers)
        row["max_abs_err"] = max(row["max_abs_err"], err)
    bf16_entries = []
    for name, what, line in (("inkernel", "in-kernel products", "580"),
                             ("tight", "hoisted operand, tight", "509"),
                             ("aligned", "hoisted operand, aligned", "509")):
        for kern, how, source in (
                ("mma", "tensor cores", "dense8_sweep_solve_mma.cu"),
                ("walk", "rated entries", "dense8_sweep_solve_bf16.cu")):
            key = (d8.sweep_mma_key(K, name) if kern == "mma"
                   else d8.sweep_instance_key(K, name, bf))
            assert total.get(key), (key, "not launched on the main path")
            bf16_entries.append(entry(
                f"dense8_sweep_solve ({what}, bf16 operands, {how})", source,
                "bpmf_tpu/ops/dense8.py:" + line, key,
                {**bf16_rows[(name, kern)], "k": K, "operands": "bfloat16",
                 "instance": key}))
    bf16_entries += [
        entry(f"dense8_gram_mma ({what}, bf16 operands, tensor cores)", "dense8_gram_mma.cu",
              "bpmf_tpu/ops/dense8.py:" + line, name + "_bf16",
              {**bf16_rows[name], "k": 64, "operands": "bfloat16"})
        for name, what, line in (("gram_inkernel", "in-kernel products", "233"),
                                 ("gram_hoisted", "hoisted operand", "339"))]
    emit({"kernels": [
        entry("dense8_sweep_solve (in-kernel products)", "dense8_sweep_solve.cu",
              "bpmf_tpu/ops/dense8.py:580", "fused_inkernel", result["inkernel"]),
        entry("dense8_sweep_solve (hoisted operand, tight)",
              "dense8_sweep_solve.cu", "bpmf_tpu/ops/dense8.py:509",
              "fused_tight", result["tight"]),
        entry("dense8_sweep_solve (hoisted operand, aligned)",
              "dense8_sweep_solve.cu", "bpmf_tpu/ops/dense8.py:509",
              "fused_aligned", result["aligned"]),
        entry("dense8_gram_rhs (in-kernel products)", "dense8_gram_rhs.cu",
              "bpmf_tpu/ops/dense8.py:233", "gram_inkernel", split["gram_inkernel"]),
        entry("dense8_gram_rhs (hoisted operand)", "dense8_gram_rhs.cu",
              "bpmf_tpu/ops/dense8.py:339", "gram_hoisted", split["gram_hoisted"]),
        entry("tri_combine_solve (shared prior)", "tri_combine_solve.cu",
              "bpmf_tpu/ops/pallas_solve.py:307", "solve_shared",
              split["solve_shared"]),
        entry("tri_combine_solve (per-item prior)", "tri_combine_solve.cu",
              "bpmf_tpu/ops/pallas_solve.py:375", "solve_peritem",
              split["solve_peritem"]),
        entry("tri_combine_solve (grouped, shared prior)", "tri_combine_solve.cu",
              "bpmf_tpu/ops/pallas_solve.py:474", "solve_shared_grouped",
              split["solve_shared_grouped"]),
        entry("tri_combine_solve (grouped, per-item prior)",
              "tri_combine_solve.cu", "bpmf_tpu/ops/pallas_solve.py:502",
              "solve_peritem_grouped", split["solve_peritem_grouped"]),
        entry("chol_solve_sample", "chol_solve_sample.cu",
              "bpmf_tpu/ops/pallas_solve.py:89", "blast", main8,
              library_ms=library8),
        entry("gather_probe A (warp per row)", "gather_probe.cu",
              "scripts/gather_probe.py:66", "probe_A",
              {**probe["A"], "design": "neighbours split over warps, "
                                       "16-byte pieces"},
              library_ms=library_ms),
        entry("gather_probe B (transposed table, lanes over neighbours)",
              "gather_probe.cu", "scripts/gather_probe.py:87", "probe_B",
              {**probe["B"], "design": "a k-row in shared memory"},
              library_ms=library_ms),
        entry("gather_probe C (cp.async rows into shared memory)",
              "gather_probe.cu", "scripts/gather_probe.py:107", "probe_C",
              {**probe["C"], "design": "a ring of mbarrier-tracked bulk "
                                       "row copies, a producer warp per 32 "
                                       "rows of a slot, four summing warps"},
              library_ms=library_ms),
        *wide_rows,
        *bf16_entries,
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
