"""The CUDA kernels against their plain PyTorch versions on the card, the
chains on the card against the CPU path, and the wrappers' checks.  No jax
here: this file also runs on a GPU host without jax, with ``python -m
pytest --noconftest -m cuda tests/test_torch_kernel.py`` (the repo's
conftest imports jax)."""

import numpy as np
import pytest
import torch

from bpmf_tpu_torch.ops import dense8 as d8
from bpmf_tpu_torch.ops import pallas_solve as ps
from bpmf_tpu_torch.ops.dense8 import (
    dense8_sweep_solve,
    dense8_sweep_solve_ref,
)
from bpmf_tpu_torch.ops.pallas_solve import (
    chol_solve_sample_pallas_blast as BLAST,
    chol_solve_sample_pallas_blast_ref,
)
from bpmf_tpu_torch.sampler import HostDraws

torch.set_num_threads(1)

CS, CB, ALPHA = 2.0, -7.2, 2.0


def pack_tight(full, k):
    """[B, K, K] symmetric -> [T_tight, B] tight packed lower triangle,
    batch-last, padding rows zero: the layout the Gram kernels write."""
    ii, jj, _ = ps.tri_tight_pairs(k)
    tv = k * (k + 1) // 2
    out = np.zeros((len(ii), full.shape[0]), full.dtype)
    out[:tv] = full[:, ii[:tv], jj[:tv]].T
    return out


# int16 codes (128-255 levels) at a scale that keeps each rating's weight
# cs*code + cb near the int8 tests' range
CS16 = CS / 64


def _inputs(r, c, k, orientation, seed, density=0.1, code_dtype="int8",
            code_range=None):
    """One half-sweep's operands as numpy: codes at ``density`` drawn from
    ``code_range`` (1..5 for int8, 1..255 for int16 by default; any value
    but 0 is a rating), a random SPD prior, noise."""
    rng = np.random.default_rng(seed)
    lo, hi = code_range or ((1, 5) if code_dtype == "int8" else (1, 255))
    codes = np.where(rng.random((r, c)) < density,
                     rng.integers(lo, hi + 1, size=(r, c)), 0).astype(code_dtype)
    items, frozen = (r, c) if orientation == "rows" else (c, r)
    v_t = (0.5 * rng.normal(size=(k, frozen))).astype(np.float32)
    w = rng.normal(size=(k, k))
    lam = (w @ w.T / k + np.eye(k)).astype(np.float32)
    prior_rhs = rng.normal(size=(k, 1)).astype(np.float32)
    noise_t = rng.normal(size=(k, items)).astype(np.float32)
    return codes, v_t, lam, prior_rhs, noise_t


def test_wrapper_refuses_bad_input():
    args = [torch.from_numpy(a) for a in _inputs(512, 512, 16, "rows", 0)]
    with pytest.raises(ValueError, match="int8 or int16, got torch.int32"):
        dense8_sweep_solve(args[0].to(torch.int32), None, *args[1:], CS, CB,
                           ALPHA, "rows")
    with pytest.raises(ValueError, match="multiples of 512"):
        dense8_sweep_solve(args[0][:256], None, *args[1:], CS, CB, ALPHA, "rows")
    with pytest.raises(ValueError, match="noise_t"):
        dense8_sweep_solve(args[0], None, *args[1:4], args[4][:, :8], CS, CB,
                           ALPHA, "rows")
    p_t = d8.packed_tri_t(args[1])            # tight rows, layout aligned
    with pytest.raises(ValueError, match="p_t has shape"):
        dense8_sweep_solve(args[0], p_t, *args[1:], CS, CB, ALPHA, "rows")
    with pytest.raises(ValueError, match="layout"):
        dense8_sweep_solve(args[0], p_t, *args[1:], CS, CB, ALPHA, "rows",
                           layout="grouped")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16, 32])
@pytest.mark.parametrize("orientation", ["rows", "cols"])
def test_kernel_matches_plain_on_card(cuda, k, orientation):
    """f32 with another summation order, amplified by the Cholesky: 1e-3."""
    args = [torch.from_numpy(a).to(cuda)
            for a in _inputs(1024, 1536, k, orientation, seed=3, density=0.05)]
    launches = d8.sweep_launches["inkernel"]
    got = dense8_sweep_solve(args[0], None, *args[1:], CS, CB, ALPHA, orientation)
    torch.cuda.synchronize()
    assert d8.sweep_launches["inkernel"] == launches + 1
    want = dense8_sweep_solve_ref(args[0], None, *args[1:], CS, CB, ALPHA,
                                  orientation)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16, 32])
@pytest.mark.parametrize("orientation", ["rows", "cols"])
@pytest.mark.parametrize("layout", ["tight", "aligned"])
@pytest.mark.parametrize("code_dtype", ["int8", "int16"])
def test_hoisted_kernel_matches_plain_on_card(cuda, k, orientation, layout,
                                              code_dtype):
    """#2 (the megakernel streaming a hoisted operand) against its plain
    version, int8 and int16 codes; NaN in the aligned layout's padding
    rows, which must not be read.  f32 in another summation order, through
    the Cholesky: 1e-3."""
    cs = CS if code_dtype == "int8" else CS16
    args = [torch.from_numpy(a).to(cuda)
            for a in _inputs(1024, 1536, k, orientation, seed=5, density=0.05,
                             code_dtype=code_dtype)]
    p_t = d8.packed_tri_t(args[1], aligned=layout == "aligned")
    rows = torch.as_tensor(d8._layout_rows(k, layout)[0], device=cuda)
    pad = torch.ones(p_t.shape[0], dtype=torch.bool, device=cuda)
    pad[rows] = False
    p_nan = p_t.clone()
    p_nan[pad] = float("nan")
    launches = dict(d8.sweep_launches)
    got = dense8_sweep_solve(args[0], p_nan, *args[1:], cs, CB, ALPHA,
                             orientation, layout=layout)
    torch.cuda.synchronize()
    assert d8.sweep_launches[layout] == launches[layout] + 1
    want = dense8_sweep_solve_ref(args[0], p_t, *args[1:], cs, CB, ALPHA,
                                  orientation, layout)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
def test_kernel_refuses_unbuilt_k(cuda):
    """The kernel takes the JAX package's megakernel gate and no more: K=42
    for #1 (K <= 41) and K=40 with an aligned p_t (K <= 39) are refused,
    naming K; K=41 with a tight p_t runs."""
    args = [torch.from_numpy(a).to(cuda) for a in _inputs(512, 512, 42, "rows", 0)]
    with pytest.raises(ValueError, match="K=42"):
        dense8_sweep_solve(args[0], None, *args[1:], CS, CB, ALPHA, "rows")
    args = [torch.from_numpy(a).to(cuda) for a in _inputs(512, 512, 40, "rows", 0)]
    p_t = d8.packed_tri_t(args[1], aligned=True)
    with pytest.raises(ValueError, match="K=40 with a p_t in the aligned"):
        dense8_sweep_solve(args[0], p_t, *args[1:], CS, CB, ALPHA, "rows",
                           layout="aligned")
    args = [torch.from_numpy(a).to(cuda) for a in _inputs(512, 512, 41, "rows", 0)]
    got = dense8_sweep_solve(args[0], d8.packed_tri_t(args[1]), *args[1:], CS, CB,
                             ALPHA, "rows", layout="tight")
    assert tuple(got.shape) == (41, 512) and torch.isfinite(got).all()


@pytest.mark.cuda
@pytest.mark.parametrize("k,layout", [(10, "tight"), (24, "tight"), (36, "tight"),
                                      (40, "tight"), (41, "tight"),
                                      (10, "aligned"), (39, "aligned")])
@pytest.mark.parametrize("orientation", ["rows", "cols"])
@pytest.mark.parametrize("code_dtype", ["int8", "int16"])
def test_hoisted_runtime_k_matches_plain_on_card(cuda, k, layout, orientation,
                                                 code_dtype):
    """#2 at a K of its own (not 16 or 32), run on the next capacity with a
    runtime K and row map: against its plain version at 1e-3, NaN in the
    layout's padding rows (never read), the launch counted on its
    instance."""
    cs = CS if code_dtype == "int8" else CS16
    args = [torch.from_numpy(a).to(cuda)
            for a in _inputs(1024, 1536, k, orientation, seed=k + 11,
                             density=0.05, code_dtype=code_dtype)]
    p_t = d8.packed_tri_t(args[1], aligned=layout == "aligned")
    pad = torch.ones(p_t.shape[0], dtype=torch.bool, device=cuda)
    pad[torch.as_tensor(d8._layout_rows(k, layout)[0], device=cuda)] = False
    assert pad.any()
    p_nan = p_t.clone()
    p_nan[pad] = float("nan")
    key = d8.sweep_instance_key(k, layout)
    assert key.startswith(f"{layout}_c")
    before = d8.sweep_instance_launches.get(key, 0)
    got = dense8_sweep_solve(args[0], p_nan, *args[1:], cs, CB, ALPHA,
                             orientation, layout=layout)
    torch.cuda.synchronize()
    assert d8.sweep_instance_launches[key] == before + 1
    want = dense8_sweep_solve_ref(args[0], p_t, *args[1:], cs, CB, ALPHA,
                                  orientation, layout)
    assert tuple(got.shape) == (k, args[4].shape[1])
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
    assert torch.equal(got, dense8_sweep_solve(args[0], p_nan, *args[1:], cs, CB,
                                               ALPHA, orientation, layout=layout))


@pytest.mark.cuda
@pytest.mark.parametrize("k,code_dtype", [(8, "int8"), (10, "int8"),
                                          (24, "int8"), (16, "int16"),
                                          (32, "int16"), (33, "int8"),
                                          (40, "int8"), (41, "int8"),
                                          (40, "int16")])
@pytest.mark.parametrize("orientation", ["rows", "cols"])
def test_kernel_capacities_and_int16_on_card(cuda, k, code_dtype, orientation):
    """#1 at every capacity (8, 24, and 40, 44: K 33-41, two rows a lane), K=10
    on the capacity 16 (the system padded block-diagonally), and int16
    codes 1..255: against the plain version at 1e-3."""
    cs = CS if code_dtype == "int8" else CS16
    args = [torch.from_numpy(a).to(cuda)
            for a in _inputs(1024, 1536, k, orientation, seed=k + 1,
                             density=0.05, code_dtype=code_dtype)]
    launches = d8.sweep_launches["inkernel"]
    got = dense8_sweep_solve(args[0], None, *args[1:], cs, CB, ALPHA, orientation)
    torch.cuda.synchronize()
    assert d8.sweep_launches["inkernel"] == launches + 1
    assert tuple(got.shape) == (k, args[4].shape[1])
    want = dense8_sweep_solve_ref(args[0], None, *args[1:], cs, CB, ALPHA,
                                  orientation)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("orientation", ["rows", "cols"])
def test_int16_codes_out_of_range_on_card(cuda, orientation):
    """Every int16 value is decoded whole, as the TPU kernels' astype does:
    codes from -32768 to 32767 (0 absent), rating weights cs*code + cb,
    through #1, #2 (both layouts), #3 and #4, against the plain versions
    at 1e-3."""
    cs = CS / 2 ** 14
    args = [torch.from_numpy(a).to(cuda)
            for a in _inputs(1024, 1536, 16, orientation, seed=9, density=0.05,
                             code_dtype="int16", code_range=(-32768, 32767))]
    codes, v_t = args[:2]
    assert int(codes.min()) < -255 and int(codes.max()) > 255
    before = _launches()
    for p_t, layout in ((None, "aligned"), (d8.packed_tri_t(v_t), "tight"),
                        (d8.packed_tri_t(v_t, aligned=True), "aligned")):
        got = dense8_sweep_solve(codes, p_t, *args[1:], cs, CB, ALPHA,
                                 orientation, layout=layout)
        want = dense8_sweep_solve_ref(codes, p_t, *args[1:], cs, CB, ALPHA,
                                      orientation, layout)
        torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
    fn = d8.dense8_gram_rhs_rows if orientation == "rows" else d8.dense8_gram_rhs_cols
    for p_t in (None, d8.packed_tri_t(v_t)):
        got = fn(codes, p_t, v_t, cs, CB)
        want = d8.dense8_gram_rhs_ref(codes, p_t, v_t, cs, CB, orientation)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-3)
    torch.cuda.synchronize()
    n = {key: c - before[key] for key, c in _launches().items() if c - before[key]}
    assert n == {"fused_inkernel": 1, "fused_tight": 1, "fused_aligned": 1,
                 "gram_inkernel": 1, "gram_hoisted": 1}, n


def _skewed_inputs(items, frozen, k, orientation, seed, code_dtype="int8"):
    """One half-sweep's operands with skewed degrees, as numpy: item 5 has
    every frozen entry rated, items 17, 300 and 701 half of them, every
    other item 1-4% (its own density); codes 1..5 (int8) or 1..255
    (int16)."""
    rng = np.random.default_rng(seed)
    hi = 5 if code_dtype == "int8" else 255
    density = rng.uniform(0.01, 0.04, size=(items, 1))
    density[[17, 300, 701]] = 0.5
    density[5] = 1.0
    x = np.where(rng.random((items, frozen)) < density,
                 rng.integers(1, hi + 1, size=(items, frozen)), 0).astype(code_dtype)
    codes = x if orientation == "rows" else np.ascontiguousarray(x.T)
    v_t = (0.5 * rng.normal(size=(k, frozen))).astype(np.float32)
    w = rng.normal(size=(k, k))
    lam = (w @ w.T / k + np.eye(k)).astype(np.float32)
    prior_rhs = rng.normal(size=(k, 1)).astype(np.float32)
    noise_t = rng.normal(size=(k, items)).astype(np.float32)
    return codes, v_t, lam, prior_rhs, noise_t


def _forced_plan(segments):
    """A substitute for ``ops.dense8.sweep_plan`` that splits the frozen
    axis into ``segments`` runs of whole tiles."""
    def plan(items, frozen, k, max_degree=None, sms=132):
        tiles = frozen // d8.BLOCK_MULTIPLE
        per = -(-tiles // segments)
        s = -(-tiles // per)
        if s == 1:
            return d8.SweepPlan(1, tiles, (), 0)
        return d8.SweepPlan(s, per, (s, items, k * (k + 1) // 2 + k),
                            items // d8.ITEMS_PER_BLOCK)
    return plan


def _check_segments(call, want, frozen, monkeypatch):
    """``call()`` (the megakernel) against ``want`` (its plain version) at
    1e-3, with S = 1, the wrapper's own S and S = 8 segments of the frozen
    axis; the same to 1e-3 across S; and three launches of the split
    kernel bitwise equal (the arrival counters reset, the partials summed
    in one order)."""
    assert frozen // d8.BLOCK_MULTIPLE >= 8
    real = d8.sweep_plan
    monkeypatch.setattr(d8, "sweep_plan", _forced_plan(1))
    one = call()
    torch.testing.assert_close(one, want, rtol=1e-3, atol=1e-3)
    for plan in (real, _forced_plan(8)):
        monkeypatch.setattr(d8, "sweep_plan", plan)
        assert plan(1024, frozen, 32, frozen).segments > 1
        got = [call() for _ in range(3)]
        torch.cuda.synchronize()
        assert torch.isfinite(got[0]).all()
        torch.testing.assert_close(got[0], want, rtol=1e-3, atol=1e-3)
        torch.testing.assert_close(got[0], one, rtol=1e-3, atol=1e-3)
        assert torch.equal(got[0], got[1]) and torch.equal(got[1], got[2])


@pytest.mark.cuda
@pytest.mark.parametrize("k", [10, 24, 32, 40])
@pytest.mark.parametrize("orientation", ["rows", "cols"])
@pytest.mark.parametrize("code_dtype", ["int8", "int16"])
def test_kernel_skewed_segments_on_card(cuda, k, orientation, code_dtype,
                                        monkeypatch):
    """#1 on skewed codes (one item with every frozen entry rated), at
    every capacity (K=10 on 16, 24, 32, K=40 on 40), split over S
    segments: against the plain version at 1e-3, S = 1 against S > 1 at
    1e-3, repeated launches bitwise equal."""
    cs = CS if code_dtype == "int8" else CS16
    args = [torch.from_numpy(a).to(cuda)
            for a in _skewed_inputs(1024, 4096, k, orientation, seed=k,
                                    code_dtype=code_dtype)]
    want = dense8_sweep_solve_ref(args[0], None, *args[1:], cs, CB, ALPHA,
                                  orientation)
    launches = d8.sweep_launches["inkernel"]
    _check_segments(
        lambda: dense8_sweep_solve(args[0], None, *args[1:], cs, CB, ALPHA,
                                   orientation, max_degree=4096),
        want, 4096, monkeypatch)
    assert d8.sweep_launches["inkernel"] == launches + 7


@pytest.mark.cuda
@pytest.mark.parametrize("orientation", ["rows", "cols"])
@pytest.mark.parametrize("layout", ["tight", "aligned"])
@pytest.mark.parametrize("code_dtype", ["int8", "int16"])
@pytest.mark.parametrize("k", [32, 40])
def test_hoisted_kernel_skewed_segments_on_card(cuda, orientation, layout,
                                                code_dtype, k, monkeypatch):
    """#2 on skewed codes, K=32 (its own instance) and K=40 (39 aligned: the
    capacity 40 with a runtime K), NaN in the layout's padding rows (never
    read), split over S segments: as the test above."""
    if layout == "aligned" and k == 40:
        k = 39  # the JAX package's aligned gate
    cs = CS if code_dtype == "int8" else CS16
    args = [torch.from_numpy(a).to(cuda)
            for a in _skewed_inputs(1024, 4096, k, orientation, seed=7,
                                    code_dtype=code_dtype)]
    p_t = d8.packed_tri_t(args[1], aligned=layout == "aligned")
    pad = torch.ones(p_t.shape[0], dtype=torch.bool, device=cuda)
    pad[torch.as_tensor(d8._layout_rows(k, layout)[0], device=cuda)] = False
    p_nan = p_t.clone()
    p_nan[pad] = float("nan")
    want = dense8_sweep_solve_ref(args[0], p_t, *args[1:], cs, CB, ALPHA,
                                  orientation, layout)
    launches = dict(d8.sweep_launches)
    _check_segments(
        lambda: dense8_sweep_solve(args[0], p_nan, *args[1:], cs, CB, ALPHA,
                                   orientation, layout=layout, max_degree=4096),
        want, 4096, monkeypatch)
    assert d8.sweep_launches[layout] == launches[layout] + 7


@pytest.mark.cuda
def test_chain_on_card_matches_cpu(cuda):
    """Three Gibbs iterations through the kernel on the card against the
    plain PyTorch path on the CPU, with the same draws: f32 on both, other
    summation orders, so 1e-3."""
    import os

    from bpmf_tpu_torch import Config, synth_movielens
    from bpmf_tpu_torch.sampler import BPMF

    train, test = synth_movielens(n_users=300, n_movies=200, n_ratings=5000,
                                  seed=3)
    runs = {}
    for dev in (torch.device("cpu"), cuda):
        s = BPMF(Config(num_latent=32, nsims=3, burnin=1), train, test,
                 out=open(os.devnull, "w"), device=dev,
                 draws=HostDraws(42, dev))
        launches = d8.sweep_launches["inkernel"]
        runs[dev.type] = s.run_chunk(3)
        assert d8.sweep_launches["inkernel"] - launches == (
            6 if dev.type == "cuda" else 0)
    for got, want in zip(runs["cuda"], runs["cpu"]):
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("k,code_dtype", [(16, "int8"), (32, "int8"),
                                          (64, "int8"), (79, "int8"),
                                          (32, "int16"), (64, "int16")])
@pytest.mark.parametrize("orientation", ["rows", "cols"])
@pytest.mark.parametrize("pt", ["inkernel", "hoisted"])
def test_gram_kernel_matches_plain_on_card(cuda, k, code_dtype, orientation, pt):
    """Kernels #3 and #4 on int8 and int16 codes: f32 sums in another
    order, 1e-3."""
    cs = CS if code_dtype == "int8" else CS16
    codes, v_t = (torch.from_numpy(a).to(cuda) for a in
                  _inputs(1024, 1536, k, orientation, seed=k, density=0.05,
                          code_dtype=code_dtype)[:2])
    p_t = d8.packed_tri_t(v_t) if pt == "hoisted" else None
    fn = d8.dense8_gram_rhs_rows if orientation == "rows" else d8.dense8_gram_rhs_cols
    launches = d8.gram_launches[pt]
    got = fn(codes, p_t, v_t, cs, CB)
    torch.cuda.synchronize()
    assert d8.gram_launches[pt] == launches + 1
    want = d8.dense8_gram_rhs_ref(codes, p_t, v_t, cs, CB, orientation)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("k,operand", [(16, "inkernel"), (32, "inkernel"),
                                       (40, "inkernel"), (32, "tight"),
                                       (24, "tight"), (32, "aligned"),
                                       (39, "aligned"), (64, "gram_inkernel"),
                                       (79, "gram_inkernel"), (64, "gram_hoisted")])
@pytest.mark.parametrize("orientation", ["rows", "cols"])
def test_bf16_kernels_match_plain_on_card(cuda, k, operand, orientation):
    """#1-#4 on bf16 operands (their bf16 instances, counted apart from the
    float32 ones; cs and cb that bf16 does not hold) against their plain
    versions at 1e-3, twice bitwise equal."""
    bf = torch.bfloat16
    codes, v_t, lam, prior_rhs, noise_t = (
        torch.from_numpy(a).to(cuda)
        for a in _inputs(1024, 1536, k, orientation, seed=k + 5, density=0.05))
    v_b = v_t.to(bf)
    cs, cb = 0.7, -1.3
    before = (dict(d8.sweep_launches), dict(d8.gram_launches))
    if operand.startswith("gram"):
        p_t = d8.packed_tri_t(v_b.float()).to(bf) if operand == "gram_hoisted" else None
        fn = d8.dense8_gram_rhs_rows if orientation == "rows" else d8.dense8_gram_rhs_cols
        got, again = (fn(codes, p_t, v_b, cs, cb) for _ in range(2))
        want = d8.dense8_gram_rhs_ref(codes, p_t, v_b, cs, cb, orientation)
        key = operand.removeprefix("gram_")
        assert d8.gram_launches[key + "_bf16"] == before[1][key + "_bf16"] + 2
        assert d8.gram_launches[key] == before[1][key]
    else:
        p_t = (None if operand == "inkernel" else
               d8.packed_tri_t(v_b.float(), aligned=operand == "aligned").to(bf))
        layout = "aligned" if operand == "inkernel" else operand
        got, again = ((dense8_sweep_solve(codes, p_t, v_b, lam, prior_rhs, noise_t,
                                          cs, cb, ALPHA, orientation, layout=layout),)
                      for _ in range(2))
        want = (dense8_sweep_solve_ref(codes, p_t, v_b, lam, prior_rhs, noise_t,
                                       cs, cb, ALPHA, orientation, layout),)
        assert d8.sweep_launches[operand + "_bf16"] == before[0][operand + "_bf16"] + 2
        assert d8.sweep_launches[operand] == before[0][operand]
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-3)


def _mma_call(cuda, codes, p_t, v_b, orientation, cs, cb, pt, calls=2):
    """``calls`` launches of the tensor-core Gram (bf16 #3/#4) on one
    input: the results, each pair bitwise equal, and each launch counted
    under ``gram_launches[pt + "_bf16"]`` and nowhere else."""
    fn = d8.dense8_gram_rhs_rows if orientation == "rows" else d8.dense8_gram_rhs_cols
    before = dict(d8.gram_launches)
    got = [fn(codes, p_t, v_b, cs, cb) for _ in range(calls)]
    torch.cuda.synchronize()
    n = {key: c - before[key] for key, c in d8.gram_launches.items() if c != before[key]}
    assert n == {pt + "_bf16": calls}, n
    for again in got[1:]:
        assert all(torch.equal(g, a) for g, a in zip(got[0], again))
    return got[0]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [42, 48, 64, 65, 79])
@pytest.mark.parametrize("code_dtype", ["int8", "int16"])
@pytest.mark.parametrize("orientation", ["rows", "cols"])
@pytest.mark.parametrize("pt", ["inkernel", "hoisted"])
def test_gram_mma_matches_plain_on_card(cuda, k, code_dtype, orientation, pt):
    """The tensor-core Gram (``csrc/dense8_gram_mma.cu``: #3 and #4 on
    bf16 operands) at every K class of the split route (one and two rhs
    tiles, the last Gram tile partial), int8 and int16 codes, both
    orientations (the cols one reads A transposed), against its plain
    version at 1e-3 (exact products, f32 sums in another order); two
    launches bitwise equal.  At [1024, 1536] the plan takes S > 1."""
    bf = torch.bfloat16
    cs = 0.7 if code_dtype == "int8" else 0.7 / 64
    codes, v_t = (torch.from_numpy(a).to(cuda) for a in
                  _inputs(1024, 1536, k, orientation, seed=k + 11, density=0.05,
                          code_dtype=code_dtype)[:2])
    v_b = v_t.to(bf)
    p_t = d8.packed_tri_t(v_b.float()).to(bf) if pt == "hoisted" else None
    got = _mma_call(cuda, codes, p_t, v_b, orientation, cs, -1.3, pt)
    want = d8.dense8_gram_rhs_ref(codes, p_t, v_b, cs, -1.3, orientation)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [64, 79])
@pytest.mark.parametrize("orientation", ["rows", "cols"])
@pytest.mark.parametrize("pt", ["inkernel", "hoisted"])
def test_gram_mma_segments_on_card(cuda, k, orientation, pt, monkeypatch):
    """512 items over 32,768 frozen entries (chembl's proteins cut down):
    the plan's S > 1 segments and a forced S = 1 against the plain version
    at 1e-3 and each other; three launches of the split form bitwise
    equal (the arrival counters reset, the partials summed in order)."""
    bf = torch.bfloat16
    shape = (512, 32768) if orientation == "rows" else (32768, 512)
    codes, v_t = (torch.from_numpy(a).to(cuda) for a in
                  _inputs(*shape, k, orientation, seed=k + 13, density=0.03)[:2])
    v_b = (0.2 * v_t).to(bf)   # keeps sums of ~1000 products near 1
    p_t = d8.packed_tri_t(v_b.float()).to(bf) if pt == "hoisted" else None
    t = d8.tight_rows(k)
    assert d8.mma_plan(512, 32768, t, k).segments > 1
    want = d8.dense8_gram_rhs_ref(codes, p_t, v_b, 0.7, -1.3, orientation)
    split = _mma_call(cuda, codes, p_t, v_b, orientation, 0.7, -1.3, pt, calls=3)
    real = d8.mma_plan
    monkeypatch.setattr(d8, "mma_plan", lambda *a, **kw: real(*a, **kw)._replace(
        segments=1, chunks_per_segment=32768 // d8.MMA_CHUNK, scratch_shape=(),
        counters=0))
    one = _mma_call(cuda, codes, p_t, v_b, orientation, 0.7, -1.3, pt)
    for g, o, w in zip(split, one, want):
        torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-3)
        torch.testing.assert_close(o, w, rtol=1e-3, atol=1e-3)
        torch.testing.assert_close(g, o, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("k,t", [(65, 2148), (79, 3164)])
@pytest.mark.parametrize("orientation", ["rows", "cols"])
def test_gram_mma_odd_rows_on_card(cuda, k, t, orientation):
    """#4 on bf16 operands with a p_t of the tight layout's first T rows,
    T % 8 == 4 (its rows read in 8-byte pieces) and the last Gram tile
    partial; every row summed (at K=79 four (0, 0) padding rows too),
    against the plain version at 1e-3."""
    bf = torch.bfloat16
    codes, v_t = (torch.from_numpy(a).to(cuda) for a in
                  _inputs(1024, 1536, k, orientation, seed=k + 17, density=0.05)[:2])
    v_b = v_t.to(bf)
    assert t % 8 == 4 and t % d8.MMA_COLS and t >= k * (k + 1) // 2
    p_t = d8.packed_tri_t(v_b.float()).to(bf)[:t].t().contiguous().t()
    got = _mma_call(cuda, codes, p_t, v_b, orientation, 0.7, -1.3, "hoisted")
    want = d8.dense8_gram_rhs_ref(codes, p_t, v_b, 0.7, -1.3, orientation)
    assert got[0].shape == (t, codes.shape[0 if orientation == "rows" else 1])
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16, 64])
@pytest.mark.parametrize("orientation", ["rows", "cols"])
@pytest.mark.parametrize("pt", ["inkernel", "hoisted"])
def test_gram_kernel_heavy_items_on_card(cuda, k, orientation, pt):
    """Items with ~2000 rated entries each, more than the kernel holds in
    its list at a time (1024): it empties the list and goes on summing.
    Codes 1..5 at 50%; f32 sums in another order, 1e-3."""
    shape = (512, 4096) if orientation == "rows" else (4096, 512)
    codes, v_t = (torch.from_numpy(a).to(cuda) for a in
                  _inputs(*shape, k, orientation, seed=k + 7, density=0.5)[:2])
    v_t = 0.2 * v_t  # keeps sums of ~2000 products near 1
    x = codes if orientation == "rows" else codes.t()
    assert int((x != 0).sum(1).min()) > 1024
    p_t = d8.packed_tri_t(v_t) if pt == "hoisted" else None
    fn = d8.dense8_gram_rhs_rows if orientation == "rows" else d8.dense8_gram_rhs_cols
    launches = d8.gram_launches[pt]
    got = fn(codes, p_t, v_t, CS, CB)
    torch.cuda.synchronize()
    assert d8.gram_launches[pt] == launches + 1
    want = d8.dense8_gram_rhs_ref(codes, p_t, v_t, CS, CB, orientation)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16, 32, 64, 79])
@pytest.mark.parametrize("orientation", ["rows", "cols"])
@pytest.mark.parametrize("code_dtype", ["int8", "int16"])
def test_gram_kernel_skewed_segments_on_card(cuda, k, orientation, code_dtype,
                                             monkeypatch):
    """#3 on skewed codes (one item with every frozen entry rated, three at
    half), split over S segments of the frozen axis: S = 1, the wrapper's
    own S and S = 8 against the plain version at 1e-3 (f32 sums in another
    order), the same across S, and three launches bitwise equal (the
    arrival counters reset, the partials summed in one order)."""
    cs = CS if code_dtype == "int8" else CS16
    codes, v_t = (torch.from_numpy(a).to(cuda) for a in
                  _skewed_inputs(1024, 4096, k, orientation, seed=k + 3,
                                 code_dtype=code_dtype)[:2])
    v_t = 0.2 * v_t  # keeps sums of 4096 products near 1
    fn = d8.dense8_gram_rhs_rows if orientation == "rows" else d8.dense8_gram_rhs_cols
    want = d8.dense8_gram_rhs_ref(codes, None, v_t, cs, CB, orientation)

    def call():
        return fn(codes, None, v_t, cs, CB, max_degree=4096)

    def close(got, ref):
        for g, w in zip(got, ref):
            torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-3)

    launches = d8.gram_launches["inkernel"]
    real = d8.sweep_plan
    monkeypatch.setattr(d8, "sweep_plan", _forced_plan(1))
    one = call()
    close(one, want)
    for plan in (real, _forced_plan(8)):
        monkeypatch.setattr(d8, "sweep_plan", plan)
        assert plan(1024, 4096, k, 4096).segments > 1
        got = [call() for _ in range(3)]
        torch.cuda.synchronize()
        close(got[0], want)
        close(got[0], one)
        for again in got[1:]:
            assert all(torch.equal(g, a) for g, a in zip(got[0], again))
    assert d8.gram_launches["inkernel"] == launches + 7


def _forced_hoisted_plan(segments):
    """A substitute for ``ops.dense8.hoisted_plan`` that splits the frozen
    axis into ``segments`` runs of whole tiles."""
    def plan(items, frozen, t, k, max_degree=None, sms=132):
        tiles = frozen // d8.BLOCK_MULTIPLE
        per = -(-tiles // segments)
        s = -(-tiles // per)
        if s == 1:
            return d8.SweepPlan(1, tiles, (), 0)
        return d8.SweepPlan(s, per, (s, items, t + -(-k // 4) * 4),
                            items // d8.ITEMS_PER_BLOCK)
    return plan


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16, 32, 48, 64, 79])
@pytest.mark.parametrize("orientation", ["rows", "cols"])
@pytest.mark.parametrize("code_dtype", ["int8", "int16"])
def test_hoisted_gram_skewed_segments_on_card(cuda, k, orientation, code_dtype,
                                              monkeypatch):
    """#4 at every instance class (2, 5, 10, 17 and 26 float4 sums a lane)
    on skewed codes (one item with every frozen entry rated, three at
    half), split over S segments of the frozen axis: S = 1, the wrapper's
    own S and S = 8 against the plain version at 1e-3 (f32 sums in another
    order), the same across S, and three launches bitwise equal (the
    arrival counters reset, the partials summed in one order)."""
    cs = CS if code_dtype == "int8" else CS16
    codes, v_t = (torch.from_numpy(a).to(cuda) for a in
                  _skewed_inputs(1024, 4096, k, orientation, seed=k + 5,
                                 code_dtype=code_dtype)[:2])
    v_t = 0.2 * v_t  # keeps sums of 4096 products near 1
    p_t = d8.packed_tri_t(v_t)
    fn = d8.dense8_gram_rhs_rows if orientation == "rows" else d8.dense8_gram_rhs_cols
    want = d8.dense8_gram_rhs_ref(codes, p_t, v_t, cs, CB, orientation)

    def call():
        return fn(codes, p_t, v_t, cs, CB, max_degree=4096)

    def close(got, ref):
        for g, w in zip(got, ref):
            torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-3)

    launches = d8.gram_launches["hoisted"]
    real = d8.hoisted_plan
    monkeypatch.setattr(d8, "hoisted_plan", _forced_hoisted_plan(1))
    one = call()
    close(one, want)
    for plan in (real, _forced_hoisted_plan(8)):
        monkeypatch.setattr(d8, "hoisted_plan", plan)
        assert plan(1024, 4096, p_t.shape[0], k, 4096).segments > 1
        got = [call() for _ in range(3)]
        torch.cuda.synchronize()
        close(got[0], want)
        close(got[0], one)
        for again in got[1:]:
            assert all(torch.equal(g, a) for g, a in zip(got[0], again))
    assert d8.gram_launches["hoisted"] == launches + 7


def _solve_inputs(k, b, seed, grouped=False):
    """A tight packed Gram from random rated rows (NaN in its padding rows,
    which must not be read), a shared and a per-item SPD prior (aligned
    layout, top-aligned with ``grouped``), rhs and noise, on the host."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, 30, k)) / np.sqrt(30)
    gram = pack_tight(x.transpose(0, 2, 1) @ x, k)
    gram[k * (k + 1) // 2:] = np.nan
    w = rng.normal(size=(k, k))
    lam = w @ w.T / k + np.eye(k)
    wb = rng.normal(size=(b, k, k))
    lam_tri = ps.pack_prior_tri(wb @ wb.transpose(0, 2, 1) / k + np.eye(k), k,
                                grouped=grouped)
    rhs, noise = rng.normal(size=(2, k, b))
    return [torch.from_numpy(a.astype(np.float32))
            for a in (gram, lam, rhs, noise, lam_tri)]


def _strided(x, layout):
    """[rows, B] ``x`` in another memory layout, same values: 'batch-last'
    (row-major), 'item-major' (the transposed view of a row-major [B, rows]
    tensor, as the Gram kernel writes), or 'strided' (every other row of a
    wider NaN-filled tensor's view, off any 16-byte run)."""
    if layout == "batch-last":
        return x.contiguous()
    if layout == "item-major":
        return x.t().contiguous().t()
    wide = torch.full((x.shape[1], 2 * x.shape[0] + 1), float("nan"),
                      device=x.device)
    wide[:, 1::2] = x.t()
    return wide[:, 1::2].t()


# K of the register solve (8, 31 padded to 32, 32, 33 padded to 48, 64) and
# of the panels (79; 74 is the per-item prior's gate), shared and
# per-item prior, grouped at K % 8 == 0
SOLVE_CASES = ([(k, False, False) for k in (8, 31, 32, 33, 64, 79)]
               + [(k, True, False) for k in (8, 31, 32, 33, 64, 74)]
               + [(k, p, True) for k in (8, 32, 64) for p in (False, True)])


@pytest.mark.cuda
@pytest.mark.parametrize("k,peritem,grouped", SOLVE_CASES)
@pytest.mark.parametrize("layout", ["batch-last", "item-major", "strided"])
def test_solve_kernel_cases_on_card(cuda, k, peritem, grouped, layout):
    """#5/#6/#7 against the plain version at 1e-3 (another factorization
    order) for every instance, both priors and layouts of the Gram and of
    the per-item prior (the Gram kernel's item-major, fused dense's
    batch-last, and non-contiguous strides, rhs and noise too); B = 700
    leaves the last block ragged; two launches bitwise equal."""
    gram, lam, rhs, noise, lam_tri = (
        t.to(cuda) for t in _solve_inputs(k, 700, k + 11, grouped))
    gram, rhs, noise, lam_tri = (_strided(t, layout)
                                 for t in (gram, rhs, noise, lam_tri))
    lt = lam_tri if peritem else None
    key = ("peritem" if peritem else "shared") + ("_grouped" if grouped else "")
    launches = ps.solve_launches[key]
    got = ps.tri_combine_solve_sample(gram, lam, rhs, noise, ALPHA, lam_tri_t=lt,
                                      grouped=grouped)
    again = ps.tri_combine_solve_sample(gram, lam, rhs, noise, ALPHA,
                                        lam_tri_t=lt, grouped=grouped)
    torch.cuda.synchronize()
    assert ps.solve_launches[key] == launches + 2
    assert tuple(got.shape) == (k, 700) and torch.equal(got, again)
    want = ps.tri_combine_solve_sample_ref(gram, lam, rhs, noise, ALPHA, lt,
                                           grouped)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("k,peritem", [
    (16, False), (16, True), (32, False), (32, True), (64, False), (64, True),
    (79, False), (74, True),  # the dense8 gates
])
def test_solve_kernel_matches_plain_on_card(cuda, k, peritem):
    """Kernels #5 and #6: another factorization order, 1e-3."""
    gram, lam, rhs, noise, lam_tri = (t.to(cuda) for t in _solve_inputs(k, 700, k))
    lt = lam_tri if peritem else None
    key = "peritem" if peritem else "shared"
    launches = ps.solve_launches[key]
    got = ps.tri_combine_solve_sample(gram, lam, rhs, noise, ALPHA, lam_tri_t=lt)
    torch.cuda.synchronize()
    assert ps.solve_launches[key] == launches + 1
    want = ps.tri_combine_solve_sample_ref(gram, lam, rhs, noise, ALPHA, lt)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)


def _launches():
    """Every kernel wrapper's launch count, by name."""
    return {**{f"fused_{n}": c for n, c in d8.sweep_launches.items()},
            **{f"gram_{n}": c for n, c in d8.gram_launches.items()},
            **{("" if n == "blast" else "solve_") + n: c
               for n, c in ps.solve_launches.items()}}


def wide_grid(train, test, seed=0):
    """The ratings moved to a 1/32 grid with about 200 levels (the codes
    then int16): each rating plus a seeded whole number of 32nds in
    [-40, 40)."""
    for m, s in ((train, seed), (test, seed + 1)):
        m.data = m.data + np.random.default_rng(s).integers(-40, 40, m.nnz) / 32
    return train, test


def _card_vs_cpu(cuda, k, offgrid=False, wide=False, **cfg_kw):
    """Three iterations on the card and on the CPU with the same draws;
    returns the launches of each kernel that launched on the card.  ``offgrid`` moves
    the ratings off their grid (uniform +-0.25 from a seed), ``wide`` onto
    a grid of about 200 levels (:func:`wide_grid`)."""
    import os

    from bpmf_tpu_torch import Config, synth_movielens
    from bpmf_tpu_torch.sampler import BPMF

    train, test = synth_movielens(n_users=300, n_movies=200, n_ratings=5000,
                                  seed=3)
    if offgrid:
        train.data = train.data + np.random.default_rng(1).uniform(
            -0.25, 0.25, train.nnz)
    if wide:
        wide_grid(train, test)
    runs, counts = {}, {}
    for dev in (torch.device("cpu"), cuda):
        s = BPMF(Config(num_latent=k, nsims=3, burnin=1, **cfg_kw), train,
                 test, out=open(os.devnull, "w"), device=dev,
                 draws=HostDraws(42, dev))
        before = _launches()
        runs[dev.type] = s.run_chunk(3)
        if wide:
            assert s._codes.dtype == torch.int16
        counts[dev.type] = {n: c - before[n] for n, c in _launches().items()
                            if c - before[n]}
    assert not counts["cpu"]
    for got, want in zip(runs["cuda"], runs["cpu"]):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    return counts["cuda"]


@pytest.mark.cuda
def test_k64_chain_on_card_matches_cpu(cuda):
    counts = _card_vs_cpu(cuda, 64)
    assert counts == {"gram_inkernel": 6, "solve_shared": 6}


@pytest.mark.cuda
@pytest.mark.parametrize("strict", [True, False])
def test_prop_chain_on_card_matches_cpu(cuda, tmp_path, strict):
    """-l on the users at K=32: users through #3 and #6, movies through #1."""
    from bpmf_tpu_torch import write_matrix

    k, num = 32, 300
    rng = np.random.default_rng(0)
    w = rng.normal(size=(num, k, k))
    lam = w @ w.transpose(0, 2, 1) / k + 2.0 * np.eye(k)
    mu_f, lam_f = str(tmp_path / "mu.ddm"), str(tmp_path / "lam.ddm")
    write_matrix(mu_f, 0.1 * rng.normal(size=(k, num)))
    write_matrix(lam_f, lam.transpose(1, 2, 0).reshape(k * k, num, order="F"))
    counts = _card_vs_cpu(cuda, k, prop_u=f"{mu_f},{lam_f}",
                          strict_reference=strict)
    assert counts == {"fused_inkernel": 3, "gram_inkernel": 3, "solve_peritem": 3}


@pytest.mark.cuda
def test_k10_runs_on_card(cuda):
    """K=10 (the Julia reference's default) takes the megakernel, on its
    capacity 16."""
    counts = _card_vs_cpu(cuda, 10)
    assert counts == {"fused_inkernel": 6}


@pytest.mark.cuda
@pytest.mark.parametrize("k,knob,want", [
    (16, {}, {"fused_inkernel": 6}),
    (10, {}, {"fused_inkernel": 6}),
    (32, {"BPMF_D8_PT": "hoisted"}, {"fused_tight": 6}),
    (64, {}, {"gram_inkernel": 6, "solve_shared": 6}),
    (64, {"BPMF_D8_PT": "hoisted"}, {"gram_hoisted": 6, "solve_shared": 6}),
])
def test_int16_chain_on_card_matches_cpu(cuda, k, knob, want, monkeypatch):
    """About 200 rating levels (int16 codes) through #1, #2 and the split
    Gram kernels #3/#4, three iterations against the CPU path."""
    for name, value in knob.items():
        monkeypatch.setenv(name, value)
    assert _card_vs_cpu(cuda, k, wide=True) == want


def spd_systems(b, k, seed, device="cpu"):
    """Random SPD precisions W W'/K + I [B, K, K] (NaN above the diagonal,
    which must not be read), rhs and noise [B, K], float32."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(b, k, k))
    a = w @ w.transpose(0, 2, 1) / k + np.eye(k)
    a[:, np.triu_indices(k, 1)[0], np.triu_indices(k, 1)[1]] = np.nan
    rhs, noise = rng.normal(size=(2, b, k))
    return [torch.from_numpy(x.astype(np.float32)).to(device)
            for x in (a, rhs, noise)]


def test_blast_wrapper_refuses_bad_input():
    a, rhs, noise = spd_systems(4, 8, 0)
    with pytest.raises(ValueError, match="rhs"):
        BLAST(a, rhs[:, :4], noise)
    with pytest.raises(ValueError, match="noise"):
        BLAST(a, rhs, noise.double())


def test_blast_beyond_gate_runs_vpu():
    """K=107 is past the kernel's gate (106): the vpu chain runs, on any
    device, as in the JAX function; nothing launches."""
    a, rhs, noise = spd_systems(3, 107, 1)
    a = torch.tril(torch.nan_to_num(a))
    launches = ps.solve_launches["blast"]
    got = BLAST(a, rhs, noise)
    assert ps.solve_launches["blast"] == launches
    full = (a + a.mT - torch.diag_embed(a.diagonal(dim1=1, dim2=2))).double()
    chol = torch.linalg.cholesky(full)
    y = torch.linalg.solve_triangular(chol, rhs.double()[..., None], upper=False)
    want = torch.linalg.solve_triangular(chol.mT, y + noise.double()[..., None],
                                         upper=True)[..., 0]
    torch.testing.assert_close(got.double(), want, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 8, 16, 31, 32, 33, 63, 64, 65, 79, 80, 96, 106])
def test_blast_kernel_matches_plain_on_card(cuda, k):
    """Kernel #8 at every instance class and its edges (the register solve
    at capacities 8-64, the panels at three and four rows a lane) against
    its plain version on random SPD systems, upper triangle NaN, at 1e-3
    (another factorization order); B = 701 leaves the last block ragged at
    8 and at 4 items a block; item 7 negative definite draws NaN as in the
    plain version, every other item finite and bitwise as without it; two
    launches bitwise equal."""
    a, rhs, noise = spd_systems(701, k, k + 40, cuda)
    bad = a.clone()
    bad[7] = -bad[7]
    launches = ps.solve_launches["blast"]
    got, again, good = BLAST(bad, rhs, noise), BLAST(bad, rhs, noise), BLAST(a, rhs, noise)
    torch.cuda.synchronize()
    assert ps.solve_launches["blast"] == launches + 3
    assert torch.equal(torch.nan_to_num(got, 1.0), torch.nan_to_num(again, 1.0))
    want = chol_solve_sample_pallas_blast_ref(torch.tril(torch.nan_to_num(bad)),
                                              rhs, noise)
    keep = torch.arange(701, device=cuda) != 7
    assert torch.isnan(got[7]).all() and torch.isnan(want[7]).all()
    assert torch.isfinite(good).all() and torch.equal(got[keep], good[keep])
    torch.testing.assert_close(got[keep], want[keep], rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
def test_blast_instance_on_card(cuda):
    """The instance the kernel launches at each K of its gate is the one
    ops.pallas_solve.blast_instance names."""
    import ctypes

    from bpmf_tpu_torch.ops._build import load

    fn = load("chol_solve_sample").bpmf_chol_solve_instance
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    out = (ctypes.c_int * 3)()
    for k in range(1, 107):
        assert fn(k, ctypes.addressof(out)) == 0
        assert tuple(out) == ps.blast_instance(k), k
    assert fn(107, ctypes.addressof(out)) != 0


@pytest.mark.cuda
def test_blast_kernel_refuses_float64(cuda):
    a, rhs, noise = (t.double() for t in spd_systems(8, 16, 2, cuda))
    with pytest.raises(ValueError, match="float32"):
        BLAST(a, rhs, noise)


@pytest.mark.cuda
def test_bucketed_chain_on_card_matches_cpu(cuda):
    """The bucketed route at K=32, split buckets included (max width 64):
    the Gram by torch ops, the solve through #8 twice per iteration."""
    counts = _card_vs_cpu(cuda, 32, gram_impl="bucketed", max_bucket_width=64)
    assert counts == {"blast": 6}


@pytest.mark.cuda
@pytest.mark.parametrize("fuse,k", [("auto", 32), ("off", 32), ("auto", 96)])
def test_dense_chain_on_card_matches_cpu(cuda, fuse, k):
    """Ratings off the grid: fused dense (#5) at K=32, plain dense (#8)
    with the fusion off and at K=96, past the dense8 gate."""
    counts = _card_vs_cpu(cuda, k, offgrid=k == 32, fuse_dense=fuse)
    key = "solve_shared" if fuse == "auto" and k == 32 else "blast"
    assert counts == {key: 6}, counts


@pytest.mark.cuda
@pytest.mark.parametrize("knob,want", [
    ({"BPMF_D8_PT": "hoisted"}, {"fused_tight": 6}),
    ({"BPMF_D8_SOLVE": "fused_aligned"}, {"fused_aligned": 6}),
])
def test_hoisted_chain_on_card_matches_cpu(cuda, knob, want, monkeypatch):
    """K=32 with the knobs that send both sides to #2."""
    for name, value in knob.items():
        monkeypatch.setenv(name, value)
    assert _card_vs_cpu(cuda, 32) == want


@pytest.mark.cuda
@pytest.mark.parametrize("k,knob,want", [
    (40, {}, {"fused_inkernel": 6}),
    (33, {}, {"fused_inkernel": 6}),
    (40, {"BPMF_D8_PT": "hoisted"}, {"fused_tight": 6}),
    (24, {"BPMF_D8_PT": "hoisted"}, {"fused_tight": 6}),
    (39, {"BPMF_D8_SOLVE": "fused_aligned"}, {"fused_aligned": 6}),
    (10, {"BPMF_D8_SOLVE": "fused_aligned"}, {"fused_aligned": 6}),
    (40, {"BPMF_D8_SOLVE": "split"}, {"gram_inkernel": 6, "solve_shared": 6}),
])
def test_wide_chain_on_card_matches_cpu(cuda, k, knob, want, monkeypatch):
    """The megakernel at the K the JAX package fuses past 32 (#1 on the
    capacities 40 and 44) and #2 at K other than 16 and 32 (a runtime K), three
    iterations against the CPU path; K=40 under BPMF_D8_SOLVE=split keeps
    the split pipeline."""
    for name, value in knob.items():
        monkeypatch.setenv(name, value)
    assert _card_vs_cpu(cuda, k) == want


@pytest.mark.cuda
def test_chembl_k40_heavy_items_to_float64_on_card(cuda):
    """The chembl synth at K=40 (167,424 padded compounds x 512 proteins):
    the compounds on #2 (tight, runtime K on the capacity 40), the
    proteins on #1 (capacity 40, the most-rated with ~61k ratings over
    many segments).  After 5 iterations each side's solve on the chain's
    own codes and last state is held, item by item, to the float64 draw of
    the same system within SOLVE_BOUND (u * kappa_F(A) * |u|_2 + 1e-5): the
    proteins' systems are too ill-conditioned for two f32 orders to agree
    at a flat 1e-3."""
    import os

    from bpmf_tpu_torch import Config, synth_chembl
    from bpmf_tpu_torch.sampler import BPMF
    from chip_smoke import d8_system64, solve_vs_f64

    train, test = synth_chembl()
    s = BPMF(Config(num_latent=40, nsims=5, burnin=2), train, test,
             out=open(os.devnull, "w"), device=cuda)
    s.setup()
    assert (s.users.route, s.movies.route) == ("fused_hoisted", "fused")
    before = _launches()
    mets = s.run_chunk(5)
    assert np.isfinite(mets.rmse).all()
    n = {key: c - before[key] for key, c in _launches().items() if c - before[key]}
    assert n == {"fused_inkernel": 5, "fused_tight": 5}, n
    codes, cs, cb, alpha = s._codes, s._d8_cs, s._d8_cb, s.cfg.alpha
    for orientation, side, state, frozen in (
            ("rows", s.users, s.state_u, s.state_m),
            ("cols", s.movies, s.state_m, s.state_u)):
        hp = state.hp
        v_t = frozen.items.t()
        items = state.items.shape[0]
        noise_t = torch.randn((40, items), device=cuda,
                              generator=torch.Generator(cuda).manual_seed(1))
        prior_rhs = (hp.lambda_f @ hp.mu)[:, None]
        p_t = d8.packed_tri_t(v_t) if side.route == "fused_hoisted" else None
        got = dense8_sweep_solve(codes, p_t, v_t, hp.lambda_f, prior_rhs, noise_t,
                                 cs, cb, alpha, orientation, layout="tight",
                                 max_degree=side.max_degree)
        x = codes if orientation == "rows" else codes.t()
        f64 = torch.float64
        v64 = v_t.to(f64).t()
        rhs64 = (cs * (x.to(f64) @ v64) + cb * ((x != 0).to(f64) @ v64)
                 + prior_rhs.t().to(f64))
        worst, err, _ = solve_vs_f64(
            d8_system64(codes, v_t, hp.lambda_f, alpha, orientation), rhs64,
            noise_t.t(), [got.t()])
        assert worst[0] <= 1.0, (side.name, worst, err)


@pytest.mark.cuda
@pytest.mark.parametrize("case,want", [
    ("split_prop", {"fused_inkernel": 3, "gram_inkernel": 3, "solve_peritem_grouped": 3}),
    ("fused_dense", {"solve_shared_grouped": 6}),
])
def test_grouped_chain_on_card_matches_cpu(cuda, tmp_path, case, want,
                                           monkeypatch):
    """BPMF_TRI_GROUPED=1 at K=32: -l on the users (their prior packed
    top-aligned, #6's grouped variant), and ratings off the grid (fused
    dense, #5's)."""
    from bpmf_tpu_torch import write_matrix

    monkeypatch.setenv("BPMF_TRI_GROUPED", "1")
    kw = {}
    if case == "split_prop":
        k, num = 32, 300
        rng = np.random.default_rng(1)
        w = rng.normal(size=(num, k, k))
        lam = w @ w.transpose(0, 2, 1) / k + 2.0 * np.eye(k)
        mu_f, lam_f = str(tmp_path / "mu.ddm"), str(tmp_path / "lam.ddm")
        write_matrix(mu_f, 0.1 * rng.normal(size=(k, num)))
        write_matrix(lam_f, lam.transpose(1, 2, 0).reshape(k * k, num, order="F"))
        kw["prop_u"] = f"{mu_f},{lam_f}"
    assert _card_vs_cpu(cuda, 32, offgrid=case == "fused_dense", **kw) == want


@pytest.mark.cuda
@pytest.mark.parametrize("k,peritem", [(16, True), (32, False), (32, True)])
def test_grouped_solve_kernel_matches_plain_on_card(cuda, k, peritem):
    """#7: the per-item prior packed top-aligned (NaN in its padding rows);
    the shared prior reads no packed prior, so its grouped launch equals
    #5's."""
    gram, lam, rhs, noise, _ = (t.to(cuda) for t in _solve_inputs(k, 700, k))
    rng = np.random.default_rng(k)
    wb = rng.normal(size=(700, k, k))
    full = wb @ wb.transpose(0, 2, 1) / k + np.eye(k)
    lam_tri = torch.from_numpy(
        ps.pack_prior_tri(full, k, grouped=True).astype(np.float32)).to(cuda)
    live = torch.zeros(lam_tri.shape[0], dtype=torch.bool)
    live[torch.as_tensor(ps._tight_entries(k, True)[2])] = True
    lam_tri[~live.to(cuda)] = float("nan")
    lt = lam_tri if peritem else None
    key = ("peritem" if peritem else "shared") + "_grouped"
    launches = ps.solve_launches[key]
    got = ps.tri_combine_solve_sample(gram, lam, rhs, noise, ALPHA, lam_tri_t=lt,
                                      grouped=True)
    torch.cuda.synchronize()
    assert ps.solve_launches[key] == launches + 1
    want = ps.tri_combine_solve_sample_ref(gram, lam, rhs, noise, ALPHA, lt,
                                           grouped=True)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)


# -- the gather probes (Queue 2 #9) ---------------------------------------

PROBE_TOL = dict(rtol=1e-4, atol=1e-4)  # sums of up to 512 f32 terms, other order

def _probe_inputs(k, nv, r, w, seed=0, device="cpu"):
    from bpmf_tpu_torch.scripts import gather_probe as gp

    idx, table = gp.make_inputs(k=k, nv=nv, r=r, w=w, seed=seed)
    return torch.from_numpy(idx).to(device), torch.from_numpy(table).to(device)


def test_probe_wrappers_refuse_bad_input():
    """Each probe wrapper checks dtype, shape and contiguity before it picks
    the plain version or the kernel."""
    from bpmf_tpu_torch.scripts import gather_probe as gp

    idx, table = _probe_inputs(8, 64, 4, 6)
    for fn in (gp.gather_sum_rows, gp.gather_sum_lanes, gp.gather_sum_copy):
        with pytest.raises(ValueError, match="int32"):
            fn(idx.long(), table)
        with pytest.raises(ValueError, match="contiguous"):
            fn(idx.t(), table)
        with pytest.raises(ValueError, match="contiguous"):
            fn(idx, table[:, ::2])
        with pytest.raises(ValueError, match="float32"):
            fn(idx, table.double())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 32768, 512, 512), (32, 1000, 7, 45),
                                   (64, 500, 9, 33), (12, 300, 5, 70),
                                   (32, 32768, 8192, 512), (32, 81270, 64, 512),
                                   (32, 1000, 1, 1), (10, 1000, 7, 45),
                                   (32, 32768, 64, 2000), (64, 5000, 16, 1500),
                                   (6, 300, 5, 70)])
def test_probe_kernels_match_plain_on_card(cuda, shape):
    """#9 A, B and C against their plain versions: sums of W f32 terms in
    another order, PROBE_TOL.  A ragged W, K=64 (A: a half warp a row) and
    K=12 (A masks a lane of four; C copies 48-byte rows), R = 8192 (A at
    one warp a row), NV = 81,270 (B's k-row in two chunks, each off 16-byte
    alignment at odd k), one neighbour of one row, K=10 and K=6 (C's
    4-byte copies) and W = 2000 at K=32 and 1500 at K=64 (C's ring past
    the rows the earlier C held in shared memory)."""
    from bpmf_tpu_torch.scripts import gather_probe as gp

    k, nv, r, w = shape
    idx, table = _probe_inputs(k, nv, r, w, seed=k + w, device=cuda)
    table_t = table.t().contiguous()
    want = gp.gather_sum_ref(idx, table)
    for key, fn, t in (("A", gp.gather_sum_rows, table),
                       ("B", gp.gather_sum_lanes, table_t),
                       ("C", gp.gather_sum_copy, table)):
        before = gp.launches[key]
        got = fn(idx, t)
        torch.cuda.synchronize()
        assert gp.launches[key] == before + 1, key
        torch.testing.assert_close(got, want, **PROBE_TOL)
    torch.testing.assert_close(gp.gather_sum_lanes_ref(idx, table_t), want,
                               **PROBE_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4000, 300, 3, 5), (16, 300, 300, 3)])
def test_probe_copy_ring_matches_plain_on_card(cuda, shape):
    """#9C's ring against the plain version where only C splits the work
    so: K = 4000 (four slabs of up to 1024 columns) and W = 3 (a slot far
    from full, each block's rows on the same few slots)."""
    from bpmf_tpu_torch.scripts import gather_probe as gp

    k, nv, r, w = shape
    idx, table = _probe_inputs(k, nv, r, w, seed=k + w, device=cuda)
    before = gp.launches["C"]
    got = gp.gather_sum_copy(idx, table)
    torch.cuda.synchronize()
    assert gp.launches["C"] == before + 1
    torch.testing.assert_close(got, gp.gather_sum_ref(idx, table), **PROBE_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 32768, 512, 512), (32, 81270, 64, 512),
                                   (12, 300, 5, 70)])
def test_probe_kernels_repeat_bitwise_on_card(cuda, shape):
    """#9A, #9B and #9C add in a fixed order (no atomics): two launches give
    the same bits, on a 16-byte aligned table and on one a float off it
    (A's and C's 4-byte pieces; B's k-rows staged with a head and a tail),
    and agree with the plain version there too."""
    from bpmf_tpu_torch.scripts import gather_probe as gp

    k, nv, r, w = shape
    idx, table = _probe_inputs(k, nv, r, w, seed=7, device=cuda)
    want = gp.gather_sum_ref(idx, table)
    shifted = [torch.empty(table.numel() + 1, device=cuda)[1:] for _ in "AB"]
    for t, t_t in ((table, table.t().contiguous()),
                   (shifted[0].view(nv, k).copy_(table),
                    shifted[1].view(k, nv).copy_(table.t()))):
        for key, fn, arg in (("A", gp.gather_sum_rows, t),
                             ("B", gp.gather_sum_lanes, t_t),
                             ("C", gp.gather_sum_copy, t)):
            before = gp.launches[key]
            first, second = fn(idx, arg), fn(idx, arg)
            torch.cuda.synchronize()
            assert gp.launches[key] == before + 2, key
            assert torch.equal(first, second), key
            torch.testing.assert_close(first, want, **PROBE_TOL)


@pytest.mark.cuda
def test_probe_kernels_refuse_on_card(cuda):
    """A non-contiguous table is refused and nothing launches; kernel C
    takes a table off 16-byte alignment and a K of 6, as ``kernel_c``
    does (its 4-byte copies), launching once each and matching the plain
    version."""
    from bpmf_tpu_torch.scripts import gather_probe as gp

    idx, table = _probe_inputs(32, 256, 4, 8, device=cuda)
    before = dict(gp.launches)
    with pytest.raises(ValueError, match="contiguous"):
        gp.gather_sum_rows(idx, table[:, :16])
    assert gp.launches == before
    shifted = torch.empty(table.numel() + 1, device=cuda)[1:].view_as(table)
    shifted.copy_(table)
    narrow = table[:, :6].contiguous()
    for t in (shifted, narrow):
        before = gp.launches["C"]
        got = gp.gather_sum_copy(idx, t)
        torch.cuda.synchronize()
        assert gp.launches["C"] == before + 1
        torch.testing.assert_close(got, gp.gather_sum_ref(idx, t), **PROBE_TOL)


@pytest.mark.cuda
def test_probe_main_runs_on_card(cuda, capsys):
    """The probe's entry point at the JAX script's shapes: four lines, the
    three kernels launched N_STEPS times per chain (a warm-up and 3 timed)."""
    from bpmf_tpu_torch.scripts import gather_probe as gp

    before = dict(gp.launches)
    assert gp.main([]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 4 and all("M edges/s" in l for l in lines), lines
    assert {k: gp.launches[k] - before[k] for k in before} == dict.fromkeys(
        "ABC", 4 * gp.N_STEPS)


def _sweep_mma(codes, p_t, v_b, rest, cs, cb, orientation, layout, calls=3):
    """``calls`` launches of the tensor-core megakernel (#1/#2 on bf16
    operands) on one input, forced by the most walk work there can be
    (the cost models' choice there): the first result, every launch bitwise
    equal to it and counted under its instance (``sweep_mma_key``) and the
    bf16 operand's key, nowhere else."""
    k = v_b.shape[0]
    operand = "inkernel" if p_t is None else layout
    key = d8.sweep_mma_key(k, operand)
    before = (dict(d8.sweep_launches), dict(d8.sweep_instance_launches))
    got = [dense8_sweep_solve(codes, p_t, v_b, *rest, cs, cb, ALPHA, orientation,
                              layout=layout, walk_work=codes.numel())
           for _ in range(calls)]
    torch.cuda.synchronize()
    n = {key_: c - before[0][key_] for key_, c in d8.sweep_launches.items()
         if c != before[0][key_]}
    assert n == {operand + "_bf16": calls}, n
    assert d8.sweep_instance_launches[key] == before[1].get(key, 0) + calls
    for again in got[1:]:
        assert torch.equal(got[0], again)
    return got[0]


@pytest.mark.cuda
@pytest.mark.parametrize("codes_kind", ["random", "skewed", "zero"])
@pytest.mark.parametrize("k", [8, 16, 24, 32])
@pytest.mark.parametrize("code_dtype", ["int8", "int16"])
@pytest.mark.parametrize("orientation", ["rows", "cols"])
def test_sweep_mma_matches_plain_on_card(cuda, codes_kind, k, code_dtype, orientation):
    """#1 on bf16 operands through the tensor-core megakernel
    (``csrc/dense8_sweep_solve_mma.cu``) at every capacity, int8 and int16
    codes, both orientations, on random codes at 5%, skewed ones (an item
    with every frozen entry rated) and all-zero ones, against its plain
    version at 1e-3 (exact products, f32 sums in another order, then the
    Cholesky); three launches bitwise equal."""
    cs = 0.7 if code_dtype == "int8" else 0.7 / 64
    if codes_kind == "skewed":
        arrays = _skewed_inputs(1024, 1536, k, orientation, seed=k + 21,
                                code_dtype=code_dtype)
    else:
        arrays = _inputs(1024, 1536, k, orientation, seed=k + 23, density=0.05,
                         code_dtype=code_dtype)
    codes, v_t, *rest = (torch.from_numpy(a).to(cuda) for a in arrays)
    if codes_kind == "zero":
        codes = torch.zeros_like(codes)
    v_b = (0.4 * v_t).bfloat16()
    got = _sweep_mma(codes, None, v_b, rest, cs, -1.3, orientation, "aligned")
    want = dense8_sweep_solve_ref(codes, None, v_b, *rest, cs, -1.3, ALPHA, orientation)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [10, 16, 24, 32])
@pytest.mark.parametrize("layout", ["tight", "aligned"])
@pytest.mark.parametrize("code_dtype", ["int8", "int16"])
@pytest.mark.parametrize("orientation", ["rows", "cols"])
def test_sweep_mma_hoisted_on_card(cuda, k, layout, code_dtype, orientation):
    """#2 on a bf16 operand through the tensor-core megakernel, in both
    layouts (K 16/32 and a runtime K on the capacities 16 and 24), with
    NaN in every row of the operand that holds no entry of the triangle
    (the aligned layout's padding, the tight one's tail): the kernel
    multiplies whole rows and drops those sums; against the plain version
    at 1e-3, three launches bitwise equal."""
    cs = 0.7 if code_dtype == "int8" else 0.7 / 64
    codes, v_t, *rest = (torch.from_numpy(a).to(cuda) for a in _inputs(
        1024, 1536, k, orientation, seed=k + 25, density=0.05, code_dtype=code_dtype))
    v_b = (0.4 * v_t).bfloat16()
    p_t = d8.packed_tri_t(v_b.float(), aligned=layout == "aligned").bfloat16()
    valid = torch.zeros(p_t.shape[0], dtype=torch.bool, device=cuda)
    valid[torch.as_tensor(d8._layout_rows(k, layout)[0], device=cuda)] = True
    p_t[~valid] = float("nan")
    got = _sweep_mma(codes, p_t, v_b, rest, cs, -1.3, orientation, layout)
    want = dense8_sweep_solve_ref(codes, p_t, v_b, *rest, cs, -1.3, ALPHA,
                                  orientation, layout)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("operand", ["inkernel", "tight", "aligned"])
@pytest.mark.parametrize("orientation", ["rows", "cols"])
def test_sweep_mma_segments_on_card(cuda, operand, orientation, monkeypatch):
    """512 items over 32,768 frozen entries at K=32 (chembl's proteins cut
    down): the plan's S > 1 segments and a forced S = 1, each against the
    plain version at 1e-3 and the two within 1e-3; three launches of each
    bitwise equal (the counters reset, the partials summed in order)."""
    k = 32
    shape = (512, 32768) if orientation == "rows" else (32768, 512)
    codes, v_t, *rest = (torch.from_numpy(a).to(cuda) for a in
                         _inputs(*shape, k, orientation, seed=29, density=0.03))
    v_b = (0.2 * v_t).bfloat16()   # keeps sums of ~1000 products near 1
    layout = "aligned" if operand == "inkernel" else operand
    p_t = (None if operand == "inkernel" else
           d8.packed_tri_t(v_b.float(), aligned=operand == "aligned").bfloat16())
    t_in = None if p_t is None else p_t.shape[0]
    real = d8.sweep_mma_plan
    assert real(512, 32768, k, t_in).segments > 1
    want = dense8_sweep_solve_ref(codes, p_t, v_b, *rest, 0.7, -1.3, ALPHA,
                                  orientation, layout)
    split = _sweep_mma(codes, p_t, v_b, rest, 0.7, -1.3, orientation, layout)
    monkeypatch.setattr(d8, "sweep_mma_plan", lambda items, frozen, kp, t, *a, **kw: real(
        items, frozen, kp, t, *a, **kw)._replace(
        segments=1, chunks_per_segment=frozen // d8.MMA_CHUNK,
        scratch_shape=(1, items, kp * (kp + 1) // 2 + kp)))
    one = _sweep_mma(codes, p_t, v_b, rest, 0.7, -1.3, orientation, layout)
    for got in (split, one):
        torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(split, one, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("operand", ["inkernel", "tight", "aligned"])
def test_sweep_bf16_choice_on_card(cuda, operand):
    """With the walk's work given, a launch below the work where the cost
    models cross runs the walk's bf16 instance and one at it the
    tensor-core kernel (each counted under its instance); the two agree at
    1e-3."""
    k = 32
    codes, v_t, *rest = (torch.from_numpy(a).to(cuda) for a in
                         _inputs(1024, 1536, k, "rows", seed=31, density=0.05))
    v_b = (0.4 * v_t).bfloat16()
    layout = "aligned" if operand == "inkernel" else operand
    p_t = (None if operand == "inkernel" else
           d8.packed_tri_t(v_b.float(), aligned=operand == "aligned").bfloat16())
    items, frozen = codes.shape
    t_in = None if p_t is None else p_t.shape[0]
    mma_us = d8.sweep_mma_plan(items, frozen, k, t_in, d8._sm_count(codes.device)).us
    edge = int(np.floor((mma_us - d8.sweep_walk_us(items, frozen, 0, k, operand, t_in))
                        / d8.WALK_RATING_US[operand][k])) + 1
    assert 0 < edge <= codes.numel()
    out = {}
    for work, key in ((edge - 1, d8.sweep_instance_key(k, operand, torch.bfloat16)),
                      (edge, d8.sweep_mma_key(k, operand))):
        before = d8.sweep_instance_launches.get(key, 0)
        out[key] = dense8_sweep_solve(codes, p_t, v_b, *rest, 0.7, -1.3, ALPHA, "rows",
                                      layout=layout, walk_work=work)
        torch.cuda.synchronize()
        assert d8.sweep_instance_launches[key] == before + 1
    walk, mma = out.values()
    torch.testing.assert_close(walk, mma, rtol=1e-3, atol=1e-3)
