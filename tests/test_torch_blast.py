"""The batched solve of full precisions (#8, ``chol_solve_sample_pallas_blast``)
on the CPU: the instance its kernel launches at each K
(``ops.pallas_solve.blast_instance``: the register solve's capacity, the
panels' rows a lane, the items a block), the ``vpu`` chain past its gate,
and its plain version against the JAX package (the Pallas kernel
``bpmf_tpu/ops/pallas_solve.py:89 _kernel_blast_inplace`` in interpret mode,
or its plain reference), non-positive-definite systems included."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bpmf_tpu.ops import cholsolve as jax_cs
from bpmf_tpu.ops import pallas_solve as jax_ps
from bpmf_tpu_torch.ops import pallas_solve as ps

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)  # f32 on both sides, other summation orders


@pytest.mark.parametrize("k,want", [
    (1, (8, 1, 8)), (8, (8, 1, 8)), (9, (16, 1, 8)), (24, (24, 1, 8)),
    (31, (32, 1, 8)), (33, (48, 2, 8)), (49, (64, 2, 8)), (64, (64, 2, 8)),
    (65, (0, 3, 8)), (76, (0, 3, 8)), (77, (0, 3, 4)), (96, (0, 3, 4)),
    (97, (0, 4, 4)), (106, (0, 4, 4)),
])
def test_blast_instance(k, want):
    """(capacity, rows a lane, items a block): K <= 64 on the register
    solve at the next capacity of 8/16/24/32/48/64 (one row a lane up to
    32, two past it), K 65-96 on the panels with three rows a lane, 97-106
    with four; 8 items a block while two blocks of 8 fit an SM's shared
    memory (to K=76 on the panels), else 4."""
    assert ps.blast_instance(k) == want


def test_blast_instance_holds_every_k():
    """At every K of the gate the lanes hold the rows (capacity or 32 rows
    a lane at least K), and a block's warp areas fit an SM's shared memory
    twice over at 8 items a block, or once at 4."""
    for k in range(1, 107):
        kp, rows, nw = ps.blast_instance(k)
        assert (kp >= k and rows == -(-kp // 32)) or (kp == 0 and 32 * rows >= k > 64)
        tv4 = -(-(k * (k + 1) // 2) // 4) * 4
        area = max(tv4, kp * kp - 8 * (kp // 4) * (kp // 4 - 1)) if kp else tv4 + 8 * k
        assert area % 4 == 0 and 4 * nw * area <= ps.SMEM_PER_SM
        assert nw == 8 or 2 * 4 * 8 * area + 2048 > ps.SMEM_PER_SM


@pytest.mark.parametrize("k", [0, 107])
def test_blast_instance_refuses_outside_gate(k):
    with pytest.raises(ValueError, match="gate"):
        ps.blast_instance(k)


def _systems(b, k, seed, indefinite=()):
    """Random SPD precisions [B, K, K] (the items in ``indefinite``
    negated), rhs and noise [B, K], float32."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(b, k, k))
    prec = w @ w.transpose(0, 2, 1) / k + np.eye(k)
    prec[list(indefinite)] *= -1
    rhs, noise = rng.normal(size=(2, b, k))
    return [a.astype(np.float32) for a in (prec, rhs, noise)]


@pytest.mark.parametrize("k", [8, 32, 65, 106])
def test_blast_plain_matches_jax(k):
    """#8's plain version against the JAX package on the same seeded
    systems, B = 130 (which the JAX function pads with identity systems),
    upper triangle NaN on the port's side (never read): at K 8 and 32 the
    Pallas kernel in interpret mode, at K 65 and 106 its plain reference,
    the JAX package's vpu chain (the same right-looking Cholesky with rsqrt
    pivots; the unrolled kernel takes 30-100 s to trace in interpret mode
    there).  1e-4."""
    prec, rhs, noise = _systems(130, k, seed=k + 5)
    args = [jnp.asarray(a) for a in (prec, rhs, noise)]
    if k <= 32:
        want = jax_ps.chol_solve_sample_pallas_blast(*args, interpret=True)
    else:
        want = jax_cs.chol_solve_sample_vpu(*args)
    lower = torch.tril(torch.from_numpy(prec)) + torch.triu(
        torch.full((k, k), float("nan")), 1)
    launches = ps.solve_launches["blast"]
    got = ps.chol_solve_sample_pallas_blast(lower, torch.from_numpy(rhs),
                                            torch.from_numpy(noise))
    assert ps.solve_launches["blast"] == launches  # CPU: the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("k", [8, 65])
def test_blast_indefinite_gives_nan_as_jax(k):
    """A system that is not positive definite draws NaN in the JAX
    package's chain and in the port's plain version; the other items'
    draws are as without it."""
    prec, rhs, noise = _systems(40, k, seed=k + 9, indefinite=(3,))
    want = np.asarray(jax_cs.chol_solve_sample_vpu(
        *[jnp.asarray(a) for a in (prec, rhs, noise)]))
    got = ps.chol_solve_sample_pallas_blast(
        *[torch.from_numpy(a) for a in (prec, rhs, noise)]).numpy()
    assert np.isnan(want[3]).all() and np.isnan(got[3]).all()
    good = ps.chol_solve_sample_pallas_blast(
        *[torch.from_numpy(a) for a in _systems(40, k, seed=k + 9)]).numpy()
    keep = np.arange(40) != 3
    np.testing.assert_array_equal(got[keep], good[keep])
    np.testing.assert_allclose(got[keep], want[keep], **TOL)
