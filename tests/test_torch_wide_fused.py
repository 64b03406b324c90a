"""The megakernel at the K the JAX package fuses past one row a lane (#1
at K 33-41, the card's capacities 40 and 44) and #2 at K other than 16
and 32 (a runtime K on the card): the port's dense8_sweep_solve against the JAX
kernels, run in interpret mode, and the K=40 chain on its fused route
against the split pipeline.  On the CPU the port runs its plain version;
tests/test_torch_kernel.py holds the CUDA kernels to it on the card."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bpmf_tpu.ops import dense8 as jax_d8
from bpmf_tpu_torch.config import Config
from bpmf_tpu_torch.ops import dense8 as d8
from bpmf_tpu_torch.sampler import BPMF, HostDraws
from tests.test_torch_kernel import ALPHA, CB, CS, _inputs
from tests.test_torch_split import _small_data

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)  # f32 on both sides, other summation orders

# (K, orientation, operand): #1 ('inkernel') or #2 in a layout; each JAX
# kernel traced in interpret mode takes 2-20 s here
CASES = [(40, "rows", "inkernel"), (33, "cols", "inkernel"),
         (41, "rows", "inkernel"), (36, "cols", "tight"),
         (10, "rows", "aligned"), (39, "rows", "aligned")]


@pytest.fixture(autouse=True)
def knobs(monkeypatch):
    """No routing knob, and the JAX package's fold at its default."""
    for var in ("BPMF_D8_SOLVE", "BPMF_D8_PT", "BPMF_D8_FOLD", "BPMF_D8_BLOCKS",
                "BPMF_TRI_GROUPED"):
        monkeypatch.delenv(var, raising=False)


@pytest.mark.parametrize("k,orientation,operand", CASES,
                         ids=["-".join(map(str, c)) for c in CASES])
def test_wide_sweep_solve_matches_jax(k, orientation, operand):
    """The same seeded inputs (512 x 512 codes at 10%) through the JAX
    megakernel and the port's: 1e-4.  The JAX package fuses each of these
    (solve_fused_supported), and the port's kernel takes each on the card."""
    layout = "tight" if operand == "inkernel" else operand
    assert jax_d8.solve_fused_supported(k, layout)
    codes, v_t, lam, prior_rhs, noise_t = _inputs(512, 512, k, orientation,
                                                  seed=k + 2)
    p_jax = (None if operand == "inkernel" else
             jax_d8.packed_tri_t(jnp.asarray(v_t), aligned=operand == "aligned"))
    want = jax_d8.dense8_sweep_solve(
        jnp.asarray(codes), p_jax,
        *(jnp.asarray(a) for a in (v_t, lam, prior_rhs, noise_t)),
        CS, CB, ALPHA, orientation, layout=layout, interpret=True)
    v = torch.from_numpy(v_t)
    p_t = (None if operand == "inkernel"
           else d8.packed_tri_t(v, aligned=operand == "aligned"))
    before = dict(d8.sweep_instance_launches)
    got = d8.dense8_sweep_solve(
        torch.from_numpy(codes), p_t, v,
        *(torch.from_numpy(a) for a in (lam, prior_rhs, noise_t)),
        CS, CB, ALPHA, orientation, layout=layout)
    assert d8.sweep_instance_launches == before  # CPU: plain version
    assert tuple(got.shape) == (k, noise_t.shape[1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_k40_chain_fused_matches_split(monkeypatch):
    """The K=40 chain on the CPU, 3 iterations with the same draws, on its
    default route (the megakernel on both sides, as in the JAX package)
    and under BPMF_D8_SOLVE=split (#3 + #5's plain versions): the two
    routes differ only in rounding, so every metric agrees to 1e-4."""
    train, test = _small_data()
    mets = {}
    for solve in ("fused", "split"):
        monkeypatch.setenv("BPMF_D8_SOLVE", solve)
        dev = torch.device("cpu")
        s = BPMF(Config(num_latent=40, nsims=3, burnin=1), train, test,
                 out=open(os.devnull, "w"), device=dev, draws=HostDraws(42, dev))
        mets[solve] = s.run_chunk(3)
        want = "fused" if solve == "fused" else "inkernel"
        assert s.movies.route == s.users.route == want
    for got, ref in zip(mets["fused"], mets["split"]):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("operand", ["inkernel", "tight", "aligned"])
def test_every_fused_k_has_an_instance(operand):
    """Every K the JAX package fuses with this operand (K <= 41, 39 in the
    aligned layout) names a built instance of the card's kernel: #2 at K
    16 and 32 its own, every other K the next capacity, a multiple of 4
    with room for K; past the last capacity there is no instance (the
    card test test_kernel_refuses_unbuilt_k holds the wrapper's refusal
    past the gate)."""
    layout = "tight" if operand == "inkernel" else operand
    fused = [k for k in range(1, 80) if jax_d8.solve_fused_supported(k, layout)]
    assert fused == list(range(1, 42 if layout == "tight" else 40))
    for k in fused:
        kp, runtime = d8.sweep_instance(k, operand)
        key = d8.sweep_instance_key(k, operand)
        if operand != "inkernel" and k in d8.HOISTED_K:
            assert (kp, runtime, key) == (k, False, f"{operand}_k{k}")
        else:
            assert kp == min(c for c in d8.INKERNEL_CAPACITIES if c >= k)
            assert runtime == (operand != "inkernel") and key == f"{operand}_c{kp}"
        assert kp % 4 == 0 and k <= kp
    with pytest.raises(ValueError, match="largest capacity"):
        d8.sweep_instance(d8.INKERNEL_CAPACITIES[-1] + 1, operand)
