"""bpmf_tpu_torch.ops.dense8: the fused sweep-solve against the JAX
megakernel, run in interpret mode."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bpmf_tpu.ops.dense8 import dense8_sweep_solve as jax_sweep_solve
from bpmf_tpu_torch.ops import dense8 as d8
from bpmf_tpu_torch.ops.dense8 import dense8_sweep_solve
from tests.test_torch_kernel import ALPHA, CB, CS, CS16, _inputs

torch.set_num_threads(1)

CASES = [(16, "rows", "int8"), (16, "cols", "int8"), (32, "rows", "int8"),
         (10, "rows", "int8"), (24, "cols", "int8"),
         (16, "rows", "int16"), (16, "cols", "int16")]


def case_ids(cases):
    """pytest ids of (..., code_dtype) cases: the int8 cases keep the ids
    they had before int16 codes were a parameter."""
    return ["-".join(map(str, c[:-1])) + ("" if c[-1] == "int8" else f"-{c[-1]}")
            for c in cases]


@pytest.mark.parametrize("k,orientation,code_dtype", CASES, ids=case_ids(CASES))
def test_sweep_solve_matches_jax(k, orientation, code_dtype):
    """f32 on both sides; only the summation order differs, so 1e-4.  K=10
    and K=24 are the megakernel's smaller latent sizes (the card runs K=10
    on its capacity 16); int16 codes run 1..255."""
    cs = CS if code_dtype == "int8" else CS16
    args = _inputs(512, 512, k, orientation, seed=k, code_dtype=code_dtype)
    assert args[0].dtype == code_dtype
    want = jax_sweep_solve(
        jnp.asarray(args[0]), None, *(jnp.asarray(a) for a in args[1:]),
        cs, CB, ALPHA, orientation, interpret=True)
    launches = d8.sweep_launches["inkernel"]
    t = [torch.from_numpy(a) for a in args]
    got = dense8_sweep_solve(t[0], None, *t[1:], cs, CB, ALPHA, orientation)
    assert d8.sweep_launches["inkernel"] == launches  # CPU: plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
