"""The port's gather probes (Queue 2 #9) against the JAX script's three
Pallas kernels and its XLA probe, on the CPU at small shapes.

``scripts/gather_probe.py`` is loaded by path and its shape constants set
to R=8, W=16, NV=64 (K stays 32), and for A, B and C also to a ragged W,
R=1, K=12, K=10 and W=2000 (one row), the script loaded anew for each; each kernel runs in a
``pl.pallas_call`` built with the script's own specs, in interpret mode
(kernel C, with its SMEM indices and DMA semaphore, under
``pltpu.InterpretParams``).  The port's wrappers take their plain versions
for CPU tensors."""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from bpmf_tpu_torch.scripts import gather_probe as gp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)  # sums of W f32 terms in another order
R, W, NV, K = 8, 16, 64, 32


def _load_script(r, w, nv, k=None):
    """A fresh copy of the JAX script with its shape constants set (K only
    when given)."""
    spec = importlib.util.spec_from_file_location(
        "jax_gather_probe", os.path.join(REPO, "scripts", "gather_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.R, mod.W, mod.NV = r, w, nv
    if k is not None:
        mod.K = k
    return mod


@pytest.fixture(scope="module")
def script():
    mod = _load_script(R, W, NV)
    assert mod.K == K
    return mod


@pytest.fixture(scope="module")
def inputs():
    return gp.make_inputs(k=K, nv=NV, r=R, w=W, seed=3)


def _jax_out(script, name, idx, table):
    """One launch of the script's kernel ``name`` with its specs, at the
    shapes of ``idx`` [R, W] and ``table`` [NV, K]."""
    (r, w), k = idx.shape, table.shape[1]
    vmem = pl.BlockSpec(memory_space=pltpu.VMEM)
    out_shape = jax.ShapeDtypeStruct((r, k), jnp.float32)
    if name == "a":
        call = pl.pallas_call(script.kernel_a, in_specs=[vmem, vmem],
                              out_specs=vmem, out_shape=out_shape,
                              interpret=True)
        return call(jnp.asarray(idx.reshape(-1)), jnp.asarray(table))
    if name == "b":
        call = pl.pallas_call(script.kernel_b, in_specs=[vmem, vmem],
                              out_specs=vmem, out_shape=out_shape,
                              interpret=True)
        return call(jnp.asarray(idx.reshape(-1)),
                    jnp.asarray(np.ascontiguousarray(table.T)))
    call = pl.pallas_call(
        script.kernel_c, grid=(r,),
        in_specs=[pl.BlockSpec((1, w), lambda i: (i, 0),
                               memory_space=pltpu.SMEM),
                  pl.BlockSpec(memory_space=pltpu.ANY)],
        out_specs=pl.BlockSpec((1, k), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=out_shape,
        scratch_shapes=[pltpu.VMEM((w, k), jnp.float32),
                        pltpu.SemaphoreType.DMA(())],
        interpret=pltpu.InterpretParams())
    return call(jnp.asarray(idx), jnp.asarray(table))


@pytest.mark.parametrize("name,port", [
    ("a", "gather_sum_rows"), ("b", "gather_sum_lanes"), ("c", "gather_sum_copy")])
def test_probe_kernel_matches_jax(script, inputs, name, port):
    """9A/9B/9C: the port's wrapper (its plain version on the CPU) against
    the script's Pallas kernel, and both against numpy."""
    idx, table = inputs
    want = np.asarray(_jax_out(script, name, idx, table))
    t = table.T.copy() if name == "b" else table
    got = getattr(gp, port)(torch.from_numpy(idx), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(want, table[idx].sum(1), **TOL)


@pytest.mark.parametrize("r,w,nv,k", [(8, 37, 64, 32), (1, 16, 64, 32),
                                      (8, 16, 64, 12), (8, 37, 64, 10),
                                      (1, 2000, 4096, 32)],
                         ids=["ragged-W", "R1", "K12", "K10", "W2000"])
@pytest.mark.parametrize("name,port", [("a", "gather_sum_rows"),
                                       ("b", "gather_sum_lanes"),
                                       ("c", "gather_sum_copy")])
def test_probe_kernel_matches_jax_shapes(name, port, r, w, nv, k):
    """9A/9B/9C beyond the script's own shapes: a ragged W (37), one item
    row, K=12, K=10 (no 16-byte copies) and W=2000 (past the rows a block
    of the earlier #9C held in shared memory), the script loaded anew with
    those constants."""
    script = _load_script(r, w, nv, k)
    idx, table = gp.make_inputs(k=k, nv=nv, r=r, w=w, seed=r + w + k)
    want = np.asarray(_jax_out(script, name, idx, table))
    assert want.shape == (r, k)
    t = table.T.copy() if name == "b" else table
    got = getattr(gp, port)(torch.from_numpy(idx), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(want, table[idx].sum(1), **TOL)


def test_probe_d_matches_jax(script, inputs):
    """Probe D's step (torch ``index_select`` then a sum) against the body
    of the script's XLA probe, and the carried chain of N_STEPS against
    ``probe_d``'s."""
    idx, table = inputs
    g = jnp.take(jnp.asarray(table), jnp.asarray(idx).reshape(-1), axis=0)
    want = np.asarray(jnp.sum(g.reshape(R, W, K), axis=1))
    got = gp.gather_sum_ref(torch.from_numpy(idx), torch.from_numpy(table))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    chain = gp.probe_chain(gp.gather_sum_ref, torch.from_numpy(idx),
                           torch.from_numpy(table), script.N_STEPS)
    want_chain = np.asarray(script.probe_d(jnp.asarray(idx), jnp.asarray(table)))
    np.testing.assert_allclose(chain.numpy(), want_chain, **TOL)


def test_probe_inputs_match_the_script(script):
    """make_inputs draws the script's arrays at the script's shapes."""
    idx, table = gp.make_inputs()
    np.testing.assert_array_equal(idx, script.idx_np)
    np.testing.assert_array_equal(table, script.table_np)
    assert (gp.K, gp.NV, gp.R, gp.W, gp.N_STEPS) == (32, 32768, 512, 512, 10)


def test_probe_main_on_cpu(capsys):
    """The entry point runs on the CPU when asked (the plain versions), one
    line per probe; no kernel launches."""
    before = dict(gp.launches)
    gp.run(["A", "B", "C", "D"], "cpu", n_steps=2, k=K, nv=NV, r=R, w=W)
    lines = capsys.readouterr().out.strip().splitlines()
    assert [l[0] for l in lines] == ["A", "B", "C", "D"]
    assert all("M edges/s" in l and "(cpu)" in l for l in lines)
    assert gp.launches == before
    with pytest.raises(SystemExit):
        gp.main(["E", "--device", "cpu"])
