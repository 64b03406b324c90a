"""The port's main path as a whole: Gibbs iterations against the JAX
package with JAX's draws injected, and the command-line entry point."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bpmf_tpu.config import Config
from bpmf_tpu.datasets import synth_movielens
from bpmf_tpu.io import write_matrix
from bpmf_tpu.ops.update import item_noise as jax_item_noise
from bpmf_tpu.sampler import BPMF as JaxBPMF
from bpmf_tpu_torch import cli
from bpmf_tpu_torch.convert import state_from_numpy, state_to_numpy
from bpmf_tpu_torch.ops.mvnormal import HyperDraws
from bpmf_tpu_torch.sampler import BPMF
from tests.conftest import tiny_matrices
from tests.test_torch_mvnormal import jax_hyper_draws
from tests.test_torch_sweep import NUM, _maps, _payload

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class JaxDraws:
    """The port's draw provider, reproducing the JAX sampler's draws from
    its keys: fold_in(key, it), then the side, then 0 for the hyperprior
    and 1 for the noise (bpmf_tpu/sampler.py:788-815, spmd.py:828)."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)

    def _side_key(self, it, side):
        return jax.random.fold_in(jax.random.fold_in(self.key, it), side)

    def hyper_pair(self, it, ns, k, dtype):
        d = [jax_hyper_draws(jax.random.fold_in(self._side_key(it, s), 0),
                             ns[s], k) for s in (0, 1)]
        return HyperDraws(*(torch.stack(x).to(dtype) for x in zip(*d)))

    def noise(self, it, side, orig_ids, num, k, dtype):
        rows = jax_item_noise(jax.random.fold_in(self._side_key(it, side), 1),
                              jnp.asarray(orig_ids.numpy()), k, jnp.float32,
                              num=num)
        return torch.from_numpy(np.array(rows)).to(dtype)


def test_gibbs_iterations_match_jax():
    """3 iterations at K=16 (burn-in 1, so the Welford average engages):
    both packages f32 on the CPU, JAX on its dense8 megakernel route in
    interpret mode.  Per-iteration metrics agree to 1e-4."""
    train, test = synth_movielens(n_users=300, n_movies=200, n_ratings=5000,
                                  seed=3)
    kw = dict(num_latent=16, nsims=3, burnin=1, n_devices=1)
    ref = JaxBPMF(Config(gram_impl="dense8", **kw), train=train, test=test,
                  out=open(os.devnull, "w"))
    port = BPMF(Config(**kw), train, test, out=open(os.devnull, "w"),
                device="cpu", draws=JaxDraws(42))
    ref.setup()
    assert ref.users.impl == ref.movies.impl == "dense8"
    for _ in range(3):
        want = jax.device_get(ref.step())
        got = port.step()
        for f in ("rmse", "rmse_avg", "norm_users", "norm_movies"):
            assert float(getattr(got, f)) == pytest.approx(
                float(getattr(want, f)), abs=1e-4), (port.iter, f)
    assert port.users.impl == port.movies.impl == "dense8"
    for side in ("users", "movies"):
        np.testing.assert_allclose(
            port.items_host(getattr(port, side), getattr(port, f"state_{side[0]}")),
            ref.items_host(getattr(ref, side), getattr(ref, f"state_{side[0]}")),
            rtol=1e-3, atol=1e-3)


def test_state_round_trip():
    """Checkpoint-format state through the port's tensors and back."""
    rng = np.random.default_rng(2)
    payload = _payload(rng)
    maps_m, maps_u = _maps(NUM["movies"]), _maps(NUM["users"])
    back = state_to_numpy(*state_from_numpy(payload, maps_m, maps_u, "cpu",
                                            torch.float64), maps_m, maps_u)
    assert sorted(back) == sorted(payload)
    for name, want in payload.items():
        np.testing.assert_array_equal(back[name], want, err_msg=name)


def _tiny_files(path):
    train, test = tiny_matrices()
    tr, te = str(path / "train.mtx"), str(path / "test.mtx")
    write_matrix(tr, train)
    write_matrix(te, test)
    return tr, te


def _final_rmse(text):
    line = [l for l in text.splitlines() if "Final Avg RMSE" in l][0]
    return float(line.split(":")[1])


def test_tiny_gate_cli(tmp_path, monkeypatch):
    """data/tiny analog, 9 iterations, burn-in 0 (data/tiny/run_test.sh):
    the run resolves to float64 on the CPU.  The gate is statistical (the
    JAX package passes it for 30 of seeds 0-39, the port for 27), so it
    is held on the median of seeds 0-4."""
    tr, te = _tiny_files(tmp_path)
    monkeypatch.chdir(tmp_path)
    rmses = []
    for seed in range(5):
        assert cli.main(["-r", "-k", "-i", "9", "-b", "0", "--device", "cpu",
                         "--seed", str(seed), "-n", tr, "-p", te]) == 0
        out = open(tmp_path / "bpmf_0.out").read()
        assert "dtype auto -> float64" in out
        rmses.append(_final_rmse(out))
    assert np.isfinite(rmses).all()
    assert np.median(rmses) < 3.0, rmses


def test_module_entry_point(tmp_path):
    """``python -m bpmf_tpu_torch --device cpu`` runs the tiny chain."""
    tr, te = _tiny_files(tmp_path)
    proc = subprocess.run(
        [sys.executable, "-m", "bpmf_tpu_torch", "-i", "9", "-b", "0", "-k",
         "--device", "cpu", "-n", tr, "-p", te],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert np.isfinite(_final_rmse(proc.stdout))
    assert "0: Sampling iteration 8:" in proc.stdout


@pytest.mark.parametrize("flags", [
    ["--mode", "reduce", "--gram-impl", "bucketed"],
    ["--devices", "2", "--halo", "on"],
    ["--halo", "on"], ["--dist", "127.0.0.1:{port},1,0"],
    ["--reduce-chunked", "on"],
], ids=lambda f: "_".join(f).replace("127.0.0.1:{port},1,0", "one_process"))
def test_cli_runs_multi_device_flags(flags, tmp_path, monkeypatch):
    """The multi-device flags that were refused until they were ported run
    on the tiny data with --device cpu: bucketed reduce, the halo ring (at
    2 gloo ranks; a no-op on one device, as in the JAX package), --dist
    (one process of one rank, through the TCP store) and the chunked
    reduce (a no-op in gather mode).  Each ends with the Final Avg RMSE of
    the plain one-device run."""
    from bpmf_tpu_torch.parallel.mesh import free_port

    _tiny_files(tmp_path)
    monkeypatch.chdir(tmp_path)
    want = _final_rmse(_run_cli(tmp_path, []))
    out = _run_cli(tmp_path, [f.format(port=free_port()) for f in flags])
    assert np.isfinite(want)
    assert _final_rmse(out) == pytest.approx(want, abs=1e-6)


def _run_cli(tmp_path, flags, iters=3):
    """``python -m bpmf_tpu_torch`` on the tiny data with ``flags``, -r into
    bpmf_0.out in ``tmp_path``; returns the log."""
    assert cli.main(["-r", "-k", "-i", str(iters), "-b", "1", "--device", "cpu",
                     "-n", "train.mtx", "-p", "test.mtx"] + flags) == 0
    return open(tmp_path / "bpmf_0.out").read()


@pytest.mark.parametrize("flags", [
    ["-o", "out/"], ["-v", "-o", "out/"], ["--ablate", "nomatmul"],
    ["--checkpoint", "c.npz"], ["--resume", "c.npz"], ["--ablate", "nosolve"],
    ["--profile"], ["--ablate", "nohyper"],
], ids=lambda f: "_".join(f))
def test_cli_runs_ported_flags(flags, tmp_path, monkeypatch):
    """The flags that were refused until their features were ported run on
    the tiny data with --device cpu and do what they say."""
    from bpmf_tpu_torch import checkpoint
    from bpmf_tpu_torch.io import read_matrix

    _tiny_files(tmp_path)
    monkeypatch.chdir(tmp_path)
    if "--resume" in flags:
        _run_cli(tmp_path, ["--checkpoint", "c.npz"], iters=2)
    # nosolve adds the precision to the draw: the chain overflows soon
    out = _run_cli(tmp_path, flags, iters=2 if "nosolve" in flags else 3)
    assert np.isfinite(_final_rmse(out))
    if "-o" in flags:
        names = {"Pavg.sdm", "Pm2.sdm", "U-mu.ddm", "U-Lambda.ddm", "V-mu.ddm",
                 "V-Lambda.ddm"}
        if "-v" in flags:
            names |= {f"{p}-{i}.ddm" for p in "UV" for i in range(3)}
            assert read_matrix(str(tmp_path / "out" / "U-2.ddm")).shape == (32, 4)
        assert set(os.listdir(tmp_path / "out")) == names
    elif "--checkpoint" in flags:
        assert int(np.load(tmp_path / "c.npz")["iter"]) == 2
        assert np.load(tmp_path / "c.npz")["format_version"] == checkpoint.FORMAT_VERSION
    elif "--resume" in flags:
        assert "resumed from c.npz at iteration 1" in out
        assert "Sampling iteration 2:" in out and "iteration 1:" not in out
    elif "--profile" in flags:
        assert "perf counters (hierarchical):" in out
        assert "sweep phase attribution" in out and "hyperprior resample" in out
    else:
        assert "route plain" in out  # the tiny data: float64, plain dense


def test_unquantizable_ratings_raise():
    """Ratings off an exact grid cannot take the int8 dense stream: they
    take the fused dense route, as the JAX package routes them on a TPU,
    and run (they raised before the dense routes were ported)."""
    train, test = synth_movielens(n_users=60, n_movies=40, n_ratings=600, seed=1)
    train.data = train.data + np.random.default_rng(0).normal(
        scale=0.01, size=train.nnz)
    s = BPMF(Config(num_latent=8, nsims=1), train, test, device="cpu",
             out=open(os.devnull, "w"))
    mets = s.run_chunk(2)
    assert s._codes is None
    assert [(x.impl, x.route) for x in (s.movies, s.users)] == [("dense", "fused")] * 2
    assert np.isfinite(mets.rmse).all()
