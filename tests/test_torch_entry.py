"""The port's entry points (``bpmf_tpu_torch.entry``) and the pure
iteration they are built on (``BPMF.iter_fn``), on the CPU.

* ``entry(device="cpu")``'s function against ``__graft_entry__.entry()``'s
  for one iteration on the same state (the JAX chain's, crossed through
  ``convert.state_from_numpy``) and JAX's draws (``JaxDraws``): metrics
  within 1e-4, factor tables and the Welford state within 1e-3.  The JAX
  side runs its CPU route, the port its TPU route through the plain
  versions, so they differ only in rounding.
* ``iter_fn`` is pure on every route: the sampler's state is unchanged by a
  call, two calls on the same inputs are bitwise equal, and
  ``BPMF.run_chunk(n)`` equals n calls on the same ``TorchDraws``.
* ``dryrun_multichip(2, device="cpu")``: each leg's two steps within 1e-4
  of the one-device chain on the same draws (the JAX package's
  one-trajectory invariant), and the two-process leg's final line equal to
  one process's.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from bpmf_tpu.checkpoint import _side_to_host
from bpmf_tpu_torch import Config, write_matrix
from bpmf_tpu_torch import entry as pe
from bpmf_tpu_torch.convert import state_from_numpy, state_to_numpy
from bpmf_tpu_torch.datasets import synth_movielens
from bpmf_tpu_torch.parallel import mesh as pm
from bpmf_tpu_torch.sampler import BPMF, TorchDraws
from tests.test_torch_sampler import JaxDraws

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ITERS = 4
METRIC_TOL = 1e-4   # abs, float32 in both packages, other routes' rounding
STATE_TOL = 1e-3    # abs, the factor tables and the Welford state
LEG_TOL = 1e-4      # abs, a leg's metrics against the one-device chain

# the chains of the purity tests: Config fields and routing knobs
CHAINS = {
    "dense8": ({}, {}),
    "split": ({}, {"BPMF_D8_SOLVE": "split"}),
    "fused_dense": ({"gram_impl": "dense"}, {}),
    "plain_dense": ({"gram_impl": "dense", "fuse_dense": "off"}, {}),
    "bucketed": ({"gram_impl": "bucketed"}, {}),
    "reduce": ({"gram_impl": "bucketed", "comm_mode": "reduce"}, {}),
    "deferred": ({"defer_predict": "on"}, {}),
    "nohyper": ({"ablate": "nohyper"}, {}),
    "float64": ({"dtype": "float64"}, {}),
}


def _sampler(chain, monkeypatch):
    fields, knobs = CHAINS[chain]
    for var, value in knobs.items():
        monkeypatch.setenv(var, value)
    train, test = synth_movielens(**pe.TINY_DATA)
    s = BPMF(Config(**pe.TINY_CFG, **fields), train, test, out=io.StringIO(),
             device="cpu")
    s.setup()
    return s


def _tensors(x):
    """Every tensor of a nest of NamedTuples, in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if x is None or isinstance(x, (int, float)):
        return []
    return [t for y in x for t in _tensors(y)]


def _bitwise(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert len(ta) == len(tb)
    for x, y in zip(ta, tb):
        assert x.dtype == y.dtype and torch.equal(x, y)


# -- entry() against the JAX package's ------------------------------------

def _jax_payload(js, sm, su, est):
    """The JAX chain's state in the checkpoint format, original item order."""
    out = {"eval.pavg": np.asarray(est.pavg, np.float64),
           "eval.pm2": np.asarray(est.pm2, np.float64)}
    for prefix, side, state in (("movies", js.movies, sm), ("users", js.users, su)):
        out.update({f"{prefix}.{k}": v for k, v in _side_to_host(side, state).items()})
    return out


@pytest.fixture(scope="module")
def jax_chain():
    """JAX_ITERS iterations of ``__graft_entry__.entry()``'s function from
    its example arguments: (state before, state after, metrics) of each."""
    jfn, (sm, su, est, key, _) = graft.entry()
    js = graft._tiny_sampler(1)          # its maps: same data, same config
    step = jax.jit(jfn)
    out = []
    for it in range(JAX_ITERS):
        before = _jax_payload(js, sm, su, est)
        sm, su, est, met = step(sm, su, est, key, jnp.asarray(it, jnp.int32))
        out.append((before, _jax_payload(js, sm, su, est),
                    np.array([float(x) for x in jax.device_get(met)])))
    return out


@pytest.fixture(scope="module")
def port_entry():
    return pe.entry(device="cpu")


@pytest.mark.parametrize("it", range(JAX_ITERS))
def test_entry_matches_jax_entry(it, jax_chain, port_entry):
    """One iteration of the port's ``entry`` function on the JAX chain's
    state before iteration ``it``, with JAX's draws: the JAX function's
    metrics within 1e-4, its tables and Welford state within 1e-3."""
    fn, args = port_entry
    s = fn.__self__
    assert s.users.impl == s.movies.impl == "dense8"
    assert s.users.route == s.movies.route == "fused"
    assert s.device.type == "cpu" and s.dtype == torch.float32
    before, after, want = jax_chain[it]
    state = state_from_numpy(before, s.movies.maps, s.users.maps, "cpu",
                             torch.float32)
    sm, su, est, met = fn(*state, JaxDraws(42), it)
    got = np.array([float(x) for x in met])
    np.testing.assert_allclose(got, want, rtol=0, atol=METRIC_TOL)
    host = state_to_numpy(sm, su, est, s.movies.maps, s.users.maps)
    for name in ("movies.items", "users.items", "eval.pavg", "eval.pm2"):
        np.testing.assert_allclose(host[name], after[name], rtol=0,
                                   atol=STATE_TOL, err_msg=name)


def test_entry_example_args(port_entry):
    """``entry``'s arguments are the tiny chain's first iteration: its
    initial state, its ``TorchDraws`` and iteration 0; the function runs
    on them and leaves them as they were."""
    fn, args = port_entry
    sm, su, est, draws, it = args
    assert isinstance(draws, TorchDraws) and draws.seed == 42 and it == 0
    assert not sm.items.any() and not su.items.any()
    copies = [t.clone() for t in _tensors(args[:3])]
    out = fn(*args)
    for t, c in zip(_tensors(args[:3]), copies):
        assert torch.equal(t, c)
    assert all(torch.isfinite(x) for x in out[3])
    assert out[0].items.shape == sm.items.shape


# -- iter_fn is pure -------------------------------------------------------

@pytest.mark.parametrize("chain", list(CHAINS))
def test_iter_fn_is_pure(chain, monkeypatch):
    """After two steps, a call of ``iter_fn`` on the sampler's own state
    leaves that state (objects and values) and ``iter`` as they were, and a
    second call on the same inputs gives the same outputs bit for bit."""
    s = _sampler(chain, monkeypatch)
    s.run_chunk(2)
    state = (s.state_m, s.state_u, s.est)
    copies = [t.clone() for t in _tensors(state)]
    skip = s.defer_group(2) > 1
    first = s.iter_fn(*state, s.draws, 2, skip)
    second = s.iter_fn(*state, s.draws, 2, skip)
    assert (s.state_m, s.state_u, s.est) == state and s.iter == 1
    for t, c in zip(_tensors(state), copies):
        assert torch.equal(t, c)
    _bitwise(first, second)
    assert not torch.equal(first[0].items, state[0].items)


@pytest.mark.parametrize("chain", list(CHAINS))
def test_run_chunk_is_iter_fn(chain, monkeypatch):
    """``run_chunk(4)`` equals 4 calls of ``iter_fn`` from the same initial
    state on the same ``TorchDraws``, bit for bit: metrics, tables and the
    Welford state (the deferred chain's evaluation batched over the chunk,
    the same arithmetic)."""
    s = _sampler(chain, monkeypatch)
    ref = _sampler(chain, monkeypatch)
    state = (ref.state_m, ref.state_u, ref.est)
    draws = TorchDraws(ref.cfg.seed, ref.device)
    mets = []
    for it in range(4):
        *state, met = ref.iter_fn(*state, draws, it)
        mets.append(torch.stack(met))
    want = torch.stack(mets).numpy()
    got = np.stack(s.run_chunk(4), 1)
    np.testing.assert_array_equal(got, want)
    _bitwise((s.state_m, s.state_u, s.est), tuple(state))
    assert s.iter == 3 and ref.iter == -1


# -- dryrun_multichip ------------------------------------------------------

@pytest.fixture(scope="module")
def dryrun(tmp_path_factory):
    """dryrun_multichip(2) on gloo ranks, what it printed, and the
    references: the one-device tiny chain's two steps and one process of
    two ranks through the command line."""
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        result = pe.dryrun_multichip(2, device="cpu")
    one = pe._tiny_sampler(1, device="cpu")
    one_device = np.array([list(one.step()) for _ in range(2)])
    tmp = tmp_path_factory.mktemp("dryrun")
    train, test = synth_movielens(**pe.TINY_DATA)
    tr, te = str(tmp / "train.sdm"), str(tmp / "test.sdm")
    write_matrix(tr, train)
    write_matrix(te, test)
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("BPMF_DIST", None)
    proc = subprocess.run(
        [sys.executable, "-m", "bpmf_tpu_torch", "-n", tr, "-p", te, "-i", "3",
         "-b", "1", "-d", "16", "--seed", "7", "--devices", "2", "--device",
         "cpu"], env=env, cwd=str(tmp), capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return result, printed.getvalue(), one_device, proc.stdout


@pytest.mark.parametrize("leg", range(len(pe.LEGS)))
def test_dryrun_leg_matches_one_device(leg, dryrun):
    """Each leg's two steps on two ranks: finite, within 1e-4 of the
    one-device chain on the same draws, no kernel launched on the CPU."""
    result, _, one_device, _ = dryrun
    got = result["legs"][leg]
    assert got["leg"] == pe.LEGS[leg]
    assert got["metrics"].shape == (2, 4) and np.isfinite(got["metrics"]).all()
    np.testing.assert_allclose(got["metrics"], one_device, rtol=0, atol=LEG_TOL)
    assert got["launches"] == {}


def test_dryrun_multihost_matches_one_process(dryrun):
    """The two-process leg (one rank in each, joined through BPMF_DIST)
    ends on the final line of one process of two ranks, and prints the
    trajectory once, from process 0."""
    result, _, _, one_process = dryrun
    final = [line for line in one_process.splitlines()
             if line.startswith("Final Avg RMSE")]
    assert result["multihost"]["final"] == final[0]
    out = result["multihost"]["stdout"]
    assert "ndevices: 2 (mode: gather)" in out
    assert "process group: gloo, 2 rank(s)" in out
    assert out.count("iteration") == 3


def test_dryrun_lines(dryrun):
    """One line per leg in the JAX package's wording, naming the placement,
    then the two-process leg's; an odd count skips the latter."""
    result, printed, _, _ = dryrun
    lines = printed.splitlines()
    assert len(lines) == len(pe.LEGS) + 1
    for line, (mode, gram, chunked, halo) in zip(lines, pe.LEGS):
        assert line.startswith(
            f"dryrun_multichip: mode={mode} gram={gram} chunked={chunked} "
            f"halo={halo} n_devices=2 ok (rmse=")
        assert line.endswith("[gloo on the CPU]")
    assert lines[-1].startswith("dryrun_multichip: multihost 2 procs x 1 "
                                "devices ok (Final Avg RMSE: ")
    assert result["placement"] == "gloo on the CPU"
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        assert pe._dryrun_multihost(3, device="cpu") is None
    assert printed.getvalue() == "dryrun_multichip: multihost skipped (n_devices=3)\n"


# -- placement and the default device ---------------------------------------

def test_placement(monkeypatch):
    """Ranks take a GPU each over NCCL where the host has enough; fewer
    GPUs, or a GPU named by index, put every rank on that GPU over gloo;
    ``cuda:<i>`` is the command line's shared placement too."""
    monkeypatch.setattr(pe, "resolve_device",
                        lambda d: torch.device("cuda", torch.device(d).index or 0))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "GPU")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert pe._placement(4, "cuda") == ("cuda", "nccl", "nccl, a GPU a rank")
    assert pe._placement(8, "cuda") == ("cuda:0", "gloo",
                                        "gloo, 8 ranks on cuda:0 (GPU)")
    assert pe._placement(2, "cuda:1")[:2] == ("cuda:1", "gloo")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert pe._placement(2, "cuda")[:2] == ("cuda:0", "gloo")
    assert pm.shared_gpu("cuda:0") and pm.shared_gpu(torch.device("cuda", 1))
    assert not pm.shared_gpu("cuda") and not pm.shared_gpu("cpu")


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the behaviour of a host without CUDA")
def test_entry_points_need_cuda():
    """Without CUDA the default device raises in both entry points and
    ``python -m bpmf_tpu_torch.entry`` fails; nothing runs on the CPU
    unless asked."""
    with pytest.raises(RuntimeError, match="cuda"):
        pe.entry()
    with pytest.raises(RuntimeError, match="cuda"):
        pe.dryrun_multichip(2)
    proc = subprocess.run([sys.executable, "-m", "bpmf_tpu_torch.entry"],
                          capture_output=True, text=True, cwd=REPO, timeout=300,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode != 0 and "torch.cuda.is_available() is False" in proc.stderr
    assert "ok" not in proc.stdout


def test_host_calls_script(capsys):
    """``scripts/host_calls.py`` counts the Python and C calls of an
    iteration of the tiny chain on the CPU: the same count for any number
    of iterations, since every iteration makes the same calls."""
    from bpmf_tpu_torch.scripts import host_calls

    counts = []
    for iters in (2, 4):
        host_calls.main(["--iters", str(iters)])
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert line["routes"] == ["fused", "fused"] and line["iterations"] == iters
        assert line["python_calls_per_iter"] > 0 and line["c_calls_per_iter"] > 0
        counts.append((line["python_calls_per_iter"], line["c_calls_per_iter"]))
    assert counts[0] == pytest.approx(counts[1], rel=0.05)
