"""A run over several processes (``--dist HOST:PORT,NPROC,PID`` or
``BPMF_DIST``): the spec, the placement of each process's ranks and their
GPUs as pure functions, the JAX package's message for a malformed spec
(tests/test_mesh.py:12-22), and on the CPU two processes of 2 gloo ranks
each against one process of 4 (tests/test_multihost.py:51), with the halo
ring across the processes (:119)."""

import os
import re
import subprocess
import sys

import pytest
import torch

from bpmf_tpu.parallel import mesh as jax_mesh
from bpmf_tpu_torch import cli, write_matrix
from bpmf_tpu_torch.parallel import mesh as pm
from tests.conftest import make_ratings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RMSE_RE = re.compile(r"iteration (\d+):\s+RMSE: ([\d.]+)\s+avg RMSE: ([\d.]+)")


def test_dist_spec_from_env_noop(monkeypatch):
    """Without --dist and BPMF_DIST the run is one process, as the JAX
    package's initialize_from_env is a no-op."""
    monkeypatch.delenv("BPMF_DIST", raising=False)
    assert pm.dist_spec() is None
    assert pm.dist_spec("") is None
    monkeypatch.setenv("BPMF_DIST", "10.0.0.1:4000,2,1")
    assert pm.dist_spec() == pm.DistSpec("10.0.0.1:4000", 2, 1)
    assert pm.dist_spec().init_method == "tcp://10.0.0.1:4000"
    assert pm.dist_spec("h:1,4,3") == pm.DistSpec("h:1", 4, 3)


@pytest.mark.parametrize("spec", ["not-a-spec", "h:1,two,0", "h:1,2"])
def test_bad_spec_raises_the_jax_message(spec, monkeypatch):
    """A malformed BPMF_DIST raises the JAX package's ValueError, word for
    word; so does --dist on the command line (a usage error)."""
    monkeypatch.setenv("BPMF_DIST", spec)
    with pytest.raises(ValueError) as want:
        jax_mesh.initialize_from_env()
    with pytest.raises(ValueError) as got:
        pm.dist_spec()
    assert str(got.value) == str(want.value) == (
        f"BPMF_DIST must be 'host:port,num_processes,process_id', got {spec!r}")
    monkeypatch.delenv("BPMF_DIST")
    with pytest.raises(SystemExit) as exc:
        cli.main(["-n", "a.mtx", "-p", "b.mtx", "--device", "cpu", "--dist", spec])
    assert exc.value.code == 2


def test_ranks_and_gpus_of_a_process():
    """N ranks over NPROC processes: process p holds N/NPROC consecutive
    global ranks from p * N/NPROC, and each takes the GPU of its place on
    its host, not of its global rank; N that does not divide raises."""
    spec = pm.DistSpec("h:1", 2, 1)
    assert pm.dist_ranks(8, spec) == (4, 4)
    assert pm.dist_ranks(2, spec) == (1, 1)
    # run_ranks starts global rank offset + i as the host's i-th rank
    per, offset = pm.dist_ranks(8, spec)
    assert [(offset + i, str(pm._rank_device("cuda", i))) for i in range(per)] == [
        (4, "cuda:0"), (5, "cuda:1"), (6, "cuda:2"), (7, "cuda:3")]
    assert pm._rank_device("cuda:0", 3) == torch.device("cuda", 0)
    assert pm._rank_device("cpu", 3) == torch.device("cpu")
    for n, nproc in ((3, 2), (1, 2), (0, 2)):
        with pytest.raises(ValueError, match="do not divide"):
            pm.dist_ranks(n, pm.DistSpec("h:1", nproc, 0))


def test_platform_stays_refused(capsys):
    """--platform picks a JAX platform; the port takes --device."""
    with pytest.raises(SystemExit):
        cli.main(["-n", "a.mtx", "-p", "b.mtx", "--platform", "cpu"])
    assert "--platform selects a JAX platform" in capsys.readouterr().err


def _trajectory(text):
    return [(int(m.group(1)), float(m.group(2)), float(m.group(3)))
            for m in RMSE_RE.finditer(text)]


def _proc(args, spec=None):
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("BPMF_DIST", None)
    if spec:
        env["BPMF_DIST"] = spec
    return subprocess.Popen([sys.executable, "-m", "bpmf_tpu_torch", *args],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=REPO)


def _two_processes(args):
    """Both processes of a 2-process run, process 0 through --dist and
    process 1 through BPMF_DIST; one retry on a fresh port when the
    store's port was taken between the probe and its use."""
    for attempt in range(2):
        spec = f"127.0.0.1:{pm.free_port()},2,"
        procs = [_proc(args + ["--dist", spec + "0"]), _proc(args, spec + "1")]
        outs = []
        for p in procs:
            try:
                out, err = p.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
            outs.append((p.returncode, out, err))
        if all(rc == 0 for rc, _, _ in outs):
            return [out for _, out, _ in outs]
        if attempt == 0 and any("address" in err.lower() for _, _, err in outs):
            continue
        for rc, _, err in outs:
            assert rc == 0, err[-3000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two processes of 2 gloo ranks each (gather mode, then the buckets
    with the halo ring off and on), and one process of 4 ranks."""
    tmp = tmp_path_factory.mktemp("multihost")
    train, test = make_ratings(n_users=60, n_movies=40, density=0.25)
    tr, te = str(tmp / "train.mtx"), str(tmp / "test.mtx")
    write_matrix(tr, train)
    write_matrix(te, test)
    common = ["-n", tr, "-p", te, "-i", "6", "-b", "2", "-d", "8", "--seed", "7",
              "--device", "cpu", "--devices", "4"]
    out = {"two": _two_processes(common)}
    for halo in ("off", "on"):
        out[f"halo_{halo}"] = _two_processes(common + ["--gram-impl", "bucketed",
                                                       "--halo", halo])
    one = _proc(common)
    text, err = one.communicate(timeout=300)
    assert one.returncode == 0, err[-3000:]
    out["one"] = text
    return out


def test_two_processes_match_one(runs):
    """Two processes of 2 ranks each run one group of 4: process 0 prints
    the trajectory of one process of 4 ranks (within 2e-4 per iteration),
    once; process 1 prints none."""
    two, one = _trajectory(runs["two"][0]), _trajectory(runs["one"])
    assert len(two) == 6 and [t[0] for t in two] == [t[0] for t in one]
    assert _trajectory(runs["two"][1]) == [] and runs["two"][1] == ""
    assert "ndevices: 4 (mode: gather)" in runs["two"][0]
    for (it, r2, ra2), (_, r1, ra1) in zip(two, one):
        assert r2 == pytest.approx(r1, abs=2e-4), it
        assert ra2 == pytest.approx(ra1, abs=2e-4), it


def test_two_process_halo_matches_all_gather(runs):
    """The halo ring across the two processes (its rounds cross between
    them) prints the trajectory of the all_gather, to the last digit."""
    on, off = (_trajectory(runs[f"halo_{h}"][0]) for h in ("on", "off"))
    assert len(on) == 6 and on == off
    assert "halo movs: <=" in runs["halo_on"][0]
    assert "halo movs" not in runs["halo_off"][0]
