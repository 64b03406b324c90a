"""The pieces of the port's multi-device run on the CPU: each sharded function
against its one-device function at 2 gloo ranks, the routes at D > 1
against the JAX sampler's, what each rank holds, the rank count, and the
command line (``--devices 2 --device cpu`` against one rank, with each
multi-device flag)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bpmf_tpu.config import Config as JaxConfig
from bpmf_tpu.datasets import synth_movielens
from bpmf_tpu.ops import dense8 as jax_d8
from bpmf_tpu.sampler import BPMF as JaxBPMF
from bpmf_tpu_torch import cli, write_matrix
from bpmf_tpu_torch.config import Config
from bpmf_tpu_torch.parallel.launch import run_ranks
from bpmf_tpu_torch.parallel.mesh import Mesh, free_port, resolve_n_devices
from bpmf_tpu_torch.sampler import SHARDED_D8_ABLATIONS, BPMF
from tests.conftest import make_ratings
from tests.torch_ranks import chains, rank_device, sharded_parts, sleeper

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARTS_TOL = 2e-6   # relative: f32 sums over ranks in another order


@pytest.fixture(scope="module")
def parts():
    return run_ranks(sharded_parts, 2, 0, device="cpu", threads=1,
                     timeout_s=600)


@pytest.mark.parametrize("name", [
    "dense8_rows_inkernel", "dense8_rows_hoisted", "dense8_cols_inkernel",
    "dense8_cols_hoisted", "predict", "stats", "reduce", "reduce_chunked",
    "halo_sweep", "halo"])
def test_sharded_function_matches_one_device(parts, name):
    """At 2 ranks, on the same inputs: the sharded dense8 half-sweep (the
    users' sweep gathers the movies, the movies' sweep reduce-scatters the
    partial Gram and rhs), both Gram operands; the entry-sharded evaluation
    (rmse, rmse_avg and each entry's Welford state); the all_reduce of the
    stats; the bucketed sweeps of reduce mode, plain and chunked, and of
    gather mode over the halo ring, against the one-device gather sweep
    (float64), and the ring's rows against the all_gather's (exact).  Each
    rank's items, aggregates and the global stats against the one-device
    function, within 2e-6 of their magnitude."""
    for rank, errs in enumerate(parts):
        assert errs[name] <= PARTS_TOL, (rank, name, errs[name])


def _d8_data():
    return synth_movielens(n_users=300, n_movies=200, n_ratings=5000, seed=7)


def _planned(cfg, train, test, d, rank=0, **kw):
    """The port's sampler of rank ``rank`` of ``d``, set up (no collective
    runs at setup, so a mesh without a group plans the layout)."""
    mesh = Mesh(rank=rank, size=d, device=torch.device("cpu"))
    s = BPMF(cfg, train, test, device="cpu", mesh=mesh,
             out=open(os.devnull, "w"), **kw)
    s.setup()
    return s


def _jax_setup(cfg, train, test):
    s = JaxBPMF(cfg, train=train, test=test, out=open(os.devnull, "w"))
    s.setup()
    return s


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("case", ["dense8", "hoisted", "budget", "reduce_dense"])
def test_routes_match_jax_sampler(d, case, monkeypatch):
    """Per side, the Gram route of the JAX sampler at n_devices d, and for
    a dense8 side the split Gram's operand that its pt_mode gives on the
    local shapes, (R/D, C) on rows and (C, R/D) on cols: forced dense8,
    BPMF_D8_PT=hoisted, a dense8 budget that holds the code array per
    device but not whole, and a forced dense route in reduce mode."""
    for var in ("BPMF_D8_SOLVE", "BPMF_D8_PT", "BPMF_TRI_GROUPED"):
        monkeypatch.delenv(var, raising=False)
    if case == "hoisted":
        monkeypatch.setenv("BPMF_D8_PT", "hoisted")
    train, test = _d8_data()
    kw = dict(num_latent=16, nsims=1, n_devices=d,
              gram_impl="dense" if case == "reduce_dense" else "dense8")
    if case == "budget":
        # both sides round up to one block of 512 before the budget: the
        # code array holds 512 x 512 codes, 1/d of them a device
        kw["dense8_limit_bytes"] = 512 * 512 // d
    if case == "reduce_dense":
        kw["comm_mode"] = "reduce"
    ref = _jax_setup(JaxConfig(**kw), train, test)
    port = _planned(Config(**kw), train, test, d)
    for jside, pside, orientation in ((ref.movies, port.movies, "cols"),
                                      (ref.users, port.users, "rows")):
        assert pside.impl == jside.impl
        if jside.impl != "dense8":
            continue
        lp_u, cp = ref.users.maps.local_pad, ref.movies.maps.padded_num
        items, frozen = (lp_u, cp) if orientation == "rows" else (cp, lp_u)
        want = jax_d8.pt_mode(items, frozen, 16, False, orientation)
        assert pside.route == want == ("hoisted" if case == "hoisted" else "inkernel")
    if case == "budget":
        with pytest.raises(ValueError, match="dense8"):
            _jax_setup(JaxConfig(**dict(kw, n_devices=1)), train, test)
        with pytest.raises(ValueError, match="dense8"):
            BPMF(Config(**dict(kw, n_devices=1)), train, test, device="cpu",
                 out=open(os.devnull, "w")).setup()


@pytest.mark.parametrize("ablate", ["", "nopredict", "nohyper", "nonoise",
                                    "nomatmul", "nosolve", "nogather"])
def test_sharded_ablation_set_matches_jax(ablate):
    """At D > 1 a forced dense8 run takes only "" nopredict nohyper nonoise
    (bpmf_tpu/sampler.py:296-300): both packages route those to dense8 and
    refuse the others."""
    train, test = _d8_data()
    kw = dict(num_latent=16, nsims=1, n_devices=2, gram_impl="dense8",
              ablate=ablate)
    if ablate in SHARDED_D8_ABLATIONS:
        ref = _jax_setup(JaxConfig(**kw), train, test)
        port = _planned(Config(**kw), train, test, 2)
        assert ref.users.impl == port.users.impl == "dense8"
        assert ref.movies.impl == port.movies.impl == "dense8"
    else:
        with pytest.raises(ValueError, match="dense8"):
            _jax_setup(JaxConfig(**kw), train, test)
        with pytest.raises(ValueError, match="dense8"):
            _planned(Config(**kw), train, test, 2)


def test_reduce_mode_takes_buckets():
    """--mode reduce sends a side that is not dense8 to the buckets, in both
    packages; the port runs them in reduce mode at 2 ranks, each rank
    holding the reduce layout (items by padded global id, neighbours in its
    own shard of the frozen side), on the one-rank trajectory."""
    train, test = make_ratings(n_users=70, n_movies=45, density=0.3, seed=11)
    kw = dict(num_latent=6, nsims=3, burnin=1, n_devices=2, comm_mode="reduce")
    ref = _jax_setup(JaxConfig(**kw), train, test)
    assert ref.movies.impl == ref.users.impl == "bucketed"
    port = _planned(Config(**kw), train, test, 2)
    for side, other in ((port.movies, port.users), (port.users, port.movies)):
        assert side.impl == "bucketed" and side.exchange == "reduce"
        aux = port._aux[side.name]
        assert max(int(b.item_ids.max()) for b in aux.buckets) < side.maps.padded_num
        assert max(int(b.nbr.max()) for b in aux.buckets) < other.maps.local_pad
    job = (train, test, dict(kw, n_devices=0), 3)
    one = chains(None, {"one": job})["one"]
    two = run_ranks(chains, 2, {"two": job}, device="cpu", threads=1,
                    timeout_s=600)[0]["two"]
    assert two["mode"] == "reduce" and two["n_devices"] == 2
    assert np.isfinite(two["metrics"]).all()
    np.testing.assert_allclose(two["metrics"], one["metrics"], rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("route", ["dense8", "dense8_prop", "fused", "dense",
                                   "bucketed"])
def test_each_rank_holds_its_shard(route, tmp_path):
    """At D = 3 each rank keeps only its rows: the code array [R/D, C], its
    items and aggregates, its dense blocks or buckets, its per-item prior,
    and its 1/D of the test entries with their Welford state; and the
    rows of all ranks make up the one-device layout's."""
    from tests.test_torch_prop import write_prop

    d = 3
    if route.startswith("dense8"):
        train, test = _d8_data()
        kw = dict(num_latent=16, gram_impl="dense8")
        if route == "dense8_prop":
            kw["prop_u"] = write_prop(tmp_path, 16, 300, seed=1, name="u")
    else:
        train, test = make_ratings(n_users=70, n_movies=45, density=0.3, seed=11)
        kw = dict(num_latent=6, gram_impl="bucketed" if route == "bucketed" else "dense",
                  fuse_dense="off" if route == "dense" else "auto")
    cfg = Config(nsims=1, output_dir=str(tmp_path / "out"), **kw)
    ranks = [_planned(cfg, train, test, d, rank=r) for r in range(d)]
    nnz, per = test.nnz, -(-test.nnz // d)
    codes, ev = [], []
    for r, s in enumerate(ranks):
        for side, state in ((s.movies, s.state_m), (s.users, s.state_u)):
            lp = side.maps.local_pad
            assert side.maps.padded_num == d * lp
            assert state.items.shape == state.aggr_mu.shape == (lp, cfg.num_latent)
            assert state.aggr_prod.shape[0] == lp
            aux = s._aux[side.name]
            assert aux.local_orig.tolist() == side.maps.local_orig[r].tolist()
            if aux.dense is not None:
                other = s.users if side is s.movies else s.movies
                shapes = [tuple(x.shape) for x in aux.dense]
                opn = other.maps.padded_num
                assert shapes == ([(opn, lp), (lp, opn)] if side.route == "fused"
                                  else [(lp, opn), (lp, opn)])
            if aux.buckets:
                ids = torch.cat([b.item_ids for b in aux.buckets])
                assert int(ids.max()) <= lp  # local slots (lp: the scratch row)
            if aux.prior_tri_t is not None:
                assert aux.prior_tri_t.shape[1] == lp
        assert s.ev.t_val.shape == s.est.pavg.shape == s.ev.valid.shape == (per,)
        ev.append(s.ev)
        if s._codes is not None:
            assert s._codes.shape == (s.users.maps.local_pad, s.movies.maps.padded_num)
            codes.append(s._codes)
    assert sum(float(e.valid.sum()) for e in ev) == nnz
    if codes:
        # the whole code array in the same padded order, built at once
        from bpmf_tpu_torch.ops.dense8 import build_code_array, quantize_values

        users, movies = ranks[0].users.maps, ranks[0].movies.maps
        coo = train.tocoo()
        whole = build_code_array(
            users.orig_to_padded[coo.row], movies.orig_to_padded[coo.col],
            coo.data, quantize_values(train.data), users.padded_num,
            movies.padded_num)
        np.testing.assert_array_equal(torch.cat(codes).numpy(), whole)


def test_rank_count_resolution(monkeypatch):
    """--devices 0 is every visible GPU on cuda and one rank on the CPU;
    asking for more GPUs than there are raises, and so does a sampler
    asked for more ranks than it has processes; nothing falls back."""
    assert resolve_n_devices(0, "cpu") == 1
    assert resolve_n_devices(3, "cpu") == 3
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert resolve_n_devices(0, "cuda") == 1
    with pytest.raises(ValueError, match="requested 2 devices, only 1 available"):
        resolve_n_devices(2, "cuda")
    train, test = make_ratings(seed=3)
    with pytest.raises(ValueError, match="one process per rank"):
        BPMF(Config(num_latent=4, n_devices=2), train, test, device="cpu")
    with pytest.raises(ValueError, match="mesh of 2 ranks"):
        BPMF(Config(num_latent=4, n_devices=3), train, test, device="cpu",
             mesh=Mesh(rank=0, size=2, device=torch.device("cpu")))
    mesh = Mesh(rank=0, size=2, device=torch.device("cpu"))
    with pytest.raises(RuntimeError, match="no process group"):
        mesh.all_gather(torch.zeros(2))


def _cli(args, cwd, launcher=()):
    proc = subprocess.run([sys.executable, *launcher, "-m", "bpmf_tpu_torch"] + args,
                          capture_output=True, text=True, cwd=cwd, timeout=600,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def _trajectory(text):
    rows = [line for line in text.splitlines() if "iteration" in line and "RMSE" in line]
    return np.asarray([[float(f.split("(")[1].rstrip(")")) if "(" in f
                        else float(f.split(":")[1].split()[0])
                        for f in line.split("\t")[1:5]] for line in rows])


def test_cli_two_ranks_match_one(tmp_path):
    """``python -m bpmf_tpu_torch --devices 2 --device cpu`` prints the
    one-rank trajectory (every printed digit of RMSE, avg RMSE, FU and FM,
    and the Final Avg RMSE within 2e-5), once: rank 1 prints nothing; the
    banner names the ranks, the mode and each side's assignment.  So do
    two ranks that torchrun starts (the ranks from the environment)."""
    train, test = _d8_data()
    tr, te = str(tmp_path / "train.mtx"), str(tmp_path / "test.mtx")
    write_matrix(tr, train)
    write_matrix(te, test)
    args = ["-i", "5", "-b", "2", "-d", "8", "--device", "cpu", "-n", tr, "-p", te]
    one = _cli(args + ["--devices", "1"], tmp_path)
    two = _cli(args + ["--devices", "2"], tmp_path)
    run = _cli(args, tmp_path, launcher=(
        "-m", "torch.distributed.run", "--nproc-per-node", "2",
        "--master-port", str(free_port())))
    assert "ndevices: 1 (mode: gather)" in one
    a = _trajectory(one)
    assert a.shape == (5, 4)
    final = float(one.split("Final Avg RMSE:")[1].split()[0])
    for text in (two, run):
        assert "ndevices: 2 (mode: gather)" in text
        assert "assign movs: work/device" in text and "assign users: work/device" in text
        assert text.count("mean rating:") == 1
        assert text.count("Final Avg RMSE") == 1
        b = _trajectory(text)
        # one unit of the last printed digit: 4 decimals (RMSE), 2 (FU, FM)
        np.testing.assert_allclose(b[:, :2], a[:, :2], rtol=0, atol=1.01e-4)
        np.testing.assert_allclose(b[:, 2:], a[:, 2:], rtol=0, atol=1.01e-2)
        assert float(text.split("Final Avg RMSE:")[1].split()[0]) == pytest.approx(
            final, abs=2e-5)


@pytest.mark.parametrize("flags", [
    ["--halo", "on", "--gram-impl", "bucketed"],
    ["--mode", "reduce", "--gram-impl", "bucketed"],
    ["--reduce-chunked", "on", "--mode", "reduce", "--gram-impl", "bucketed"],
    ["--dist", "127.0.0.1:{port},1,0"],
], ids=("halo", "reduce", "reduce_chunked", "dist"))
def test_cli_runs_the_multi_device_flags(flags, tmp_path, monkeypatch):
    """What multi-device used to refuse runs at --devices 2 --device cpu:
    the halo ring, bucketed reduce, its chunked form, and --dist (one
    process holding both ranks, meeting at its TCP store).  The banner
    names the layout each took, and the Final Avg RMSE is the one-rank
    run's within 2e-5."""
    train, test = _d8_data()
    write_matrix(str(tmp_path / "train.mtx"), train)
    write_matrix(str(tmp_path / "test.mtx"), test)
    monkeypatch.chdir(tmp_path)
    args = ["-r", "-i", "4", "-b", "1", "-d", "8", "--device", "cpu",
            "-n", "train.mtx", "-p", "test.mtx"]

    def final(extra):
        assert cli.main(args + extra) == 0
        text = open(tmp_path / "bpmf_0.out").read()
        return text, float(text.split("Final Avg RMSE:")[1].split()[0])

    _, want = final(["--devices", "1"])
    text, got = final(["--devices", "2"] + [f.format(port=free_port()) for f in flags])
    assert "ndevices: 2" in text and np.isfinite(got)
    assert got == pytest.approx(want, abs=2e-5)
    if "--halo" in flags:
        assert "halo movs: <=" in text and "halo users rows from -> to:" in text
    if "--reduce-chunked" in flags:
        assert "reduce-chunked, 2 destination shards" in text
    elif "reduce" in flags:
        assert "(mode: reduce)" in text and "gram layout movs: buckets 2x" in text


def test_cli_refuses_more_gpus_than_there_are(capsys):
    """On CUDA, --devices past the visible GPUs stops the run (this box has
    none); nothing runs on fewer ranks or on the CPU."""
    assert cli.main(["-n", "train.mtx", "-p", "test.mtx", "--devices", "2"]) == 1
    err = capsys.readouterr().err
    assert f"requested 2 devices, only {torch.cuda.device_count()} available" in err


def test_run_ranks_defaults_to_the_card():
    """``run_ranks`` puts its ranks on the GPUs unless asked for the CPU,
    like every other entry point of the port: without CUDA its rank fails
    and it raises, rather than run on the CPU."""
    if torch.cuda.is_available():
        assert run_ranks(rank_device, 1, timeout_s=600) == ["cuda:0"]
    else:
        with pytest.raises(RuntimeError, match="rank 0 of 1 failed"):
            run_ranks(rank_device, 1, timeout_s=600)
    assert run_ranks(rank_device, 1, device="cpu", timeout_s=600) == ["cpu"]


def test_run_ranks_deadline_is_opt_in():
    """No deadline unless one is given (a chain may run for hours); a given
    one stops the ranks and raises."""
    import inspect

    assert inspect.signature(run_ranks).parameters["timeout_s"].default is None
    with pytest.raises(TimeoutError):
        run_ranks(sleeper, 1, 60, device="cpu", timeout_s=1)


def test_rank_modules_import_without_jax():
    """The modules a spawned rank imports afresh (the launcher, the mesh and
    the test ranks' workers) import neither jax nor the JAX package."""
    from tests.test_torch_import import _run

    assert _run("""
        import bpmf_tpu_torch.parallel.launch, bpmf_tpu_torch.parallel.mesh
        sys.path.insert(0, ".")
        import tests.torch_ranks
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "triton", "bpmf_tpu")]
        assert not bad, bad
        print("ok")
    """) == "ok"
