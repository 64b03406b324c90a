"""The port's bench legs (``bpmf_tpu_torch.bench``) on the CPU: the
subprocess runner, the failure without CUDA, the headline and the choice of
legs, parity with the JAX package's ``bench.py`` on recording fakes (the
same data, K, iterations, repeats, Config and call sequence), and one real
``measure`` on a small synth.  The legs' numbers come only from the card
(``chip_smoke.py`` phase 29)."""

import dataclasses
import json
import os
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import bpmf_tpu.datasets as jax_datasets
import bpmf_tpu.sampler as jax_sampler
import bpmf_tpu_torch.bench as port
import bpmf_tpu_torch.device as port_device
import bpmf_tpu_torch.sampler as port_sampler
from bpmf_tpu_torch.datasets import synth_movielens

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bench  # noqa: E402  (the JAX package's bench.py, at the repo root)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the keys of bench.py's measure(); the port says "device" for "backend"
BENCH_KEYS = {"items_per_sec", "ratings_per_sec", "ms_per_iter", "iters",
              "rmse_avg_check", "n_devices", "setup_s", "compile_s",
              "measure_s", "leg_s"}
ENV = ("BENCH_ITERS", "BENCH_K", "BENCH_FAST", "BENCH_DEVICE",
       "BENCH_PLATFORM", "BENCH_BUDGET_S")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)


def _lines(text):
    return [json.loads(line) for line in text.strip().splitlines()]


def _details(text):
    return {k: v for line in _lines(text) for k, v in line.items()}


# -- run_leg: a subprocess with a hard timeout -----------------------------

def test_run_leg_unknown_leg_is_error_marker():
    d = port.run_leg("nonsense", timeout_s=120.0)
    assert d["skipped"] == "leg_error"
    assert d["leg"] == "nonsense"
    assert d["rc"] != 0
    assert "unknown leg" in d["stderr_tail"]


def test_run_leg_timeout_is_timeout_marker():
    # 1 s is below the interpreter's and torch's start: the group is killed
    t0 = time.time()
    d = port.run_leg("ml1m", timeout_s=1.0)
    assert d == {"skipped": "leg_timeout", "leg": "ml1m", "timeout_s": 1.0}
    assert time.time() - t0 < 30


@pytest.mark.parametrize("leg", port.LEGS)
def test_leg_without_cuda_fails_before_data(leg):
    """Without CUDA and without BENCH_DEVICE=cpu a leg fails within
    seconds, naming the cause, and prints no number (the ml-25M legs would
    spend a minute making data first if the device were resolved after)."""
    t0 = time.time()
    d = port.run_leg(leg, timeout_s=120.0,
                     env_overrides={"CUDA_VISIBLE_DEVICES": ""})
    assert d["skipped"] == "leg_error", d
    assert d["rc"] != 0
    assert "CUDA" in d["stderr_tail"]
    assert time.time() - t0 < 30


# -- main(): the headline and the choice of legs ---------------------------

def _fake_run_leg(legs, result=None):
    def run_leg(leg, timeout_s, env_overrides=None):
        legs.append(leg)
        assert timeout_s > 0
        return dict(result or {"items_per_sec": 5e6,
                               "device": "NVIDIA H100 80GB HBM3"})
    return run_leg


def test_main_without_cuda_runs_no_leg(monkeypatch, capsys):
    legs = []
    monkeypatch.setattr(port.torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(port, "run_leg", _fake_run_leg(legs))
    with pytest.raises(SystemExit) as e:
        port.main()
    assert e.value.code not in (0, None)
    assert "CUDA" in str(e.value.code)
    assert legs == []
    assert capsys.readouterr().out == ""


def test_main_primary_failure_prints_zero_and_exits_nonzero(monkeypatch, capsys):
    legs = []
    monkeypatch.setattr(port.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(port, "run_leg", _fake_run_leg(
        legs, {"skipped": "leg_timeout", "leg": "ml1m", "timeout_s": 700.0}))
    with pytest.raises(SystemExit) as e:
        port.main()
    assert e.value.code not in (0, None)
    assert legs == ["ml1m"]
    captured = capsys.readouterr()
    out = _lines(captured.out)
    assert len(out) == 1
    assert out[0]["value"] == 0.0
    assert out[0]["vs_baseline"] == 0.0
    assert out[0]["skipped"] == "leg_timeout"
    assert out[0]["unit"] == "items/sec"
    assert _details(captured.err)["detail_ml1m"]["skipped"] == "leg_timeout"


def test_main_happy_path_runs_legs_in_order(monkeypatch, capsys):
    legs = []
    monkeypatch.setattr(port.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(port, "run_leg", _fake_run_leg(legs))
    port.main()
    assert legs[:2] == ["ml1m", "chembl"]
    assert len(legs) == 3 and legs[2] in ("ml25m_full", "ml25m_half")
    captured = capsys.readouterr()
    out = _lines(captured.out)
    assert len(out) == 1
    assert out[0]["metric"] == "user+item updates/sec (ml-1m synth, K=32)"
    assert out[0]["device"] == "NVIDIA H100 80GB HBM3"
    details = _details(captured.err)
    assert set(details) == {"detail_ml1m", "detail_chembl_synth",
                            "detail_ml25m_synth", "bench_budget"}
    assert details["bench_budget"]["budget_s"] == 720.0


def test_main_vs_baseline(monkeypatch, capsys):
    monkeypatch.setattr(port.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(port, "run_leg", _fake_run_leg(
        [], {"items_per_sec": 7654321.5, "device": "card"}))
    monkeypatch.setenv("BENCH_FAST", "1")
    port.main()
    head = _lines(capsys.readouterr().out)[0]
    assert head["value"] == 7654321.5
    assert head["vs_baseline"] == pytest.approx(7654321.5 / 2_093_248, abs=5e-5)


def test_baseline_is_the_measured_files():
    with open(os.path.join(ROOT, "BASELINE_MEASURED.json")) as f:
        want = json.load(f)["derived"]["items_per_sec_64thread_upper_bound"]
    assert port.BASELINE_ITEMS_PER_SEC == want == 2_093_248


def test_main_bench_fast_skips_secondaries(monkeypatch, capsys):
    legs = []
    monkeypatch.setattr(port.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(port, "run_leg", _fake_run_leg(legs))
    monkeypatch.setenv("BENCH_FAST", "1")
    port.main()
    assert legs == ["ml1m"]
    details = _details(capsys.readouterr().err)
    assert details["detail_chembl_synth"] == {"skipped": "BENCH_FAST"}
    assert details["detail_ml25m_synth"] == {"skipped": "BENCH_FAST"}
    assert "bench_budget" in details


def test_main_cpu_only_on_request(monkeypatch, capsys):
    """BENCH_DEVICE=cpu runs the legs without CUDA; the headline carries
    the legs' device, "cpu"."""
    legs = []
    monkeypatch.setattr(port.torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(port, "run_leg", _fake_run_leg(
        legs, {"items_per_sec": 1000.0, "device": "cpu"}))
    monkeypatch.setenv("BENCH_DEVICE", "cpu")
    monkeypatch.setenv("BENCH_FAST", "1")
    port.main()
    assert legs == ["ml1m"]
    assert _lines(capsys.readouterr().out)[0]["device"] == "cpu"


@pytest.mark.parametrize("budget,ml25m", [(150.0, "ml25m_full"),
                                          (50.0, "ml25m_half"),
                                          (5.0, None)])
def test_main_budget_picks_ml25m_scale(monkeypatch, capsys, budget, ml25m):
    """Full scale where its cost fits what is left, else half, else a
    budget marker."""
    legs = []
    monkeypatch.setattr(port.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(port, "run_leg", _fake_run_leg(legs))
    monkeypatch.setattr(port, "LEG_COST_S", {"ml1m": 0.0, "chembl": 0.0,
                                             "ml25m_full": 100.0,
                                             "ml25m_half": 10.0})
    monkeypatch.setattr(port, "COST_MARGIN", 1.0)
    monkeypatch.setattr(port, "SLACK_S", 0.0)
    monkeypatch.setenv("BENCH_BUDGET_S", str(budget))
    port.main()
    assert legs == ["ml1m", "chembl"] + ([ml25m] if ml25m else [])
    d = _details(capsys.readouterr().err)["detail_ml25m_synth"]
    assert (d.get("skipped") == "budget") == (ml25m is None)


# -- parity with bench.py on recording fakes -------------------------------

def _record_synth(log, kind):
    def synth(**kw):
        log.append((kind, kw))
        return f"train:{kind}", f"test:{kind}"
    return synth


def _record_measure(log):
    def measure(train, test, k, iters, repeats=3, device=None):
        log.append(("measure", train, test, k, iters, repeats))
        return {"items_per_sec": 1.0}
    return measure


def _no_file(*args, **kwargs):
    raise OSError("no cache in this test")


@pytest.mark.parametrize("leg", port.LEGS)
def test_leg_parity_with_bench(leg, monkeypatch, capsys):
    """Each leg makes the same dataset call (dimensions, seed) and measures
    with the same K, iterations and repeats as bench.py's, at the defaults
    of the device (BENCH_ITERS 500)."""
    jax_log, port_log = [], []
    monkeypatch.setattr(jax_datasets, "synth_movielens",
                        _record_synth(jax_log, "movielens"))
    monkeypatch.setattr(jax_datasets, "synth_chembl",
                        _record_synth(jax_log, "chembl"))
    monkeypatch.setattr(bench, "measure", _record_measure(jax_log))
    # bench.py's ml-25M cache is a fixed /tmp path: neither read nor written
    monkeypatch.setattr(bench, "open", _no_file, raising=False)
    monkeypatch.setattr(port, "synth_movielens",
                        _record_synth(port_log, "movielens"))
    monkeypatch.setattr(port, "synth_chembl", _record_synth(port_log, "chembl"))
    monkeypatch.setattr(port, "measure", _record_measure(port_log))
    monkeypatch.setattr(port, "resolve_device", torch.device)
    monkeypatch.setattr(port, "_ml25m_cache", lambda scale: None)

    bench.leg_main(leg)
    port.leg_main(leg)
    assert port_log == jax_log
    assert [e[0] for e in jax_log] == [
        "chembl" if leg == "chembl" else "movielens", "measure"]
    jax_out, port_out = _lines(capsys.readouterr().out)
    assert port_out == jax_out


def _recording_bpmf(log):
    class Sampler:
        def __init__(self, cfg, train=None, test=None, out=None, **kw):
            log.append(("init", dataclasses.asdict(cfg), train, test))
            self.movies = SimpleNamespace(name="movs", num=5, impl="dense8",
                                          route="fused")
            self.users = SimpleNamespace(name="users", num=7, impl="dense8",
                                         route="fused")
            self.train = SimpleNamespace(nnz=11)
            self.n_devices = 1

        def setup(self):
            log.append(("setup",))

        def run_chunk(self, n):
            log.append(("run_chunk", n))
            x = np.full(n, 0.75)
            return SimpleNamespace(rmse=x, rmse_avg=x, norm_users=x,
                                   norm_movies=x)
    return Sampler


def test_measure_parity_with_bench(monkeypatch):
    """Both measure()s build the same Config, make the same setup /
    run_chunk calls, and return bench.py's keys."""
    jax_log, port_log = [], []
    monkeypatch.setattr(jax_sampler, "BPMF", _recording_bpmf(jax_log))
    monkeypatch.setattr(port_sampler, "BPMF", _recording_bpmf(port_log))
    jax_r = bench.measure("tr", "te", 24, 7, repeats=3)
    port_r = port.measure("tr", "te", 24, 7, repeats=3, device="cpu")
    assert port_log == jax_log
    assert jax_log[0][1]["num_latent"] == 24
    assert jax_log[0][1]["nsims"] == 35 and jax_log[0][1]["burnin"] == 2
    assert [e[0] for e in jax_log[1:]] == ["setup"] + ["run_chunk"] * 4
    assert set(jax_r) == BENCH_KEYS | {"backend"}
    assert BENCH_KEYS <= set(port_r)
    for key in ("iters", "rmse_avg_check", "n_devices"):
        assert port_r[key] == jax_r[key]
    assert port_r["device"] == "cpu"


def test_measure_on_cpu():
    """A real chain on a small synth: bench.py's keys, the CPU named, and
    items/s x ms/iter = the items of one iteration."""
    train, test = synth_movielens(n_users=200, n_movies=150, n_ratings=5000,
                                  seed=3)
    r = port.measure(train, test, 8, 3, repeats=2, device="cpu")
    assert BENCH_KEYS <= set(r)
    assert r["device"] == "cpu"
    assert r["iters"] == 3 and r["n_devices"] == 1
    assert np.isfinite(r["rmse_avg_check"]) and 0 < r["rmse_avg_check"] < 5
    assert r["items_per_sec"] * r["ms_per_iter"] / 1e3 == pytest.approx(
        200 + 150, rel=1e-3)
    assert r["ratings_per_sec"] * r["ms_per_iter"] / 1e3 == pytest.approx(
        train.nnz, rel=1e-3)
    # nothing of the card: no launches, no peak memory, no power limit
    assert r["launches"] == {} and "peak_mem_bytes" not in r
    assert set(r["sides"]) == {"movs", "users"}


# -- ml25m_leg's data cache ------------------------------------------------

SMALL = {"full": dict(n_users=300, n_movies=200, n_ratings=4000),
         "half": dict(n_users=160, n_movies=120, n_ratings=2000)}


@pytest.fixture
def small_ml25m(monkeypatch, tmp_path):
    """ml25m_leg at small dimensions, its cache under ``tmp_path``, its
    measure recording the data it is handed; yields (made, measured)."""
    made, measured = [], []

    def synth(**kw):
        made.append(kw)
        return synth_movielens(**kw)

    def measure(train, test, k, iters, repeats=3, device=None):
        measured.append((train, test))
        return {"items_per_sec": 1.0}

    monkeypatch.setattr(port, "ML25M_DIMS", SMALL)
    monkeypatch.setattr(port, "synth_movielens", synth)
    monkeypatch.setattr(port, "measure", measure)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    yield made, measured


def _same_csc(a, b):
    assert a.format == b.format == "csc" and a.shape == b.shape
    for name in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


@pytest.mark.parametrize("scale", ["full", "half"])
def test_ml25m_cache_round_trip(scale, small_ml25m):
    """The second leg reads the first leg's data back, the same matrices,
    from an .npz in a directory of this user's alone."""
    made, measured = small_ml25m
    port.ml25m_leg(2, scale, device="cpu")
    port.ml25m_leg(2, scale, device="cpu")
    assert made == [dict(seed=25, **SMALL[scale])]
    for fresh, cached in zip(*measured):
        _same_csc(fresh, cached)
    path = port._ml25m_cache(scale)
    assert path.endswith(".npz") and os.path.isfile(path)
    assert os.stat(os.path.dirname(path)).st_mode & 0o777 == 0o700


@pytest.mark.parametrize("change", ["dims", "seed", "scale"])
def test_ml25m_cache_keyed_on_dims_seed_scale(change, small_ml25m, monkeypatch):
    before = port._ml25m_cache("half")
    assert port._ml25m_cache("half") == before
    scale = "half"
    if change == "dims":
        monkeypatch.setitem(port.ML25M_DIMS, "half",
                            dict(SMALL["half"], n_ratings=2001))
    elif change == "seed":
        monkeypatch.setattr(port, "ML25M_SEED", 26)
    else:
        scale = "full"
    assert port._ml25m_cache(scale) != before


def test_ml25m_cache_refuses_shared_directory(small_ml25m, tmp_path):
    """A cache directory others may write to is not used: no cache."""
    shared = tmp_path / f"bpmf_torch_bench_{os.getuid()}"
    shared.mkdir(mode=0o777)
    shared.chmod(0o777)
    assert port._ml25m_cache("half") is None
    made, _ = small_ml25m
    port.ml25m_leg(2, "half", device="cpu")
    assert len(made) == 1 and os.listdir(shared) == []


def test_ml25m_cache_never_unpickles(small_ml25m, tmp_path):
    """A pickle planted at the cache's path is not loaded (allow_pickle
    is off): the data is made again and the file replaced."""
    import pickle

    path = port._ml25m_cache("half")
    marker = tmp_path / "unpickled"
    with open(path, "wb") as f:
        pickle.dump(_Plant(str(marker)), f)
    made, measured = small_ml25m
    port.ml25m_leg(2, "half", device="cpu")
    assert not marker.exists()
    assert len(made) == 1
    _same_csc(measured[0][0], port._load_csc_pair(path)[0])


class _Plant:
    def __init__(self, path):
        self.path = path

    def __reduce__(self):
        return (open, (self.path, "w"))


# -- device.card_power: one nvidia-smi query for every script --------------

def test_card_power_none_without_nvidia_smi(monkeypatch):
    monkeypatch.setenv("PATH", "")
    assert port_device.card_power() is None
    assert port_device.card_power(0) is None


@pytest.mark.parametrize("index,flag", [(None, []), (2, ["--id=2"])])
def test_card_power_query(index, flag, monkeypatch):
    calls = []

    def run(cmd, **kw):
        calls.append(cmd)
        return SimpleNamespace(stdout="NVIDIA H100 80GB HBM3, 700.00 W\n")
    monkeypatch.setattr(port_device.subprocess, "run", run)
    assert port_device.card_power(index) == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert calls == [["nvidia-smi", *flag, "--query-gpu=name,power.limit",
                      "--format=csv,noheader"]]
