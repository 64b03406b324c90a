"""The port's tracing (``bpmf_tpu_torch.utils.counters``) and the
benchmark's reading of it (``benchmark/program_trace.py`` and its metric
readers), on the CPU: the spans a chain opens and how they nest, their
cost with no profiler, the host-sync, kernel-build and set-up counters,
the program's reduction of a trace beside the harness's, and each new
reader on a hand-made context."""

import contextlib
import gc
import importlib.util
import io
import json
import os
import tempfile
import time
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from benchmark import program_trace, work
from benchmark import trace as tracing
from bpmf_tpu_torch import synth_movielens
from bpmf_tpu_torch.config import Config
from bpmf_tpu_torch.ops import _build
from bpmf_tpu_torch.sampler import BPMF
from bpmf_tpu_torch.utils import counters

REPO = Path(__file__).resolve().parents[1]
SIDES = ("movies", "users")
# every hot-path span of one iteration, and the span each nests in
PARENT = {"bpmf.iter": None, "bpmf.hyper.draws": "bpmf.iter",
          "bpmf.hyper.sample": "bpmf.iter", "bpmf.predict": "bpmf.iter",
          **{f"bpmf.sweep.{s}": "bpmf.iter" for s in SIDES},
          **{f"bpmf.{k}.{s}": f"bpmf.sweep.{s}"
             for s in SIDES for k in ("noise", "solve")}}
# (gram_impl, BPMF_D8_SOLVE): the megakernel, the split pipeline, the
# buckets and plain dense
ROUTES = [("auto", None), ("auto", "split"), ("bucketed", None),
          ("dense", None)]


@pytest.fixture(autouse=True)
def default_routes(monkeypatch):
    for var in ("BPMF_TRI_GROUPED", "BPMF_D8_SOLVE", "BPMF_D8_PT"):
        monkeypatch.delenv(var, raising=False)


def _sampler(gram_impl="auto", n_users=300, n_movies=200, n_ratings=5000,
             **cfg):
    train, test = synth_movielens(n_users=n_users, n_movies=n_movies,
                                  n_ratings=n_ratings, seed=3)
    cfg = {"num_latent": 8, "burnin": 1, "nsims": 100, **cfg}
    s = BPMF(Config(gram_impl=gram_impl, **cfg), train, test,
             out=open(os.devnull, "w"), device="cpu")
    s.setup()
    return s


def _events(prof) -> list:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def _profiled(fn) -> list:
    """The ``bpmf.*`` spans ``fn()`` opens under the CPU profiler, as
    (name, start, end, the innermost span enclosing it)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    xs = sorted(((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                 for e in _events(prof)
                 if e.get("cat") == "user_annotation"
                 and e["name"].startswith("bpmf.")),
                key=lambda x: (x[1], x[1] - x[2]))
    out = []
    for name, t0, t1 in xs:
        parents = [p for p in xs if p[1] <= t0 and t1 <= p[2]
                   and (p[0], p[1], p[2]) != (name, t0, t1)]
        inner = min(parents, key=lambda p: p[2] - p[1]) if parents else None
        out.append((name, t0, t1, inner[0] if inner else None))
    return out


@pytest.mark.parametrize("gram_impl,solve", ROUTES)
def test_chain_opens_every_span_nested(gram_impl, solve, monkeypatch):
    """Two chunks of 3 iterations under the profiler open each hot-path
    span 6 times, nested as the sampler names them, with the stats inside
    each side's sweep and exactly one ``bpmf.sync`` a chunk, outside every
    other span."""
    if solve:
        monkeypatch.setenv("BPMF_D8_SOLVE", solve)
    s = _sampler(gram_impl)
    s.run_chunk(1)
    spans = _profiled(lambda: (s.run_chunk(3), s.run_chunk(3)))
    names = Counter(n for n, *_ in spans)
    for name, parent in PARENT.items():
        assert names[name] == 6, (name, names)
        assert {p for n, _, _, p in spans if n == name} == {parent}, name
    assert names["bpmf.sync"] == 2
    assert {p for n, _, _, p in spans if n == "bpmf.sync"} == {None}
    assert names["bpmf.stats"] >= 12
    assert {p for n, _, _, p in spans if n == "bpmf.stats"} == {
        f"bpmf.sweep.{s}" for s in SIDES}
    # noise, then the solve, then the stats, one after another in a sweep
    for side in SIDES:
        sweep = [x for x in spans if x[0] == f"bpmf.sweep.{side}"][0]
        kids = [n for n, t0, _, p in spans
                if p == sweep[0] and sweep[1] <= t0 <= sweep[2]]
        assert kids[:2] == [f"bpmf.noise.{side}", f"bpmf.solve.{side}"]
        assert set(kids[2:]) == {"bpmf.stats"}


def test_defer_predict_span():
    """The chunk-batched evaluation runs in ``bpmf.predict`` too."""
    s = _sampler(defer_predict="on")
    spans = _profiled(lambda: s.run_chunk(4))
    assert [p for n, *_, p in spans if n == "bpmf.predict"] == [None]
    assert sum(n == "bpmf.sync" for n, *_ in spans) == 1


def test_no_profiler_never_enters_record_function(monkeypatch):
    """With no profiler running a chain enters ``record_function`` for no
    span; under the profiler it does, so the count sees the spans."""
    calls = []

    def counting(name):
        calls.append(name)
        return contextlib.nullcontext()

    s = _sampler()
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    s.run_chunk(2)
    assert calls == []
    with counters.span("bpmf.x"):
        pass
    assert calls == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        s.run_chunk(1)
    assert "bpmf.iter" in calls and "bpmf.sync" in calls


def test_span_off_is_one_shared_no_op():
    assert counters.span("bpmf.a") is counters.span("bpmf.b")


@pytest.mark.parametrize("n,defer", [(1, "off"), (5, "off"), (5, "on")])
def test_run_chunk_counts_one_host_sync(n, defer):
    s = _sampler(defer_predict=defer)
    before = counters.event_counts()["host_sync"]
    s.run_chunk(n)
    after = counters.event_counts()["host_sync"]
    assert after.get("run_chunk", 0) - before.get("run_chunk", 0) == 1
    assert sum(after.values()) - sum(before.values()) == 1


def test_sync_sites_outside_the_chain(tmp_path):
    """``items_host``, the output files, the checkpoint and ``run()``'s
    final pass each count their site."""
    s = _sampler(output_dir=str(tmp_path / "out"), nsims=3,
                 checkpoint_path=str(tmp_path / "c.npz"))
    before = counters.event_counts()["host_sync"]
    s.items_host(s.users, s.state_u)
    s.run()
    after = counters.event_counts()["host_sync"]
    delta = {k: v - before.get(k, 0) for k, v in after.items()}
    assert delta["items_host"] == 1
    assert delta["write_output"] == 1
    assert delta["checkpoint"] == 1
    assert delta["run_final"] == 1
    assert delta["run_chunk"] >= 1
    assert "run" not in delta or delta["run"] == 0  # the CPU: no synchronize


@pytest.mark.parametrize("gram_impl", ["auto", "bucketed", "dense"])
def test_setup_parts_cover_the_setup(gram_impl):
    """The parts sum to at least 95% of ``BPMF(...)`` + ``setup()`` clocked
    around them, and ``event_counts()`` reports the last sampler's."""
    train, test = synth_movielens(n_users=2000, n_movies=1000,
                                  n_ratings=40000, seed=3)
    cfg = Config(num_latent=8, burnin=1, nsims=10, gram_impl=gram_impl)
    out = open(os.devnull, "w")
    best = 0.0
    for _ in range(3):
        gc.collect()
        gc.disable()
        try:
            t0 = time.perf_counter()
            s = BPMF(cfg, train, test, out=out, device="cpu")
            s.setup()
            total = time.perf_counter() - t0
        finally:
            gc.enable()
        best = max(best, sum(s.setup_parts.values()) / total)
    assert 0.95 <= best <= 1.0
    assert counters.event_counts()["setup_s"] == s.setup_parts
    want = {"inputs", "side_maps", "test_entries", "route",
            "aux.movies", "aux.users", "eval_data", "state", "banner"}
    if gram_impl == "auto":
        want |= {"codes_host", "codes_copy", "codes_degrees"}
    assert set(s.setup_parts) == want
    s.setup()  # a second call is not clocked again
    assert counters.event_counts()["setup_s"] == s.setup_parts


def test_every_listed_program_span_is_opened():
    """Every name the layer files list under ``program_spans`` is a span
    that set-up and a chain on the megakernel's route open."""
    listed = program_trace.program_spans()
    assert listed and len(listed) == len(set(listed))
    assert all(n.startswith("bpmf.") for n in listed)
    found = {}

    def run():
        found["s"] = _sampler()
        found["s"].run_chunk(2)

    opened = {n for n, *_ in _profiled(run)}
    assert set(listed) <= opened, set(listed) - opened
    for p in (REPO / "benchmark/layers").glob("*.json"):
        d = json.loads(p.read_text())
        assert {"layer", "modules", "spans", "kernels"} <= set(d)


def test_kernel_build_counted_on_a_cache_miss(tmp_path, monkeypatch):
    """A compile (here a stand-in that succeeds) counts one build and its
    seconds; the cached library counts none."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "true")
    before = counters.event_counts()["kernel_build"]
    lib, _ = _build.build("gather_probe")
    mid = counters.event_counts()["kernel_build"]
    assert lib.parent == tmp_path and lib.exists()
    assert mid["count"] == before["count"] + 1
    assert mid["seconds"] > before["seconds"]
    _build.build("gather_probe")
    assert counters.event_counts()["kernel_build"] == mid


def test_profile_report_appends_parts_and_events():
    train, test = synth_movielens(n_users=300, n_movies=200, n_ratings=5000,
                                  seed=3)
    out = io.StringIO()
    s = BPMF(Config(num_latent=4, nsims=3, burnin=1, profile=True), train,
             test, out=out, device="cpu")
    s.run()
    text = out.getvalue()
    assert "set-up parts (host seconds" in text
    for part in s.setup_parts:
        assert f"  {part} " in text
    assert "kernel builds: " in text and "host syncs: " in text
    syncs = next(x for x in text.splitlines() if x.startswith("host syncs: "))
    assert "run_chunk " in syncs and "run_final " in syncs, syncs
    assert text.index("perf counters (flat):") < text.index("set-up parts")
    assert text.index("set-up parts") < text.index("sweep phase attribution")


def test_event_counts_is_a_copy():
    ev = counters.event_counts()
    ev["host_sync"]["x"] = 5
    ev["kernel_build"]["count"] = -1
    assert "x" not in counters.event_counts()["host_sync"]
    assert counters.event_counts()["kernel_build"]["count"] != -1


# -- the benchmark's reading ------------------------------------------------

def _x(name, ts, dur, cat="user_annotation", tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1, "args": args}


def _trace(with_program: bool) -> list:
    """A window of two iterations: the harness's spans ``iter_fn``,
    ``sweep`` and ``sync`` on the host, kernels launched in them, a
    chunk's copy and stream sync, and, with ``with_program``, the
    program's spans nested inside the harness's."""
    ev = [_x(tracing.WINDOW_SPAN, 0, 1000)]
    corr = 0
    for i, t in enumerate((0, 500)):
        ev.append(_x("iter_fn", t + 10, 400))
        ev.append(_x("sweep", t + 20, 300))
        if with_program:
            ev.append(_x("bpmf.iter", t + 12, 396))
            ev.append(_x("bpmf.sweep.movies", t + 22, 140))
            ev.append(_x("bpmf.solve.movies", t + 30, 120))
            ev.append(_x("bpmf.sweep.users", t + 170, 140))
            ev.append(_x("bpmf.solve.users", t + 175, 100))
            ev.append(_x("bpmf.stats", t + 280, 20))
        for launch, k0, dur, name in ((t + 40, t + 60, 100, "sweep_solve"),
                                      (t + 180, t + 200, 150, "sweep_solve"),
                                      (t + 290, t + 360, 30, "reduce"),
                                      (t + 400, t + 430, 20, "gather")):
            corr += 1
            ev.append(_x("cudaLaunchKernel", launch, 5, cat="cuda_runtime",
                         correlation=corr))
            ev.append(_x(name, k0, dur, cat="kernel", tid=7, correlation=corr))
        ev.append(_x("sync", t + 450, 40))
        if with_program:
            ev.append(_x("bpmf.sync", t + 455, 30))
        corr += 1
        ev.append(_x("cudaMemcpyAsync", t + 458, 3, cat="cuda_runtime",
                     correlation=corr))
        ev.append(_x("Memcpy DtoH", t + 462, 2, cat="gpu_memcpy", tid=7,
                     correlation=corr))
        ev.append(_x("cudaStreamSynchronize", t + 462, 20,
                     cat="cuda_runtime"))
    return ev


HARNESS = {"iter_fn", "sweep", "sync"}
PATTERNS = {"half-sweep": ["sweep_solve"], "evaluation": []}


def test_harness_summary_unchanged_by_program_spans():
    plain = tracing.summarize(_trace(False), HARNESS, PATTERNS)
    both = tracing.summarize(_trace(True), HARNESS, PATTERNS)
    assert both == plain
    assert plain.span_device_s["sweep"] == pytest.approx(560e-6)


def test_program_summary_by_correlation():
    """Over the program's spans alone each kernel goes to the innermost
    program span it was launched in (no name pattern), and each gap to the
    innermost program span the host was in as it began."""
    names = set(program_trace.program_spans())
    s = tracing.summarize(_trace(True), names, {})
    dev = s.span_device_s
    assert dev["bpmf.solve.movies"] == pytest.approx(200e-6)
    assert dev["bpmf.solve.users"] == pytest.approx(300e-6)
    assert dev["bpmf.stats"] == pytest.approx(60e-6)
    assert dev["bpmf.iter"] == pytest.approx(40e-6)
    assert s.pattern_device_s == {} and s.unattributed_s == 0
    gaps = dict(s.idle_gaps)
    assert sum(gaps.values()) == pytest.approx(s.window_s - s.busy_s)
    assert gaps["bpmf.sweep.movies"] == pytest.approx(2 * 40e-6)
    assert gaps["outside spans"] == pytest.approx((60 + 12 + 12) * 1e-6)
    assert gaps["bpmf.sync"] == pytest.approx((96 + 36) * 1e-6)


def test_trace_check_on_a_hand_made_trace():
    """The card check: #1's device time all launched in the solve spans,
    one stream sync and one copy a chunk, in ``bpmf.sync``."""
    from benchmark import trace_check

    got = trace_check.check(_trace(True))
    assert got["traced_iterations"] == 2
    assert got["kernel_share_in_solve_spans"] == 1.0
    assert got["kernel_device_s"] == pytest.approx(500e-6)
    assert got["sync_calls"] == {"cudaStreamSynchronize in bpmf.sync": 2}
    assert got["copies"] == {"Memcpy DtoH in bpmf.sync": 2}
    assert got["runtime_ms_per_iter_by_span"]["bpmf.sync"] == pytest.approx(
        0.023)
    assert got["program_spans_per_iter"] == 7
    plain = trace_check.check(_trace(False))
    assert plain["kernel_share_in_solve_spans"] == 0.0
    assert plain["sync_calls"] == {
        "cudaStreamSynchronize in outside spans": 2}


def _arm_and_summarize(events):
    """What a traced run does: look ``window`` up as the harness installs
    its spans, then the harness's summarize after the window."""
    getattr(program_trace, "window")
    return tracing.summarize(events, HARNESS, PATTERNS)


def test_hook_reads_the_window_once():
    events = _trace(True)
    out = _arm_and_summarize(events)
    assert out == program_trace._harness_summarize(events, HARNESS, PATTERNS)
    r = program_trace.last()
    assert r.start == r.end == counters.event_counts()
    assert r.trace.span_device_s["bpmf.solve.users"] == pytest.approx(300e-6)
    assert "bpmf.solve.movies" in r.seen and "bpmf.iter" in r.seen
    # disarmed: a later summarize leaves the reading as it was
    tracing.summarize(_trace(False), HARNESS, PATTERNS)
    assert program_trace.last() is r
    with pytest.raises(AttributeError):
        getattr(program_trace, "nothing")


def _reader(name):
    path = REPO / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"reader_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


NEW = ("solve_ms_per_iter", "solve_roofline_pct", "host_syncs_per_iter",
       "idle_gap_ms_per_iter", "sampler_setup_s")


def _ctx(**kw):
    shape = work.Shape(32, 1000, 500, 20000, 2000)
    return SimpleNamespace(traced_iterations=2, iterations=40, shape=shape,
                           peak_dtype="float32", **kw)


def _reading(events, start, end):
    names = set(program_trace.program_spans())
    return program_trace.Reading(
        start, end, program_trace._harness_summarize(events, names, {}),
        frozenset(e["name"] for e in events
                  if e.get("cat") == "user_annotation" and e["name"] in names))


@pytest.fixture
def reading(monkeypatch):
    start = {"host_sync": {"run_chunk": 3, "items_host": 2},
             "kernel_build": {"count": 1, "seconds": 2.0}, "setup_s": {}}
    end = {"host_sync": {"run_chunk": 5, "items_host": 2, "run": 1},
           "kernel_build": {"count": 4, "seconds": 9.5},
           "setup_s": {"route": 1.5, "codes_host": 6.0, "banner": 0.5}}
    r = _reading(_trace(True), start, end)
    monkeypatch.setitem(program_trace._state, "reading", r)
    return r


def test_reader_solve_ms(reading):
    got = _reader("solve_ms_per_iter")(_ctx())
    assert got["by_side"] == pytest.approx({"movies": 0.1, "users": 0.15})
    assert got["value"] == pytest.approx(0.25)


def test_reader_solve_roofline(reading):
    got = _reader("solve_roofline_pct")(_ctx())
    ms = {"movies": 0.1, "users": 0.15}
    least = {}
    for side, w in zip(SIDES, work.sweeps(_ctx().shape)):
        least[side] = max(w.ops / work.PEAK_FLOPS["float32"],
                          w.bytes / work.PEAK_BYTES_PER_S) * 1e3
    assert got["value"] == pytest.approx(100 * sum(least.values()) / 0.25)
    assert got["by_side"] == pytest.approx(
        {s: 100 * least[s] / ms[s] for s in SIDES})
    assert set(got["bound"].values()) <= {"operations", "bytes"}


def test_reader_host_syncs(reading):
    got = _reader("host_syncs_per_iter")(_ctx())
    assert got["value"] == pytest.approx(3 / 40)
    assert got["by_site"] == pytest.approx({"run_chunk": 2 / 40,
                                            "run": 1 / 40})


def test_reader_idle_gaps(reading):
    got = _reader("idle_gap_ms_per_iter")(_ctx())
    t = reading.trace
    assert got["value"] == pytest.approx((t.window_s - t.busy_s) * 1e3 / 2)
    assert sum(got["by_span"].values()) == pytest.approx(got["value"])
    assert got["by_span"]["bpmf.sweep.movies"] == pytest.approx(0.04)


def test_reader_sampler_setup(reading):
    got = _reader("sampler_setup_s")(_ctx())
    assert got["value"] == pytest.approx(8.0)
    assert got["by_part"] == {"route": 1.5, "codes_host": 6.0, "banner": 0.5}
    assert got["kernel_build_s"] == 9.5


@pytest.mark.parametrize("name", NEW)
def test_readers_silent_without_the_program_spans(name, monkeypatch):
    """A program without spans or counters (an older tree) leaves every new
    reader with nothing to read: it returns None."""
    r = _reading(_trace(False), None, None)
    monkeypatch.setitem(program_trace._state, "reading", r)
    assert _reader(name)(_ctx()) is None
    monkeypatch.setitem(program_trace._state, "reading", program_trace._EMPTY)
    assert _reader(name)(_ctx()) is None


def test_manifest_lists_the_new_metrics():
    m = json.loads((REPO / "BENCHMARK.json").read_text())
    per_layer = {x["name"]: x for x in m["per_layer"]}
    layers = {json.loads(p.read_text())["layer"]
              for p in (REPO / "benchmark/layers").glob("*.json")}
    for name in NEW:
        entry = per_layer[name]
        assert entry["layer"] in layers
        assert entry["workloads"] == ["ml25m.k32"]
    assert [x["name"] for x in m["per_layer"][-len(NEW):]] == list(NEW)
