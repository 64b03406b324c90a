"""The benchmark of ``bpmf_tpu_torch``: one cell of ``BENCHMARK.json``, run
on the card.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

1. The cell's data is made on the card from ``--seed``
   (``benchmark.generator``, the configuration's file and the cell's value
   model).
2. ``bpmf_tpu_torch.sampler.BPMF`` is built with the cell's ``Config`` on
   the route the sampler picks by default, and set up.
3. Iteration 0 runs through ``run_chunk(1)`` (``benchmark.check``), then
   one warm-up chunk.
4. For ``--seconds`` the harness calls ``BPMF.run_chunk(chunk)`` back to
   back; each chunk ends in the sampler's own host sync.
5. One more ``run_chunk(chunk)`` from the state the window left, then the
   program's state is freed, iteration 0 and that chunk are held to the
   plain reference, and the result is printed: the compared numbers and
   their limits on standard error, then one JSON line on standard output.

With ``--trace 1`` the harness wraps each layer's entry functions
(``benchmark/layers/*.json``) with ``torch.profiler.record_function``, and
profiles the last ``trace_seconds`` of the window; the per-layer metrics
(``benchmark/metrics/<name>.py``) read that trace, the spans' host clocks
and the program's launch counters.  Without it nothing is wrapped.

Everything that belongs to one configuration, cell, layer or metric is a
file that the harness finds by its name in ``BENCHMARK.json``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import functools  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import NamedTuple  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "bpmf_tpu")
NSIMS = 1 << 30  # never reached: the window ends the chain


def _cache_env(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program's nvcc builds already go to build/bpmf_tpu_torch/)."""
    cache = root / "build" / "bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"


import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import check, generator, reference, work  # noqa: E402
from benchmark import trace as tracing  # noqa: E402


# -- the manifest and the files it names --------------------------------

def manifest(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(root: Path, workload: str) -> tuple[dict, dict, dict]:
    """(the manifest's workload entry, the cell file, the configuration
    file) of ``workload``."""
    m = manifest(root)
    entry = next((w for w in m["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"unknown workload {workload!r}; workloads: "
                         + ", ".join(w["name"] for w in m["workloads"]))
    conf = next(c for c in m["configs"] if c["name"] == entry["config"])
    cell = load_json(root / "benchmark" / "cells" / f"{entry['traffic']}.json")
    return entry, cell, load_json(root / conf["file"])


def layers(root: Path) -> dict:
    """Every layer file, by its layer's name."""
    out = {}
    for p in sorted((root / "benchmark" / "layers").glob("*.json")):
        d = load_json(p)
        out[d["layer"]] = d
    return out


def cell_metrics(root: Path, trace: bool) -> list[dict]:
    """The metrics a run reports: the end-to-end metrics, or with ``trace``
    the per-layer ones (a reader that finds nothing to read in a cell
    returns None, and the metric is left out of its line)."""
    return manifest(root)["per_layer" if trace else "end_to_end"]


@functools.cache
def reader(root: Path, name: str):
    """``benchmark/metrics/<name>.py``'s ``read``."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# -- spans -----------------------------------------------------------------

class Spans:
    """The traced run's wrappers: each layer file's entry functions, on the
    sampler instance, its draw provider, or a module's attribute, wrapped
    with ``record_function`` and a host clock."""

    def __init__(self, layer_files: dict):
        self.layer_files = layer_files
        self.host = {}       # span -> [host seconds]
        self.undo = []
        self.clocking = True

    def span_names(self) -> set:
        return {s["span"] for d in self.layer_files.values()
                for s in d["spans"]}

    def install(self, sampler) -> None:
        for d in self.layer_files.values():
            for s in d["spans"]:
                on = s["on"]
                if on == "sampler":
                    obj = sampler
                elif on == "draws":
                    obj = sampler.draws
                elif on.startswith("module:"):
                    obj = importlib.import_module(on.split(":", 1)[1])
                else:
                    raise ValueError(f"unknown span target {on!r}")
                self._wrap(obj, s["attr"], s["span"])

    def _wrap(self, obj, attr: str, span: str) -> None:
        fn = getattr(obj, attr)
        had = attr in vars(obj)
        acc = self.host.setdefault(span, [0.0])

        @functools.wraps(fn)
        def wrapped(*a, **kw):
            with torch.profiler.record_function(span):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    if self.clocking:
                        acc[0] += time.perf_counter() - t0

        setattr(obj, attr, wrapped)
        self.undo.append((obj, attr, fn if had else None))

    def remove(self) -> None:
        for obj, attr, fn in reversed(self.undo):
            if fn is None:
                delattr(obj, attr)
            else:
                setattr(obj, attr, fn)
        self.undo.clear()


# -- the metrics' view of a run ---------------------------------------------

class Context:
    """What the metric readers read."""

    def __init__(self, **kw):
        self.trace = None
        self.traced_iterations = 0
        self.untraced = (0, 0.0)
        self.host_spans = {}
        self.layer_files = {}
        self.peak_mem_bytes = None
        self.__dict__.update(kw)

    def host_span(self, span: str) -> tuple[float, int]:
        """(host seconds, iterations) of ``span`` over the untraced part."""
        return self.host_spans.get(span, 0.0), self.untraced[0]

    def layer_ms_per_iter(self, layer: str):
        if self.trace is None or self.traced_iterations == 0:
            return None
        d = self.layer_files[layer]
        s = sum(self.trace.span_device_s.get(x["span"], 0.0)
                for x in d["spans"])
        s += self.trace.pattern_device_s.get(layer, 0.0)
        if s <= 0:
            return None
        return s * 1e3 / self.traced_iterations


# -- the run ------------------------------------------------------------------

def _finite_iterations(met) -> int:
    ok = np.ones(len(met.rmse), bool)
    for x in met:
        ok &= np.isfinite(np.asarray(x, np.float64))
    return int(ok.sum())


def _forbidden_modules() -> list[str]:
    top = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(top & set(FORBIDDEN))


def _card_power() -> str | None:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={torch.cuda.current_device()}"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


class Prepared(NamedTuple):
    entry: dict
    cell: dict
    data: generator.Data      # the harness's copy of the ratings, on the host
    sampler: object           # the program, set up, after its first iteration
    start: dict               # what that iteration produced (check.drive_start)
    ref_order: torch.Tensor   # the reference's test triples by (user, movie)


def prepare(workload: str, seed: int, device, root: Path = ROOT) -> Prepared:
    """Set-up up to the warm-up chunk: the cell's data made on ``device``
    from ``seed``, the sampler built on its default route and set up, and
    its first iteration run through ``run_chunk(1)``."""
    from bpmf_tpu_torch.config import Config
    from bpmf_tpu_torch.sampler import BPMF

    dev = torch.device(device)
    entry, cell, conf = cell_files(root, workload)
    data = generator.make_data(conf, cell["values"], seed, dev)
    train = generator.to_csc(data.train, data.shape)
    test = generator.to_csc(data.test, data.shape)
    data = generator.Data(data.shape, data.train.to("cpu"), data.test.to("cpu"))
    if dev.type == "cuda":
        # the peak is the program's: the generator's temporaries are the
        # harness's
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    cfg = Config(num_latent=cell["k"], dtype=cell["dtype"], nsims=NSIMS,
                 burnin=cell["burnin"], alpha=cell["alpha"], seed=seed,
                 **cell.get("config_fields", {}))
    with open(os.devnull, "w") as devnull:
        sampler = BPMF(cfg, train=train, test=test, out=devnull, device=dev)
        sampler.setup()
    del train, test
    ref_order = torch.argsort(data.test.rows * data.shape[1] + data.test.cols)
    start = check.drive_start(sampler, ref_order)
    return Prepared(entry, cell, data, sampler, start, ref_order)


def release(dev) -> None:
    """Return the memory of dropped program state before the reference
    runs."""
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()


def problem(prep: Prepared, dev) -> reference.Problem:
    c = prep.cell
    return reference.problem(prep.data.shape, prep.data.train, prep.data.test,
                             c["k"], c["alpha"], c["burnin"], dev)


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", root: Path = ROOT, t_start: float | None = None,
             readings: bool = False, with_control: bool = False) -> dict:
    """One run of ``workload``: returns the result line's object (without
    the device check, which :func:`main` makes).  On the CPU the program
    runs its kernels' plain versions.  ``readings`` adds the parts of the
    compared numbers, ``with_control`` the control's (``benchmark.control``)."""
    from bpmf_tpu_torch.ops import launch_counts

    t_start = time.perf_counter() if t_start is None else t_start
    root = Path(root)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    layer_files = layers(root)
    prep = prepare(workload, seed, dev, root)
    entry, cell, data, sampler = prep.entry, prep.cell, prep.data, prep.sampler
    chunk = cell["chunk"]
    sampler.run_chunk(chunk)  # the warm-up chunk

    spans = Spans(layer_files) if trace else None
    if spans is not None:
        spans.install(sampler)
    launches0 = launch_counts()

    # 4. the window
    trace_s = min(cell.get("trace_seconds", 3.0), seconds) if trace else 0.0
    iterations = finite = traced_iters = 0
    summary = None
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    now = t0
    while now - t0 < seconds - trace_s:
        met = sampler.run_chunk(chunk)
        iterations += chunk
        finite += _finite_iterations(met)
        now = time.perf_counter()
    untraced = (iterations, now - t0)
    host_spans = {}
    if trace:
        host_spans = {k: v[0] for k, v in spans.host.items()}
        spans.clocking = False
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            t_tr = time.perf_counter()
            with torch.profiler.record_function(tracing.WINDOW_SPAN):
                while True:
                    met = sampler.run_chunk(chunk)
                    traced_iters += chunk
                    finite += _finite_iterations(met)
                    if time.perf_counter() - t_tr >= trace_s:
                        break
        iterations += traced_iters
        now = time.perf_counter()
    window_s = now - t0
    launches1 = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    if trace:
        spans.remove()
        patterns = {d["layer"]: d["kernels"] for d in layer_files.values()}
        summary = tracing.summarize(tracing.export_events(prof),
                                    spans.span_names(), patterns)
        del prof

    # 5. free the program's state, then hold the checked iterations to the
    # reference
    shape = work.Shape(cell["k"], data.shape[0], data.shape[1],
                       data.train.rows.numel(), data.test.rows.numel())
    n_items = sampler.users.num + sampler.movies.num
    chunk_check = check.drive_chunk(sampler, prep.ref_order, chunk)
    prep = prep._replace(sampler=None)
    del sampler
    release(dev)
    p = problem(prep, dev)
    compared, parts = check.judge(prep.start, chunk_check, p, seed, dev)
    limits = cell["limits"]
    correct = (all(compared[n] <= limits[n] for n in limits)
               and finite == iterations)

    ctx = Context(cell=cell, shape=shape, items=n_items, iterations=iterations,
                  window_s=window_s, setup_s=setup_s,
                  launches={k: launches1[k] - launches0[k] for k in launches1},
                  peak_mem_bytes=peak, trace=summary,
                  traced_iterations=traced_iters,
                  untraced=untraced, window=(iterations, window_s),
                  host_spans=host_spans, layer_files=layer_files,
                  peak_dtype=cell.get("config_fields", {}).get(
                      "matmul_dtype", "float32").replace("auto", "float32"))
    metrics = {}
    for m in cell_metrics(root, trace):
        v = reader(root, m["name"])(ctx)
        if v is None:
            continue
        v = v if isinstance(v, dict) else {"value": v}
        if not math.isfinite(v["value"]):
            continue
        metrics[m["name"]] = {"value": v["value"], "unit": m["unit"],
                              **{k: x for k, x in v.items() if k != "value"}}
    result = {
        "correct": bool(correct),
        "attempted": iterations,
        "failed": iterations - finite,
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": entry["chips"],
                   "memory_peak_bytes": peak,
                   "power_limit": _card_power() if cuda else None},
    }
    if summary is not None:
        result["device"]["busy_s"] = summary.busy_s
        result["device"]["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    result["forbidden_modules"] = _forbidden_modules()
    if readings:
        result["parts"] = parts
    if with_control:
        result["control"], result["control_parts"] = check.judge(
            prep.start, chunk_check, p, seed, dev, control=True)
    result["compared"] = {n: {"value": compared[n], "limit": limits[n]}
                          for n in limits}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    _cache_env(ROOT)
    entry, _, _ = cell_files(ROOT, a.workload)
    if not torch.cuda.is_available():
        print("benchmark: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < entry["chips"]:
        print(f"benchmark: {a.workload} needs {entry['chips']} GPUs, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result = run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                      device="cuda", t_start=T_START)
    if result["forbidden_modules"]:
        print("benchmark: modules of the JAX package loaded in this process: "
              + ", ".join(result["forbidden_modules"]), file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"compared {name}: {c['value']:.6g} (limit {c['limit']:.6g})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
