"""One traced run of a cell, held to the program's own spans and counters:
where the hand-written kernels' device time went, the host's synchronizing
runtime calls against the program's ``host_sync`` counter, where the host
spent its runtime calls (a launch that blocks on a full queue is a long
one), the window's copies by the program span that made them, and what a
span costs with no profiler running.

    python3 -m benchmark.trace_check --workload ml25m.k32 --seed 12345 --seconds 20

Prints one JSON object; the benchmark's own runs never run it.  On a
program without spans (an older tree) the program's parts read empty.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict

from benchmark import program_trace, run
from benchmark import trace as tracing

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D",
              "cudaMemcpy3D", "cudaMemcpyFromSymbol", "cudaMemcpyToSymbol")
SOLVE_SPANS = {f"bpmf.solve.{s}" for s in program_trace.SIDES}


def _span_cost_us(n: int = 100_000) -> float | None:
    """Microseconds of one ``span()`` with no profiler running."""
    try:
        from bpmf_tpu_torch.utils.counters import span
    except ImportError:
        return None
    t0 = time.perf_counter()
    for _ in range(n):
        with span("bpmf.cost"):
            pass
    return (time.perf_counter() - t0) / n * 1e6


def check(events: list, kernel: str = "sweep_solve") -> dict:
    """The traced window's numbers: ``kernel``'s device time and its share
    launched in the solve spans; the synchronizing calls, the copies and
    the runtime calls' host time, each by innermost program span; the
    harness's ``iter_fn`` spans (the traced iterations) and the program
    spans an iteration."""
    xs = [e for e in events if e.get("ph") == "X"]
    w = next(e for e in xs if e.get("name") == tracing.WINDOW_SPAN)
    w0, w1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    tid = w.get("tid")
    names = set(program_trace.program_spans())

    def inside(e):
        return w0 <= float(e["ts"]) <= w1

    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
             for e in xs if e.get("cat") == "user_annotation"
             and e.get("name") in names and e.get("tid") == tid]
    painter = tracing._Painter(spans)
    launches = {}
    runtime_us = defaultdict(float)
    syncs = defaultdict(int)
    longest = []
    for e in xs:
        if e.get("cat") not in tracing.LAUNCH_CATS or not inside(e):
            continue
        at = painter.at(float(e["ts"])) or tracing.OUTSIDE
        c = (e.get("args") or {}).get("correlation")
        if c is not None:
            launches[c] = at
        if e.get("tid") == tid:
            runtime_us[at] += float(e["dur"])
            longest.append((float(e["dur"]), e["name"], at))
        if e["name"] in SYNC_CALLS:
            syncs[f"{e['name']} in {at}"] += 1
    k_us = k_solve_us = 0.0
    copies = defaultdict(int)
    for e in xs:
        if e.get("cat") == "gpu_memcpy" and inside(e):
            at = launches.get((e.get("args") or {}).get("correlation"))
            copies[f"{e.get('name')} in {at or tracing.OUTSIDE}"] += 1
        if e.get("cat") != "kernel" or kernel not in e.get("name", ""):
            continue
        s = max(float(e["ts"]), w0)
        t = min(float(e["ts"]) + float(e["dur"]), w1)
        if t <= s:
            continue
        k_us += t - s
        c = (e.get("args") or {}).get("correlation")
        if launches.get(c) in SOLVE_SPANS:
            k_solve_us += t - s
    iters = sum(1 for e in xs if e.get("cat") == "user_annotation"
                and e.get("name") == "iter_fn" and inside(e))
    n_spans = sum(1 for x in spans if w0 <= x[0] <= w1)
    longest.sort(reverse=True)
    return {
        "window_s": (w1 - w0) * 1e-6,
        "traced_iterations": iters,
        "traced_ms_per_iter": (w1 - w0) * 1e-3 / iters if iters else None,
        "kernel": kernel,
        "kernel_device_s": k_us * 1e-6,
        "kernel_share_in_solve_spans": k_solve_us / k_us if k_us else None,
        "sync_calls": dict(syncs),
        "sync_calls_per_iter": sum(syncs.values()) / iters if iters else None,
        "copies": dict(copies),
        "runtime_ms_per_iter_by_span": {
            k: v * 1e-3 / iters for k, v in
            sorted(runtime_us.items(), key=lambda kv: -kv[1])} if iters else {},
        "longest_runtime_calls_us": [[round(d, 1), n, at]
                                     for d, n, at in longest[:10]],
        "program_spans_per_iter": n_spans / iters if iters else None,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    a = ap.parse_args(argv)
    run._cache_env(run.ROOT)
    captured = {}
    export = tracing.export_events

    def keep(prof):
        captured["events"] = export(prof)
        return captured["events"]

    tracing.export_events = keep
    try:
        result = run.run_cell(a.workload, a.seed, a.seconds, True)
    finally:
        tracing.export_events = export
    out = check(captured.pop("events"))
    out["span_off_us"] = _span_cost_us()
    if out["span_off_us"] is not None and out["program_spans_per_iter"]:
        out["spans_off_us_per_iter"] = (out["span_off_us"]
                                        * out["program_spans_per_iter"])
    out["correct"] = result["correct"]
    out["metrics"] = result["metrics"]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
