"""Reduction of one traced window (a ``torch.profiler`` chrome trace) to the
numbers the per-layer metrics read.

- Device operations are the trace's ``kernel``, ``gpu_memcpy`` and
  ``gpu_memset`` events, cut to the window.
- Each is attributed to the innermost harness span (a
  ``record_function`` range) that was open on the host thread when it was
  launched, found through its launch's ``correlation`` id; one whose launch
  is not in the trace goes to the layer whose kernel-name patterns match
  it, else to ``unattributed``.
- ``busy_s`` is the union of the device operations' intervals: the time in
  which at least one ran, however many streams.
- Idle gaps are the window's time outside that union, each named by the
  innermost span the launching thread was in when the gap began.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
from collections import defaultdict
from typing import NamedTuple

__all__ = ["Summary", "summarize", "export_events", "DEVICE_CATS",
           "WINDOW_SPAN"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW_SPAN = "bench.traced_window"
OUTSIDE = "outside spans"
TOP = 10


class Summary(NamedTuple):
    window_s: float
    busy_s: float
    span_device_s: dict       # span name -> device seconds launched in it
    pattern_device_s: dict    # layer -> seconds of unlaunched ops it matched
    unattributed_s: float
    device_ops: list          # [[kernel name, seconds]] longest first
    idle_gaps: list           # [[span name, seconds]] longest first
    n_device_ops: int


def export_events(prof) -> list:
    """The trace's events: exported to a temporary file under TMPDIR, read
    back and deleted."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)


class _Painter:
    """The innermost span open at a time on one thread: spans nest, so a
    sweep over their edges flattens them into segments."""

    def __init__(self, spans):
        edges = []
        for ts, end, name in spans:
            # at one instant: closes before opens, an inner span closing
            # first and an outer one opening first
            edges.append((ts, 1, ts - end, name))
            edges.append((end, 0, end - ts, name))
        edges.sort(key=lambda e: e[:3])
        self.starts, self.names = [], []
        stack = []
        for t, opening, _, name in edges:
            if opening:
                stack.append(name)
            elif name in stack:
                # remove the innermost open span of that name
                del stack[len(stack) - 1 - stack[::-1].index(name)]
            self.starts.append(t)
            self.names.append(stack[-1] if stack else None)

    def at(self, t: float):
        i = bisect.bisect_right(self.starts, t) - 1
        return self.names[i] if i >= 0 else None


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events: list, span_names: set, layer_patterns: dict) -> Summary:
    """The window's numbers.  ``span_names``: the harness's spans;
    ``layer_patterns``: layer -> regular expressions of its kernels' names.
    Times in the trace are microseconds."""
    xs = [e for e in events if e.get("ph") == "X"]
    win = [e for e in xs if e.get("name") == WINDOW_SPAN]
    if not win:
        raise ValueError(f"the trace has no {WINDOW_SPAN!r} span")
    w = win[0]
    w0, w1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    main_tid = w.get("tid")

    by_tid = defaultdict(list)
    for e in xs:
        if e.get("cat") == "user_annotation" and e.get("name") in span_names:
            ts = float(e["ts"])
            by_tid[e.get("tid")].append((ts, ts + float(e["dur"]), e["name"]))
    painters = {tid: _Painter(sp) for tid, sp in by_tid.items()}
    launches = {}
    for e in xs:
        if e.get("cat") in LAUNCH_CATS:
            c = (e.get("args") or {}).get("correlation")
            if c is not None:
                launches[c] = (e.get("tid"), float(e["ts"]))
    pats = {layer: [re.compile(p) for p in ps]
            for layer, ps in layer_patterns.items()}

    span_dev = defaultdict(float)
    pat_dev = defaultdict(float)
    kernels = defaultdict(float)
    unattributed = 0.0
    busy = []
    n_ops = 0
    for e in xs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        s = max(float(e["ts"]), w0)
        t = min(float(e["ts"]) + float(e["dur"]), w1)
        if t <= s:
            continue
        n_ops += 1
        d = (t - s) * 1e-6
        busy.append((s, t))
        name = e.get("name", "?")
        kernels[name] += d
        span = None
        launch = launches.get((e.get("args") or {}).get("correlation"))
        if launch is not None and launch[0] in painters:
            span = painters[launch[0]].at(launch[1])
        if span is not None:
            span_dev[span] += d
            continue
        layer = next((lay for lay, ps in pats.items()
                      if any(p.search(name) for p in ps)), None)
        if layer is not None:
            pat_dev[layer] += d
        else:
            unattributed += d

    union = _union(busy)
    busy_s = sum(e - s for s, e in union) * 1e-6
    gaps = defaultdict(float)
    painter = painters.get(main_tid)
    prev = w0
    for s, e in union + [[w1, w1]]:
        if s > prev:
            name = (painter.at(prev) if painter else None) or OUTSIDE
            gaps[name] += (s - prev) * 1e-6
        prev = max(prev, e)

    def top(d):
        return [[k[:160], v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return Summary(window_s=(w1 - w0) * 1e-6, busy_s=busy_s,
                   span_device_s=dict(span_dev),
                   pattern_device_s=dict(pat_dev),
                   unattributed_s=unattributed, device_ops=top(kernels),
                   idle_gaps=top(gaps), n_device_ops=n_ops)
