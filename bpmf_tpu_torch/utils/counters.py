"""Hierarchical phase timers — the analog of BPMF_COUNTER
(c++/counters.h:14-33, c++/counters.cpp:31-56,102-156).

The reference wraps every phase (main/movies/compute/computeMuLambda/...)
in RAII wall-clock scopes kept in both a hierarchical map (full path) and a
flat per-name map, printed at exit with %-of-parent.  Here a scope is a
context manager; since CUDA work is asynchronous, callers that want
accurate phase times must pass ``sync=...`` a function that blocks until
the device is idle (e.g. ``torch.cuda.synchronize``) — timers are only
meaningful when profiling is enabled, so the extra sync cost is opt-in,
exactly like ENABLE_PROFILING in the reference build
(CMakeLists.txt:125-127).  Copy of ``bpmf_tpu/utils/counters.py``.

Beside the phase timers, the port's one tracing module:

- :func:`span` opens a named range (``bpmf.*``) where the work happens.
  While the autograd profiler runs (``torch.profiler``) it is a
  ``record_function``, so the range lands in the same trace as the
  kernels, on the same clock; otherwise it costs one flag check.
- :class:`SetupClock` clocks the named parts of a sampler's set-up with
  ``time.perf_counter``, always.
- Process-wide event counters, read through :func:`event_counts`: the
  host's syncs with the device by site, the kernel builds with their
  ``nvcc`` seconds, and the set-up parts of the last sampler built.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch
from torch._C._autograd import _profiler_enabled


class Counters:
    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._stack: list[str] = []
        self.hier: dict[str, float] = defaultdict(float)
        self.flat: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def scope(self, name: str, sync=None):
        if not self.enabled:
            yield
            return
        self._stack.append(name)
        full = "/".join(self._stack)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                sync()
            dt = time.perf_counter() - t0
            self.hier[full] += dt
            self.flat[name] += dt
            self.counts[full] += 1
            self._stack.pop()

    def report(self) -> str:
        """Render the hierarchical + flat report (c++/counters.cpp:137-156)."""
        if not self.enabled or not self.hier:
            return ""
        lines = ["perf counters (hierarchical):"]
        total = self.hier.get("main", sum(v for k, v in self.hier.items() if "/" not in k))
        for full in sorted(self.hier):
            depth = full.count("/")
            t = self.hier[full]
            parent = full.rsplit("/", 1)[0] if "/" in full else None
            pt = self.hier.get(parent, total) if parent else total
            pct_parent = 100.0 * t / pt if pt else 0.0
            pct_total = 100.0 * t / total if total else 0.0
            lines.append(
                f"  {'  ' * depth}{full.rsplit('/', 1)[-1]:<24} "
                f"{t:10.4f}s  x{self.counts[full]:<6d} "
                f"{pct_parent:5.1f}%parent {pct_total:5.1f}%total"
            )
        lines.append("perf counters (flat):")
        for name in sorted(self.flat, key=self.flat.get, reverse=True):
            lines.append(f"  {name:<28} {self.flat[name]:10.4f}s")
        return "\n".join(lines)


def tick() -> float:
    """Monotonic seconds (c++/counters.cpp:160-163)."""
    return time.perf_counter()


# -- spans ----------------------------------------------------------------

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context manager naming the range it encloses ``name`` (every name
    of the port starts with ``bpmf.``): ``torch.profiler.record_function``
    while the profiler runs, else a shared no-op that costs the one flag
    check."""
    if _profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


class SetupClock:
    """Host seconds of the named parts of a sampler's set-up, clocked with
    ``time.perf_counter`` whether or not a profiler runs; each part is also
    a span ``bpmf.setup.<part>``."""

    def __init__(self):
        self.parts: dict[str, float] = {}

    @contextlib.contextmanager
    def part(self, name: str):
        t0 = time.perf_counter()
        try:
            with span(f"bpmf.setup.{name}"):
                yield
        finally:
            self.parts[name] = (self.parts.get(name, 0.0)
                                + time.perf_counter() - t0)


# -- event counters ---------------------------------------------------------

_host_syncs: dict[str, int] = defaultdict(int)
_builds = {"count": 0, "seconds": 0.0}
_setup = SetupClock()


def count_sync(site: str) -> None:
    """One blocking wait of the host on the device at ``site`` (a
    device-to-host copy or a synchronize); counted on every device, so a
    chain on the CPU counts what the same chain blocks on the card."""
    _host_syncs[site] += 1


def count_build(seconds: float) -> None:
    """One kernel library compiled (a build cache miss), and its seconds."""
    _builds["count"] += 1
    _builds["seconds"] += seconds


def setup_clock() -> SetupClock:
    """A fresh clock for a sampler's set-up parts; :func:`event_counts`
    reports the last one made."""
    global _setup
    _setup = SetupClock()
    return _setup


def event_counts() -> dict:
    """The process's events so far: ``host_sync`` (site -> count),
    ``kernel_build`` (``count``, ``seconds``) and ``setup_s`` (the last
    sampler's set-up part -> host seconds).  A copy: the caller may keep
    it as a snapshot."""
    return {"host_sync": dict(_host_syncs), "kernel_build": dict(_builds),
            "setup_s": dict(_setup.parts)}
