"""The program's own spans and counters, read beside the harness's.

``bpmf_tpu_torch`` opens spans named ``bpmf.*`` where its work happens
(``bpmf_tpu_torch.utils.counters.span``: ``record_function`` ranges while
a profiler runs, in the same trace as the kernels) and counts its host
syncs, kernel builds and set-up parts (``event_counts()``).  A layer file
lists the spans it reads under ``"program_spans"``; the harness wraps
nothing for them.

``layers/program_spans.json`` names this module as a span target, so a
traced run imports it and looks ``window`` up as it installs its spans,
at the window's start.  That look-up snapshots ``event_counts()``, puts
a wrapper in place of ``benchmark.trace.summarize`` and arms it: the
next call (the harness's, once, after the window) returns the harness's
``Summary`` as before, and beside it this module
reduces the same events over the program's spans alone
(``summarize(events, program_spans(), {})``: each device operation goes to
the innermost program span its launch was made in, through the launch's
correlation id, and each idle gap to the innermost program span the host
was in as it began) and snapshots ``event_counts()`` again, at the
window's end.

The readers (``metrics/*.py``) read :func:`last`.  A program without these
spans or counters leaves the reading empty, and its readers return None.
"""

from __future__ import annotations

import functools
import json
from pathlib import Path
from typing import NamedTuple, Optional

from benchmark import trace as tracing

__all__ = ["Reading", "SIDES", "last", "program_spans", "solve_ms_by_side"]

LAYERS = Path(__file__).resolve().parent / "layers"
SIDES = ("movies", "users")


class Reading(NamedTuple):
    start: Optional[dict]       # event_counts() at the window's start
    end: Optional[dict]         # event_counts() at the window's end
    trace: Optional[tracing.Summary]  # the traced window, program spans only
    seen: frozenset             # the program spans the traced window holds


_EMPTY = Reading(None, None, None, frozenset())
_state = {"armed": False, "reading": _EMPTY}
_harness_summarize = getattr(tracing.summarize, "__wrapped__",
                             tracing.summarize)


def program_spans() -> list:
    """Every name the layer files list under ``"program_spans"``."""
    names = []
    for p in sorted(LAYERS.glob("*.json")):
        names += json.loads(p.read_text()).get("program_spans", [])
    return names


def last() -> Reading:
    """The reading of the last traced window (empty before one)."""
    return _state["reading"]


def _event_counts() -> Optional[dict]:
    try:
        from bpmf_tpu_torch.utils.counters import event_counts
    except ImportError:  # a program without the counters
        return None
    return event_counts()


def _window():
    """The attribute the harness wraps: looking it up starts a reading;
    nothing calls it."""




@functools.wraps(_harness_summarize)
def _summarize(events, span_names, layer_patterns):
    out = _harness_summarize(events, span_names, layer_patterns)
    if _state["armed"]:
        _state["armed"] = False
        names = set(program_spans())
        seen = frozenset(e.get("name") for e in events
                         if e.get("cat") == "user_annotation"
                         and e.get("name") in names)
        _state["reading"] = _state["reading"]._replace(
            end=_event_counts(), trace=_harness_summarize(events, names, {}),
            seen=seen)
    return out


def __getattr__(name: str):
    if name != "window":
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    tracing.summarize = _summarize
    _state.update(armed=True, reading=_EMPTY._replace(start=_event_counts()))
    return _window


def solve_ms_by_side(ctx) -> dict:
    """Device milliseconds an iteration of the traced window in each
    side's ``bpmf.solve.<side>`` span, for the sides the window holds."""
    r = last()
    if (r.trace is None or r.trace.n_device_ops == 0
            or ctx.traced_iterations == 0):
        return {}
    return {side: r.trace.span_device_s.get(f"bpmf.solve.{side}", 0.0) * 1e3
            / ctx.traced_iterations
            for side in SIDES if f"bpmf.solve.{side}" in r.seen}
