"""idle_gap_ms_per_iter: the traced window's time with no device operation
running, in milliseconds an iteration; ``by_span``: each gap under the
innermost program span the host was in as it began ("outside spans" when
none), the ten largest (benchmark.program_trace)."""

from benchmark import program_trace


def read(ctx):
    r = program_trace.last()
    if (r.trace is None or r.trace.n_device_ops == 0 or not r.seen
            or ctx.traced_iterations == 0):
        return None
    n = ctx.traced_iterations
    return {"value": (r.trace.window_s - r.trace.busy_s) * 1e3 / n,
            "by_span": {name: s * 1e3 / n for name, s in r.trace.idle_gaps}}
