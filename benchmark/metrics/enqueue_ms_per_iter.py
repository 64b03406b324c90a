"""enqueue_ms_per_iter: host milliseconds inside the harness's spans
around each BPMF.iter_fn call, per iteration, over the traced run's
untraced part (the profiler slows the host)."""


def read(ctx):
    s, n = ctx.host_span("iter_fn")
    if n == 0:
        return None
    return s * 1e3 / n
