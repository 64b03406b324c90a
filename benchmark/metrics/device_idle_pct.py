"""device_idle_pct: 100 x (1 - the union of the device operations'
intervals / the traced window)."""


def read(ctx):
    if ctx.trace is None or ctx.trace.n_device_ops == 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
