"""iter_mfu: one iteration's counted operations (benchmark.work) x the
iterations / the wall time, over the peak of the configuration's
precision, in percent; over the traced run's untraced part (the whole
window where that part is empty)."""

from benchmark import work


def read(ctx):
    n, s = ctx.untraced if ctx.untraced[0] else ctx.window
    if n == 0:
        return None
    return (100.0 * work.iteration_ops(ctx.shape) * n / s
            / work.PEAK_FLOPS[ctx.peak_dtype])
