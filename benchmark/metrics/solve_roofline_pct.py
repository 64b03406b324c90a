"""solve_roofline_pct: the least time the card could take for each side's
half-sweep work as the ratings need it (benchmark.work.sweeps), over that
side's solve time (solve_ms_per_iter), in percent: both sides together,
``by_side`` beside it, and which of operations or bytes bound each
side."""

from benchmark import program_trace, work


def read(ctx):
    ms = program_trace.solve_ms_by_side(ctx)
    if len(ms) != len(program_trace.SIDES) or not all(ms.values()):
        return None
    least, bound = {}, {}
    for side, w in zip(program_trace.SIDES, work.sweeps(ctx.shape)):
        t_ops = w.ops / work.PEAK_FLOPS[ctx.peak_dtype]
        t_bytes = w.bytes / work.PEAK_BYTES_PER_S
        least[side] = max(t_ops, t_bytes) * 1e3
        bound[side] = "operations" if t_ops >= t_bytes else "bytes"
    return {"value": 100.0 * sum(least.values()) / sum(ms.values()),
            "by_side": {s: 100.0 * least[s] / ms[s] for s in ms},
            "bound": bound}
