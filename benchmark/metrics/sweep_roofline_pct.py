"""sweep_roofline_pct: the least time the card could take for both
half-sweeps' work as the ratings need it (benchmark.work: rated entries
and items, not the port's layout), over sweep_ms_per_iter, in percent;
``bound`` says whether operations or bytes bound it."""

from benchmark import work


def read(ctx):
    ms = ctx.layer_ms_per_iter("half-sweep")
    if not ms:
        return None
    t, bound = work.sweep_bound(ctx.shape, ctx.peak_dtype)
    return {"value": 100.0 * t * 1e3 / ms, "bound": bound}
