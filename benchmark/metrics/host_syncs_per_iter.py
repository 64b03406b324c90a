"""host_syncs_per_iter: the program's counted host syncs with the device
(``event_counts()["host_sync"]``) over the window, from its start to its
end, per iteration; ``by_site`` beside it."""

from benchmark import program_trace


def read(ctx):
    r = program_trace.last()
    if r.start is None or r.end is None or ctx.iterations == 0:
        return None
    start, end = r.start["host_sync"], r.end["host_sync"]
    delta = {site: n - start.get(site, 0) for site, n in sorted(end.items())}
    return {"value": sum(delta.values()) / ctx.iterations,
            "by_site": {s: n / ctx.iterations for s, n in delta.items() if n}}
