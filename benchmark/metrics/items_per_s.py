"""items_per_s: (users + items) x the Gibbs iterations completed in the
window / the window's wall time from its start to the last chunk's host
sync (the reference's yardstick, c++/bpmf.cpp:193-198), over all the work
and all the time of the window."""


def read(ctx):
    if ctx.iterations == 0:
        return None
    return ctx.items * ctx.iterations / ctx.window_s
