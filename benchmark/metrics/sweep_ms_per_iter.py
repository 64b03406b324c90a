"""sweep_ms_per_iter: device milliseconds of the operations launched in
the half-sweeps' spans (BPMF._sweep, whatever the route), per iteration of
the traced window."""


def read(ctx):
    return ctx.layer_ms_per_iter("half-sweep")
