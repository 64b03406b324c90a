"""hyper_ms_per_iter: device milliseconds of the operations launched in
the hyperprior's spans, per iteration of the traced window."""


def read(ctx):
    return ctx.layer_ms_per_iter("hyperprior")
