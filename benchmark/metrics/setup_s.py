"""setup_s: seconds from the harness's start to the window's start: data
made, the sampler built and set up (kernels loaded or built), the checked
iterations and the warm-up chunk."""


def read(ctx):
    return ctx.setup_s
