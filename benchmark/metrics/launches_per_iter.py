"""launches_per_iter: launches of the program's hand-written kernels over
the window (bpmf_tpu_torch.ops.launch_counts differences), per iteration,
with the count of each kernel beside it."""


def read(ctx):
    if ctx.iterations == 0:
        return None
    per = {k: v / ctx.iterations for k, v in sorted(ctx.launches.items()) if v}
    return {"value": sum(ctx.launches.values()) / ctx.iterations,
            "by_kernel": per}
