"""peak_mem_gb: torch.cuda.max_memory_allocated over set-up and window,
in GB (1e9 bytes)."""


def read(ctx):
    if ctx.peak_mem_bytes is None:
        return None
    return ctx.peak_mem_bytes / 1e9
