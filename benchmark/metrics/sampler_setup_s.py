"""sampler_setup_s: host seconds of the last sampler's construction and
setup() (``BPMF.__init__`` + ``BPMF.setup``), the sum of its clocked parts
as ``event_counts()`` held them at the window's end; ``by_part`` beside
it, and ``kernel_build_s``, the process's nvcc seconds (kernels build at
their first launch, after the set-up)."""

from benchmark import program_trace


def read(ctx):
    r = program_trace.last()
    if r.end is None or not r.end["setup_s"]:
        return None
    parts = r.end["setup_s"]
    return {"value": sum(parts.values()), "by_part": parts,
            "kernel_build_s": r.end["kernel_build"]["seconds"]}
