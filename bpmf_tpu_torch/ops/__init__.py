"""Compute ops of the port: the kernels (dense8, the packed-triangle solve,
the batched solve) with their plain versions, the solvers, the bucket Gram
and prior combine, the Normal-Wishart draws, the noise tables."""


def launch_counts() -> dict:
    """The CUDA launches of the main path's kernel wrappers in this process
    so far, by kernel (each wrapper counts where it launches; a plain
    version's call is not counted): the megakernel (#1 ``fused_inkernel``,
    #2 ``fused_tight``/``fused_aligned``), the Gram (#3 ``gram_inkernel``,
    #4 ``gram_hoisted``), each also on bf16 operands (``*_bf16``), the
    packed-triangle solve (#5/#6 ``solve_shared``/``solve_peritem``, #7
    ``*_grouped``) and the batched solve (#8 ``blast``)."""
    from bpmf_tpu_torch.ops import dense8, pallas_solve

    solves = pallas_solve.solve_launches
    return {**{"fused_" + n: c for n, c in dense8.sweep_launches.items()},
            **{"gram_" + n: c for n, c in dense8.gram_launches.items()},
            **{"solve_" + n: c for n, c in solves.items() if n != "blast"},
            "blast": solves["blast"]}
