"""solve_ms_per_iter: device milliseconds of the operations launched in
the program's solve spans (``bpmf.solve.movies``, ``bpmf.solve.users``:
from the frozen side's operand to the drawn items, on any route), per
iteration of the traced window, each operation found through its launch's
correlation (benchmark.program_trace); ``by_side`` beside it."""

from benchmark import program_trace


def read(ctx):
    by_side = program_trace.solve_ms_by_side(ctx)
    if not by_side:
        return None
    return {"value": sum(by_side.values()), "by_side": by_side}
