"""The readings that the limits of ``correct`` are set from, on the card:
whole runs of a cell (set-up, the window, the chunk after it) that report,
beside the program's compared numbers (the lower readings), the control's
(the upper readings): the reference itself, put in the program's place,
in float32 with every matrix product's operands rounded to TF32, the
nearest precision below the configuration's float32, run from the same
inputs.

    python3 -m benchmark.control --workload ml25m.k32 --seconds 20 \\
        --seeds 1,2,3 [--control-seeds 1,2,3]

Prints one JSON line per seed.  The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys

from benchmark import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    a = ap.parse_args(argv)
    run._cache_env(run.ROOT)
    ctl = {int(s) for s in a.control_seeds.split(",") if s}
    seeds = [int(s) for s in a.seeds.split(",")]
    for seed in seeds + sorted(ctl - set(seeds)):
        r = run.run_cell(a.workload, seed, a.seconds, False, readings=True,
                         with_control=seed in ctl)
        print(json.dumps({
            "workload": a.workload, "seed": seed, "correct": r["correct"],
            "attempted": r["attempted"], "metrics": r["metrics"],
            "program": {n: c["value"] for n, c in r["compared"].items()},
            "control": r.get("control"), "parts": r.get("parts"),
            "control_parts": r.get("control_parts")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
