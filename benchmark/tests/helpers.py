"""A benchmark root at a size the CPU tests can run: the benchmark's own
layer, metric, configuration and cell files, and beside them a small
configuration and cell added the way a later change adds them, as new
files and new manifest entries: a cell's own file (its K, value model and
limits) on its configuration's laws at a fraction of the size."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
TINY = "tiny.k8"
SEED = 2**31 + 4242
SMALL = {"movielens-25m": dict(n_rows=700, n_cols=260, n_ratings=24_000)}


def make_root(dst: Path, *, like: str = "ml25m.k32", k: int = 8) -> Path:
    """``dst`` as a checkout's benchmark, with the cell ``TINY``: the cell
    ``like`` at K = ``k`` on its configuration at ``SMALL`` size."""
    for d in ("layers", "metrics", "configs", "cells"):
        shutil.copytree(REPO / "benchmark" / d, dst / "benchmark" / d)
    m = json.loads((REPO / "BENCHMARK.json").read_text())
    cell = json.loads((REPO / f"benchmark/cells/{like}.json").read_text())
    conf = json.loads(
        (REPO / f"benchmark/configs/{cell['config']}.json").read_text())
    conf.update(name="tiny", **SMALL[cell["config"]])
    (dst / "benchmark/configs/tiny.json").write_text(json.dumps(conf))
    cell.update(config="tiny", k=k, chunk=4, trace_seconds=0.3)
    (dst / f"benchmark/cells/{TINY}.json").write_text(json.dumps(cell))
    m["configs"].append({"name": "tiny", "source": "a small copy of a config",
                         "file": "benchmark/configs/tiny.json", "reduced": [],
                         "why": "CPU tests"})
    m["workloads"].append({"name": TINY, "config": "tiny", "traffic": TINY,
                           "chips": 1, "why": "CPU tests"})
    (dst / "BENCHMARK.json").write_text(json.dumps(m))
    return dst
