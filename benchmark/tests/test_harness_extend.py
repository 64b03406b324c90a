"""A cell, a configuration, a layer and a per-layer metric added as new
files and manifest entries alone are found and run; no file of the
harness is edited."""

from __future__ import annotations

import hashlib
import json

from benchmark import run
from benchmark.tests.helpers import REPO, SEED, TINY, make_root


def _digest() -> str:
    h = hashlib.sha256()
    for p in sorted((REPO / "benchmark").glob("*.py")):
        h.update(p.read_bytes())
    return h.hexdigest()


def test_new_files_are_found_and_run(tmp_path):
    before = _digest()
    root = make_root(tmp_path)
    (root / "benchmark/metrics/window_chunks.py").write_text(
        "def read(ctx):\n"
        "    return ctx.iterations / ctx.cell['chunk']\n")
    (root / "benchmark/layers/extra.json").write_text(json.dumps(
        {"layer": "extra", "modules": "a test layer",
         "spans": [{"on": "sampler", "attr": "_predict", "span": "extra_eval"}],
         "kernels": []}))
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["per_layer"].append({"name": "window_chunks", "unit": "chunks",
                           "better": "higher", "source": "host_clock",
                           "layer": "extra", "moves": "items_per_s",
                           "workloads": [TINY]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))

    plain = run.run_cell(TINY, SEED, 0.4, False, device="cpu", root=root)
    assert plain["correct"]
    assert set(plain["metrics"]) == {"items_per_s", "setup_s"}
    traced = run.run_cell(TINY, SEED, 0.6, True, device="cpu", root=root)
    assert traced["correct"]
    got = traced["metrics"]["window_chunks"]
    assert got["unit"] == "chunks"
    assert got["value"] == traced["attempted"] / 4
    assert list(traced)[-1] == "compared"
    assert _digest() == before
