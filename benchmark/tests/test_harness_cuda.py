"""The benchmark's command as the driver runs it: without a card it exits
non-zero and prints no result; on the card (marked ``cuda``) a cell runs
end to end, for the manifest's ``run_seconds`` (the limits of ``correct``
hold for a chain that far in), and comes out correct."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark.tests.helpers import REPO

RUN_SECONDS = json.loads((REPO / "BENCHMARK.json").read_text())["run_seconds"]
CMD = [sys.executable, "-m", "benchmark.run", "--workload", "ml25m.k32",
       "--seed", str(2**31 + 99), "--seconds", str(RUN_SECONDS), "--trace", "0"]


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without one")
    p = subprocess.run(CMD, cwd=REPO, capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(CMD, cwd=tmp_path, capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.cuda
def test_a_cell_end_to_end_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    p = subprocess.run(CMD, cwd=REPO, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"items_per_s", "setup_s"}
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
