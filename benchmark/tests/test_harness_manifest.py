"""BENCHMARK.json against the contract's rules on names, units, keys and
limits, and against the files the harness finds by those names."""

from __future__ import annotations

import json
import re

import pytest

from benchmark.tests.helpers import REPO

M = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                   r"projection|head|expansion|experts_per_tok|^k$")


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_command_and_paths():
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (REPO / p).is_dir()
    assert 1 <= len(M["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in M["command"])


@pytest.mark.parametrize("kind", sorted(ENTRY_KEYS))
def test_entries(kind):
    entries = M[kind]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        extra = {"workloads"} if kind in ("end_to_end", "per_layer") else set()
        assert ENTRY_KEYS[kind] <= set(e) <= ENTRY_KEYS[kind] | extra, e
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert _line(e[key]), (key, e[key])


def test_metric_names_unique_across_kinds():
    names = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(names) == len(set(names))


def test_end_to_end_rules():
    names = {m["name"] for m in M["end_to_end"]}
    assert "setup_s" in names and 1 <= len(M["end_to_end"]) <= 16
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = next(m for m in M["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25


def test_per_layer_rules():
    e2e = {m["name"] for m in M["end_to_end"]}
    cells = {w["name"] for w in M["workloads"]}
    assert 1 <= len(M["per_layer"]) <= 128
    for m in M["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_enough():
    for w in M["workloads"]:
        def has(x):
            return "workloads" not in x or w["name"] in x["workloads"]
        e2e = [m["name"] for m in M["end_to_end"] if has(m)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(has(m) for m in M["per_layer"])


def test_layers_have_files_and_metrics_have_readers():
    layer_names = {json.loads(p.read_text())["layer"]
                   for p in (REPO / "benchmark/layers").glob("*.json")}
    for m in M["per_layer"]:
        assert m["layer"] in layer_names, m["layer"]
    for m in M["per_layer"] + M["end_to_end"]:
        assert (REPO / "benchmark/metrics" / f"{m['name']}.py").is_file()


def test_configs_and_cells():
    used = {w["config"] for w in M["workloads"]}
    assert {c["name"] for c in M["configs"]} == used
    assert 1 <= len(M["configs"]) <= 24 and 1 <= len(M["workloads"]) <= 24
    files = [c["file"] for c in M["configs"]]
    assert len(files) == len(set(files))
    for c in M["configs"]:
        assert c["file"].startswith(tuple(p + "/" for p in M["paths"]))
        conf = json.loads((REPO / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert not any(WIDTH.search(k) for k in c["reduced"])
        assert _line(c["source"])
    pairs = {(w["config"], w["traffic"]) for w in M["workloads"]}
    assert len(pairs) == len(M["workloads"])
    for w in M["workloads"]:
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        cell = json.loads(
            (REPO / "benchmark/cells" / f"{w['traffic']}.json").read_text())
        assert cell["config"] == w["config"]
        assert set(cell["limits"]) == {"hyper", "items", "eval", "m2", "start"}
    four = sum(w["chips"] == 4 for w in M["workloads"])
    assert four <= max(1, len(M["workloads"]) // 4)


def test_run_seconds_fit_a_full_check_of_24_cells():
    rs = M["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    cells = 24
    assert (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200 <= 43200
