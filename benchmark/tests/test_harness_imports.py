"""What the benchmark may import: the plain reference nothing of the port
and nothing of JAX; no file of the benchmark the JAX package or its
files; and after a run, no module of JAX or of the JAX package in the
process (top-level names compared whole: bpmf_tpu_torch is the port)."""

from __future__ import annotations

import ast
import json
import re
import subprocess
import sys

import pytest

from benchmark.tests.helpers import REPO, SEED, TINY, make_root

BENCH = REPO / "benchmark"
JAX_SIDE = {"jax", "jaxlib", "flax", "bpmf_tpu"}


def _imports(path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out


def _closure(module: str) -> set[str]:
    """The modules ``benchmark.<module>`` imports, following the
    benchmark's own modules."""
    seen, todo, out = set(), [module], set()
    while todo:
        m = todo.pop()
        if m in seen:
            continue
        seen.add(m)
        for name in _imports(BENCH / f"{m}.py"):
            out.add(name)
            if name.startswith("benchmark."):
                todo.append(name.split(".", 1)[1])
    return out


def test_reference_imports_nothing_of_the_port_or_jax():
    top = {n.split(".")[0] for n in _closure("reference")}
    assert not top & (JAX_SIDE | {"bpmf_tpu_torch"}), top


def test_reference_loads_nothing_of_the_port_or_jax():
    code = ("import sys, benchmark.reference, benchmark.check; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True).stdout
    top = set(json.loads(out.strip().replace("'", '"')))
    assert not top & (JAX_SIDE | {"bpmf_tpu_torch"})


@pytest.mark.parametrize("path", sorted(p.relative_to(BENCH).as_posix()
                                        for p in BENCH.rglob("*.py")))
def test_no_file_imports_the_jax_side(path):
    top = {n.split(".")[0] for n in _imports(BENCH / path)}
    assert not top & JAX_SIDE, (path, top)


def test_no_file_reads_the_jax_packages_files():
    # a path into the JAX package, or one of its modules by name
    pat = re.compile(r"bpmf_tpu(?!_torch)(/|\.[a-z])")
    for p in BENCH.rglob("*"):
        if p.is_file() and p.suffix in (".py", ".json", ".md", ".txt"):
            assert not pat.search(p.read_text()), p


def test_no_jax_module_after_a_run(tmp_path):
    root = make_root(tmp_path)
    code = (f"import json, sys; from benchmark import run; "
            f"r = run.run_cell({TINY!r}, {SEED}, 0.5, False, device='cpu', "
            f"root={str(root)!r}); "
            f"print(json.dumps([r['correct'], run._forbidden_modules(), "
            f"sorted({{m.split('.')[0] for m in sys.modules}})]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True).stdout
    correct, forbidden, top = json.loads(out.strip().splitlines()[-1])
    assert correct and forbidden == []
    assert "bpmf_tpu_torch" in top and not set(top) & JAX_SIDE
