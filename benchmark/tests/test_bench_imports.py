"""No JAX and no JAX package anywhere in the benchmark, and no port in its
reference. Top-level module names are compared whole: ``muse_tpu_torch``
begins with ``muse_tpu`` but is not it."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import run

FORBIDDEN = {"jax", "jaxlib", "flax", "muse_tpu"}
FILES = sorted(p for p in run.BENCH.rglob("*.py"))


def _top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(
    run.ROOT)))
def test_no_jax_imported(path):
    assert not (_top_level_imports(path) & FORBIDDEN)


@pytest.mark.parametrize("path", sorted((run.BENCH / "reference").glob(
    "*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "muse_tpu_torch" not in _top_level_imports(path)
    # and nothing of the benchmark outside the reference
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.level:
            assert node.level == 1


def test_a_run_loads_no_jax():
    """The modules a tiny run loads, in a fresh process."""
    code = (
        "import sys\n"
        "from benchmark.tests._tiny import run_tiny\n"
        "rc, line, err = run_tiny(seconds=0.1)\n"
        "print(rc, sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT,
                         capture_output=True, text=True, timeout=600)
    rc, mods = out.stdout.strip().splitlines()[-1].split(" ", 1)
    assert rc == "0", out.stderr[-3000:]
    assert not (set(eval(mods)) & FORBIDDEN)
    assert "muse_tpu_torch" in mods
