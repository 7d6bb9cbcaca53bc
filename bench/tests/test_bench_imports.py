"""What the benchmark may import: nothing of JAX or the JAX package
anywhere under ``bench/`` (top-level names compared whole, so
``repro_torch`` is not ``repro``), and nothing of the program in the
reference."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported(path: Path):
    """Top-level names of every module ``path`` imports (a relative import
    names the ``bench`` package)."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield "bench" if node.level else node.module.split(".")[0]


FILES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(
    BENCH)))
def test_no_jax(path):
    assert not set(imported(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "ref").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_takes_nothing_of_the_program(path):
    assert set(imported(path)) <= {"__future__", "bench", "functools",
                                   "importlib", "math", "typing", "torch"}


def test_the_check_is_whole_names():
    src = "import repro_torch\nfrom repro_torch.models import x\n"
    path = BENCH / "tests" / "_probe.py"
    try:
        path.write_text(src)
        assert set(imported(path)) == {"repro_torch"}
    finally:
        path.unlink()
