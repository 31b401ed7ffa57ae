"""Nothing under bench/ imports JAX, the JAX package or the JAX package's
benchmarks: top-level module names compared whole (the program's name
begins with the JAX package's)."""

import ast
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from gsbench.harness import FORBIDDEN  # noqa: E402

SOURCES = sorted(BENCH.rglob("*.py"))


def _tops(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_forbidden_import(path):
    bad = sorted(set(_tops(path)) & set(FORBIDDEN))
    assert not bad, f"{path}: {bad}"


def test_names_are_compared_whole():
    assert "repro_torch".split(".")[0] not in FORBIDDEN
    assert {"jax", "repro", "benchmarks"} <= set(FORBIDDEN)
