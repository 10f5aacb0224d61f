"""What the benchmark's modules import, by top-level name compared whole:
the reference nothing of JAX, the JAX package or the port; nothing under
benchmark/ JAX or the JAX package (the port's own name begins with the
JAX package's, and is allowed there)."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
JAX_SIDE = {"jax", "jaxlib", "flax", "spgemm_gnn_tpu"}


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_only_plain_libraries():
    found = top_level_imports(BENCH / "reference.py")
    assert not found & (JAX_SIDE | {"spgemm_gnn_tpu_torch", "benchmark"})
    assert found <= {"__future__", "dataclasses", "warnings", "torch"}


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_side_import(path):
    assert not top_level_imports(path) & JAX_SIDE


def test_names_compared_whole():
    assert "spgemm_gnn_tpu_torch".split(".")[0] not in JAX_SIDE
