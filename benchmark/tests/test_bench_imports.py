"""What the benchmark's modules import, by top-level name compared whole:
the reference and the model files nothing of JAX, the JAX package or the
port (a model file at most the reference and the counts' arithmetic);
nothing under benchmark/ JAX or the JAX package (the port's own name
begins with the JAX package's, and is allowed there)."""
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


def benchmark_imports(path: Path) -> set[str]:
    """The modules of the benchmark that `path` imports, by full name."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names
                      if a.name.split(".")[0] == "benchmark"}
        elif (isinstance(node, ast.ImportFrom) and node.level == 0
              and node.module.split(".")[0] == "benchmark"):
            names |= ({node.module} if node.module != "benchmark" else
                      {f"benchmark.{a.name}" for a in node.names})
    return names


@pytest.mark.parametrize("path", sorted((BENCH / "models").glob("*.py")),
                         ids=lambda p: p.name)
def test_model_files_import_only_plain_libraries(path):
    found = top_level_imports(path)
    assert not found & (JAX_SIDE | {"spgemm_gnn_tpu_torch"})
    assert found <= {"__future__", "math", "torch", "benchmark"}
    assert benchmark_imports(path) <= {"benchmark.reference",
                                       "benchmark.counts"}


def test_model_files_are_there():
    assert {"sage.py", "gcn.py"} <= {p.name for p in
                                     (BENCH / "models").glob("*.py")}


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
