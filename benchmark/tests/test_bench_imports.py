"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program (top-level names compared
whole)."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "svt_speechbrain_tpu"}
FILES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    modules = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            modules |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            modules.add(node.module)
    assert all(m in ("__future__", "math", "torch", "torch.nn.functional")
               or m.startswith("benchmark.reference") for m in modules)


def test_run_refuses_a_run_that_loaded_jax(monkeypatch):
    import sys
    import types

    from benchmark import run

    monkeypatch.setitem(sys.modules, "jaxlib.xla", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "svt_speechbrain_tpu_torch_extra",
                        types.ModuleType("y"))
    assert run.forbidden_modules() == ["jaxlib"]
