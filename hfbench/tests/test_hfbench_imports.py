"""Nothing under hfbench/ imports the JAX stack, and the references import
nothing of the program."""

from __future__ import annotations

import ast
import sys

import pytest

from hfbench import harness

FILES = sorted(p for p in harness.PACKAGE.rglob("*.py") if "__pycache__" not in p.parts)
JAX = {"jax", "jaxlib", "flax", "machine_learning_replications_tpu"}
PORT = "machine_learning_replications_tpu_torch"


def top_level_imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(harness.ROOT)))
def test_no_jax_stack(path):
    assert not (top_level_imports(path) & JAX), path


@pytest.mark.parametrize("path", sorted((harness.PACKAGE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    assert top_level_imports(path) <= {"__future__", "torch", "numpy", "math"}, path


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, f"{PORT}_probe", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "machine_learning_replications_tpu.models", sys)
    assert harness.forbidden_modules() == ["jax", "machine_learning_replications_tpu"]
