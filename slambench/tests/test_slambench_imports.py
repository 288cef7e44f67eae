"""No module of the benchmark imports JAX or the JAX package, and the
reference, the renderer, the work counts, the trace reader and the metric
readers import nothing of the program either (top-level names compared
whole: the port's name begins with the JAX package's)."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
NEVER = {"jax", "jaxlib", "flax", "refactored_orb_slam2_tpu"}
PORT = "refactored_orb_slam2_tpu_torch"
#: modules that judge or count: they may not import the program
JUDGES = {"reference.py", "world.py", "work.py", "tracing.py", "registry.py"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


MODULES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & NEVER


@pytest.mark.parametrize("path", [p for p in MODULES
                                  if p.name in JUDGES or p.parent.name == "metrics"],
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_judges_import_no_program(path):
    assert PORT not in top_level_imports(path)


def test_loaded_modules_compared_whole(monkeypatch):
    """``run.forbidden_loaded`` flags JAX and the JAX package by whole
    top-level name, and not the port."""
    import sys

    from slambench import run

    fake = dict.fromkeys(["refactored_orb_slam2_tpu_torch", "refactored_orb_slam2_tpu_torch.system"])
    monkeypatch.setattr(sys, "modules", fake)
    assert run.forbidden_loaded() == []
    fake.update(dict.fromkeys(["refactored_orb_slam2_tpu.system", "jax.numpy"]))
    assert run.forbidden_loaded() == ["jax", "refactored_orb_slam2_tpu"]
