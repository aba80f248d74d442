"""The import walk: no module of the benchmark imports JAX or the JAX
package (top-level names compared whole, since the port's name begins with
the JAX package's), the reference imports nothing of the program, and only
``program.py`` reaches the program."""

import ast
import sys

import pytest

from portbench import harness
from portbench.registry import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "lrce_tpu"}
SOURCES = sorted(p for p in ROOT.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0], a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0], node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(
    ROOT)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not {top for top, _ in top_level_imports(path)} & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "reference").rglob("*.py"):
        for top, full in top_level_imports(path):
            assert top != "lrce_tpu_torch", path
            assert full in ("portbench.reference", "portbench.reference.lrce",
                            "portbench.reference.train") \
                or top != "portbench", (path, full)


def test_only_the_program_adapter_imports_the_program():
    users = {p.relative_to(ROOT).as_posix() for p in SOURCES
             for top, _ in top_level_imports(p) if top == "lrce_tpu_torch"}
    assert users == {"program.py"}


def test_the_run_names_what_it_must_not_hold(monkeypatch):
    monkeypatch.setitem(sys.modules, "lrce_tpu.models", object())
    found = harness.forbidden_modules()
    assert "lrce_tpu" in found
    assert set(found) <= FORBIDDEN
