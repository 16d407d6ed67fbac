"""Nothing of the benchmark imports JAX or the JAX package: top-level
module names compared whole (the port's ``repro_torch`` begins with
``repro``), and no file reads the JAX package's old harness."""
from __future__ import annotations

import ast

from tomobench.program import FORBIDDEN, forbidden_modules

from .tiny import HERE


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_imports_jax_or_the_reference_package():
    found = {}
    for path in HERE.rglob("*.py"):
        for mod in _imports(path):
            if mod.split(".")[0] in FORBIDDEN:
                found[str(path)] = mod
    assert found == {}


def test_no_source_reads_the_old_harness():
    for path in HERE.rglob("*.py"):
        if path.name == "test_tomobench_isolation.py":
            continue
        assert "benchmarks/" not in path.read_text(), path


def test_names_are_compared_whole():
    import sys
    import types
    sys.modules["repro_torch_probe"] = types.ModuleType("repro_torch_probe")
    try:
        assert "repro" not in forbidden_modules()
        sys.modules["repro"] = types.ModuleType("repro")
        assert "repro" in forbidden_modules()
    finally:
        sys.modules.pop("repro_torch_probe")
        sys.modules.pop("repro", None)
